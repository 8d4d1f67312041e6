"""hobbyraytracer_tpu_torch — the path tracer ported to PyTorch and CUDA.

A second package beside `hobbyraytracer_tpu` (the JAX reference, which it
never imports). The layout mirrors the reference (`core/`, `io/`, `scene/`,
`ops/`, `kernels/`, `integrator/`, `cli/`) so each module has an obvious
counterpart there:

- scene tables are `nn.Module`s holding buffers (`scene.to(device)`);
- rays, hits and the wavefront pool state are dataclasses of tensors;
- randomness goes through explicit `torch.Generator`s (`core/rng.py`);
- the fused mesh traversal is a hand-written CUDA kernel for Hopper
  (`kernels/csrc/mesh_traverse.cu`) with a plain PyTorch version beside it
  that runs for CPU tensors.

Every entry point takes an explicit device; nothing falls back to the CPU.
The slice covers the wavefront main path on `scenes/teapot_scene.yaml`;
what it leaves out raises `NotImplementedError` naming its ROADMAP item.
"""

__version__ = "0.1.0"
