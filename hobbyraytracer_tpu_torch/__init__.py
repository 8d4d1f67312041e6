"""hobbyraytracer_tpu_torch — the path tracer ported to PyTorch and CUDA.

A second package beside `hobbyraytracer_tpu` (the JAX reference, which it
never imports). The layout mirrors the reference (`core/`, `io/`,
`scene/`, `ops/`, `kernels/`, `integrator/`, `diff/`, `parallel/`,
`cli/`) so each module has an obvious counterpart there:

- scene tables are `nn.Module`s holding buffers (`scene.to(device)`);
- rays, hits and the wavefront pool state are dataclasses of tensors;
- randomness goes through explicit `torch.Generator`s (`core/rng.py`);
- the four TPU kernels are hand-written CUDA kernels for Hopper
  (`kernels/csrc/`: the fused mesh traversal in its resident and streaming
  layouts, the coherence keys, the clustered sphere find), each with a
  plain PyTorch version beside it that runs for CPU tensors.

Every entry point takes an explicit device; nothing falls back to the CPU.
The port does what the JAX package does: the forward renderer, by the
wavefront and the batch integrator, for spheres, rects, boxes, triangles,
dense and clustered meshes of every format of `scene/meshload.py` and
constant media with all seven material types and image textures (all
eight scenes in `scenes/`), and the opt-in thin lens; the image codecs
(`io/`), the procedural assets (`scene/procgen.py`, `scene/fixtures.py`);
the differentiable fit (`diff/`); checkpoint/resume in the JAX package's
format (`io/checkpoint.py`); rendering and fitting over several workers
and processes (`parallel/`); the CLI (`cli/main.py`, with `bench.py`
behind its `bench`) and `entry.py`.
"""

__version__ = "0.1.0"
