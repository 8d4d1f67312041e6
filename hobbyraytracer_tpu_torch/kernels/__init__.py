"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version (kernels/mesh_traverse.py, kernels/sphere_traverse.py,
kernels/sphere_scan.py, kernels/threefry.py):

- K1 mesh_traverse: fused cluster-BVH traversal + Moller-Trumbore +
  attribute interpolation over the 24-row resident table (replaces the
  TPU kernel hobbyraytracer_tpu/kernels/mesh_traverse.py:_kernel);
- K2 mesh_traverse_stream: the same over the 32-row streaming table
  (replaces :_kernel_stream);
- K3 coherence_keys: per-ray nearest cluster entry and first cluster
  (replaces :_key_kernel);
- K4 sphere_traverse: nearest sphere of a clustered sphere pool (replaces
  hobbyraytracer_tpu/kernels/sphere_traverse.py:_kernel);
- sphere_scan: nearest pooled sphere by the dense scan, the default
  sphere find (the reference leaves its dense scan to XLA, so this kernel
  replaces no Pallas kernel);
- threefry: jax.random's threefry2x32 bits and float32 uniforms, the
  port's every draw (kernels/threefry.py; jax.random is XLA, so this
  kernel replaces no Pallas kernel).

Nothing here builds or imports a compiler at import time: a kernel is
compiled by nvcc at its first launch (kernels/build.py).
"""
