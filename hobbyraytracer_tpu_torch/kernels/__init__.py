"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version.

- mesh_traverse: fused cluster-BVH traversal + Moller-Trumbore +
  attribute interpolation (replaces the TPU kernel
  hobbyraytracer_tpu/kernels/mesh_traverse.py:_kernel).

Nothing here builds or imports a compiler at import time: a kernel is
compiled by nvcc at its first launch (kernels/build.py).
"""
