"""Threefry-2x32 draws (the port's counterpart of jax.random's bits): the
CUDA kernel's wrapper and its plain PyTorch version.

A port-only kernel: the JAX package's draws are jax.random's, which XLA
compiles, not a Pallas kernel. With jax_threefry_partitionable on (the
default of the JAX this repository runs), a key is two uint32 words and

- fold_in(key, d) = threefry2x32(key, (0, d)), and split(key, n)[i] is the
  same as fold_in(key, i);
- element i of a draw (its flat index in the whole draw) takes the bits
  x0 ^ x1 of threefry2x32(key, (i >> 32, i & 0xFFFFFFFF));
- a float32 uniform is bitcast((bits >> 9) | 0x3F800000) - 1, max 0.

`threefry_draw(words, it, path, n, offset, floats, device)` gives the n
elements from counter `offset` on of the draw under the key words, folded
first by the 0-d int32 tensor `it` when one is given and then by each host
value of `path`. The words are two host ints, or a (2,) int32 tensor on
the draw's device (a key slot, core/rng.py:KeySlot). The kernel reads a
slot's words and `it` from device memory, so a replayed CUDA graph draws
from whatever the host wrote there before the replay. Bits come back as
int64 values in [0, 2**32), uniforms as float32.

A draw on a CUDA device launches the kernel (csrc/threefry.cu), built at
first use, and raises if it cannot be built or launched; a draw on the CPU
runs the plain version, integer arithmetic that equals the kernel's bit
for bit. The kernel counts its launches on its KernelLibrary.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .build import INT, PTR, KernelLibrary, check, runs_plain

THREEFRY = KernelLibrary("threefry")
MAX_PATH = 6            # folds after the device iteration (csrc: kTfMaxPath)
_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k0, k1, c0, c1):
    """threefry2x32 of the counter (c0, c1) under the key (k0, k1), on
    Python ints or int64 tensors holding values in [0, 2**32) (broadcast
    together) -> (x0, x1) of the same kind."""
    k2 = k0 ^ k1 ^ 0x1BD11BDA
    ks = (k0, k1, k2)
    x0 = (c0 + k0) & _M32
    x1 = (c1 + k1) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) & _M32) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


@functools.lru_cache(maxsize=4096)
def fold(words: tuple, data: int) -> tuple:
    """jax.random.fold_in on host key words: threefry2x32(key, (0, d))."""
    return threefry2x32(words[0], words[1], 0, int(data) & _M32)


def _key_plain(words, it, path):
    """The draw's key: host ints, or 0-d int64 tensors when the words are
    a tensor or `it` is given (the folds then run as tensor arithmetic on
    its device, with no host read)."""
    if isinstance(words, torch.Tensor):
        k0, k1 = (words.to(torch.int64) & _M32).unbind()
    else:
        k0, k1 = words
    if it is not None:
        k0, k1 = threefry2x32(k0, k1, 0, it.to(torch.int64) & _M32)
    for d in path:
        k0, k1 = threefry2x32(k0, k1, 0, int(d) & _M32)
    return k0, k1


def threefry_plain(words, it, path, n: int, offset: int, floats: bool,
                   device) -> torch.Tensor:
    """The plain PyTorch version of the kernel (same contract), in int64
    arithmetic masked to 32 bits, on any device."""
    k0, k1 = _key_plain(words, it, path)
    c = torch.arange(offset, offset + n, dtype=torch.int64, device=device)
    x0, x1 = threefry2x32(k0, k1, c >> 32, c & _M32)
    bits = x0 ^ x1
    if not floats:
        return bits
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return torch.clamp(f - 1.0, min=0.0)


def _threefry_cuda(words, it, path, n, offset, floats, device):
    device = THREEFRY.device_for(device)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    slot = isinstance(words, torch.Tensor)
    if slot:
        check("key slot", words, torch.int32, (2,), device)
    if it is not None:
        check("iteration", it, torch.int32, (), device)
    if n >= 2 ** 31:
        raise ValueError(f"{n} elements exceed the kernel's int32 indexing")
    out = torch.empty((n,), dtype=torch.float32 if floats else torch.int32,
                      device=device)
    if n:
        path_arr = (ctypes.c_uint * MAX_PATH)(*path)
        THREEFRY.launch(
            [ctypes.c_uint, ctypes.c_uint, PTR, PTR, INT, PTR,
             ctypes.c_longlong, INT, INT, PTR], device,
            0 if slot else words[0], 0 if slot else words[1],
            words.data_ptr() if slot else None,
            None if it is None else it.data_ptr(), len(path),
            ctypes.addressof(path_arr), offset, n, int(bool(floats)),
            out.data_ptr())
    return out if floats else out.to(torch.int64) & _M32


def threefry_draw(words, it, path, n: int, offset: int, floats: bool,
                  device) -> torch.Tensor:
    """n elements of a draw from counter `offset` (contract in the module
    docstring). A CUDA device launches the kernel or raises; the CPU runs
    the plain version."""
    device = torch.device(device)
    path = tuple(int(d) & _M32 for d in path)
    if len(path) > MAX_PATH:
        raise ValueError(f"{len(path)} folds after the iteration: the "
                         f"kernel takes at most {MAX_PATH}")
    if offset < 0:
        raise ValueError(f"negative counter offset {offset}")
    if runs_plain(device, find=False):
        return threefry_plain(words, it, path, n, offset, floats, device)
    return _threefry_cuda(words, it, path, n, offset, floats, device)
