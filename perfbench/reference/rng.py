"""Threefry-2x32 keys and draws, as jax.random makes them with
jax_threefry_partitionable on (the program draws the same bits).

- PRNGKey(seed) is the two words (0, seed mod 2**32);
- fold_in(key, d) = threefry2x32(key, (0, d)); split(key, n)[i] is the
  same as fold_in(key, i);
- element i of a draw takes the bits x0 ^ x1 of threefry2x32(key, (i >> 32,
  i & 0xFFFFFFFF));
- a float32 uniform is bitcast((bits >> 9) | 0x3F800000) - 1, at least 0.

Keys are host integers. A draw is int64 tensor arithmetic masked to 32
bits, on any device; `uniforms` draws several keys in one pass.
"""
from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

# purpose tags of the streams
PIXEL_JITTER_U = 0
PIXEL_JITTER_V = 1
SCATTER_SPHERE = 2
RUSSIAN_ROULETTE = 7


def threefry2x32(k0, k1, c0, c1):
    """threefry2x32 of the counter (c0, c1) under the key (k0, k1), on
    Python ints or int64 tensors holding values in [0, 2**32)."""
    k2 = k0 ^ k1 ^ 0x1BD11BDA
    ks = (k0, k1, k2)
    x0 = (c0 + k0) & M32
    x1 = (c1 + k1) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = (((x1 << r) & M32) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
    return x0, x1


def seed_key(seed: int) -> tuple:
    """jax.random.PRNGKey(seed)."""
    return (0, int(seed) & M32)


def fold(key: tuple, data: int) -> tuple:
    """jax.random.fold_in(key, data)."""
    return threefry2x32(key[0], key[1], 0, int(data) & M32)


def stream(key: tuple, purpose: int, iteration: int) -> tuple:
    """The key of the (purpose, iteration) stream."""
    return fold(fold(key, purpose), iteration)


def uniforms(keys, n: int, device, dtype=torch.float32) -> torch.Tensor:
    """(len(keys), n) uniforms in [0, 1): row r is the draw of n elements
    under keys[r]; float32 bits, then cast to `dtype`."""
    k0 = torch.tensor([k[0] for k in keys], dtype=torch.int64,
                      device=device)[:, None]
    k1 = torch.tensor([k[1] for k in keys], dtype=torch.int64,
                      device=device)[:, None]
    c = torch.arange(n, dtype=torch.int64, device=device)[None, :]
    x0, x1 = threefry2x32(k0, k1, c >> 32, c & M32)
    bits = x0 ^ x1
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return torch.clamp(f - 1.0, min=0.0).to(dtype)
