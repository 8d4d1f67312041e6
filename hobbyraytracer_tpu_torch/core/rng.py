"""Sampling discipline: one explicit `torch.Generator` per (purpose,
iteration).

Counterpart of hobbyraytracer_tpu/core/rng.py. The reference folds a
threefry key by (purpose, bounce) so every call site draws from its own
stream; here a `Sampler(seed, device)` seeds a fresh generator for each
stream from (seed, purpose, iteration) through a fixed 64-bit mixing
function (splitmix64). The draws are not the reference's bits: parity tests
inject identical noise into both packages instead (a subclass overriding
`uniform` / `unit_sphere`).
"""
from __future__ import annotations

import math

import torch

# Stable purpose tags, the same numbers as the reference's.
PIXEL_JITTER_U = 0
PIXEL_JITTER_V = 1
SCATTER_SPHERE = 2   # unit-sphere offsets (lambertian fuzz)
SCATTER_BALL = 3     # isotropic phase function
DIELECTRIC_CHOICE = 4
MEDIUM_FLIGHT = 5
LENS = 6
RUSSIAN_ROULETTE = 7

_MASK64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def stream_seed(seed: int, purpose: int, iteration: int) -> int:
    """63-bit generator seed for one (seed, purpose, iteration) stream."""
    h = _splitmix64(seed & _MASK64)
    h = _splitmix64(h ^ (purpose & _MASK64))
    h = _splitmix64(h ^ (iteration & _MASK64))
    return h >> 1


class Sampler:
    """Random draws for one render: `uniform` / `unit_sphere` return
    float32 tensors on `device`, from the stream of (purpose, iteration)."""

    def __init__(self, seed: int, device):
        self.seed = int(seed)
        self.device = torch.device(device)

    def generator(self, purpose: int, iteration: int) -> torch.Generator:
        g = torch.Generator(device=self.device)
        g.manual_seed(stream_seed(self.seed, purpose, int(iteration)))
        return g

    def uniform(self, purpose: int, iteration: int, shape) -> torch.Tensor:
        """U[0, 1) float32 (glm::linearRand(0, 1))."""
        return torch.rand(tuple(shape), generator=self.generator(
            purpose, iteration), dtype=torch.float32, device=self.device)

    def unit_sphere(self, purpose: int, iteration: int,
                    shape) -> torch.Tensor:
        """Uniform on the unit sphere (glm::sphericalRand(1)): shape + (3,),
        from z = 2*U1 - 1 and phi = 2*pi*U2 as in the reference."""
        u = torch.rand((2,) + tuple(shape), generator=self.generator(
            purpose, iteration), dtype=torch.float32, device=self.device)
        z = u[0] * 2.0 - 1.0
        phi = u[1] * (2.0 * math.pi)
        r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
        return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z],
                           dim=-1)
