"""Sampling discipline: one explicit `torch.Generator` per (purpose,
iteration).

Counterpart of hobbyraytracer_tpu/core/rng.py. The reference folds a
threefry key by (purpose, bounce) so every call site draws from its own
stream; here a `Sampler(seed, device)` seeds a fresh generator for each
stream from (seed, purpose, iteration) through a fixed 64-bit mixing
function (splitmix64). The draws are not the reference's bits: parity tests
inject identical noise into both packages instead (a subclass overriding
`uniform` / `unit_sphere` / `in_ball` / `in_disk` / `randint` /
`fold_in`).

span=(offset, total) on a draw (reference core/rng.py:33-55): the full
(total, ...) batch is drawn from the stream and rows offset:offset+n are
returned, n the leading size of `shape`. A worker that renders a slice of
the rays then sees the same numbers as the same rows of an unsliced
render, bit for bit (parallel/shard.py).
"""
from __future__ import annotations

import math

import torch

# Stable purpose tags, the same numbers as the reference's.
PIXEL_JITTER_U = 0
PIXEL_JITTER_V = 1
SCATTER_SPHERE = 2   # unit-sphere offsets (lambertian/metal/dielectric fuzz)
SCATTER_BALL = 3     # isotropic phase function
DIELECTRIC_CHOICE = 4
MEDIUM_FLIGHT = 5
LENS = 6
RUSSIAN_ROULETTE = 7
# edge sampling (diff/edges.py; the reference's tags, diff/edges.py:55-58)
EDGE_PICK = 201
EDGE_S = 202
EDGE_PICK_SH = 203
EDGE_S_SH = 204
_FOLD = 1 << 32      # Sampler.fold_in's purpose, apart from every tag above

_MASK64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def _full_shape(shape, span):
    """The shape of the whole batch a span-sliced draw takes rows of."""
    shape = tuple(shape)
    return shape if span is None else (int(span[1]),) + shape[1:]


def _rows(full: torch.Tensor, shape, span, axis: int = 0) -> torch.Tensor:
    """This worker's rows of a full-batch draw along `axis`."""
    if span is None:
        return full
    return full.narrow(axis, int(span[0]), int(tuple(shape)[0]))


def stream_seed(seed: int, purpose: int, iteration: int) -> int:
    """63-bit generator seed for one (seed, purpose, iteration) stream."""
    h = _splitmix64(seed & _MASK64)
    h = _splitmix64(h ^ (purpose & _MASK64))
    h = _splitmix64(h ^ (iteration & _MASK64))
    return h >> 1


class Sampler:
    """Random draws for one render: `uniform` / `unit_sphere` / `in_ball` /
    `in_disk` return float32 tensors on `device`, `randint` int64 ones,
    each from the stream of (purpose, iteration); each takes
    span=(offset, total) for a slice of a larger batch's draw."""

    def __init__(self, seed: int, device):
        self.seed = int(seed)
        self.device = torch.device(device)

    def fold_in(self, index: int) -> "Sampler":
        """An independent Sampler for sub-render `index` (one sample of the
        batch integrator, one chunk of its samples): the counterpart of
        jax.random.fold_in on the reference's key."""
        return Sampler(stream_seed(self.seed, _FOLD, index), self.device)

    def generator(self, purpose: int, iteration: int) -> torch.Generator:
        g = torch.Generator(device=self.device)
        g.manual_seed(stream_seed(self.seed, purpose, int(iteration)))
        return g

    def _rand(self, purpose: int, iteration: int, shape) -> torch.Tensor:
        return torch.rand(tuple(shape), generator=self.generator(
            purpose, iteration), dtype=torch.float32, device=self.device)

    def uniform(self, purpose: int, iteration: int, shape,
                span=None) -> torch.Tensor:
        """U[0, 1) float32 (glm::linearRand(0, 1))."""
        return _rows(self._rand(purpose, iteration, _full_shape(shape, span)),
                     shape, span)

    def randint(self, purpose: int, iteration: int, shape, high: int,
                span=None) -> torch.Tensor:
        """Integers uniform in [0, high), int64 (jax.random.randint)."""
        full = torch.randint(0, int(high), _full_shape(shape, span),
                             generator=self.generator(purpose, iteration),
                             dtype=torch.int64, device=self.device)
        return _rows(full, shape, span)

    def unit_sphere(self, purpose: int, iteration: int, shape,
                    span=None) -> torch.Tensor:
        """Uniform on the unit sphere (glm::sphericalRand(1)): shape + (3,),
        from z = 2*U1 - 1 and phi = 2*pi*U2 as in the reference. The two
        uniforms are one (2,) + shape draw, so a span slices its axis 1."""
        u = self._rand(purpose, iteration, (2,) + _full_shape(shape, span))
        return _on_sphere(*_rows(u, shape, span, axis=1))

    def in_ball(self, purpose: int, iteration: int, shape,
                span=None) -> torch.Tensor:
        """Uniform inside the unit ball (glm::ballRand(1)): shape + (3,), a
        unit-sphere direction times cbrt(U3), as in the reference (one
        (3,) + shape draw; a span slices its axis 1)."""
        u = _rows(self._rand(purpose, iteration,
                             (3,) + _full_shape(shape, span)),
                  shape, span, axis=1)
        return _on_sphere(u[0], u[1]) * torch.pow(u[2], 1.0 / 3.0)[..., None]

    def in_disk(self, purpose: int, iteration: int, shape,
                span=None) -> torch.Tensor:
        """Uniform inside the unit disk (the thin lens): shape + (2,),
        r = sqrt(U1) and phi = 2*pi*U2 as in the reference (one (2,) +
        shape draw; a span slices its axis 1)."""
        u = _rows(self._rand(purpose, iteration,
                             (2,) + _full_shape(shape, span)),
                  shape, span, axis=1)
        r = torch.sqrt(u[0])
        phi = u[1] * (2.0 * math.pi)
        return torch.stack([r * torch.cos(phi), r * torch.sin(phi)], dim=-1)


def _on_sphere(u1: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    z = u1 * 2.0 - 1.0
    phi = u2 * (2.0 * math.pi)
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)
