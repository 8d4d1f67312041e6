"""Vector math helpers on (..., 3) tensors (float32).

Counterpart of hobbyraytracer_tpu/core/mathx.py. The constants that define
what is computed are kept as they are; the reference's `take_rows` (a TPU
gather-avoidance trick) becomes plain indexing at its call sites.
"""
from __future__ import annotations

import torch

EPS_F32 = 1.1920929e-07  # FLT_EPSILON
NEAR_ZERO = 1e-8  # reference nearZero (hobbyraytracer.h:34-38)
T_MIN = 1e-3      # shadow epsilon (main.cpp:45)
BIG = 1e30        # stand-in for +INFINITY in closest-hit windows


def first_min(tc: torch.Tensor):
    """Row minimum of (R, C) and the lowest column index at it."""
    t_c = tc.min(dim=1).values
    lane = torch.arange(tc.shape[1], device=tc.device)
    i_c = torch.where(tc == t_c[:, None], lane, tc.shape[1]).min(dim=1).values
    return t_c, i_c


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dot product over the last axis."""
    return (a * b).sum(dim=-1)


def length(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((v * v).sum(dim=-1))


def normalize(v: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """glm::normalize (NaN on a zero vector when eps == 0)."""
    n2 = (v * v).sum(dim=-1)
    if eps:
        n2 = torch.clamp(n2, min=eps * eps)
    return v * torch.rsqrt(n2)[..., None]


def near_zero(v: torch.Tensor) -> torch.Tensor:
    """True where every component is below 1e-8 in magnitude."""
    return (v.abs() < NEAR_ZERO).all(dim=-1)


def reflect(i: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """glm::reflect: i - 2*dot(n, i)*n (the caller passes a unit n)."""
    return i - 2.0 * dot(n, i)[..., None] * n


def refract(i: torch.Tensor, n: torch.Tensor,
            eta: torch.Tensor) -> torch.Tensor:
    """glm::refract (material.h:225): i unit incident, n normal, eta =
    n1/n2 (...,). k = 1 - eta^2 * (1 - dot(n, i)^2); the zero vector where
    k < 0 (total internal reflection). sqrt runs on 1 where k <= 0, as in
    the reference, so a masked lane carries no inf into a gradient."""
    cos_i = dot(n, i)
    k = 1.0 - eta * eta * (1.0 - cos_i * cos_i)
    k_safe = torch.where(k > 0.0, k, 1.0)
    out = eta[..., None] * i - (eta * cos_i + torch.sqrt(k_safe))[..., None] * n
    return torch.where((k < 0.0)[..., None], torch.zeros_like(out), out)


def schlick(cosine: torch.Tensor, ref_idx: torch.Tensor) -> torch.Tensor:
    """Schlick's reflectance approximation (material.h:236-241), pow(x, 5)
    as the reference's multiply chain."""
    r0 = (1.0 - ref_idx) / (1.0 + ref_idx)
    r0 = r0 * r0
    x = 1.0 - cosine
    x2 = x * x
    return r0 + (1.0 - r0) * (x2 * x2 * x)


class _SafeArccos(torch.autograd.Function):
    """arccos with the reference's custom JVP (core/mathx.py:77-90)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.arccos(torch.clamp(x, -1.0, 1.0))

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        return grad * (-1.0 / torch.sqrt(torch.clamp(1.0 - x * x,
                                                     min=1e-12)))


def safe_arccos(x: torch.Tensor) -> torch.Tensor:
    """arccos of x clipped to [-1, 1], with a bounded derivative: -1 /
    sqrt(max(1 - x^2, 1e-12)) of the unclipped x (the true derivative is
    infinite at +-1 and would poison gradients with inf * 0 at the sphere
    poles and straight-up environment lookups; torch's clamp would give 0
    outside [-1, 1])."""
    return _SafeArccos.apply(x)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product over the last axis, written out component-wise."""
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz,
                        ax * by - ay * bx], dim=-1)


def ray_at(o: torch.Tensor, d: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """ray::at — o + t*d."""
    return o + t[..., None] * d
