"""Vector math helpers on (..., 3) tensors (float32).

Counterpart of hobbyraytracer_tpu/core/mathx.py. The constants that define
what is computed are kept as they are; the reference's `take_rows` (a TPU
gather-avoidance trick) becomes plain indexing at its call sites.
"""
from __future__ import annotations

import torch

NEAR_ZERO = 1e-8  # reference nearZero (hobbyraytracer.h:34-38)
T_MIN = 1e-3      # shadow epsilon (main.cpp:45)
BIG = 1e30        # stand-in for +INFINITY in closest-hit windows


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


def safe_arccos(x: torch.Tensor) -> torch.Tensor:
    """arccos of x clipped to [-1, 1]. Forward only: the reference's clamped
    derivative (a custom JVP) arrives with the differentiable fit."""
    return torch.arccos(torch.clamp(x, -1.0, 1.0))


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product over the last axis, written out component-wise."""
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz,
                        ax * by - ay * bx], dim=-1)


def ray_at(o: torch.Tensor, d: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """ray::at — o + t*d."""
    return o + t[..., None] * d
