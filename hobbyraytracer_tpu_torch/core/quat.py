"""Quaternions in glm's conventions ([w, x, y, z]); counterpart of
hobbyraytracer_tpu/core/quat.py."""
from __future__ import annotations

import torch

from .mathx import cross


def from_euler(euler_rad: torch.Tensor) -> torch.Tensor:
    """glm::quat(vec3 eulerAngle): component-wise half-angle products."""
    half = torch.as_tensor(euler_rad, dtype=torch.float32) * 0.5
    c = torch.cos(half)
    s = torch.sin(half)
    cx, cy, cz = c[..., 0], c[..., 1], c[..., 2]
    sx, sy, sz = s[..., 0], s[..., 1], s[..., 2]
    w = cx * cy * cz + sx * sy * sz
    x = sx * cy * cz - cx * sy * sz
    y = cx * sy * cz + sx * cy * sz
    z = cx * cy * sz - sx * sy * cz
    return torch.stack([w, x, y, z], dim=-1)


def conjugate(q: torch.Tensor) -> torch.Tensor:
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype,
                            device=q.device)


def rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """v' = v + w*t + cross(q.xyz, t) with t = 2*cross(q.xyz, v)."""
    qv = q[..., 1:4]
    w = q[..., 0:1]
    t = 2.0 * cross(qv.expand_as(v), v)
    return v + w * t + cross(qv.expand_as(v), t)


def inverse_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return rotate(conjugate(q), v)
