"""Rays and hit records as dataclasses of tensors.

Counterpart of hobbyraytracer_tpu/core/types.py: every field is batched over
N rays (struct of arrays), so a whole wavefront is a handful of tensors.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .mathx import BIG


def as_buffer(val, dtype: torch.dtype) -> torch.Tensor:
    """A host array (numpy, list or CPU tensor) copied into a new tensor of
    `dtype`, for an nn.Module buffer."""
    return torch.as_tensor(np.array(val), dtype=dtype)


@dataclass
class Rays:
    """A wavefront of rays. o/d: (N, 3) float32."""
    o: torch.Tensor
    d: torch.Tensor


@dataclass
class Hits:
    """Hit records (reference hitRecord, hittable.h:8-25).

    hit (N,) bool; t (N,) f32, BIG on a miss; p/normal (N, 3); uv (N, 2);
    front_face (N,) bool; mat_id (N,) int32, -1 on a miss. Triangle hits
    keep the raw interpolated normal (unnormalized) like ITriangle::hit.
    """
    hit: torch.Tensor
    t: torch.Tensor
    p: torch.Tensor
    normal: torch.Tensor
    uv: torch.Tensor
    front_face: torch.Tensor
    mat_id: torch.Tensor

    @staticmethod
    def none(n: int, device) -> "Hits":
        """No hit anywhere: t = BIG, mat_id = -1, everything else zero."""
        f32 = dict(dtype=torch.float32, device=device)
        return Hits(
            hit=torch.zeros((n,), dtype=torch.bool, device=device),
            t=torch.full((n,), BIG, **f32),
            p=torch.zeros((n, 3), **f32),
            normal=torch.zeros((n, 3), **f32),
            uv=torch.zeros((n, 2), **f32),
            front_face=torch.zeros((n,), dtype=torch.bool, device=device),
            mat_id=torch.full((n,), -1, dtype=torch.int32, device=device),
        )


def closer(a: Hits, b: Hits) -> Hits:
    """Closest-hit merge of two hit sets for the same rays
    (HittableList::hit's shrinking scan, hittableList.cpp:4-21)."""
    take_b = b.hit & (~a.hit | (b.t < a.t))
    tb3 = take_b[..., None]
    return Hits(
        hit=a.hit | b.hit,
        t=torch.where(take_b, b.t, a.t),
        p=torch.where(tb3, b.p, a.p),
        normal=torch.where(tb3, b.normal, a.normal),
        uv=torch.where(tb3, b.uv, a.uv),
        front_face=torch.where(take_b, b.front_face, a.front_face),
        mat_id=torch.where(take_b, b.mat_id, a.mat_id),
    )


def set_face_normal(d: torch.Tensor, outward_normal: torch.Tensor):
    """hitRecord::setFaceNormal: (normal flipped against d, front_face)."""
    front = (d * outward_normal).sum(dim=-1) < 0.0
    n = torch.where(front[..., None], outward_normal, -outward_normal)
    return n, front
