"""Shared integrator pieces (counterpart of
hobbyraytracer_tpu/integrator/path.py): the bounce cap and the miss
shading. The batch integrator itself is ROADMAP Queue 1 item 12."""
from __future__ import annotations

import math

import torch

from ..core import mathx
from ..ops import texture as tex_ops

MAX_DEPTH = 50  # main.cpp:32


def background_colour(scene, d: torch.Tensor) -> torch.Tensor:
    """Miss shading: equirectangular lookup of the normalized direction
    (main.cpp:46-58): u = atan2(z, x)/2pi + 0.5, v = acos(y)/pi, through
    the background texture (solid textures ignore uv)."""
    nd = mathx.normalize(d)
    phi = torch.atan2(nd[..., 2], nd[..., 0])
    theta = mathx.safe_arccos(nd[..., 1])
    u = phi / (2.0 * math.pi) + 0.5
    v = theta / math.pi
    tex_id = scene.background_tex.expand(u.shape)
    p = torch.zeros(u.shape + (3,), dtype=torch.float32, device=d.device)
    return tex_ops.colour_value(scene.textures, tex_id, u, v, p)
