"""Camera ray generation (reference camera.h; counterpart of
hobbyraytracer_tpu/ops/camera.py).

The reference hardcodes defocus off (camera.h:34-35); the JAX package
keeps the thin lens as an opt-in (`use_lens`, off by default) that no YAML
field reaches, and so does the port: with it on and a sampler given,
get_rays offsets each ray by a point of the lens disk.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..core import rng as rng_mod
from ..core.types import Rays, as_buffer


class Camera(nn.Module):
    """Camera basis and viewport vectors as (3,) buffers, the lens radius
    (aperture / 2) as a () buffer, and use_lens, a Python bool (static, as
    in the JAX package's pytree)."""

    def __init__(self, origin, lower_left_corner, horizontal, vertical, u,
                 v, w, lens_radius, use_lens: bool = False):
        super().__init__()
        self.use_lens = bool(use_lens)
        for name, val in (("origin", origin),
                          ("lower_left_corner", lower_left_corner),
                          ("horizontal", horizontal), ("vertical", vertical),
                          ("u", u), ("v", v), ("w", w),
                          ("lens_radius", lens_radius)):
            self.register_buffer(name, as_buffer(val, torch.float32))


def make_camera(look_from, look_at, up, vfov_deg, aspect_ratio,
                aperture=0.0, focus_distance=1.0, use_lens=False) -> Camera:
    """The camera basis exactly as camera.h:14-30 (in float32 numpy)."""
    look_from = np.asarray(look_from, np.float32)
    look_at = np.asarray(look_at, np.float32)
    up = np.asarray(up, np.float32)

    theta = np.radians(np.float32(vfov_deg))
    h = np.tan(theta / 2.0)
    viewport_height = 2.0 * h
    viewport_width = aspect_ratio * viewport_height

    w = look_from - look_at
    w = w / np.linalg.norm(w)
    u = np.cross(up, w)
    u = u / np.linalg.norm(u)
    v = np.cross(w, u)

    horizontal = focus_distance * viewport_width * u
    vertical = focus_distance * viewport_height * v
    llc = look_from - horizontal / 2.0 - vertical / 2.0 - focus_distance * w
    return Camera(look_from, llc.astype(np.float32),
                  horizontal.astype(np.float32), vertical.astype(np.float32),
                  u.astype(np.float32), v.astype(np.float32),
                  w.astype(np.float32), np.float32(aperture / 2.0), use_lens)


def get_rays(cam: Camera, s: torch.Tensor, t: torch.Tensor, sampler=None,
             iteration: int = 0, span=None) -> Rays:
    """Batched Camera::getRay (camera.h:32-39). s, t: (N,) in [0, 1].
    Directions are not normalized, as in the reference. With cam.use_lens
    and a sampler, origin and direction move by in_disk * lens_radius
    along u and v, drawn from the (LENS, iteration) stream (span as in
    core/rng.py); otherwise every ray starts at the camera origin."""
    if cam.use_lens and sampler is not None:
        rd = sampler.in_disk(rng_mod.LENS, iteration, s.shape,
                             span) * cam.lens_radius
        offset = rd[..., 0:1] * cam.u + rd[..., 1:2] * cam.v
        o = cam.origin + offset
        d = (cam.lower_left_corner + s[..., None] * cam.horizontal
             + t[..., None] * cam.vertical - cam.origin - offset)
        return Rays(o=o, d=d)
    o = cam.origin.expand(s.shape + (3,))
    d = (cam.lower_left_corner + s[..., None] * cam.horizontal
         + t[..., None] * cam.vertical - cam.origin)
    return Rays(o=o.contiguous(), d=d)
