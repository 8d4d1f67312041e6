"""Camera ray generation (reference camera.h; counterpart of
hobbyraytracer_tpu/ops/camera.py).

The reference hardcodes defocus off (camera.h:34-35); the JAX package
keeps it as an opt-in that no YAML field reaches, and this slice leaves it
out: rays start at the camera origin.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..core.types import Rays, as_buffer


class Camera(nn.Module):
    """Camera basis and viewport vectors as (3,) buffers, plus the
    (unused) lens radius as a () buffer."""

    def __init__(self, origin, lower_left_corner, horizontal, vertical, u,
                 v, w, lens_radius):
        super().__init__()
        for name, val in (("origin", origin),
                          ("lower_left_corner", lower_left_corner),
                          ("horizontal", horizontal), ("vertical", vertical),
                          ("u", u), ("v", v), ("w", w),
                          ("lens_radius", lens_radius)):
            self.register_buffer(name, as_buffer(val, torch.float32))


def make_camera(look_from, look_at, up, vfov_deg, aspect_ratio,
                aperture=0.0, focus_distance=1.0) -> Camera:
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
                  w.astype(np.float32), np.float32(aperture / 2.0))


def get_rays(cam: Camera, s: torch.Tensor, t: torch.Tensor) -> Rays:
    """Batched Camera::getRay (camera.h:32-39). s, t: (N,) in [0, 1].
    Directions are not normalized, as in the reference."""
    o = cam.origin.expand(s.shape + (3,))
    d = (cam.lower_left_corner + s[..., None] * cam.horizontal
         + t[..., None] * cam.vertical - cam.origin)
    return Rays(o=o.contiguous(), d=d)
