"""Nearest pooled sphere of each ray by the dense scan (kernel sphere_scan):
the CUDA kernel's wrapper and its plain PyTorch version.

The dense scan is the default route for pooled spheres, as in the
reference (hobbyraytracer_tpu/ops/intersect.py:intersect_spheres, which
XLA fuses: there is no Pallas kernel to replace). `sphere_t` is its
arithmetic: the half-b quadratic with the two-root window test of
sphere.cpp:20-49. The plain version runs it over chunks of `CHUNK`
spheres with a running strict-< minimum; the kernel
(csrc/sphere_scan.cu) runs it sphere by sphere in index order with a
strict <, which picks the same winner, and rounds op for op as the plain
version does, so the two agree bit for bit.

Contract: rays (o, d: (N, 3) float32), center (S, 3), radius (S,) float32,
S >= 1 -> t (N,) float32, the nearest root inside [t_min, t_max] (the
window rounded to float32, as PyTorch compares a float32 tensor with a
Python float), BIG on a miss, and idx (N,) int64, the nearest sphere's
index (the lowest at the smallest t), -1 on a miss.

`scan_spheres` launches the kernel for CUDA tensors (built at first use;
it raises if the kernel cannot be built or launched) and runs the plain
version for tensors on the CPU (kernels/build.py:runs_plain). The kernel
counts its launches on its KernelLibrary. `winner_t` replays the winner's
quadratic with sphere_t's operations, so the t it gives equals the scan's
bit for bit and carries the scan's gradients.
"""
from __future__ import annotations

import torch

from ..core.mathx import BIG, first_min
from ..core.types import Rays
from .build import FLOAT, INT, PTR, KernelLibrary, check, f32, runs_plain

# spheres a step of the plain version (bounds its (N, CHUNK) intermediates)
CHUNK = 128

SCAN_KERNEL = KernelLibrary("sphere_scan")


def _quadratic_t(o, d, c, r, t_min, t_max):
    """The scan's t for rays o, d (three components each) against spheres
    c (three components), r, all broadcast together; BIG where missed."""
    ox, oy, oz = o
    dx, dy, dz = d
    ocx = ox - c[0]
    ocy = oy - c[1]
    ocz = oz - c[2]
    a = dx * dx + dy * dy + dz * dz
    half_b = ocx * dx + ocy * dy + ocz * dz
    cc = ocx * ocx + ocy * ocy + ocz * ocz - r * r
    disc = half_b * half_b - a * cc
    sqrtd = torch.sqrt(torch.where(disc > 0.0, disc, 1.0))
    inv_a = 1.0 / a
    r1 = (-half_b - sqrtd) * inv_a
    r2 = (-half_b + sqrtd) * inv_a
    in1 = (r1 >= t_min) & (r1 <= t_max)
    in2 = (r2 >= t_min) & (r2 <= t_max)
    root = torch.where(in1, r1, torch.where(in2, r2, BIG))
    return torch.where(disc >= 0.0, root, BIG)


def sphere_t(rays: Rays, center, radius, t_min, t_max):
    """Candidate t per (ray, sphere): center (S, 3), radius (S,) -> (R, S),
    BIG where missed. The square root runs on 1 where disc <= 0 (no inf in
    a masked lane's gradient), and a ray counts as hitting from disc >= 0,
    both as in the reference's dense scan."""
    return _quadratic_t([rays.o[:, i, None] for i in range(3)],
                        [rays.d[:, i, None] for i in range(3)],
                        [center[None, :, i] for i in range(3)],
                        radius[None, :], t_min, t_max)


def winner_t(rays: Rays, center, radius, idx, t_min, t_max):
    """t of each ray against its own sphere idx (R,) (-1: none, BIG), by
    sphere_t's operations on the gathered center and radius."""
    safe = torch.clamp(idx, 0, center.shape[0] - 1)
    c = center[safe]
    t = _quadratic_t([rays.o[:, i] for i in range(3)],
                     [rays.d[:, i] for i in range(3)],
                     [c[:, i] for i in range(3)], radius[safe], t_min, t_max)
    return torch.where(idx >= 0, t, BIG)


def scan_spheres_plain(rays: Rays, center, radius, t_min, t_max,
                       chunk: int = CHUNK):
    """The plain PyTorch version: a running strict-< minimum over chunks of
    `chunk` spheres (the last chunk padded with spheres at 1e30 of radius
    0, which never hit) -> (t, idx)."""
    n_rays = rays.o.shape[0]
    n = center.shape[0]
    dev = rays.o.device
    chunk = min(chunk, n)
    pad = -n % chunk
    if pad:
        center = torch.cat([center, center.new_full((pad, 3), 1e30)])
        radius = torch.cat([radius, radius.new_zeros((pad,))])
    t_best = torch.full((n_rays,), BIG, dtype=torch.float32, device=dev)
    i_best = torch.full((n_rays,), -1, dtype=torch.int64, device=dev)
    for s in range(0, n + pad, chunk):
        t_c, i_c = first_min(sphere_t(rays, center[s:s + chunk],
                                      radius[s:s + chunk], t_min, t_max))
        take = t_c < t_best
        t_best = torch.where(take, t_c, t_best)
        i_best = torch.where(take, i_c + s, i_best)
    return t_best, i_best


def _scan_cuda(rays: Rays, center, radius, t_min, t_max):
    dev = SCAN_KERNEL.device_for(rays.o.device)
    n = rays.o.shape[0]
    if n >= 2 ** 31:
        raise ValueError(f"{n} rays exceed the kernel's int32 indexing")
    check("rays.o", rays.o, torch.float32, (n, 3), dev)
    check("rays.d", rays.d, torch.float32, (n, 3), dev)
    s = center.shape[0]
    check("center", center, torch.float32, (s, 3), dev)
    check("radius", radius, torch.float32, (s,), dev)
    out_t = torch.empty((n,), dtype=torch.float32, device=dev)
    out_id = torch.empty((n,), dtype=torch.int64, device=dev)
    if n:
        SCAN_KERNEL.launch(
            [PTR, PTR, INT, PTR, PTR, INT, FLOAT, FLOAT, PTR, PTR], dev,
            rays.o.data_ptr(), rays.d.data_ptr(), n, center.data_ptr(),
            radius.data_ptr(), s, f32(t_min), f32(t_max), out_t.data_ptr(),
            out_id.data_ptr())
    return out_t, out_id


def scan_spheres(rays: Rays, center, radius, t_min, t_max,
                 chunk: int = CHUNK):
    """Nearest sphere per ray by the dense scan (contract in the module
    docstring). CUDA tensors launch the kernel, built at first use; the
    wrapper raises if the kernel cannot be built or launched. CPU tensors
    run the plain version over chunks of `chunk` spheres (the winner does
    not depend on it)."""
    if center.dim() != 2 or center.shape[0] == 0:
        raise ValueError(f"the sphere pool must be (S, 3) with S >= 1, got "
                         f"{tuple(center.shape)}")
    if runs_plain(rays.o.device):
        return scan_spheres_plain(rays, center, radius, t_min, t_max, chunk)
    return _scan_cuda(rays, center, radius, t_min, t_max)
