"""Batched ray/primitive intersection: the parts the main path runs
(counterpart of hobbyraytracer_tpu/ops/intersect.py).

- axis-aligned rects: `rect_t` / `intersect_rects` (aarect.h:5-144);
- the coherence key `cheap_key_from_box` in its octant form;
- `intersect_mesh_clustered_fused` (the reference's
  intersect_mesh_clustered_pallas): key -> stable argsort -> gather ->
  fused traversal kernel -> undo the sort;
- the kernel branch of `intersect_triangles_bvh`.

Spheres, the dense and watertight triangle paths, the lockstep XLA
traversal and the corridor key are ROADMAP Queue 1 items 5 and 10.
"""
from __future__ import annotations

import torch

from ..core.mathx import BIG, ray_at
from ..core.types import Hits, Rays, set_face_normal
from ..kernels import mesh_traverse as kmod

# rects processed per step of the running-min scan (bounds the (R, chunk)
# intermediate, as in the reference)
DEFAULT_CHUNK = 128
# cluster count at which the reference's default key switches from the
# octant form to the corridor form (HRT_CORRIDOR_MIN_K's default)
CORRIDOR_MIN_K = 256

# rect normal axis n -> in-plane axes (a, b): yz_rect n=0 (a=y, b=z),
# xz_rect n=1 (a=x, b=z), xy_rect n=2 (a=x, b=y)
_AXIS_A = (1, 0, 0)
_AXIS_B = (2, 2, 1)


def rect_t(rays: Rays, axis, a0, a1, b0, b1, k, t_min, t_max):
    """Candidate t per (ray, rect): (R, Q), BIG where missed. axis (Q,)
    int32 normal axis; the plane solve runs for all three axes and the
    rect's own is selected, as in the reference."""
    oc = [rays.o[:, i, None] for i in range(3)]   # 3 x (R, 1)
    dc = [rays.d[:, i, None] for i in range(3)]
    kq = k[None, :]
    t = torch.zeros((rays.o.shape[0], axis.shape[0]), dtype=torch.float32,
                    device=rays.o.device)
    pa = torch.zeros_like(t)
    pb = torch.zeros_like(t)
    parallel = torch.zeros(t.shape, dtype=torch.bool, device=t.device)
    for ax in range(3):
        sel = (axis == ax)[None, :]
        d_ax = dc[ax]
        inv_ax = 1.0 / torch.where(d_ax == 0.0, 1.0, d_ax)
        t_ax = (kq - oc[ax]) * inv_ax
        t = torch.where(sel, t_ax, t)
        pa = torch.where(sel, oc[_AXIS_A[ax]] + t_ax * dc[_AXIS_A[ax]], pa)
        pb = torch.where(sel, oc[_AXIS_B[ax]] + t_ax * dc[_AXIS_B[ax]], pb)
        parallel = torch.where(sel, (d_ax == 0.0).expand_as(parallel),
                               parallel)
    ok = (~parallel & (t >= t_min) & (t <= t_max)
          & (pa >= a0[None, :]) & (pa <= a1[None, :])
          & (pb >= b0[None, :]) & (pb <= b1[None, :]))
    return torch.where(ok, t, BIG)


def intersect_rects(rays: Rays, axis, a0, a1, b0, b1, k, mat_id,
                    t_min, t_max, chunk: int = DEFAULT_CHUNK) -> Hits:
    """Closest rect per ray, then its hit record (uv across the rect,
    one-hot outward normal faced against the ray)."""
    n_rays = rays.o.shape[0]
    n = axis.shape[0]
    dev = rays.o.device
    if n == 0:
        return Hits.none(n_rays, dev)
    t_best = torch.full((n_rays,), BIG, dtype=torch.float32, device=dev)
    i_best = torch.full((n_rays,), -1, dtype=torch.int64, device=dev)
    for s in range(0, n, chunk):
        sl = slice(s, s + chunk)
        tc = rect_t(rays, axis[sl], a0[sl], a1[sl], b0[sl], b1[sl], k[sl],
                    t_min, t_max)
        t_c = tc.min(dim=1).values
        lane = torch.arange(tc.shape[1], device=dev)
        i_c = torch.where(tc == t_c[:, None], lane,
                          tc.shape[1]).min(dim=1).values + s
        take = t_c < t_best
        t_best = torch.where(take, t_c, t_best)
        i_best = torch.where(take, i_c, i_best)
    hit = t_best < BIG
    safe = torch.clamp(i_best, 0, n - 1)
    ax = axis[safe].long()
    p = ray_at(rays.o, rays.d, torch.where(hit, t_best, 1.0))
    ia = torch.tensor(_AXIS_A, device=dev)[ax]
    ib = torch.tensor(_AXIS_B, device=dev)[ax]
    pa = p.gather(1, ia[:, None])[:, 0]
    pb = p.gather(1, ib[:, None])[:, 0]
    u = (pa - a0[safe]) / (a1[safe] - a0[safe])
    v = (pb - b0[safe]) / (b1[safe] - b0[safe])
    outward = torch.nn.functional.one_hot(ax, 3).to(torch.float32)
    normal, front = set_face_normal(rays.d, outward)
    return Hits(hit=hit, t=torch.where(hit, t_best, BIG), p=p, normal=normal,
                uv=torch.stack([u, v], dim=-1), front_face=front,
                mat_id=torch.where(hit, mat_id[safe], -1).to(torch.int32))


def _spread(x: torch.Tensor) -> torch.Tensor:
    """5-bit abcde -> a00b00c00d00e (Morton interleave)."""
    x = (x | (x << 8)) & 0x100F
    x = (x | (x << 4)) & 0x10C3
    x = (x | (x << 2)) & 0x1249
    return x


def cheap_key_from_box(o, d, valid, bmin, bmax, t_max) -> torch.Tensor:
    """Coherence-sort key against a box (the reference's octant form):
    rays that cannot hit the box sort last (key 1 << 20); potential hitters
    group by (direction octant, 15-bit Morton cell of the point where the
    ray enters the box). Returns (R,) int32."""
    inv = 1.0 / torch.where(d.abs() < 1e-30, 1e-30, d)
    t0 = (bmin[None, :] - o) * inv
    t1 = (bmax[None, :] - o) * inv
    lo = torch.minimum(t0, t1).max(dim=1).values
    hi = torch.maximum(t0, t1).min(dim=1).values
    entry = torch.clamp(lo, min=0.0)
    could_hit = (hi > entry) & (entry < t_max) & valid
    pe = o + d * entry[:, None]
    q = torch.clamp((pe - bmin[None, :])
                    / torch.clamp(bmax - bmin, min=1e-30), 0.0, 1.0)
    cell = (q * 31.0).to(torch.int32)
    morton = (_spread(cell[:, 0]) | (_spread(cell[:, 1]) << 1)
              | (_spread(cell[:, 2]) << 2))
    octant = ((d[:, 0] > 0).to(torch.int32)
              | ((d[:, 1] > 0).to(torch.int32) << 1)
              | ((d[:, 2] > 0).to(torch.int32) << 2))
    key = (octant << 15) | morton
    return torch.where(could_hit, key, 1 << 20).to(torch.int32)


def intersect_mesh_clustered_fused(rays: Rays, tri_id, tri_soa, bounds8,
                                   t_max, ray_valid=None,
                                   need_uv: bool = True,
                                   plain: bool = False):
    """Nearest triangle through the fused traversal kernel
    (kernels/mesh_traverse.py). The wavefront is coherence-sorted first
    (stable argsort of `cheap_key_from_box` against the mesh's root box),
    traversed, and the sort undone. plain=True runs the kernel's plain
    PyTorch version instead (a comparison switch; the kernel's output does
    not depend on the ray order).

    tri_id (K, L) int32; tri_soa (K, 24, L); bounds8 (8, K).
    Returns (t (R,), gid (R,) int32, hit (R,), normal (R, 3), uv (R, 2))."""
    n_rays = rays.o.shape[0]
    if bounds8.shape[1] >= CORRIDOR_MIN_K:
        raise NotImplementedError(
            f"{bounds8.shape[1]} clusters: the reference keys such meshes "
            "with the corridor key, which is not ported yet (ROADMAP Queue 1 "
            "item 5)")
    if ray_valid is None:
        ray_valid = torch.ones((n_rays,), dtype=torch.bool,
                               device=rays.o.device)
    rays8 = torch.cat([rays.o, rays.d, ray_valid.to(torch.float32)[:, None],
                       torch.zeros_like(rays.o[:, :1])], dim=1)
    bmin = bounds8[:3, :].min(dim=1).values
    bmax = bounds8[3:6, :].max(dim=1).values
    key = cheap_key_from_box(rays.o, rays.d, ray_valid, bmin, bmax,
                             float(t_max))
    perm = torch.argsort(key, stable=True)
    traverse = kmod.traverse_clusters_plain if plain else kmod.traverse_clusters
    out_s, id_s = traverse(rays8[perm], bounds8, tri_soa, tri_id,
                           t_max=float(t_max), need_uv=need_uv)
    out = torch.empty_like(out_s)
    out[perm] = out_s
    gid = torch.empty_like(id_s)
    gid[perm] = id_s
    t = out[:, 0]
    return t, gid, t < BIG, out[:, 1:4], out[:, 4:6]


def intersect_triangles_bvh(rays: Rays, tri_id, tri_soa, bounds8, mat_id,
                            t_max, ray_valid=None, need_uv: bool = True,
                            plain: bool = False) -> Hits:
    """Full mesh hit through the fused kernel (the reference's
    backend="pallas" branch): normal and uv come out of the kernel; the
    normal is the raw interpolated one and front_face follows it."""
    t, _, hit, normal, uv = intersect_mesh_clustered_fused(
        rays, tri_id, tri_soa, bounds8, t_max, ray_valid, need_uv=need_uv,
        plain=plain)
    front = (rays.d * normal).sum(dim=-1) < 0.0
    return Hits(hit=hit, t=torch.where(hit, t, BIG),
                p=ray_at(rays.o, rays.d, torch.where(hit, t, 1.0)),
                normal=normal, uv=uv, front_face=front,
                mat_id=torch.where(hit, mat_id, -1).to(torch.int32))
