"""Batched ray/primitive intersection: the parts the ported paths run
(counterpart of hobbyraytracer_tpu/ops/intersect.py).

- spheres: `sphere_t` / `intersect_spheres` (the dense scan, the default
  route: one launch of the sphere_scan kernel on the card, chunks of the
  pool on the CPU; kernels/sphere_scan.py) and
  `intersect_spheres_clustered` (the clustered find of kernel K4, then a
  differentiable replay of the winner's quadratic), chosen by
  HRT_SPHERE_KERNEL in scene/ir.py;
- axis-aligned rects: `rect_t` / `intersect_rects` (aarect.h:5-144);
- the coherence keys: `cheap_key_from_box` (octant and corridor forms),
  `cheap_coherence_key`, `cluster_entries`, `pack_coherence_key` and
  `coherence_key`, which dispatches on HRT_KEY_MODE;
- triangles outside any kernel: the watertight `triangle_t` and
  `triangle_attribs`, the dense scan `intersect_triangles`, the exact
  lockstep find over live vertices `intersect_mesh_clustered` (the plain
  PyTorch path by design, as in the reference, where it serves the
  differentiable paths and the mesh-boundary media) and `aabb_hit`;
- `intersect_mesh_clustered_fused` (the reference's
  intersect_mesh_clustered_pallas): key -> stable argsort -> gather ->
  fused traversal kernel (K1 or K2 by the table's layout) -> undo the sort,
  or none of the four with cohsort=False (HRT_NO_COHSORT, or a caller that
  sorted the whole pool already);
- `intersect_triangles_bvh`: the kernel branch, and the two branches
  that find the winning triangle without gradients (through the kernel,
  or by the lockstep find) and replay its t and attributes from the live
  vertices, so the result carries gradients to them.

The reference's MXU sphere scan (HRT_SPHERE_MXU), its sphere block size
(HRT_SPHERE_BLOCK) and the packed row gathers of its sphere attributes are
TPU cost choices and have no counterpart here: plain indexing gives the
same values.
"""
from __future__ import annotations

import math
import os

import torch

from ..core.mathx import BIG, first_min, ray_at, safe_arccos
from ..core.types import Hits, Rays, set_face_normal
from ..kernels import mesh_traverse as kmod
from ..kernels import sphere_scan as scmod
from ..kernels import sphere_traverse as skmod
from ..kernels.sphere_scan import sphere_t  # noqa: F401 (the reference's)

# primitives (spheres, rects) processed per step of the running-min scan
# (bounds the (R, chunk) intermediate, as in the reference)
DEFAULT_CHUNK = 128
# The reference's key knobs, read once at import with its defaults. They
# stay module attributes read at call time, so a caller may switch them
# in-process. HRT_KEY_MODE: "auto" (octant key below CORRIDOR_MIN_K
# clusters, corridor key at or above) | "cheap" | "corridor" | "pallas"
# (the per-ray keys of kernel K3, packed by pack_coherence_key).
KEY_MODES = ("auto", "cheap", "corridor", "pallas")
KEY_MODE = os.environ.get("HRT_KEY_MODE", "auto")
if KEY_MODE not in KEY_MODES:
    raise ValueError(f"HRT_KEY_MODE={KEY_MODE!r}: expected 'auto', "
                     "'cheap', 'corridor' or 'pallas'")
CORRIDOR_MIN_K = int(os.environ.get("HRT_CORRIDOR_MIN_K", "256"))
# HRT_SPHERE_KERNEL=1: pooled spheres that carry cluster tables go through
# the clustered find of kernel K4 instead of the dense scan (off by default,
# as in the reference). Read at import, switchable in-process like KEY_MODE.
SPHERE_KERNEL = os.environ.get("HRT_SPHERE_KERNEL", "0") != "0"
# HRT_NO_COHSORT=1 (any non-empty value, as in the reference): the mesh find
# skips its per-mesh coherence sort. Read at import, switchable in-process.
NO_COHSORT = bool(os.environ.get("HRT_NO_COHSORT"))


def switches() -> tuple:
    """The module-level switches above that a find reads as a CUDA graph
    records it (the kept graphs' keys: diff/fit.py, integrator/
    wavefront.py)."""
    return (KEY_MODE, CORRIDOR_MIN_K, SPHERE_KERNEL, NO_COHSORT)

# rect normal axis n -> in-plane axes (a, b): yz_rect n=0 (a=y, b=z),
# xz_rect n=1 (a=x, b=z), xy_rect n=2 (a=x, b=y)
_AXIS_A = (1, 0, 0)
_AXIS_B = (2, 2, 1)


# ---------------------------------------------------------------- spheres

def sphere_uv(outward_normal: torch.Tensor) -> torch.Tensor:
    """getSphereUV (sphere.cpp:4-18): theta = acos(-n.y), phi =
    atan2(-n.z, n.x) + pi -> (..., 2) [phi / 2pi, theta / pi]."""
    theta = safe_arccos(-outward_normal[..., 1])
    phi = torch.atan2(-outward_normal[..., 2],
                      outward_normal[..., 0]) + math.pi
    return torch.stack([phi / (2.0 * math.pi), theta / math.pi], dim=-1)


def _sphere_attribs(rays: Rays, center, radius, mat_id, t, idx) -> Hits:
    """Hit record from a sphere find's (t, winning index): the winner's
    center, radius and material, then p, normal and uv (sphere.cpp:50-57)."""
    n = center.shape[0]
    hit = (t < BIG) & (idx >= 0)
    safe = torch.clamp(idx, 0, n - 1).long()
    c = center[safe]
    r = torch.clamp(radius[safe], min=1e-20)
    p = ray_at(rays.o, rays.d, torch.where(hit, t, 1.0))
    outward = (p - c) / r[:, None]
    normal, front = set_face_normal(rays.d, outward)
    return Hits(hit=hit, t=torch.where(hit, t, BIG), p=p, normal=normal,
                uv=sphere_uv(outward), front_face=front,
                mat_id=torch.where(hit, mat_id[safe], -1).to(torch.int32))


def intersect_spheres(rays: Rays, center, radius, mat_id, t_min, t_max,
                      chunk: int = DEFAULT_CHUNK) -> Hits:
    """Closest sphere per ray by the dense scan (kernels/sphere_scan.py):
    on CUDA tensors one launch of the sphere_scan kernel, on the CPU its
    plain version, a running strict-< minimum over chunks of `chunk`
    spheres; then the winner's hit record. The two give the same (t,
    winner) bit for bit.

    The find runs without gradients. Where a gradient is wanted (grad mode
    on and the rays, center or radius requiring grad), t is replayed from
    the winner's center and radius by the scan's own operations: the same
    bits, and the scan's gradients but for exact ties between spheres."""
    n_rays = rays.o.shape[0]
    n = center.shape[0]
    dev = rays.o.device
    if n == 0:
        return Hits.none(n_rays, dev)
    with torch.no_grad():
        t, idx = scmod.scan_spheres(
            Rays(o=rays.o.contiguous(), d=rays.d.contiguous()),
            center.contiguous(), radius.contiguous(), t_min, t_max, chunk)
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in (rays.o, rays.d, center, radius)):
        t = scmod.winner_t(rays, center, radius, idx, t_min, t_max)
    return _sphere_attribs(rays, center, radius, mat_id, t, idx)


def intersect_spheres_clustered(rays: Rays, center, radius, mat_id,
                                kernel_table, kernel_bounds, kernel_ids,
                                t_min, t_max, ray_valid=None) -> Hits:
    """Closest sphere per ray through the clustered find of kernel K4
    (kernels/sphere_traverse.py).

    The find runs without gradients on detached rays and gives (t, winning
    id). The winner's quadratic is then replayed from center and radius
    with the dense scan's guards, so gradients reach center, radius and the
    rays as on the dense route. A grazing hit can miss on the replay (its
    dot products are summed in another order than the kernel's): such a
    lane keeps the kernel's t."""
    n_rays = rays.o.shape[0]
    dev = rays.o.device
    if ray_valid is None:
        ray_valid = torch.ones((n_rays,), dtype=torch.bool, device=dev)
    with torch.no_grad():
        rays8 = torch.cat([rays.o.detach(), rays.d.detach(),
                           ray_valid.to(torch.float32)[:, None],
                           torch.zeros((n_rays, 1), dtype=torch.float32,
                                       device=dev)], dim=1)
        t_nd, idx = skmod.intersect_spheres_kernel(
            rays8, kernel_bounds, kernel_table, kernel_ids, float(t_min),
            float(t_max))
    found = idx >= 0
    safe = torch.clamp(idx, 0, center.shape[0] - 1).long()
    c = center[safe]
    r = radius[safe]
    oc = rays.o - c
    a = (rays.d * rays.d).sum(dim=-1)
    half_b = (oc * rays.d).sum(dim=-1)
    cc = (oc * oc).sum(dim=-1) - r * r
    disc = half_b * half_b - a * cc
    sqrtd = torch.sqrt(torch.where(disc > 0.0, disc, 1.0))
    inv_a = 1.0 / a
    r1 = (-half_b - sqrtd) * inv_a
    r2 = (-half_b + sqrtd) * inv_a
    in1 = (r1 >= t_min) & (r1 <= t_max)
    in2 = (r2 >= t_min) & (r2 <= t_max)
    t_rep = torch.where(in1, r1, torch.where(in2, r2, BIG))
    t_rep = torch.where(disc > 0.0, t_rep, BIG)
    t = torch.where(found & (t_rep < BIG), t_rep,
                    torch.where(found, t_nd, BIG))
    return _sphere_attribs(rays, center, radius, mat_id, t, idx)


# ------------------------------------------------------------------ rects

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
        t_c, i_c = first_min(tc)
        take = t_c < t_best
        t_best = torch.where(take, t_c, t_best)
        i_best = torch.where(take, i_c + s, i_best)
    hit = t_best < BIG
    safe = torch.clamp(i_best, 0, n - 1)
    ax = axis[safe].long()
    p = ray_at(rays.o, rays.d, torch.where(hit, t_best, 1.0))
    # the in-plane axes _AXIS_A / _AXIS_B of each rect's normal axis, by
    # arithmetic on the device (a table copied from the host could not be
    # captured into a CUDA graph)
    ia = torch.where(ax == 0, 1, 0)
    ib = torch.where(ax == 2, 1, 2)
    pa = p.gather(1, ia[:, None])[:, 0]
    pb = p.gather(1, ib[:, None])[:, 0]
    u = (pa - a0[safe]) / (a1[safe] - a0[safe])
    v = (pb - b0[safe]) / (b1[safe] - b0[safe])
    outward = torch.nn.functional.one_hot(ax, 3).to(torch.float32)
    normal, front = set_face_normal(rays.d, outward)
    return Hits(hit=hit, t=torch.where(hit, t_best, BIG), p=p, normal=normal,
                uv=torch.stack([u, v], dim=-1), front_face=front,
                mat_id=torch.where(hit, mat_id[safe], -1).to(torch.int32))


# -------------------------------------------------------------- triangles

def _shear_axes(d: torch.Tensor):
    """Per ray the permutation of the watertight test: kz = the axis of
    the largest |d| (the first on ties), kx = kz + 1, ky = kx + 1 mod 3,
    each (R, 1) int64."""
    kz = d.abs().argmax(dim=-1, keepdim=True)
    kx = (kz + 1) % 3
    ky = (kx + 1) % 3
    return kx, ky, kz


def triangle_t(rays: Rays, v0, v1, v2, t_max):
    """Candidate t per (ray, triangle): the watertight test after PBRT-3
    (reference ITriangle::hit, triangle.cpp:57-109), BIG where missed.

    v0/v1/v2 are (T, 3), one table for all rays, or (R, T, 3), gathered
    per ray; the result is (R, T). The projection axis is that of the
    largest |d| and t_min is ignored (0 < t <= t_max), both as in the
    reference package."""
    d = rays.d
    kx, ky, kz = _shear_axes(d)
    dz = d.gather(1, kz)                                  # (R, 1)
    inv_dz = 1.0 / dz
    sx = -d.gather(1, kx) * inv_dz
    sy = -d.gather(1, ky) * inv_dz
    sz = inv_dz

    def permuted(v):
        rel = (v[None, :, :] if v.dim() == 2 else v) - rays.o[:, None, :]
        n_tri = rel.shape[1]
        return tuple(rel.gather(2, k[:, :, None].expand(-1, n_tri, 1))[..., 0]
                     for k in (kx, ky, kz))

    p0x, p0y, p0z = permuted(v0)
    p1x, p1y, p1z = permuted(v1)
    p2x, p2y, p2z = permuted(v2)
    p0x = p0x + sx * p0z
    p0y = p0y + sy * p0z
    p1x = p1x + sx * p1z
    p1y = p1y + sy * p1z
    p2x = p2x + sx * p2z
    p2y = p2y + sy * p2z
    e0 = p1x * p2y - p1y * p2x
    e1 = p2x * p0y - p2y * p0x
    e2 = p0x * p1y - p0y * p1x
    inside = ~(((e0 < 0) | (e1 < 0) | (e2 < 0))
               & ((e0 > 0) | (e1 > 0) | (e2 > 0)))
    det = e0 + e1 + e2
    t_scaled = (e0 * p0z + e1 * p1z + e2 * p2z) * sz
    neg_ok = (det < 0) & (t_scaled < 0) & (t_scaled >= t_max * det)
    pos_ok = (det > 0) & (t_scaled > 0) & (t_scaled <= t_max * det)
    ok = inside & (det != 0) & (neg_ok | pos_ok)
    t = t_scaled / torch.where(det == 0, 1.0, det)   # no inf in a gradient
    return torch.where(ok, t, BIG)


def triangle_attribs(rays: Rays, v0, v1, v2):
    """Barycentrics (b0, b1, b2), each (R,), of each ray's own triangle
    v0/v1/v2 (R, 3): the edge functions of triangle_t over their sum."""
    d = rays.d
    kx, ky, kz = _shear_axes(d)
    dz = d.gather(1, kz)[:, 0]
    sx = -d.gather(1, kx)[:, 0] / dz
    sy = -d.gather(1, ky)[:, 0] / dz

    def permute(v):
        rel = v - rays.o
        pz = rel.gather(1, kz)[:, 0]
        return (rel.gather(1, kx)[:, 0] + sx * pz,
                rel.gather(1, ky)[:, 0] + sy * pz)

    p0x, p0y = permute(v0)
    p1x, p1y = permute(v1)
    p2x, p2y = permute(v2)
    e0 = p1x * p2y - p1y * p2x
    e1 = p2x * p0y - p2y * p0x
    e2 = p0x * p1y - p0y * p1x
    det = e0 + e1 + e2
    inv = 1.0 / torch.where(det == 0, 1.0, det)
    return e0 * inv, e1 * inv, e2 * inv


def _triangle_hits(rays: Rays, verts, normals, uvs, indices, mat_id, t,
                   idx, hit) -> Hits:
    """Hit record of each ray's winning triangle `idx` at `t` (ITriangle::
    hit, triangle.cpp:112-128): normal and uv interpolated by the
    barycentrics, the normal neither normalized nor flipped; front_face
    from its side of the ray."""
    safe = torch.clamp(idx, 0, indices.shape[0] - 1).long()
    i0, i1, i2 = (indices[safe, c].long() for c in range(3))
    b0, b1, b2 = (b[:, None] for b in triangle_attribs(
        rays, verts[i0], verts[i1], verts[i2]))
    normal = b0 * normals[i0] + b1 * normals[i1] + b2 * normals[i2]
    uv = b0 * uvs[i0] + b1 * uvs[i1] + b2 * uvs[i2]
    front = (rays.d * normal).sum(dim=-1) < 0.0
    return Hits(hit=hit, t=torch.where(hit, t, BIG),
                p=ray_at(rays.o, rays.d, torch.where(hit, t, 1.0)),
                normal=normal, uv=uv, front_face=front,
                mat_id=torch.where(hit, mat_id, -1).to(torch.int32))


def intersect_triangles(rays: Rays, verts, normals, uvs, indices, mat_id,
                        t_max, chunk: int = DEFAULT_CHUNK) -> Hits:
    """Closest triangle per ray by the dense scan (the reference's path for
    meshes without a cluster BVH): a running strict-< minimum over chunks
    of `chunk` triangles, the last chunk padded with zero triangles under
    an explicit mask (a degenerate triangle alone is not enough: rounding
    can leave its det off zero), then the winner's hit record.

    verts/normals (V, 3), uvs (V, 2), indices (T, 3), mat_id () int32."""
    n_rays = rays.o.shape[0]
    n = indices.shape[0]
    dev = rays.o.device
    if n == 0:
        return Hits.none(n_rays, dev)
    chunk = min(chunk, n)
    pad = -n % chunk
    corners = verts[indices.long()]                       # (T, 3, 3)
    if pad:
        corners = torch.cat([corners, corners.new_zeros((pad, 3, 3))])
    tri_ok = torch.arange(n + pad, device=dev) < n
    t_best = torch.full((n_rays,), BIG, dtype=torch.float32, device=dev)
    i_best = torch.full((n_rays,), -1, dtype=torch.int64, device=dev)
    for s in range(0, n + pad, chunk):
        c = corners[s:s + chunk]
        tc = torch.where(tri_ok[None, s:s + chunk],
                         triangle_t(rays, c[:, 0], c[:, 1], c[:, 2], t_max),
                         BIG)
        t_c, i_c = first_min(tc)
        take = t_c < t_best
        t_best = torch.where(take, t_c, t_best)
        i_best = torch.where(take, i_c + s, i_best)
    return _triangle_hits(rays, verts, normals, uvs, indices, mat_id, t_best,
                          i_best, t_best < BIG)


# rays per chunk of the lockstep find: bounds its (chunk, K) entries and
# the (chunk, 9, L) gathered leaf blocks
LOCKSTEP_CHUNK = 4096


def _leaf_soa(tri_verts: torch.Tensor) -> torch.Tensor:
    """(K, L, 3, 3) leaf vertices -> (K, 9, L) rows [v0 e1 e2]."""
    v0 = tri_verts[:, :, 0, :]
    soa = torch.cat([v0, tri_verts[:, :, 1, :] - v0,
                     tri_verts[:, :, 2, :] - v0], dim=2)  # (K, L, 9)
    return soa.transpose(1, 2).contiguous()


def intersect_mesh_clustered(rays: Rays, tri_verts, tri_id, bmin, bmax,
                             t_max, ray_valid=None,
                             chunk: int = LOCKSTEP_CHUNK):
    """Closest triangle through the cluster BVH over LIVE leaf vertices:
    the exact lockstep find (the reference's intersect_mesh_clustered).

    This is the plain PyTorch path by design, on either device, as the
    reference's is plain XLA: it serves the callers whose vertices may have
    moved since the kernel tables were built (the differentiable lockstep
    branch of intersect_triangles_bvh, the mesh-boundary media). It is not
    a fallback for kernel K1, and nothing routes here because a kernel
    failed.

    Each ray visits the clusters its slab test enters, nearest entry first,
    while the entry is below its own best t; a visit is Moller-Trumbore
    over the leaf. The reference groups rays into blocks of 64 that visit
    the union of their needs; the nearest hit is the same whatever the
    grouping (ids may differ on exact t-ties), so the rays go one by one
    here, in rounds, with one host read a round (is any ray left?).

    tri_verts (K, L, 3, 3); tri_id (K, L) int32, -1 pads; bmin/bmax (K, 3).
    Returns (t (R,), global triangle id (R,) int32, hit (R,) bool)."""
    n_rays = rays.o.shape[0]
    dev = rays.o.device
    k_clusters = tri_id.shape[0]
    if ray_valid is None:
        ray_valid = torch.ones((n_rays,), dtype=torch.bool, device=dev)
    bounds8 = torch.cat([bmin.T, bmax.T])
    soa = _leaf_soa(tri_verts)
    t_best = torch.full((n_rays,), BIG, dtype=torch.float32, device=dev)
    id_best = torch.full((n_rays,), -1, dtype=torch.int32, device=dev)
    for s in range(0, n_rays, chunk):
        o, d = rays.o[s:s + chunk], rays.d[s:s + chunk]
        t_c, id_c = t_best[s:s + chunk], id_best[s:s + chunk]   # views
        entry = kmod.slab_entries(o, d, ray_valid[s:s + chunk], bounds8,
                                  t_max)
        e_sorted, order = torch.sort(entry, dim=1, stable=True)
        for j in range(k_clusters):
            idx = (e_sorted[:, j] < t_c).nonzero().squeeze(1)
            if idx.numel() == 0:
                break
            kk = order[idx, j]
            ids = tri_id[kk]
            t_min, win, _, _ = kmod.leaf_hits(o[idx], d[idx], soa[kk], ids,
                                              t_max)
            take = t_min < t_c[idx]
            t_c[idx] = torch.where(take, t_min, t_c[idx])
            id_c[idx] = torch.where(take, ids.gather(1, win[:, None])[:, 0],
                                    id_c[idx])
    return t_best, id_best, t_best < BIG


# ------------------------------------------------------- coherence keys

def _spread(x: torch.Tensor) -> torch.Tensor:
    """5-bit abcde -> a00b00c00d00e (Morton interleave)."""
    x = (x | (x << 8)) & 0x100F
    x = (x | (x << 4)) & 0x10C3
    x = (x | (x << 2)) & 0x1249
    return x


def _morton(p, bmin, bmax) -> torch.Tensor:
    """15-bit Morton cell (5 bits an axis) of points p (R, 3) in the box."""
    q = torch.clamp((p - bmin[None, :])
                    / torch.clamp(bmax - bmin, min=1e-30), 0.0, 1.0)
    cell = (q * 31.0).to(torch.int32)
    return (_spread(cell[:, 0]) | (_spread(cell[:, 1]) << 1)
            | (_spread(cell[:, 2]) << 2))


def cheap_key_from_box(o, d, valid, bmin, bmax, t_max,
                       corridor: bool = False) -> torch.Tensor:
    """Coherence-sort key against a box (R,) int32. Rays that cannot hit
    the box sort last. Octant form (1 << 20 for misses): potential hitters
    group by (direction octant, 15-bit Morton cell of the point where the
    ray enters the box). Corridor form (1 << 30 for misses): the octant
    gives way to the Morton cell of the exit point, so two rays share a
    prefix when they enter and leave the box in nearby cells."""
    inv = 1.0 / torch.where(d.abs() < 1e-30, 1e-30, d)
    t0 = (bmin[None, :] - o) * inv
    t1 = (bmax[None, :] - o) * inv
    lo = torch.minimum(t0, t1).max(dim=1).values
    hi = torch.maximum(t0, t1).min(dim=1).values
    entry = torch.clamp(lo, min=0.0)
    could_hit = (hi > entry) & (entry < t_max) & valid
    morton = _morton(o + d * entry[:, None], bmin, bmax)
    if corridor:
        m_exit = _morton(o + d * torch.maximum(hi, entry)[:, None], bmin,
                         bmax)
        key = (morton << 15) | m_exit                     # 30 bits
        return torch.where(could_hit, key, 1 << 30).to(torch.int32)
    octant = ((d[:, 0] > 0).to(torch.int32)
              | ((d[:, 1] > 0).to(torch.int32) << 1)
              | ((d[:, 2] > 0).to(torch.int32) << 2))
    key = (octant << 15) | morton
    return torch.where(could_hit, key, 1 << 20).to(torch.int32)


def cheap_coherence_key(o, d, valid, bounds8, t_max) -> torch.Tensor:
    """The key against the mesh's root box (the union of its cluster
    boxes): the corridor form under KEY_MODE "corridor", or under "auto"
    from CORRIDOR_MIN_K clusters up; the octant form otherwise."""
    bmin = bounds8[:3, :].min(dim=1).values
    bmax = bounds8[3:6, :].max(dim=1).values
    corridor = (KEY_MODE == "corridor"
                or (KEY_MODE == "auto"
                    and bounds8.shape[1] >= CORRIDOR_MIN_K))
    return cheap_key_from_box(o, d, valid, bmin, bmax, t_max,
                              corridor=corridor)


def cluster_entries(rays: Rays, bmin, bmax, t_max) -> torch.Tensor:
    """Slab-test all K cluster boxes per ray: bmin/bmax (K, 3) -> (R, K)
    entry distance (>= 0), +inf where missed."""
    valid = torch.ones(rays.o.shape[:1], dtype=torch.bool,
                       device=rays.o.device)
    return kmod.slab_entries(rays.o, rays.d, valid,
                             torch.cat([bmin.T, bmax.T]), t_max)


def pack_coherence_key(e_min, first, k_clusters: int) -> torch.Tensor:
    """Int-packed (cluster id, quantized entry) key (R,) int32: the first
    cluster in the high bits, the entry quantized into the low bits against
    the wavefront's own largest finite entry. Rays that miss every cluster
    sort last."""
    e_bits = max(1, min(20, 31 - max(1, (k_clusters + 1)).bit_length()))
    e_lvls = (1 << e_bits) - 1
    if e_min.numel() == 0:
        return torch.zeros(e_min.shape, dtype=torch.int32,
                           device=e_min.device)
    finite = torch.isfinite(e_min)
    e_max = torch.where(finite, e_min, 0.0).max()
    e_q = torch.clamp(e_min / torch.clamp(e_max, min=1e-30) * e_lvls,
                      0, e_lvls).to(torch.int32)
    key = torch.where(finite, first.to(torch.int32) * (e_lvls + 1) + e_q,
                      k_clusters * (e_lvls + 1))
    return key.to(torch.int32)


def coherence_key(o, d, valid, bounds8, t_max) -> torch.Tensor:
    """The coherence-sort key for a wavefront, resolved by KEY_MODE at call
    time: "auto", "cheap" and "corridor" key against the root box
    (cheap_coherence_key); "pallas" packs the per-ray (nearest entry, first
    cluster) of kernel K3 (kernels/mesh_traverse.py:coherence_keys)."""
    if KEY_MODE in ("auto", "cheap", "corridor"):
        return cheap_coherence_key(o, d, valid, bounds8, t_max)
    if KEY_MODE != "pallas":
        raise ValueError(f"KEY_MODE={KEY_MODE!r}: expected one of "
                         f"{KEY_MODES}")
    rays8 = torch.cat([o, d, valid.to(torch.float32)[:, None],
                       torch.zeros_like(o[:, :1])], dim=1)
    e_min, first = kmod.coherence_keys(rays8, bounds8, t_max=float(t_max))
    return pack_coherence_key(e_min, first, bounds8.shape[1])


def intersect_mesh_clustered_fused(rays: Rays, tri_id, tri_soa, bounds8,
                                   t_max, ray_valid=None,
                                   need_uv: bool = True, cohsort=None):
    """Nearest triangle through the fused traversal kernel
    (kernels/mesh_traverse.py: K1 for a 24-row table, K2 for the 32-row
    streaming table). The wavefront is coherence-sorted first (stable
    argsort of `coherence_key`), traversed, and the sort undone (the
    traversal's output does not depend on the ray order).

    cohsort: None reads NO_COHSORT (HRT_NO_COHSORT); False skips the key,
    the argsort, the gather and the undo, for a caller whose rays are
    sorted already (the pool sort of integrator/wavefront.py).

    tri_id (K, L) int32; tri_soa (K, 24, L) or (K, 32, L); bounds8 (8, K).
    Returns (t (R,), gid (R,) int32, hit (R,), normal (R, 3), uv (R, 2))."""
    n_rays = rays.o.shape[0]
    if ray_valid is None:
        ray_valid = torch.ones((n_rays,), dtype=torch.bool,
                               device=rays.o.device)
    rays8 = torch.cat([rays.o, rays.d, ray_valid.to(torch.float32)[:, None],
                       torch.zeros_like(rays.o[:, :1])], dim=1)
    if cohsort is None:
        cohsort = not NO_COHSORT
    if cohsort:
        key = coherence_key(rays.o, rays.d, ray_valid, bounds8, float(t_max))
        perm = torch.argsort(key, stable=True)
        out_s, id_s = kmod.traverse_clusters(
            rays8[perm], bounds8, tri_soa, tri_id, t_max=float(t_max),
            need_uv=need_uv)
        out = torch.empty_like(out_s)
        out[perm] = out_s
        gid = torch.empty_like(id_s)
        gid[perm] = id_s
    else:
        out, gid = kmod.traverse_clusters(rays8, bounds8, tri_soa, tri_id,
                                          t_max=float(t_max), need_uv=need_uv)
    t = out[:, 0]
    return t, gid, t < BIG, out[:, 1:4], out[:, 4:6]


def intersect_triangles_bvh(rays: Rays, tri_id, tri_soa, bounds8, mat_id,
                            t_max, ray_valid=None, need_uv: bool = True,
                            cohsort=None, backend: str = "kernel", *,
                            verts=None, normals=None, uvs=None,
                            indices=None, tri_verts=None, bmin=None,
                            bmax=None) -> Hits:
    """Full mesh hit through the cluster BVH, by one of three backends.

    "kernel" (the reference's backend="pallas"): the fused kernel over the
    tables tri_soa / bounds8; normal and uv come out of the kernel, the
    normal is the raw interpolated one and front_face follows it.

    The two differentiable backends find the winning triangle under
    no_grad, on detached rays, and then replay t from its id through
    triangle_t and the attributes through triangle_attribs over
    verts/normals/uvs/indices, so that the result carries gradients to
    verts (and to the rays). A grazing hit can miss on the replay: such a
    lane keeps the find's t. They differ in the find:

    - "kernel_replay" (the reference's backend="pallas_replay"): the fused
      kernel over tri_soa / bounds8 with need_uv off, K1 or K2 on a CUDA
      tensor (or raise), the plain version on a CPU one. The tables must
      hold the live vertices: the build's, or those of
      scene/ir.py:refresh_kernel_tables;
    - "lockstep" (the reference's backend="xla"): intersect_mesh_clustered
      over the live leaf vertices tri_verts (K, L, 3, 3) and bounds
      bmin/bmax (K, 3); tri_soa and bounds8 are not read."""
    if backend == "kernel":
        t, _, hit, normal, uv = intersect_mesh_clustered_fused(
            rays, tri_id, tri_soa, bounds8, t_max, ray_valid,
            need_uv=need_uv, cohsort=cohsort)
        front = (rays.d * normal).sum(dim=-1) < 0.0
        return Hits(hit=hit, t=torch.where(hit, t, BIG),
                    p=ray_at(rays.o, rays.d, torch.where(hit, t, 1.0)),
                    normal=normal, uv=uv, front_face=front,
                    mat_id=torch.where(hit, mat_id, -1).to(torch.int32))
    if backend not in ("kernel_replay", "lockstep"):
        raise ValueError(f"backend {backend!r}: expected 'kernel', "
                         "'kernel_replay' or 'lockstep'")
    found = Rays(o=rays.o.detach(), d=rays.d.detach())
    with torch.no_grad():
        if backend == "kernel_replay":
            t_nd, gid, hit, _, _ = intersect_mesh_clustered_fused(
                found, tri_id, tri_soa, bounds8, t_max, ray_valid,
                need_uv=False, cohsort=cohsort)
        else:
            t_nd, gid, hit = intersect_mesh_clustered(
                found, tri_verts.detach(), tri_id, bmin.detach(),
                bmax.detach(), t_max, ray_valid)
    safe = torch.clamp(gid, min=0).long()
    corner = verts[indices[safe].long()]                  # (R, 3, 3)
    t_replay = triangle_t(rays, corner[:, None, 0], corner[:, None, 1],
                          corner[:, None, 2], t_max)[:, 0]
    t = torch.where(t_replay < BIG, t_replay, t_nd)
    return _triangle_hits(rays, verts, normals, uvs, indices, mat_id, t, gid,
                          hit)


# ------------------------------------------------------------------- slab

def aabb_hit(o, inv_d, bmin, bmax, t_min, t_max):
    """Branchless slab test (reference AABB::hit, aabb.h:26-39), rejecting
    an empty interval (t_max <= t_min). o/inv_d (..., 3); bmin/bmax
    broadcastable to them."""
    t0 = (bmin - o) * inv_d
    t1 = (bmax - o) * inv_d
    lo = torch.minimum(t0, t1).max(dim=-1).values
    hi = torch.maximum(t0, t1).min(dim=-1).values
    return torch.clamp(hi, max=t_max) > torch.clamp(lo, min=t_min)
