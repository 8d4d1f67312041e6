"""Nearest sphere of a clustered sphere pool (kernel K4): the CUDA kernel's
wrapper and its plain PyTorch version.

K4 replaces the TPU kernel hobbyraytracer_tpu/kernels/sphere_traverse.py:
_kernel (launched by intersect_spheres_pallas). The contract at the public
function is the reference's, with the ray axes flattened:

- rays8 (..., 8) float32 lanes [ox oy oz dx dy dz valid 0];
- bounds8 (8, K) float32 rows [bmin.xyz bmax.xyz 0 0];
- table (K, 8, L) float32 rows [cx cy cz r2 0 0 0 0], spheres on the last
  axis, pad spheres with r2 = -1 (scene/bvh.py:build_sphere_clusters);
- ids (K, L) int32 indices into the sphere table, -1 for padding;
- -> t (...) float32, the nearest root inside [t_min, t_max] (BIG on a
  miss or a ray with valid <= 0), and id (...) int32 (-1 likewise).

Visit rule (kernel and plain version): a ray visits its clusters in order
of (slab entry distance, cluster index) while the entry is below the ray's
own best t; a visit solves the half-b quadratic of sphere.cpp:20-49 for
the cluster's L spheres (near root if inside the window, else the far
root, a hit only where disc > 0), takes the lowest lane at the cluster's
minimum and folds it in when strictly nearer. The TPU kernel visits the
union of a ray block's needs; a ray's own set is a subset of it, so the
nearest hit is the same except on exact t-ties between clusters.

Only (t, id) come out: ops/intersect.py:intersect_spheres_clustered
recomputes the hit record from the winner, which is also the
differentiable replay.

`intersect_spheres_kernel` launches the CUDA kernel
(csrc/sphere_traverse.cu) for CUDA tensors and runs the plain version for
tensors on the CPU (kernels/build.py:runs_plain). The kernel counts its
launches on its KernelLibrary.
"""
from __future__ import annotations

import torch

from ..core.mathx import BIG
from .build import (FLOAT, INT, PTR, KernelLibrary, check, f32,
                    runs_plain)
from .mesh_traverse import flat_rays8, slab_entries

SPHERE_ROWS = 8
# rays per chunk of the plain version: bounds its (chunk, 4, L) gathered
# cluster block and (chunk, L) temporaries to tens of MB at any ray count
PLAIN_CHUNK = 16384

SPHERE_KERNEL = KernelLibrary("sphere_traverse")       # K4


def _spheres_chunk(rays, bounds8, table, ids, t_min, t_max):
    """Plain find of one chunk of rays (R, 8) -> t (R,), id (R,)."""
    dev = rays.device
    m = rays.shape[0]
    k_clusters, _, leaf = table.shape
    o, d = rays[:, 0:3], rays[:, 3:6]
    entry = slab_entries(o, d, rays[:, 6] > 0.0, bounds8, t_max)
    e_sorted, order = torch.sort(entry, dim=1, stable=True)
    best_t = torch.full((m,), BIG, dtype=torch.float32, device=dev)
    best_id = torch.full((m,), -1, dtype=torch.int32, device=dev)
    lane = torch.arange(leaf, device=dev)
    for j in range(k_clusters):
        # round j: every ray whose j-th nearest entry still beats its own
        # best t visits that cluster (entries ascend, best t only falls)
        idx = (e_sorted[:, j] < best_t).nonzero().squeeze(1)
        if idx.numel() == 0:
            break
        kk = order[idx, j]
        blk = table[kk, 0:4]                              # (A, 4, L)
        ox, oy, oz = (o[idx, c:c + 1] for c in range(3))  # (A, 1)
        dx, dy, dz = (d[idx, c:c + 1] for c in range(3))
        a = dx * dx + dy * dy + dz * dz
        inv_a = 1.0 / a
        ocx = ox - blk[:, 0]
        ocy = oy - blk[:, 1]
        ocz = oz - blk[:, 2]
        half_b = ocx * dx + ocy * dy + ocz * dz
        c = ocx * ocx + ocy * ocy + ocz * ocz - blk[:, 3]
        disc = half_b * half_b - a * c
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        r1 = (-half_b - sq) * inv_a
        r2 = (-half_b + sq) * inv_a
        in1 = (r1 >= t_min) & (r1 <= t_max)
        in2 = (r2 >= t_min) & (r2 <= t_max)
        root = torch.where(in1, r1, torch.where(in2, r2, BIG))
        t = torch.where(disc > 0.0, root, BIG)            # (A, L)
        t_c = t.min(dim=1).values
        win = torch.where(t == t_c[:, None], lane, leaf).min(dim=1).values
        take = t_c < best_t[idx]
        idx, kk, win = idx[take], kk[take], win[take]
        best_t[idx] = t_c[take]
        best_id[idx] = ids[kk, win]
    return best_t, best_id


def intersect_spheres_plain(rays8: torch.Tensor, bounds8: torch.Tensor,
                            table: torch.Tensor, ids: torch.Tensor,
                            t_min: float, t_max: float = BIG,
                            chunk: int = PLAIN_CHUNK):
    """The plain PyTorch version of kernel K4 (same contract, per-ray visit
    order and rounding), lockstep over visit rounds in chunks of `chunk`
    rays."""
    lead = rays8.shape[:-1]
    rays = rays8.reshape(-1, 8)
    t_min, t_max = f32(t_min), f32(t_max)
    ts, out_ids = [], []
    for s in range(0, rays.shape[0], chunk):
        t, i = _spheres_chunk(rays[s:s + chunk], bounds8, table, ids, t_min,
                              t_max)
        ts.append(t)
        out_ids.append(i)
    if not ts:
        return (torch.zeros(lead, dtype=torch.float32, device=rays8.device),
                torch.zeros(lead, dtype=torch.int32, device=rays8.device))
    return torch.cat(ts).reshape(lead), torch.cat(out_ids).reshape(lead)


def _spheres_cuda(rays8, bounds8, table, ids, t_min, t_max):
    rays = flat_rays8(rays8, SPHERE_KERNEL)
    dev = rays.device
    if table.dim() != 3 or table.shape[1] != SPHERE_ROWS:
        raise ValueError(f"the sphere table must be (K, {SPHERE_ROWS}, L), "
                         f"got {tuple(table.shape)}")
    k_clusters, rows, leaf = table.shape
    if k_clusters == 0 or leaf == 0:
        raise ValueError(f"empty sphere table {tuple(table.shape)}")
    check("bounds8", bounds8, torch.float32, (8, k_clusters), dev)
    check("table", table, torch.float32, (k_clusters, rows, leaf), dev)
    check("ids", ids, torch.int32, (k_clusters, leaf), dev)
    n = rays.shape[0]
    out_t = torch.empty((n,), dtype=torch.float32, device=dev)
    out_id = torch.empty((n,), dtype=torch.int32, device=dev)
    if n:
        SPHERE_KERNEL.launch(
            [PTR, INT, PTR, INT, PTR, PTR, INT, FLOAT, FLOAT, PTR, PTR], dev,
            rays.data_ptr(), n, bounds8.data_ptr(), k_clusters,
            table.data_ptr(), ids.data_ptr(), leaf, float(t_min),
            float(t_max), out_t.data_ptr(), out_id.data_ptr())
    lead = rays8.shape[:-1]
    return out_t.reshape(lead), out_id.reshape(lead)


def intersect_spheres_kernel(rays8: torch.Tensor, bounds8: torch.Tensor,
                             table: torch.Tensor, ids: torch.Tensor,
                             t_min: float, t_max: float = BIG):
    """Nearest sphere per ray through the sphere clusters (contract in the
    module docstring). CUDA tensors launch K4, built at first use; the
    wrapper raises if the kernel cannot be built or launched. CPU tensors
    run the plain version."""
    if runs_plain(rays8.device):
        return intersect_spheres_plain(rays8, bounds8, table, ids, t_min,
                                       t_max)
    return _spheres_cuda(rays8, bounds8, table, ids, t_min, t_max)

