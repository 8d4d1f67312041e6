"""Fused cluster-BVH traversal + triangle intersection + attribute
interpolation (kernels K1 and K2), and the per-ray coherence keys (kernel
K3): the CUDA kernels' wrappers and their plain PyTorch versions.

K1 and K2 replace the TPU kernels hobbyraytracer_tpu/kernels/
mesh_traverse.py:_kernel (resident table) and :_kernel_stream (streaming
table), both launched by traverse_clusters_pallas, which routes on the
table's row count. The contract at the public function is the reference's:

- rays8 (..., 8) float32 lanes [ox oy oz dx dy dz valid 0];
- bounds8 (8, K) float32 rows [bmin.xyz bmax.xyz 0 0] (pack_bounds);
- tri_soa (K, 24, L) float32 rows [v0 e1 e2 n0 n1 n2 uv0 uv1 uv2]
  (pack_mesh_soa), triangles on the last axis, with tri_id (K, L) int32
  global triangle ids, -1 for padding; or the (K, 32, L) streaming table
  (pack_mesh_stream) with the ids bit-cast into row 24, when tri_id is
  ignored, as in the reference;
- -> out (..., 8) float32 [t nx ny nz u v 0 0] (t = BIG on a miss, uv
  zeros unless need_uv) and id (...) int32 (-1 on a miss).

Visit rule (kernels and plain version): a ray visits its clusters in order
of (slab entry distance, cluster index) while the entry is below the ray's
own best t; each visit runs Moller-Trumbore over the cluster's L triangles
(t > 0, no t_min, as the reference) and folds in a strictly better hit,
the lowest triangle slot among those with the smallest t winning ties. The
TPU kernels visit the union of a ray block's needs; a ray's own set is a
subset of it, so the nearest hit is the same except on exact t-ties. The
two layouts give the same result bit for bit, and any K and L are taken.

How each side gets that sequence. The plain version sorts a ray's K
entries and walks them in lockstep rounds. The kernels (csrc/
mesh_traverse.cuh) scan the K slab tests once per ray into a window of the
4 smallest pending (entry, index) pairs and consume it in order, scanning
again (the warp together, lanes over clusters) only for a ray that used a
full window up; a visit is made by the ray's whole warp, lanes over the
leaf's triangle slots, with a warp reduction on (t, slot) for the winner.
tests/test_torch_traverse_window.py holds a CPU model of that schedule
against the plain version bit for bit.

K3 replaces :_key_kernel (launched by coherence_keys_pallas): per ray the
nearest slab entry over all clusters and the lowest cluster index at it.

`traverse_clusters` and `coherence_keys` launch the CUDA kernels
(csrc/mesh_traverse.cu, csrc/mesh_traverse_stream.cu, csrc/
coherence_keys.cu) for CUDA tensors, and run the plain versions for
tensors on the CPU (kernels/build.py:runs_plain). Each kernel counts its
launches on its KernelLibrary.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.mathx import BIG
from .build import FLOAT, INT, PTR, KernelLibrary, check, runs_plain

SOA_ROWS = 24        # v0, e1, e2 (9) + n0, n1, n2 (9) + uv0, uv1, uv2 (6)
STREAM_ROWS = 32     # the reference's streaming layout (kernel K2)
ID_ROW = 24          # the streaming table's row of bit-cast triangle ids
# rays per chunk of the plain traversal: bounds its (chunk, K) entries,
# (chunk, 9, L) gathered leaf block and (chunk, L) temporaries to tens of
# MB at any ray count
PLAIN_CHUNK = 4096
# rays per chunk of the plain keys: bounds the (chunk, K) entry matrix
KEY_CHUNK = 16384

KERNEL = KernelLibrary("mesh_traverse")                # K1, 24-row table
KERNEL_STREAM = KernelLibrary("mesh_traverse_stream")  # K2, 32-row table
KEY_KERNEL = KernelLibrary("coherence_keys")           # K3


def pack_mesh_soa_torch(tri_verts: torch.Tensor, tri_normals: torch.Tensor,
                        tri_uvs: torch.Tensor) -> torch.Tensor:
    """(K,L,3,3) verts / (K,L,3,3) corner normals / (K,L,3,2) corner UVs ->
    (K, 24, L) float32 SoA with triangles on the last axis, on the
    tensors' own device (scene/ir.py:refresh_kernel_tables packs on the
    card)."""
    v0 = tri_verts[:, :, 0, :]
    cols = [v0, tri_verts[:, :, 1, :] - v0, tri_verts[:, :, 2, :] - v0,
            tri_normals[:, :, 0, :], tri_normals[:, :, 1, :],
            tri_normals[:, :, 2, :],
            tri_uvs[:, :, 0, :], tri_uvs[:, :, 1, :], tri_uvs[:, :, 2, :]]
    return torch.cat(cols, dim=2).transpose(1, 2).contiguous()


def pack_mesh_stream_torch(tri_soa: torch.Tensor,
                           tri_id: torch.Tensor) -> torch.Tensor:
    """(K, 24, L) SoA + (K, L) int32 ids -> the reference's (K, 32, L)
    streaming table: ids bit-cast to float32 in row 24, rows 25-31 zero."""
    k, rows, leaf = tri_soa.shape
    if rows != SOA_ROWS:
        raise ValueError(f"expected a {SOA_ROWS}-row table, got {rows}")
    id_row = tri_id.to(torch.int32).contiguous().view(torch.float32)
    pad = tri_soa.new_zeros((k, STREAM_ROWS - SOA_ROWS - 1, leaf))
    return torch.cat([tri_soa, id_row[:, None, :], pad], dim=1)


def pack_bounds_torch(bmin: torch.Tensor, bmax: torch.Tensor) -> torch.Tensor:
    """(K,3)/(K,3) cluster bounds -> (8, K) float32 rows [bmin.xyz,
    bmax.xyz, 0, 0]."""
    return torch.cat([bmin.T, bmax.T, bmin.new_zeros((2, bmin.shape[0]))],
                     dim=0).contiguous()


def _host(fn, *arrays) -> np.ndarray:
    """A torch pack on the host: numpy in (as float32, ids as int32), numpy
    out."""
    return fn(*(torch.from_numpy(np.ascontiguousarray(
        a, np.int32 if np.issubdtype(np.asarray(a).dtype, np.integer)
        else np.float32)) for a in arrays)).numpy()


def pack_mesh_soa(tri_verts, tri_normals, tri_uvs) -> np.ndarray:
    """pack_mesh_soa_torch for numpy arrays (the host build)."""
    return _host(pack_mesh_soa_torch, tri_verts, tri_normals, tri_uvs)


def pack_mesh_stream(tri_soa, tri_id) -> np.ndarray:
    """pack_mesh_stream_torch for numpy arrays (the host build)."""
    return _host(pack_mesh_stream_torch, tri_soa, tri_id)


def pack_bounds(bmin, bmax) -> np.ndarray:
    """pack_bounds_torch for numpy arrays (the host build)."""
    return _host(pack_bounds_torch, bmin, bmax)


def stream_ids(table: torch.Tensor) -> torch.Tensor:
    """The (K, L) int32 triangle ids bit-cast in row 24 of a (K, 32, L)
    streaming table."""
    return table[:, ID_ROW, :].contiguous().view(torch.int32)


def _rows(tri_soa: torch.Tensor) -> int:
    """The table's layout: 24 rows (resident, K1) or 32 (streaming, K2)."""
    rows = tri_soa.shape[1] if tri_soa.dim() == 3 else None
    if rows not in (SOA_ROWS, STREAM_ROWS):
        raise ValueError(f"the mesh table must be (K, {SOA_ROWS}, L) or "
                         f"(K, {STREAM_ROWS}, L), got {tuple(tri_soa.shape)}")
    return rows


def _table_ids(tri_soa: torch.Tensor, tri_id: torch.Tensor) -> torch.Tensor:
    """The ids the table's layout says to use."""
    return tri_id if _rows(tri_soa) == SOA_ROWS else stream_ids(tri_soa)


def slab_entries(o: torch.Tensor, d: torch.Tensor, valid: torch.Tensor,
                 bounds8: torch.Tensor, t_max: float) -> torch.Tensor:
    """Cluster slab test (aabb.h:26-39): (R,3), (R,3), (R,) bool, (8,K) ->
    (R, K) entry distance (>= 0), +inf where missed or the ray is invalid."""
    lo = hi = None
    for ax in range(3):
        o_ax = o[:, ax:ax + 1]
        d_ax = d[:, ax:ax + 1]
        inv = 1.0 / torch.where(d_ax.abs() < 1e-30, 1e-30, d_ax)
        t0 = (bounds8[ax:ax + 1, :] - o_ax) * inv
        t1 = (bounds8[3 + ax:4 + ax, :] - o_ax) * inv
        lo_ax = torch.minimum(t0, t1)
        hi_ax = torch.maximum(t0, t1)
        lo = lo_ax if lo is None else torch.maximum(lo, lo_ax)
        hi = hi_ax if hi is None else torch.minimum(hi, hi_ax)
    entry = torch.clamp(lo, min=0.0)
    ok = (hi > entry) & (entry < t_max) & valid[:, None]
    return torch.where(ok, entry, float("inf"))


def leaf_hits(o, d, blk, ids, t_max):
    """Moller-Trumbore of A rays against their leaves: o, d (A, 3), blk
    (A, 9, L) rows [v0 e1 e2], ids (A, L) int32 (-1 pad) -> (t_min (A,),
    the lowest slot at it (A,), u (A, L), v (A, L)); t_min = BIG where the
    leaf holds no hit (t > 0, no t_min, as the reference). Shared by the
    plain traversal below and the lockstep find of ops/intersect.py."""
    leaf = blk.shape[2]
    lane = torch.arange(leaf, device=blk.device)
    ox, oy, oz = (o[:, c:c + 1] for c in range(3))        # (A, 1)
    dx, dy, dz = (d[:, c:c + 1] for c in range(3))
    v0x, v0y, v0z = blk[:, 0], blk[:, 1], blk[:, 2]       # (A, L)
    e1x, e1y, e1z = blk[:, 3], blk[:, 4], blk[:, 5]
    e2x, e2y, e2z = blk[:, 6], blk[:, 7], blk[:, 8]
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    inv = 1.0 / torch.where(det == 0.0, 1.0, det)
    tx = ox - v0x
    ty = oy - v0y
    tz = oz - v0z
    u = (tx * px + ty * py + tz * pz) * inv
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv
    t = (e2x * qx + e2y * qy + e2z * qz) * inv
    good = ((det != 0.0) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
            & (t > 0.0) & (t <= t_max) & (ids >= 0))
    t = torch.where(good, t, BIG)
    t_min = t.min(dim=1).values
    win = torch.where(t == t_min[:, None], lane, leaf).min(dim=1).values
    return t_min, win, u, v


def _traverse_chunk(rays, bounds8, tri_soa, tri_id, t_max, need_uv):
    """Plain traversal of one chunk of rays (R, 8) -> (R, 8), (R,)."""
    dev = rays.device
    m = rays.shape[0]
    k_clusters = tri_soa.shape[0]
    o, d = rays[:, 0:3], rays[:, 3:6]
    entry = slab_entries(o, d, rays[:, 6] > 0.0, bounds8, t_max)
    e_sorted, order = torch.sort(entry, dim=1, stable=True)
    out = torch.zeros((m, 8), dtype=torch.float32, device=dev)
    out[:, 0] = BIG
    best_id = torch.full((m,), -1, dtype=torch.int32, device=dev)
    for j in range(k_clusters):
        # round j: every ray whose j-th nearest entry still beats its own
        # best t visits that cluster (later rounds never re-open a ray:
        # entries ascend while best t only falls)
        idx = (e_sorted[:, j] < out[:, 0]).nonzero().squeeze(1)
        if idx.numel() == 0:
            break
        kk = order[idx, j]
        ids = tri_id[kk]                                  # (A, L)
        t_min, win, u, v = leaf_hits(o[idx], d[idx], tri_soa[kk, 0:9], ids,
                                     t_max)
        take = t_min < out[idx, 0]
        if not bool(take.any()):
            continue
        idx, kk, win, t_min = idx[take], kk[take], win[take], t_min[take]
        w1 = u[take].gather(1, win[:, None])[:, 0]
        w2 = v[take].gather(1, win[:, None])[:, 0]
        w0 = 1.0 - w1 - w2
        a = tri_soa[kk, 9:24, win]                        # (A', 15)
        row = torch.zeros((idx.shape[0], 8), dtype=torch.float32, device=dev)
        row[:, 0] = t_min
        for c in range(3):  # n = w0*n0 + u*n1 + v*n2
            row[:, 1 + c] = w0 * a[:, c] + w1 * a[:, 3 + c] + w2 * a[:, 6 + c]
        if need_uv:
            for c in range(2):
                row[:, 4 + c] = (w0 * a[:, 9 + c] + w1 * a[:, 11 + c]
                                 + w2 * a[:, 13 + c])
        out[idx] = row
        best_id[idx] = ids[take].gather(1, win[:, None])[:, 0]
    return out, best_id


def traverse_clusters_plain(rays8: torch.Tensor, bounds8: torch.Tensor,
                            tri_soa: torch.Tensor, tri_id: torch.Tensor,
                            t_max: float = BIG, need_uv: bool = True,
                            chunk: int = PLAIN_CHUNK):
    """The plain PyTorch version of kernels K1 and K2 (same contract and
    per-ray visit order), lockstep over visit rounds in chunks of `chunk`
    rays. A 32-row table takes its ids from row 24 (tri_id is ignored)."""
    tri_id = _table_ids(tri_soa, tri_id)
    lead = rays8.shape[:-1]
    rays = rays8.reshape(-1, 8)
    outs, ids = [], []
    for s in range(0, rays.shape[0], chunk):
        o, i = _traverse_chunk(rays[s:s + chunk], bounds8, tri_soa, tri_id,
                               float(t_max), need_uv)
        outs.append(o)
        ids.append(i)
    if not outs:
        return (torch.zeros(lead + (8,), dtype=torch.float32,
                            device=rays8.device),
                torch.zeros(lead, dtype=torch.int32, device=rays8.device))
    return (torch.cat(outs).reshape(lead + (8,)),
            torch.cat(ids).reshape(lead))


def flat_rays8(rays8: torch.Tensor, library: KernelLibrary) -> torch.Tensor:
    """rays8 (..., 8) as the (N, 8) rows that `library`'s kernel takes,
    checked (K1-K4)."""
    dev = library.device_for(rays8.device)
    rays = rays8.reshape(-1, 8)
    n = rays.shape[0]
    if n >= 2 ** 31:
        raise ValueError(f"{n} rays exceed the kernel's int32 indexing")
    check("rays8", rays, torch.float32, (n, 8), dev)
    return rays


def _traverse_cuda(rays8, bounds8, tri_soa, tri_id, t_max, need_uv):
    """Launch K1 (24-row table, ids from tri_id) or K2 (32-row table, ids
    from row 24)."""
    resident = _rows(tri_soa) == SOA_ROWS
    library = KERNEL if resident else KERNEL_STREAM
    rays = flat_rays8(rays8, library)
    dev = rays.device
    k_clusters, rows, leaf = tri_soa.shape
    if k_clusters == 0 or leaf == 0:
        raise ValueError(f"empty mesh table {tuple(tri_soa.shape)}")
    check("bounds8", bounds8, torch.float32, (8, k_clusters), dev)
    check("tri_soa", tri_soa, torch.float32, (k_clusters, rows, leaf), dev)
    if resident:
        check("tri_id", tri_id, torch.int32, (k_clusters, leaf), dev)
    n = rays.shape[0]
    out = torch.empty((n, 8), dtype=torch.float32, device=dev)
    out_id = torch.empty((n,), dtype=torch.int32, device=dev)
    if n:
        table = ((tri_soa.data_ptr(), tri_id.data_ptr()) if resident
                 else (tri_soa.data_ptr(),))
        library.launch(
            [PTR, INT, PTR, INT, *[PTR] * len(table), INT, FLOAT, INT, PTR,
             PTR], dev, rays.data_ptr(), n, bounds8.data_ptr(), k_clusters,
            *table, leaf, float(t_max), int(bool(need_uv)), out.data_ptr(),
            out_id.data_ptr())
    lead = rays8.shape[:-1]
    return out.reshape(lead + (8,)), out_id.reshape(lead)


def traverse_clusters(rays8: torch.Tensor, bounds8: torch.Tensor,
                      tri_soa: torch.Tensor, tri_id: torch.Tensor,
                      t_max: float = BIG, need_uv: bool = True):
    """Nearest triangle per ray through the cluster BVH (contract in the
    module docstring). CUDA tensors launch K1 for a 24-row table and K2 for
    a 32-row one, built at first use; the wrapper raises if the kernel
    cannot be built or launched. CPU tensors run the plain version."""
    if runs_plain(rays8.device):
        return traverse_clusters_plain(rays8, bounds8, tri_soa, tri_id,
                                       t_max, need_uv)
    return _traverse_cuda(rays8, bounds8, tri_soa, tri_id, t_max, need_uv)


def coherence_keys_plain(rays8: torch.Tensor, bounds8: torch.Tensor,
                         t_max: float = BIG, chunk: int = KEY_CHUNK):
    """The plain PyTorch version of kernel K3: rays8 (..., 8), bounds8
    (8, K) -> e_min (...) float32, the nearest slab entry over the K
    clusters (+inf when the ray misses them all or is invalid), and first
    (...) int32, the lowest cluster index at e_min (0 on a miss)."""
    lead = rays8.shape[:-1]
    rays = rays8.reshape(-1, 8)
    k_clusters = bounds8.shape[1]
    lane = torch.arange(k_clusters, device=rays.device)
    e_out, k_out = [], []
    for s in range(0, rays.shape[0], chunk):
        r = rays[s:s + chunk]
        entry = slab_entries(r[:, 0:3], r[:, 3:6], r[:, 6] > 0.0, bounds8,
                             float(t_max))
        e_min = entry.min(dim=1).values
        first = torch.where(entry == e_min[:, None], lane,
                            k_clusters).min(dim=1).values
        e_out.append(e_min)
        k_out.append(torch.where(torch.isfinite(e_min), first, 0)
                     .to(torch.int32))
    if not e_out:
        return (torch.zeros(lead, dtype=torch.float32, device=rays8.device),
                torch.zeros(lead, dtype=torch.int32, device=rays8.device))
    return torch.cat(e_out).reshape(lead), torch.cat(k_out).reshape(lead)


def _keys_cuda(rays8, bounds8, t_max):
    rays = flat_rays8(rays8, KEY_KERNEL)
    dev = rays.device
    k_clusters = bounds8.shape[1] if bounds8.dim() == 2 else 0
    if k_clusters == 0:
        raise ValueError(f"bounds8 must be (8, K) with K >= 1, got "
                         f"{tuple(bounds8.shape)}")
    check("bounds8", bounds8, torch.float32, (8, k_clusters), dev)
    n = rays.shape[0]
    e_min = torch.empty((n,), dtype=torch.float32, device=dev)
    first = torch.empty((n,), dtype=torch.int32, device=dev)
    if n:
        KEY_KERNEL.launch([PTR, INT, PTR, INT, FLOAT, PTR, PTR], dev,
                          rays.data_ptr(), n, bounds8.data_ptr(), k_clusters,
                          float(t_max), e_min.data_ptr(), first.data_ptr())
    lead = rays8.shape[:-1]
    return e_min.reshape(lead), first.reshape(lead)


def coherence_keys(rays8: torch.Tensor, bounds8: torch.Tensor,
                   t_max: float = BIG):
    """Per ray (e_min, first) for the coherence sort (see
    coherence_keys_plain). CUDA tensors launch K3, built at first use, or
    raise; CPU tensors run the plain version."""
    if runs_plain(rays8.device):
        return coherence_keys_plain(rays8, bounds8, t_max)
    return _keys_cuda(rays8, bounds8, t_max)
