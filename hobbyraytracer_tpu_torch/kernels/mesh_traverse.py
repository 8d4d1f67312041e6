"""Fused cluster-BVH traversal + triangle intersection + attribute
interpolation: the CUDA kernel's wrapper and its plain PyTorch version.

Replaces the TPU kernel hobbyraytracer_tpu/kernels/mesh_traverse.py:_kernel
(launched by traverse_clusters_pallas). The contract at the public function
is the reference's:

- rays8 (..., 8) float32 lanes [ox oy oz dx dy dz valid 0];
- bounds8 (8, K) float32 rows [bmin.xyz bmax.xyz 0 0] (pack_bounds);
- tri_soa (K, 24, L) float32 rows [v0 e1 e2 n0 n1 n2 uv0 uv1 uv2]
  (pack_mesh_soa), triangles on the last axis;
- tri_id (K, L) int32 global triangle ids, -1 for padding;
- -> out (..., 8) float32 [t nx ny nz u v 0 0] (t = BIG on a miss, uv
  zeros unless need_uv) and id (...) int32 (-1 on a miss).

Visit rule (both versions): a ray visits its clusters in order of (slab
entry distance, cluster index) while the entry is below the ray's own best
t; each visit runs Moller-Trumbore over the cluster's L triangles (t > 0,
no t_min, as the reference) and folds in a strictly better hit, the first
minimum lane winning ties. The TPU kernel visits the union of a ray
block's needs; a ray's own set is a subset of it, so the nearest hit is the
same except on exact t-ties.

`traverse_clusters` launches the CUDA kernel (csrc/mesh_traverse.cu) for
CUDA tensors and runs `traverse_clusters_plain` only for tensors on the
CPU. The 32-row streaming table (TPU kernel K2, _kernel_stream) is not
ported yet and is refused.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core.mathx import BIG
from .build import KernelLibrary

SOA_ROWS = 24        # v0, e1, e2 (9) + n0, n1, n2 (9) + uv0, uv1, uv2 (6)
STREAM_ROWS = 32     # the reference's HBM-streaming layout (kernel K2)
# compile-time cap of the CUDA kernel's per-ray entry array (MAX_K in
# csrc/mesh_traverse.cu); larger meshes belong to the streaming kernel
MAX_CLUSTERS = 256
# rays per chunk of the plain version: bounds its (chunk, 9, L) gathered
# leaf block and (chunk, L) temporaries to tens of MB at any ray count
PLAIN_CHUNK = 4096

KERNEL = KernelLibrary("mesh_traverse")


def pack_mesh_soa(tri_verts: np.ndarray, tri_normals: np.ndarray,
                  tri_uvs: np.ndarray) -> np.ndarray:
    """(K,L,3,3) verts / (K,L,3,3) corner normals / (K,L,3,2) corner UVs ->
    (K, 24, L) float32 SoA with triangles on the last axis."""
    tri_verts = np.asarray(tri_verts, np.float32)
    v0 = tri_verts[:, :, 0, :]
    e1 = tri_verts[:, :, 1, :] - v0
    e2 = tri_verts[:, :, 2, :] - v0
    tri_normals = np.asarray(tri_normals, np.float32)
    tri_uvs = np.asarray(tri_uvs, np.float32)
    cols = [v0, e1, e2,
            tri_normals[:, :, 0, :], tri_normals[:, :, 1, :],
            tri_normals[:, :, 2, :],
            tri_uvs[:, :, 0, :], tri_uvs[:, :, 1, :], tri_uvs[:, :, 2, :]]
    soa = np.concatenate(cols, axis=2)                    # (K, L, 24)
    return np.ascontiguousarray(np.swapaxes(soa, 1, 2))   # (K, 24, L)


def pack_mesh_stream(tri_soa: np.ndarray, tri_id: np.ndarray) -> np.ndarray:
    """(K, 24, L) SoA + (K, L) int32 ids -> the reference's (K, 32, L)
    streaming table: ids bitcast to float32 in row 24, rows 25-31 zero."""
    k, rows, leaf = tri_soa.shape
    if rows != SOA_ROWS:
        raise ValueError(f"expected a {SOA_ROWS}-row table, got {rows}")
    id_row = np.asarray(tri_id, np.int32).view(np.float32)[:, None, :]
    pad = np.zeros((k, STREAM_ROWS - SOA_ROWS - 1, leaf), np.float32)
    return np.concatenate([tri_soa, id_row, pad], axis=1)


def pack_bounds(bmin: np.ndarray, bmax: np.ndarray) -> np.ndarray:
    """(K,3)/(K,3) cluster bounds -> (8, K) float32 rows
    [bmin.xyz, bmax.xyz, 0, 0]."""
    bmin = np.asarray(bmin, np.float32)
    bmax = np.asarray(bmax, np.float32)
    return np.concatenate([bmin.T, bmax.T,
                           np.zeros((2, bmin.shape[0]), np.float32)],
                          axis=0).astype(np.float32)


def _refuse_stream_table(tri_soa: torch.Tensor) -> None:
    if tri_soa.dim() == 3 and tri_soa.shape[1] == STREAM_ROWS:
        raise NotImplementedError(
            "a 32-row streaming mesh table needs the TPU kernel K2 "
            "(hobbyraytracer_tpu/kernels/mesh_traverse.py:_kernel_stream), "
            "which is not ported yet: ROADMAP Queue 2")


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


def _traverse_chunk(rays, bounds8, tri_soa, tri_id, t_max, need_uv):
    """Plain traversal of one chunk of rays (R, 8) -> (R, 8), (R,)."""
    dev = rays.device
    m = rays.shape[0]
    k_clusters, _, leaf = tri_soa.shape
    o, d = rays[:, 0:3], rays[:, 3:6]
    entry = slab_entries(o, d, rays[:, 6] > 0.0, bounds8, t_max)
    e_sorted, order = torch.sort(entry, dim=1, stable=True)
    out = torch.zeros((m, 8), dtype=torch.float32, device=dev)
    out[:, 0] = BIG
    best_id = torch.full((m,), -1, dtype=torch.int32, device=dev)
    lane = torch.arange(leaf, device=dev)
    for j in range(k_clusters):
        # round j: every ray whose j-th nearest entry still beats its own
        # best t visits that cluster (later rounds never re-open a ray:
        # entries ascend while best t only falls)
        idx = (e_sorted[:, j] < out[:, 0]).nonzero().squeeze(1)
        if idx.numel() == 0:
            break
        kk = order[idx, j]
        blk = tri_soa[kk, 0:9]                            # (A, 9, L)
        ids = tri_id[kk]                                  # (A, L)
        ox, oy, oz = (o[idx, c:c + 1] for c in range(3))  # (A, 1)
        dx, dy, dz = (d[idx, c:c + 1] for c in range(3))
        v0x, v0y, v0z = blk[:, 0], blk[:, 1], blk[:, 2]   # (A, L)
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
    """The plain PyTorch version of the kernel (same contract and per-ray
    visit order), lockstep over visit rounds in chunks of `chunk` rays."""
    _refuse_stream_table(tri_soa)
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


def _check(name, x, dtype, shape, device):
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, rays8 on {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _library() -> ctypes.CDLL:
    lib = KERNEL.load()
    fn = lib.hrt_mesh_traverse
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, p, i, p, p, i, ctypes.c_float, i, p, p, p]
        fn.restype = ctypes.c_int
    return lib


def _traverse_cuda(rays8, bounds8, tri_soa, tri_id, t_max, need_uv):
    lib = _library()
    dev = rays8.device
    if dev.type != "cuda":
        raise ValueError(f"the mesh traversal kernel needs CUDA tensors, "
                         f"got {dev}")
    if tri_soa.dim() != 3:
        raise ValueError(f"tri_soa must be (K, 24, L), got "
                         f"{tuple(tri_soa.shape)}")
    k_clusters, _, leaf = tri_soa.shape
    if k_clusters > MAX_CLUSTERS:
        raise ValueError(
            f"{k_clusters} clusters exceed the kernel's cap of "
            f"{MAX_CLUSTERS}; larger meshes belong to the streaming kernel "
            "K2 (not ported yet: ROADMAP Queue 2)")
    rays = rays8.reshape(-1, 8)
    n = rays.shape[0]
    if n >= 2 ** 31:
        raise ValueError(f"{n} rays exceed the kernel's int32 indexing")
    _check("rays8", rays, torch.float32, (n, 8), dev)
    _check("bounds8", bounds8, torch.float32, (8, k_clusters), dev)
    _check("tri_soa", tri_soa, torch.float32, (k_clusters, SOA_ROWS, leaf),
           dev)
    _check("tri_id", tri_id, torch.int32, (k_clusters, leaf), dev)
    out = torch.empty((n, 8), dtype=torch.float32, device=dev)
    out_id = torch.empty((n,), dtype=torch.int32, device=dev)
    if n:
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.hrt_mesh_traverse(
            rays.data_ptr(), n, bounds8.data_ptr(), k_clusters,
            tri_soa.data_ptr(), tri_id.data_ptr(), leaf, float(t_max),
            int(bool(need_uv)), out.data_ptr(), out_id.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"mesh_traverse kernel launch failed: CUDA "
                               f"error {err}")
        KERNEL.launches += 1
    lead = rays8.shape[:-1]
    return out.reshape(lead + (8,)), out_id.reshape(lead)


def traverse_clusters(rays8: torch.Tensor, bounds8: torch.Tensor,
                      tri_soa: torch.Tensor, tri_id: torch.Tensor,
                      t_max: float = BIG, need_uv: bool = True):
    """Nearest triangle per ray through the cluster BVH (contract in the
    module docstring). CUDA tensors launch the kernel, which is built at
    first use and raises if it cannot be built or launched; CPU tensors
    run the plain version."""
    _refuse_stream_table(tri_soa)
    if rays8.device.type == "cpu":
        return traverse_clusters_plain(rays8, bounds8, tri_soa, tri_id,
                                       t_max, need_uv)
    return _traverse_cuda(rays8, bounds8, tri_soa, tri_id, t_max, need_uv)
