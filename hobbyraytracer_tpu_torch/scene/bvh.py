"""Host-side cluster BVH build in numpy (uniform leaves).

A copy of hobbyraytracer_tpu/scene/bvh.py's numpy builders: triangles are
split recursively until each leaf ("cluster") holds <= leaf_size triangles,
and each cluster is padded to exactly leaf_size with degenerate triangles,
so the device tables are rectangular: tri vertices (K, L, 3, 3), global
triangle ids (K, L), cluster bounds (K, 3) + (K, 3).

The constrained SAH split is the default, as in the reference; the median
split is kept beside it. The reference's native C++ builder is not ported
(its SAH picks other splits than this numpy SAH on the teapot; ROADMAP
Queue 3).
"""
from __future__ import annotations

import numpy as np


def median_split_order(centroids: np.ndarray, leaf_size: int) -> list:
    """Recursively median-split triangle indices on the centroids' longest
    axis; returns a list of index arrays, each of length <= leaf_size."""
    out = []

    def split(idx):
        if len(idx) <= leaf_size:
            out.append(idx)
            return
        c = centroids[idx]
        axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        order = np.argsort(c[:, axis], kind="stable")
        half = len(idx) // 2
        split(idx[order[:half]])
        split(idx[order[half:]])

    split(np.arange(len(centroids), dtype=np.int64))
    return out


def sah_split_order(tri_verts: np.ndarray, leaf_size: int) -> list:
    """Constrained surface-area-heuristic split: each recursion picks the
    axis and the split position (a multiple of leaf_size, so leaves stay
    full) minimizing SA(left)*n_left + SA(right)*n_right over prefix boxes.
    tri_verts: (T, 3, 3)."""
    cent = tri_verts.mean(axis=1)
    out = []

    def sa_prefix(t):
        p = t.reshape(len(t), -1, 3)
        mn = np.minimum.accumulate(p.min(axis=1), axis=0)
        mx = np.maximum.accumulate(p.max(axis=1), axis=0)
        e = mx - mn
        return 2 * (e[:, 0] * e[:, 1] + e[:, 1] * e[:, 2]
                    + e[:, 0] * e[:, 2])

    def split(idx):
        n = len(idx)
        if n <= leaf_size:
            out.append(idx)
            return
        best = None
        for ax in range(3):
            o = np.argsort(cent[idx][:, ax], kind="stable")
            sidx = idx[o]
            t = tri_verts[sidx]
            sa_l = sa_prefix(t)
            sa_r = sa_prefix(t[::-1])[::-1]
            cands = np.arange(leaf_size, n, leaf_size)
            cost = sa_l[cands - 1] * cands + sa_r[cands] * (n - cands)
            j = int(np.argmin(cost))
            if best is None or cost[j] < best[0]:
                best = (float(cost[j]), sidx, int(cands[j]))
        _, sidx, c = best
        split(sidx[:c])
        split(sidx[c:])

    split(np.arange(len(tri_verts), dtype=np.int64))
    return out


def build_clusters(verts: np.ndarray, indices: np.ndarray,
                   leaf_size: int = 32, sah: bool = True) -> dict:
    """-> dict with:
    tri_verts (K, L, 3, 3) float32 — leaf triangles, padded with all-zero
        triangles that never intersect (det == 0);
    tri_id (K, L) int32 — global triangle index, -1 for padding;
    bmin/bmax (K, 3) float32 — cluster bounds, padded by 1e-4 like the
        reference's triangle boxes (triangle.cpp:42-55).
    sah=False selects the median split."""
    verts = np.asarray(verts, np.float32)
    indices = np.asarray(indices, np.int64)
    tv = verts[indices]                     # (T, 3, 3)
    leaves = (sah_split_order(tv, leaf_size) if sah
              else median_split_order(tv.mean(axis=1), leaf_size))
    k = len(leaves)
    tri_verts = np.zeros((k, leaf_size, 3, 3), np.float32)
    tri_id = np.full((k, leaf_size), -1, np.int32)
    bmin = np.zeros((k, 3), np.float32)
    bmax = np.zeros((k, 3), np.float32)
    for i, leaf in enumerate(leaves):
        n = len(leaf)
        tri_verts[i, :n] = tv[leaf]
        tri_id[i, :n] = leaf
        bmin[i] = tv[leaf].reshape(-1, 3).min(axis=0) - 1e-4
        bmax[i] = tv[leaf].reshape(-1, 3).max(axis=0) + 1e-4
    return {"tri_verts": tri_verts, "tri_id": tri_id,
            "bmin": bmin, "bmax": bmax}
