"""Host-side cluster BVH build (uniform leaves), as in
hobbyraytracer_tpu/scene/bvh.py: triangles are split recursively until
each leaf ("cluster") holds <= leaf_size triangles, and each cluster is
padded to exactly leaf_size with degenerate triangles, so the device tables
are rectangular: tri vertices (K, L, 3, 3), global triangle ids (K, L),
cluster bounds (K, 3) + (K, 3).

`build_clusters` chooses its builder as the reference does: the native C++
one (native/objbvh.cpp) when its library builds, the numpy copies below
otherwise or with HRT_NO_NATIVE=1. The two SAH builders pick different
splits (23 of the teapot's 30 leaves differ), so both packages must take
the same one for their tables to agree. The constrained SAH split is the
default, as in the reference (HRT_BVH_SAH=0 selects the median split);
the median split is kept beside it.

`build_sphere_clusters` groups a sphere pool into the clusters that the
sphere kernel K4 (kernels/sphere_traverse.py) visits.
"""
from __future__ import annotations

import os

import numpy as np

from .. import native

# HRT_BVH_SAH: the constrained SAH cluster build (default) or, with 0, the
# longest-axis median split. Read once at import, as the reference reads
# it; a module attribute read at call time, so a caller may switch it
# in-process.
BVH_SAH = os.environ.get("HRT_BVH_SAH", "1") != "0"

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
                   leaf_size: int = 32, sah=None) -> dict:
    """-> dict with:
    tri_verts (K, L, 3, 3) float32 — leaf triangles, padded with all-zero
        triangles that never intersect (det == 0);
    tri_id (K, L) int32 — global triangle index, -1 for padding;
    bmin/bmax (K, 3) float32 — cluster bounds, padded by 1e-4 like the
        reference's triangle boxes (triangle.cpp:42-55).
    sah: True the SAH split, False the median split, None BVH_SAH."""
    if sah is None:
        sah = BVH_SAH
    built = native.build_clusters(verts, indices, leaf_size, sah=sah)
    if built is not None:
        return built
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


def build_sphere_clusters(center: np.ndarray, radius: np.ndarray,
                          leaf_size: int = 128) -> dict:
    """Cluster a sphere table for the sphere kernel: median-split the
    centers into groups of <= leaf_size, pad each group to exactly
    leaf_size, and pack

    - table   (K, 8, L) f32 rows [cx cy cz r2 0 0 0 0]; pad spheres carry
              r2 = -1 (the discriminant stays negative: never hit);
    - bounds8 (8, K) f32 [bmin.xyz bmax.xyz 0 0], the union of
              center +- |radius| over the cluster's real spheres;
    - ids     (K, L) int32 indices into the unpermuted sphere table, -1
              for padding.
    """
    center = np.asarray(center, np.float32)
    radius = np.asarray(radius, np.float32)
    groups = median_split_order(center, leaf_size)
    k = len(groups)
    table = np.zeros((k, 8, leaf_size), np.float32)
    table[:, 3, :] = -1.0
    ids = np.full((k, leaf_size), -1, np.int32)
    bmin = np.empty((k, 3), np.float32)
    bmax = np.empty((k, 3), np.float32)
    for gi, g in enumerate(groups):
        n = len(g)
        c = center[g]
        r = np.abs(radius[g])
        table[gi, 0:3, :n] = c.T
        table[gi, 3, :n] = radius[g] * radius[g]
        ids[gi, :n] = g
        bmin[gi] = (c - r[:, None]).min(axis=0)
        bmax[gi] = (c + r[:, None]).max(axis=0)
    bounds8 = np.concatenate(
        [bmin.T, bmax.T, np.zeros((2, k), np.float32)], axis=0)
    return {"table": table, "bounds8": bounds8.astype(np.float32),
            "ids": ids}
