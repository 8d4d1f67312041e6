"""Wavefront OBJ parser (replaces assimp, reference mesh.cpp:53-120).

A copy of the python parser in hobbyraytracer_tpu/scene/objloader.py
(`parse_obj_python`); the reference's native C++ fast path is not ported.

- v / vn / vt / f records; polygon faces triangulated as fans;
- f indices may be v, v/vt, v//vn, v/vt/vn, and may be negative;
- per-corner (v, vt, vn) triples are deduplicated into one vertex buffer;
- V texture coordinate flipped (assimp FlipUVs);
- missing normals/uvs zero-filled like the reference.
"""
from __future__ import annotations

import numpy as np


def parse_obj(path: str) -> dict:
    """-> dict(verts (V,3) f32, normals (V,3) f32, uvs (V,2) f32,
    indices (T,3) i32)."""
    positions, normals_in, uvs_in = [], [], []
    corner_map = {}
    out_pos, out_nrm, out_uv = [], [], []
    tris = []

    def resolve(idx: int, n: int) -> int:
        return idx - 1 if idx > 0 else n + idx

    def corner(token: str) -> int:
        if token in corner_map:
            return corner_map[token]
        parts = token.split("/")
        vi = resolve(int(parts[0]), len(positions))
        ti = (resolve(int(parts[1]), len(uvs_in))
              if len(parts) > 1 and parts[1] else -1)
        ni = (resolve(int(parts[2]), len(normals_in))
              if len(parts) > 2 and parts[2] else -1)
        out_pos.append(positions[vi])
        out_uv.append(uvs_in[ti] if ti >= 0 else (0.0, 0.0))
        out_nrm.append(normals_in[ni] if ni >= 0 else (0.0, 0.0, 0.0))
        idx = len(out_pos) - 1
        corner_map[token] = idx
        return idx

    with open(path, "r", errors="replace") as f:
        for line in f:
            if not line or line[0] in "#\n":
                continue
            parts = line.split()
            if not parts:
                continue
            tag = parts[0]
            if tag == "v":
                positions.append(tuple(float(x) for x in parts[1:4]))
            elif tag == "vn":
                normals_in.append(tuple(float(x) for x in parts[1:4]))
            elif tag == "vt":
                u = float(parts[1])
                v = float(parts[2]) if len(parts) > 2 else 0.0
                uvs_in.append((u, 1.0 - v))  # assimp FlipUVs (mesh.cpp:56)
            elif tag == "f":
                corners = [corner(tok) for tok in parts[1:]]
                for i in range(1, len(corners) - 1):  # fan triangulation
                    tris.append((corners[0], corners[i], corners[i + 1]))

    if not tris:
        raise ValueError(f"no faces in OBJ file: {path}")
    return {
        "verts": np.asarray(out_pos, np.float32),
        "normals": np.asarray(out_nrm, np.float32),
        "uvs": np.asarray(out_uv, np.float32),
        "indices": np.asarray(tris, np.int32),
    }
