"""Mesh import by extension (counterpart of
hobbyraytracer_tpu/scene/meshload.py:load_mesh).

Only OBJ is ported; the reference's PLY, STL, glTF/GLB, DAE, 3DS and FBX
parsers are ROADMAP Queue 1 item 16 and raise NotImplementedError here.
"""
from __future__ import annotations

import os

from . import objloader

_NOT_PORTED = (".ply", ".stl", ".gltf", ".glb", ".dae", ".3ds", ".fbx")


def load_mesh(path: str) -> dict:
    """Parse a mesh file -> dict(verts (V,3) f32, normals (V,3) f32,
    uvs (V,2) f32, indices (T,3) i32). Extensionless paths parse as OBJ,
    like the reference."""
    ext = os.path.splitext(path)[1].lower()
    if ext in _NOT_PORTED:
        raise NotImplementedError(
            f"mesh format {ext} ({path}) is not ported yet: ROADMAP Queue 1 "
            "item 16 (long-tail host code)")
    if ext in (".blend", ".x3d"):
        raise ValueError(f"unsupported mesh format {ext}: {path}")
    try:
        return objloader.parse_obj(path)
    except (OSError, ValueError):
        raise
    except (IndexError, KeyError) as e:  # malformed face records
        raise ValueError(f"malformed mesh file {path}: "
                         f"{type(e).__name__}: {e}") from e
