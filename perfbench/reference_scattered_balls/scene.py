"""The scene as this reference renders it, read from the frozen YAML:
untransformed spheres, kept in the YAML's order (the order of the
program's sphere pool, which decides an exact tie in t: the earlier sphere
keeps it), lambertian, metal and dielectric materials with constant
parameters, and a solid background colour or an environment map.

The material rows are the program's: row 0 the default lambertian (albedo
0.5), then one row a YAML material in order, each with its albedo (zero
for a dielectric, which has none), roughness (a metal's; a dielectric's
where given, else 0), strength 1 and ior (a dielectric's, else 1.5). The
camera basis is the shared reference's.

Departures from the book's final scene (Ray Tracing in One Weekend v4.0,
main.cc: 1200 wide at 16:9, vfov 20, defocus angle 0.6, focus 10), as the
program renders the frozen YAML:
- no defocus: neither the book's defocus angle nor the YAML's `aperture`
  (read and not applied) opens a lens (upstream HobbyRaytracer's
  camera hardcodes defocus off, camera.h:34-35, and no YAML field turns the
  program's thin lens on), so every ray starts at the camera's origin;
- a solid background (0.7, 0.8, 1.0) in place of the book's sky gradient;
- Russian roulette from depth 4, as in every render of the benchmark;
- the small spheres' placements and materials are the repository's
  generator's (scripts/gen_scattered_balls.py, seed 20260817), not the
  book's random draws.
A feature outside that set raises.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np
import yaml

from perfbench.reference import scene as shared

MAT_LAMBERTIAN = shared.MAT_LAMBERTIAN
MAT_METAL = shared.MAT_METAL
MAT_DIELECTRIC = 2
_MTYPE = {"lambertian": MAT_LAMBERTIAN, "metal": MAT_METAL,
          "dielectric": MAT_DIELECTRIC}


@dataclass
class Scene(shared.Scene):
    """The shared reference's scene (no rects, no meshes) with the sphere
    pool: center (S, 3), radius (S,) float32 and mat (S,) int32."""
    spheres: dict = field(default_factory=dict)


def _constant(m: dict, key: str, default):
    v = m.get(key, default)
    if not isinstance(v, (int, float, list, tuple)):
        raise NotImplementedError(f"textured {key}")
    return v


def load(yaml_path: str) -> Scene:
    """Read a scene YAML of spheres and the files it names (relative to
    it)."""
    with open(yaml_path) as f:
        root = yaml.safe_load(f)
    base = os.path.dirname(os.path.abspath(yaml_path))
    film, cam = root["film"], root["camera"]
    bg = cam["background"]
    if isinstance(bg, (list, tuple)):
        background, is_map = np.asarray(bg, np.float32), False
    else:
        tex = {t["name"]: t for t in root.get("textures") or []}[bg]
        if tex["type"] != "environment":
            raise NotImplementedError(f"background texture {tex['type']}")
        background = shared.read_hdr(os.path.join(base, tex["path"]))
        is_map = True

    rows = [dict(mtype=MAT_LAMBERTIAN, albedo=(0.5, 0.5, 0.5),
                 roughness=0.0, ior=1.5)]
    mat_of = {}
    for m in root.get("materials") or []:
        if m["type"] not in _MTYPE:
            raise NotImplementedError(f"material type {m['type']}")
        mtype = _MTYPE[m["type"]]
        mat_of[m["name"]] = len(rows)
        rows.append(dict(
            mtype=mtype,
            albedo=(tuple(float(x) for x in _constant(m, "albedo", None))
                    if mtype != MAT_DIELECTRIC else (0.0, 0.0, 0.0)),
            roughness=(float(_constant(m, "roughness", 0.0))
                       if mtype != MAT_LAMBERTIAN else 0.0),
            ior=(float(_constant(m, "ior", 1.5)) if mtype == MAT_DIELECTRIC
                 else 1.5)))
    materials = {
        "mtype": np.asarray([r["mtype"] for r in rows], np.int32),
        "albedo": np.asarray([r["albedo"] for r in rows], np.float32),
        "roughness": np.asarray([r["roughness"] for r in rows], np.float32),
        "strength": np.ones((len(rows),), np.float32),
        "ior": np.asarray([r["ior"] for r in rows], np.float32),
        "metallness": np.zeros((len(rows),), np.float32)}

    center, radius, mat = [], [], []
    for o in root.get("objects") or []:
        if o["type"] != "sphere" or o.get("transform"):
            raise NotImplementedError(f"object type {o['type']}"
                                      + (" (transformed)"
                                         if o.get("transform") else ""))
        center.append([float(x) for x in o["center"]])
        radius.append(float(o["radius"]))
        mat.append(mat_of[o["material"]])
    rects = {k: np.zeros((0,), np.int32 if k in ("axis", "mat")
                         else np.float32)
             for k in ("axis", "a0", "a1", "b0", "b1", "k", "mat")}
    width, height = int(film["width"]), int(film["height"])
    return Scene(width, height, int(film["samples"]),
                 shared.camera_basis(cam, width / height), materials, rects,
                 [], background, is_map,
                 spheres={"center": np.asarray(center, np.float32),
                          "radius": np.asarray(radius, np.float32),
                          "mat": np.asarray(mat, np.int32)})
