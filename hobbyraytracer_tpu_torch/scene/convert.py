"""Scenes and cameras to and from nested dicts of numpy arrays.

The JAX package's SceneIR / Camera, flattened to nested dicts of numpy
arrays, become the port's `SceneIR` / `Camera` here, so both packages can
trace the very same tables (what carrying weights across is for a model).
The dict layout follows the reference's pytree field names:

    scene = {"rects": {axis, a0, a1, b0, b1, k, mat_id},
             "instances": [{"kind": "rect" | "mesh",
                            "rects": {...} | None,
                            "mesh": {verts, normals, uvs, indices, mat_id,
                                     cluster_id, cluster_bmin,
                                     cluster_bmax, tri_soa, bounds8,
                                     use_bvh} | None,
                            "transform": {translate, scale, quat} | None}],
             "materials": {mtype, albedo, albedo_tex, roughness,
                           roughness_tex, strength, strength_tex, ior,
                           metallness, metallness_tex,
                           present, textured, tex_types},
             "textures": {ttype, solid, solid2, atlas, offset, width,
                          height, bilinear},
             "background_tex": int,
             "spheres": {center, radius, mat_id},   # must be empty
             "media": []}                            # must be empty
    camera = {origin, lower_left_corner, horizontal, vertical, u, v, w,
              lens_radius, use_lens}

What the port does not render yet (spheres, media, dense meshes,
bilinear textures, the lens) raises NotImplementedError.
"""
from __future__ import annotations

import numpy as np

from ..ops.camera import Camera
from ..ops.shade import MaterialTable
from ..ops.texture import TextureTable
from . import ir

RECT_FIELDS = ("axis", "a0", "a1", "b0", "b1", "k", "mat_id")
MESH_FIELDS = ("verts", "normals", "uvs", "indices", "mat_id", "cluster_id",
               "cluster_bmin", "cluster_bmax", "tri_soa", "bounds8")
MATERIAL_FIELDS = ("mtype", "albedo", "albedo_tex", "roughness",
                   "roughness_tex", "strength", "strength_tex", "ior",
                   "metallness", "metallness_tex")
TEXTURE_FIELDS = ("ttype", "solid", "solid2", "atlas", "offset", "width",
                  "height")
CAMERA_FIELDS = ("origin", "lower_left_corner", "horizontal", "vertical",
                 "u", "v", "w", "lens_radius")
TRANSFORM_FIELDS = ("translate", "scale", "quat")


def _np(module, fields) -> dict:
    return {f: getattr(module, f).detach().cpu().numpy() for f in fields}


def _rects(d: dict) -> ir.RectTable:
    return ir.RectTable(**{f: np.asarray(d[f]) for f in RECT_FIELDS})


def _transform(d) -> ir.Transform:
    if d is None:
        return None
    return ir.Transform(np.asarray(d["translate"]), np.asarray(d["scale"]),
                        np.asarray(d["quat"]))


def _mesh(d: dict) -> ir.MeshGeom:
    if not d.get("use_bvh", True) or d.get("tri_soa") is None:
        raise NotImplementedError(
            "a mesh without a cluster BVH takes the dense triangle path, "
            "which is not ported yet: ROADMAP Queue 1 item 5")
    return ir.MeshGeom(**{f: np.asarray(d[f]) for f in MESH_FIELDS})


def scene_from_arrays(d: dict) -> ir.SceneIR:
    """Nested dict of numpy arrays (layout above) -> the port's SceneIR,
    on the CPU."""
    sp = d.get("spheres")
    if sp is not None and np.asarray(sp["center"]).reshape(-1, 3).shape[0]:
        raise NotImplementedError(
            "spheres are not ported yet: ROADMAP Queue 1 item 5")
    if d.get("media"):
        raise NotImplementedError(
            "participating media are not ported yet: ROADMAP Queue 1 "
            "item 10")
    tex = d["textures"]
    if tex.get("bilinear", False):
        raise NotImplementedError(
            "bilinear textures (the fit's filtering) are not ported yet: "
            "ROADMAP Queue 1 item 13")
    instances = []
    for inst in d["instances"]:
        kind = inst["kind"]
        instances.append(ir.Instance(
            kind,
            rects=_rects(inst["rects"]) if kind == "rect" else None,
            mesh=_mesh(inst["mesh"]) if kind == "mesh" else None,
            transform=_transform(inst.get("transform"))))
    mats = d["materials"]
    return ir.SceneIR(
        rects=_rects(d["rects"]),
        instances=instances,
        materials=MaterialTable(
            **{f: np.asarray(mats[f]) for f in MATERIAL_FIELDS},
            present=mats["present"], textured=mats["textured"],
            tex_types=mats["tex_types"]),
        textures=TextureTable(
            **{f: np.asarray(tex[f]) for f in TEXTURE_FIELDS}),
        background_tex=int(np.asarray(d["background_tex"])))


def scene_to_arrays(scene: ir.SceneIR) -> dict:
    """The port's SceneIR -> nested dict of numpy arrays (layout above)."""
    instances = []
    for inst in scene.instances:
        mesh = None
        if inst.kind == "mesh":
            mesh = dict(_np(inst.mesh, MESH_FIELDS), use_bvh=True)
        instances.append({
            "kind": inst.kind,
            "rects": _np(inst.rects, RECT_FIELDS) if inst.kind == "rect"
            else None,
            "mesh": mesh,
            "transform": (_np(inst.transform, TRANSFORM_FIELDS)
                          if inst.transform is not None else None)})
    mats = scene.materials
    return {
        "rects": _np(scene.rects, RECT_FIELDS),
        "instances": instances,
        "materials": dict(_np(mats, MATERIAL_FIELDS), present=mats.present,
                          textured=mats.textured, tex_types=mats.tex_types),
        "textures": dict(_np(scene.textures, TEXTURE_FIELDS),
                         bilinear=False),
        "background_tex": int(scene.background_tex),
        "spheres": {"center": np.zeros((0, 3), np.float32),
                    "radius": np.zeros((0,), np.float32),
                    "mat_id": np.zeros((0,), np.int32)},
        "media": [],
    }


def camera_from_arrays(d: dict) -> Camera:
    """Camera dict -> the port's Camera (the lens is not ported)."""
    if d.get("use_lens", False):
        raise NotImplementedError(
            "the thin-lens camera is not ported yet (no YAML field reaches "
            "it): ROADMAP Queue 1 item 4")
    return Camera(*(np.asarray(d[f]) for f in CAMERA_FIELDS))


def camera_to_arrays(cam: Camera) -> dict:
    return dict(_np(cam, CAMERA_FIELDS), use_lens=False)
