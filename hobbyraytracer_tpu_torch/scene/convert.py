"""Scenes and cameras to and from nested dicts of numpy arrays.

The JAX package's SceneIR / Camera, flattened to nested dicts of numpy
arrays, become the port's `SceneIR` / `Camera` here, so both packages can
trace the very same tables (what carrying weights across is for a model).
The dict layout follows the reference's pytree field names:

    scene = {"rects": {axis, a0, a1, b0, b1, k, mat_id},
             "instances": [{"kind": "sphere" | "rect" | "mesh",
                            "spheres": {...} | None,
                            "rects": {...} | None,
                            "mesh": {verts, normals, uvs, indices, mat_id,
                                     cluster_id, cluster_bmin,
                                     cluster_bmax, tri_soa, bounds8,
                                     use_bvh} | None,   # a dense mesh
                                     # (use_bvh False): the five cluster
                                     # tables None
                            "transform": {translate, scale, quat} | None}],
             "materials": {mtype, albedo, albedo_tex, roughness,
                           roughness_tex, strength, strength_tex, ior,
                           metallness, metallness_tex,
                           present, textured, tex_types},
             "textures": {ttype, solid, solid2, atlas, offset, width,
                          height, bilinear},
             "background_tex": int,
             "spheres": {center, radius, mat_id,
                         kernel_table, kernel_bounds, kernel_ids},
             "media": [{"btype": "sphere" | "box" | "mesh",
                        center, radius, bmin, bmax (None unless the
                        boundary's own), "mesh": {...} | None,
                        neg_inv_density, mat_id,
                        "transform": {...} | None}]}
    camera = {origin, lower_left_corner, horizontal, vertical, u, v, w,
              lens_radius, use_lens}

A mesh's tri_soa comes across in either layout: the 24-row resident
table (kernel K1) or the 32-row streaming table (kernel K2). A sphere
table's kernel_* entries are the cluster tables of kernel K4, or None (a
dict without them reads as None).

A fit's parameters cross the same way (`params_from_arrays` /
`params_to_arrays`): the dict of diff/fit.py:select_params, {"materials":
{albedo, roughness, strength, ior, metallness}, "verts": [(V, 3), ...]}
(no "verts" for a material fit), as numpy arrays on one side and leaf
tensors that require grad on the other, so that both packages start a fit
from the same point.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.camera import Camera
from ..ops.shade import MaterialTable
from ..ops.texture import TextureTable
from . import ir

SPHERE_FIELDS = ("center", "radius", "mat_id")
SPHERE_KERNEL_FIELDS = ("kernel_table", "kernel_bounds", "kernel_ids")
RECT_FIELDS = ("axis", "a0", "a1", "b0", "b1", "k", "mat_id")
MESH_BASE_FIELDS = ("verts", "normals", "uvs", "indices", "mat_id")
MESH_TABLE_FIELDS = ("cluster_id", "cluster_bmin", "cluster_bmax", "tri_soa",
                     "bounds8")
MESH_FIELDS = MESH_BASE_FIELDS + MESH_TABLE_FIELDS
MEDIUM_FIELDS = ("center", "radius", "bmin", "bmax", "neg_inv_density",
                 "mat_id")
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


def _optional_np(module, fields) -> dict:
    return {f: (None if getattr(module, f) is None
                else getattr(module, f).detach().cpu().numpy())
            for f in fields}


def _spheres(d) -> ir.SphereTable:
    if d is None:
        return None
    tables = {f: np.asarray(d[f]) for f in SPHERE_KERNEL_FIELDS
              if d.get(f) is not None}
    return ir.SphereTable(**{f: np.asarray(d[f]) for f in SPHERE_FIELDS},
                          **tables)


def _spheres_np(table: ir.SphereTable) -> dict:
    return dict(_np(table, SPHERE_FIELDS),
                **_optional_np(table, SPHERE_KERNEL_FIELDS))


def _rects(d: dict) -> ir.RectTable:
    return ir.RectTable(**{f: np.asarray(d[f]) for f in RECT_FIELDS})


def _transform(d) -> ir.Transform:
    if d is None:
        return None
    return ir.Transform(np.asarray(d["translate"]), np.asarray(d["scale"]),
                        np.asarray(d["quat"]))


def _mesh(d) -> ir.MeshGeom:
    if d is None:
        return None
    fields = MESH_FIELDS if d.get("use_bvh", True) else MESH_BASE_FIELDS
    return ir.MeshGeom(**{f: np.asarray(d[f]) for f in fields})


def _mesh_np(mesh: ir.MeshGeom) -> dict:
    return dict(_np(mesh, MESH_BASE_FIELDS),
                **_optional_np(mesh, MESH_TABLE_FIELDS),
                use_bvh=mesh.use_bvh)


def _medium(d: dict) -> ir.Medium:
    return ir.Medium(
        d["btype"], mesh=_mesh(d.get("mesh")),
        transform=_transform(d.get("transform")),
        **{f: np.asarray(d[f]) for f in MEDIUM_FIELDS
           if d.get(f) is not None})


def _medium_np(med: ir.Medium) -> dict:
    return dict(_optional_np(med, MEDIUM_FIELDS), btype=med.btype,
                mesh=None if med.mesh is None else _mesh_np(med.mesh),
                transform=(None if med.transform is None
                           else _np(med.transform, TRANSFORM_FIELDS)))


def scene_from_arrays(d: dict) -> ir.SceneIR:
    """Nested dict of numpy arrays (layout above) -> the port's SceneIR,
    on the CPU."""
    tex = d["textures"]
    instances = []
    for inst in d["instances"]:
        kind = inst["kind"]
        instances.append(ir.Instance(
            kind,
            spheres=_spheres(inst.get("spheres")) if kind == "sphere"
            else None,
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
            **{f: np.asarray(tex[f]) for f in TEXTURE_FIELDS},
            bilinear=bool(tex.get("bilinear", False))),
        background_tex=int(np.asarray(d["background_tex"])),
        spheres=_spheres(d.get("spheres")),
        media=[_medium(m) for m in d.get("media", ())])


def scene_to_arrays(scene: ir.SceneIR) -> dict:
    """The port's SceneIR -> nested dict of numpy arrays (layout above)."""
    instances = []
    for inst in scene.instances:
        mesh = _mesh_np(inst.mesh) if inst.kind == "mesh" else None
        instances.append({
            "kind": inst.kind,
            "spheres": _spheres_np(inst.spheres) if inst.kind == "sphere"
            else None,
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
                         bilinear=scene.textures.bilinear),
        "background_tex": int(scene.background_tex),
        "spheres": _spheres_np(scene.spheres),
        "media": [_medium_np(m) for m in scene.media],
    }


def params_from_arrays(d: dict, device="cpu") -> dict:
    """A fit's parameter dict of numpy arrays -> leaf float32 tensors on
    `device` that require grad (the layout of diff/fit.py:select_params)."""
    def leaf(a):
        return torch.tensor(np.asarray(a), dtype=torch.float32,
                            device=device, requires_grad=True)
    out = {"materials": {f: leaf(a) for f, a in d["materials"].items()}}
    if "verts" in d:
        out["verts"] = [leaf(v) for v in d["verts"]]
    return out


def params_to_arrays(params: dict) -> dict:
    """The port's fit parameters -> the same dict of numpy arrays."""
    def arr(t):
        return t.detach().cpu().numpy()
    out = {"materials": {f: arr(t) for f, t in params["materials"].items()}}
    if "verts" in params:
        out["verts"] = [arr(v) for v in params["verts"]]
    return out


def camera_from_arrays(d: dict) -> Camera:
    """Camera dict -> the port's Camera (use_lens False when absent)."""
    return Camera(*(np.asarray(d[f]) for f in CAMERA_FIELDS),
                  use_lens=bool(d.get("use_lens", False)))


def camera_to_arrays(cam: Camera) -> dict:
    return dict(_np(cam, CAMERA_FIELDS), use_lens=cam.use_lens)
