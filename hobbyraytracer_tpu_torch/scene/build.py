"""SceneDesc -> SceneIR + Camera + film config (counterpart of
hobbyraytracer_tpu/scene/build.py).

All asset I/O and table building happens here, on the host in numpy; the
result is built on the CPU and moved with `job.scene.to(device)`. The slice
builds the object types scenes/teapot_scene.yaml uses: axis rects (pooled,
or transformed instances), OBJ meshes with an optional transform,
lambertian and diffuse_light materials, textures and the background.
Spheres, boxes, triangles and media raise NotImplementedError naming
their ROADMAP item, never silently.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List

import numpy as np

from ..core import quat as quat_ops
from ..io import hdr as hdr_io
from ..kernels import mesh_traverse as kmod
from ..ops import shade as shade_ops
from ..ops import texture as tex_ops
from ..ops.camera import Camera, make_camera
from . import ir, meshload
from .bvh import build_clusters
from .schema import MatValue, SceneDesc, TransformDesc

# meshes below this triangle count take the reference's dense path, which
# is not ported yet (ROADMAP Queue 1 item 5)
BVH_MIN_TRIS = 64
BVH_LEAF_SIZE = 128

# The reference's choice between the 24-row resident table and the 32-row
# streaming table (hobbyraytracer_tpu/kernels/mesh_traverse.py:
# mesh_fits_vmem at its default BLOCK = 256). It is the TPU's rule: a
# budget of TPU VMEM, kept here only so the port's tables equal the
# reference's leaf for leaf.
_TPU_BLOCK = 256
_TPU_VMEM_BUDGET_BYTES = 14 * 1024 * 1024


def tpu_mesh_fits_vmem(k_clusters: int, leaf: int) -> bool:
    """The TPU rule: do the resident tables and a 256-ray block's working
    set fit the TPU kernel's VMEM budget?"""
    tables = k_clusters * (32 * leaf * 4 + leaf * 4)
    block_ws = _TPU_BLOCK * k_clusters * 4 + 12 * _TPU_BLOCK * leaf * 4
    return tables + block_ws <= _TPU_VMEM_BUDGET_BYTES


@dataclass
class RenderJob:
    scene: ir.SceneIR
    camera: Camera
    width: int
    height: int
    samples: int
    output: str


class _TextureBuilder:
    def __init__(self, desc: SceneDesc):
        self.desc = desc
        self.specs: List[Dict[str, Any]] = []
        self.by_name: Dict[str, int] = {}
        # index 0: reserved solid white
        self._add({"type": tex_ops.TEX_SOLID, "solid": (1.0, 1.0, 1.0)})

    def _add(self, spec) -> int:
        self.specs.append(spec)
        return len(self.specs) - 1

    def _load_image(self, path: str):
        raise NotImplementedError(
            f"image texture {path!r}: the image codecs are not ported yet "
            "(ROADMAP Queue 1 item 16)")

    def _load_env(self, path: str):
        """EnvironmentMap ctor (texture.cpp:99-115): float HDR decode; a
        file that cannot be read degrades to no data (debug cyan)."""
        rp = self.desc.resolve_path(path)
        try:
            data = hdr_io.read_hdr(rp).astype(np.float32)
        except (OSError, ValueError):
            print(f"ERROR: Could not environment map file: {path}")
            return None
        print(f"Loaded environment map: {path}")
        return data

    def add_named(self, t) -> int:
        if t.type == "solid":
            idx = self._add({"type": tex_ops.TEX_SOLID, "solid": t.colour})
        elif t.type == "checkered":
            idx = self._add({"type": tex_ops.TEX_CHECKERED, "solid": t.even,
                             "solid2": t.odd})
        elif t.type == "image":
            idx = self._add({"type": tex_ops.TEX_IMAGE,
                             "image": self._load_image(t.path)})
        elif t.type == "environment":
            idx = self._add({"type": tex_ops.TEX_ENVIRONMENT,
                             "image": self._load_env(t.path)})
        else:
            raise ValueError(t.type)
        self.by_name[t.name] = idx
        return idx

    def resolve(self, name: str, auto: str = "image") -> int:
        """Texture by name; unknown names auto-create an image texture
        (scene.cpp:84-93) or an environment map for the background."""
        if name in self.by_name:
            return self.by_name[name]
        if auto == "environment":
            idx = self._add({"type": tex_ops.TEX_ENVIRONMENT,
                             "image": self._load_env(name)})
        else:
            idx = self._add({"type": tex_ops.TEX_IMAGE,
                             "image": self._load_image(name)})
        self.by_name[name] = idx
        return idx

    def solid(self, colour) -> int:
        return self._add({"type": tex_ops.TEX_SOLID, "solid": colour})


def _mv3(v: MatValue, texb: _TextureBuilder):
    """MatVec3 -> (constant rgb, tex_id)."""
    if v is None:
        return (0.0, 0.0, 0.0), -1
    if v.texture is not None:
        return (0.0, 0.0, 0.0), texb.resolve(v.texture)
    return v.constant, -1


def _ms(v: MatValue, texb: _TextureBuilder, default=0.0):
    """MatScalar -> (constant, tex_id)."""
    if v is None:
        return default, -1
    if v.texture is not None:
        return 0.0, texb.resolve(v.texture)
    return float(v.constant), -1


_MTYPE = {
    "lambertian": shade_ops.MAT_LAMBERTIAN,
    "metal": shade_ops.MAT_METAL,
    "dielectric": shade_ops.MAT_DIELECTRIC,
    "diffuse_light": shade_ops.MAT_DIFFUSE_LIGHT,
    "isotropic": shade_ops.MAT_ISOTROPIC,
    "pbr": shade_ops.MAT_PBR,
    "uvtest": shade_ops.MAT_UVTEST,
}
_RECT_AXIS = {"yz_rect": 0, "xz_rect": 1, "xy_rect": 2}
_NOT_PORTED = {
    "sphere": "ROADMAP Queue 1 item 5 (spheres)",
    "box": "ROADMAP Queue 1 item 10 (box objects)",
    "triangle": "ROADMAP Queue 1 item 5 (dense triangle path)",
    "constant_medium": "ROADMAP Queue 1 item 10 (media)",
}


def _transform(t: TransformDesc) -> ir.Transform:
    if t.rotate is not None:
        rot = quat_ops.from_euler(
            np.radians(np.asarray(t.rotate, np.float32))).numpy()
    else:
        rot = np.asarray([1.0, 0.0, 0.0, 0.0], np.float32)
    return ir.Transform(
        translate=np.asarray(t.translate or (0.0, 0.0, 0.0), np.float32),
        scale=np.asarray(t.scale or (1.0, 1.0, 1.0), np.float32),
        quat_wxyz=rot)


def _mesh_geom(m: dict, mat_id: int) -> ir.MeshGeom:
    """Mesh arrays + host cluster-BVH build + the kernel's tables."""
    n_tris = int(m["indices"].shape[0])
    if n_tris < BVH_MIN_TRIS:
        raise NotImplementedError(
            f"a {n_tris}-triangle mesh takes the reference's dense triangle "
            "path, which is not ported yet: ROADMAP Queue 1 item 5")
    cl = build_clusters(m["verts"], m["indices"], leaf_size=BVH_LEAF_SIZE)
    safe_id = np.maximum(cl["tri_id"], 0)
    corner = np.asarray(m["indices"])[safe_id]            # (K, L, 3)
    tri_soa = kmod.pack_mesh_soa(
        cl["tri_verts"], np.asarray(m["normals"], np.float32)[corner],
        np.asarray(m["uvs"], np.float32)[corner])
    k, leaf = cl["tri_id"].shape
    if not tpu_mesh_fits_vmem(k, leaf):
        tri_soa = kmod.pack_mesh_stream(tri_soa, cl["tri_id"])
    return ir.MeshGeom(
        verts=m["verts"], normals=m["normals"], uvs=m["uvs"],
        indices=m["indices"], mat_id=mat_id, cluster_id=cl["tri_id"],
        cluster_bmin=cl["bmin"], cluster_bmax=cl["bmax"], tri_soa=tri_soa,
        bounds8=kmod.pack_bounds(cl["bmin"], cl["bmax"]))


def _rect_table(rows) -> ir.RectTable:
    cols = {c: [r[c] for r in rows]
            for c in ("axis", "a0", "a1", "b0", "b1", "k", "mat_id")}
    return ir.RectTable(
        axis=np.asarray(cols["axis"], np.int32).reshape(-1),
        a0=np.asarray(cols["a0"], np.float32).reshape(-1),
        a1=np.asarray(cols["a1"], np.float32).reshape(-1),
        b0=np.asarray(cols["b0"], np.float32).reshape(-1),
        b1=np.asarray(cols["b1"], np.float32).reshape(-1),
        k=np.asarray(cols["k"], np.float32).reshape(-1),
        mat_id=np.asarray(cols["mat_id"], np.int32).reshape(-1))


def build_scene(desc: SceneDesc) -> RenderJob:
    """Build the scene tables (on the CPU) and the camera for `desc`."""
    texb = _TextureBuilder(desc)
    for t in desc.textures:
        texb.add_named(t)
    # background: sequence -> solid; name -> texture (auto environment)
    if isinstance(desc.background, tuple):
        bg_id = texb.solid(desc.background)
    else:
        bg_id = texb.resolve(desc.background, auto="environment")

    mat_specs: List[Dict[str, Any]] = [{"mtype": shade_ops.MAT_LAMBERTIAN}]
    mat_by_name: Dict[str, int] = {}
    for m in desc.materials:
        if m.type not in _MTYPE:
            print(f"Unknown material type: {m.type}, skipping")
            continue
        alb, alb_t = _mv3(m.albedo, texb)
        rough, rough_t = _ms(m.roughness, texb)
        stren, stren_t = _ms(m.strength, texb, default=1.0)
        ior, _ = _ms(m.ior, texb, default=1.5)
        metl, metl_t = _ms(m.metallness, texb)
        mat_by_name[m.name] = len(mat_specs)
        mat_specs.append({
            "mtype": _MTYPE[m.type], "albedo": alb, "albedo_tex": alb_t,
            "roughness": rough, "roughness_tex": rough_t,
            "strength": stren, "strength_tex": stren_t, "ior": ior,
            "metallness": metl, "metallness_tex": metl_t,
        })

    pooled_rects: List[dict] = []
    instances: List[ir.Instance] = []
    for o in desc.objects:
        if o.type in _NOT_PORTED:
            raise NotImplementedError(
                f"object type {o.type!r} is not ported yet: "
                f"{_NOT_PORTED[o.type]}")
        if o.material not in mat_by_name:
            # reference: log and skip (scene.cpp:288-289)
            print(f"Material {o.material} does not exist!")
            continue
        mat_id = mat_by_name[o.material]
        tr = _transform(o.transform) if o.transform else None
        if o.type in _RECT_AXIS:
            row = {"axis": _RECT_AXIS[o.type],
                   "a0": o.params["a"][0], "a1": o.params["a"][1],
                   "b0": o.params["b"][0], "b1": o.params["b"][1],
                   "k": o.params["k"], "mat_id": mat_id}
            if tr is None:
                pooled_rects.append(row)
            else:
                instances.append(ir.Instance("rect", rects=_rect_table([row]),
                                             transform=tr))
        elif o.type == "mesh":
            path = desc.resolve_path(o.params["path"])
            try:
                m = meshload.load_mesh(path)
            except (OSError, ValueError) as e:
                # log and skip, like the reference (mesh.cpp:58-61)
                print(f"ERROR: Couldn't load file: {o.params['path']} ({e})")
                continue
            print(f"Loaded file: {o.params['path']}")
            instances.append(ir.Instance("mesh", mesh=_mesh_geom(m, mat_id),
                                         transform=tr))
        else:
            raise NotImplementedError(f"object type {o.type!r}")

    scene = ir.SceneIR(
        rects=_rect_table(pooled_rects),
        instances=instances,
        materials=shade_ops.build_table(
            mat_specs, tex_ttypes=[s["type"] for s in texb.specs]),
        textures=tex_ops.build_table(texb.specs),
        background_tex=bg_id)
    return RenderJob(scene=scene, camera=make_camera(
        desc.camera["position"], desc.camera["look_at"], desc.camera["up"],
        desc.camera["fov"], desc.film["width"] / desc.film["height"],
        desc.camera["aperture"], desc.camera["focal_distance"]),
        width=desc.film["width"], height=desc.film["height"],
        samples=desc.film["samples"], output=desc.film["output"])
