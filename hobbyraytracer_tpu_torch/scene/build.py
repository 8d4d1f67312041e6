"""SceneDesc -> SceneIR + Camera + film config (counterpart of
hobbyraytracer_tpu/scene/build.py).

All asset I/O and table building happens here, on the host in numpy; the
result is built on the CPU and moved with `job.scene.to(device)`. Built
here: spheres (pooled, with the cluster tables of kernel K4 from
SPHERE_CLUSTER_MIN spheres up, or transformed instances), axis rects and
boxes (six rects; pooled, or transformed instances), meshes of every
format of scene/meshload.py with an optional transform (clustered from
BVH_MIN_TRIS triangles up, dense below),
standalone triangles (a dense mesh of one), constant media with a box,
sphere or mesh boundary and their isotropic phase materials, all seven
material types, textures (image textures through io/images.py) and the
background.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Dict, List

import numpy as np

from ..core import quat as quat_ops
from ..io import hdr as hdr_io
from ..io import images as img_io
from ..kernels import mesh_traverse as kmod
from ..ops import shade as shade_ops
from ..ops import texture as tex_ops
from ..ops.camera import Camera, make_camera
from . import ir, meshload
from .bvh import build_clusters, build_sphere_clusters
from .schema import MatValue, SceneDesc, TransformDesc

# meshes below this triangle count get no cluster BVH and take the dense
# scan (ops/intersect.py:intersect_triangles), as in the reference
BVH_MIN_TRIS = 64
# pooled sphere tables of this many spheres or more get the cluster tables
# of the sphere kernel (at least 2 clusters of 128); smaller pools have
# only the dense scan
SPHERE_CLUSTER_MIN = 129
BVH_LEAF_SIZE = 128

# The reference's choice between the 24-row resident table and the 32-row
# streaming table (hobbyraytracer_tpu/kernels/mesh_traverse.py:
# mesh_fits_vmem at its default BLOCK = 256). It is the TPU's rule: a
# budget of TPU VMEM, kept here only so the port's tables equal the
# reference's leaf for leaf. HRT_FORCE_STREAM=1 (read once at import, as
# the reference reads it) gives every mesh the streaming table, so that
# every mesh find runs kernel K2.
_TPU_BLOCK = 256
_TPU_VMEM_BUDGET_BYTES = 14 * 1024 * 1024
FORCE_STREAM = os.environ.get("HRT_FORCE_STREAM", "0") != "0"


def tpu_mesh_fits_vmem(k_clusters: int, leaf: int) -> bool:
    """The TPU rule: do the resident tables and a 256-ray block's working
    set fit the TPU kernel's VMEM budget? Never under HRT_FORCE_STREAM."""
    if FORCE_STREAM:
        return False
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
        """ImageTexture ctor (texture.cpp:30-51): 8-bit decode / 255; a
        file that cannot be read degrades to no data (debug cyan at
        lookup, texture.cpp:56-57). Any failure of the decoders counts,
        as in the reference and the JAX package: a corrupt file raises
        struct.error, KeyError or IndexError as well as ValueError."""
        rp = self.desc.resolve_path(path)
        try:
            data = img_io.read_image(rp)[:, :, :3].astype(np.float32) / 255.0
        except Exception:
            print(f"ERROR: Could not load image file: {path}")
            return None
        print(f"Loaded image file: {path}")
        return data

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
    """Mesh arrays; from BVH_MIN_TRIS triangles up also the host
    cluster-BVH build and the kernel's tables."""
    if int(m["indices"].shape[0]) < BVH_MIN_TRIS:
        return ir.MeshGeom(verts=m["verts"], normals=m["normals"],
                           uvs=m["uvs"], indices=m["indices"], mat_id=mat_id)
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


def _load_mesh(desc: SceneDesc, rel_path: str):
    """The mesh file's arrays, or None with the reference's message when it
    cannot be read (log and skip, mesh.cpp:58-61)."""
    try:
        m = meshload.load_mesh(desc.resolve_path(rel_path))
    except (OSError, ValueError) as e:
        print(f"ERROR: Couldn't load file: {rel_path} ({e})")
        return None
    print(f"Loaded file: {rel_path}")
    return m


def _box_rects(bmin, bmax, mat_id) -> List[dict]:
    """minMaxBox / Box ctor (box.h:11-39): 6 axis-aligned rects."""
    x0, y0, z0 = bmin
    x1, y1, z1 = bmax
    sides = ((2, (x0, x1), (y0, y1), (z1, z0)),     # xy rects at z1, z0
             (1, (x0, x1), (z0, z1), (y1, y0)),     # xz rects at y1, y0
             (0, (y0, y1), (z0, z1), (x1, x0)))     # yz rects at x1, x0
    return [{"axis": axis, "a0": a[0], "a1": a[1], "b0": b[0], "b1": b[1],
             "k": k, "mat_id": mat_id}
            for axis, a, b, ks in sides for k in ks]


def _sphere_table(centers, radii, mat_ids) -> ir.SphereTable:
    """A sphere table; from SPHERE_CLUSTER_MIN spheres up with the cluster
    tables of kernel K4."""
    center = np.asarray(centers, np.float32).reshape(-1, 3)
    radius = np.asarray(radii, np.float32).reshape(-1)
    tables = {}
    if center.shape[0] >= SPHERE_CLUSTER_MIN:
        sc = build_sphere_clusters(center, radius)
        tables = dict(kernel_table=sc["table"], kernel_bounds=sc["bounds8"],
                      kernel_ids=sc["ids"])
    return ir.SphereTable(center, radius,
                          np.asarray(mat_ids, np.int32).reshape(-1), **tables)


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

    pooled_spheres: Dict[str, list] = {"center": [], "radius": [],
                                       "mat_id": []}
    pooled_rects: List[dict] = []
    instances: List[ir.Instance] = []
    media: List[ir.Medium] = []
    for o in desc.objects:
        mat_id = None
        if o.type != "constant_medium":
            if o.material not in mat_by_name:
                # reference: log and skip (scene.cpp:288-289)
                print(f"Material {o.material} does not exist!")
                continue
            mat_id = mat_by_name[o.material]
        tr = _transform(o.transform) if o.transform else None
        if o.type == "sphere":
            if tr is None:
                pooled_spheres["center"].append(o.params["center"])
                pooled_spheres["radius"].append(o.params["radius"])
                pooled_spheres["mat_id"].append(mat_id)
            else:
                instances.append(ir.Instance(
                    "sphere", transform=tr, spheres=_sphere_table(
                        [o.params["center"]], [o.params["radius"]],
                        [mat_id])))
        elif o.type in _RECT_AXIS:
            row = {"axis": _RECT_AXIS[o.type],
                   "a0": o.params["a"][0], "a1": o.params["a"][1],
                   "b0": o.params["b"][0], "b1": o.params["b"][1],
                   "k": o.params["k"], "mat_id": mat_id}
            if tr is None:
                pooled_rects.append(row)
            else:
                instances.append(ir.Instance("rect", rects=_rect_table([row]),
                                             transform=tr))
        elif o.type == "box":
            rows = _box_rects(o.params["min"], o.params["max"], mat_id)
            if tr is None:
                pooled_rects.extend(rows)
            else:
                instances.append(ir.Instance("rect", rects=_rect_table(rows),
                                             transform=tr))
        elif o.type == "triangle":
            # a standalone triangle (triangle.h:6-19) is a dense mesh of
            # one, with its face normal at all three corners
            v = np.asarray([o.params["v0"], o.params["v1"], o.params["v2"]],
                           np.float32)
            n = np.cross(v[1] - v[0], v[2] - v[0])
            n = n / max(np.linalg.norm(n), 1e-12)
            geom = ir.MeshGeom(
                verts=v, normals=np.tile(n, (3, 1)),
                uvs=np.asarray([[0, 0], [1, 0], [1, 1]], np.float32),
                indices=np.asarray([[0, 1, 2]], np.int32), mat_id=mat_id)
            instances.append(ir.Instance("mesh", mesh=geom, transform=tr))
        elif o.type == "mesh":
            m = _load_mesh(desc, o.params["path"])
            if m is None:
                continue
            instances.append(ir.Instance("mesh", mesh=_mesh_geom(m, mat_id),
                                         transform=tr))
        elif o.type == "constant_medium":
            # the isotropic phase material goes after every material so
            # far: the named ones, and the phase materials of earlier media
            alb, alb_t = _mv3(o.params["albedo"], texb)
            phase_id = len(mat_specs)
            mat_specs.append({"mtype": shade_ops.MAT_ISOTROPIC,
                              "albedo": alb, "albedo_tex": alb_t})
            b = o.params["boundary"]
            common = dict(
                neg_inv_density=np.float32(-1.0 / o.params["density"]),
                mat_id=phase_id, transform=tr)
            if b["type"] == "sphere":
                media.append(ir.Medium("sphere", center=b["center"],
                                       radius=b["radius"], **common))
            elif b["type"] == "mesh":
                bm = _load_mesh(desc, b["path"])
                if bm is None:
                    continue
                media.append(ir.Medium("mesh", mesh=_mesh_geom(bm, phase_id),
                                       **common))
            else:
                media.append(ir.Medium("box", bmin=b["min"], bmax=b["max"],
                                       **common))
        else:
            raise NotImplementedError(f"object type {o.type!r}")

    scene = ir.SceneIR(
        rects=_rect_table(pooled_rects),
        instances=instances,
        materials=shade_ops.build_table(
            mat_specs, tex_ttypes=[s["type"] for s in texb.specs]),
        textures=tex_ops.build_table(texb.specs),
        background_tex=bg_id,
        spheres=_sphere_table(pooled_spheres["center"],
                              pooled_spheres["radius"],
                              pooled_spheres["mat_id"]),
        media=media)
    return RenderJob(scene=scene, camera=make_camera(
        desc.camera["position"], desc.camera["look_at"], desc.camera["up"],
        desc.camera["fov"], desc.film["width"] / desc.film["height"],
        desc.camera["aperture"], desc.camera["focal_distance"]),
        width=desc.film["width"], height=desc.film["height"],
        samples=desc.film["samples"], output=desc.film["output"])
