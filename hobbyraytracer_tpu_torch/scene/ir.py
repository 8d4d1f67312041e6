"""Scene tables as `nn.Module`s + world intersection (counterpart of
hobbyraytracer_tpu/scene/ir.py).

- untransformed spheres and rects are pooled into one `SphereTable` and
  one `RectTable`;
- each transformed object and each mesh is an `Instance` whose TRS
  `Transform` maps rays into object space on entry and hits back on exit;
- `SceneIR.to(device)` moves every table.

t stays in world units through the transforms (o' = q^-1((o-T)/S),
d' = q^-1(d/S)), as in the reference. Participating media are not ported
yet (ROADMAP Queue 1 item 10): nothing here holds them, and scene/build.py
and scene/convert.py refuse scenes that have them.

The pooled spheres take the reference's routing: the dense scan by
default, the clustered find of kernel K4 when `ops.intersect.SPHERE_KERNEL`
is set (HRT_SPHERE_KERNEL=1) and the table carries cluster tables. The
reference also asks whether its backend can run a Pallas kernel at all;
here the tensor's device decides (a CUDA tensor launches K4 or raises, a
CPU tensor runs the plain version), so that check has no counterpart.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..core import quat
from ..core.mathx import BIG, T_MIN
from ..core.types import Hits, Rays, as_buffer, closer, set_face_normal
from ..ops import intersect as isect
from ..ops.shade import MaterialTable
from ..ops.texture import TextureTable


def _buffers(module: nn.Module, **arrays) -> None:
    for name, (val, dtype) in arrays.items():
        module.register_buffer(name, as_buffer(val, dtype))


class Transform(nn.Module):
    """TRS instance transform: world = translate + scale * rotate(obj)
    (the reference's Translate(Scale(RotateQuat(obj))), scene.cpp:334-354).
    translate/scale (3,), quat (4,) [w, x, y, z]."""

    def __init__(self, translate, scale, quat_wxyz):
        super().__init__()
        f32 = torch.float32
        _buffers(self, translate=(translate, f32), scale=(scale, f32),
                 quat=(quat_wxyz, f32))

    def ray_to_object(self, rays: Rays) -> Rays:
        o = (rays.o - self.translate) / self.scale
        d = rays.d / self.scale
        return Rays(o=quat.inverse_rotate(self.quat, o),
                    d=quat.inverse_rotate(self.quat, d))

    def point_to_world(self, p: torch.Tensor) -> torch.Tensor:
        return self.scale * quat.rotate(self.quat, p) + self.translate

    def normal_to_world(self, n: torch.Tensor) -> torch.Tensor:
        # rotation only, like the reference (Scale does not rescale
        # normals, scale.cpp:24)
        return quat.rotate(self.quat, n)


class SphereTable(nn.Module):
    """S spheres: center (S, 3), radius (S,) float32, mat_id (S,) int32.
    Pools of scene/build.py:SPHERE_CLUSTER_MIN spheres or more also carry
    the cluster tables of kernel K4 (scene/bvh.py:build_sphere_clusters):
    kernel_table (K, 8, L) float32, kernel_bounds (8, K) float32 and
    kernel_ids (K, L) int32; None otherwise."""

    def __init__(self, center, radius, mat_id, kernel_table=None,
                 kernel_bounds=None, kernel_ids=None):
        super().__init__()
        f32, i32 = torch.float32, torch.int32
        _buffers(self, radius=(radius, f32), mat_id=(mat_id, i32))
        self.register_buffer("center", as_buffer(center, f32).reshape(-1, 3))
        for name, val, dtype in (("kernel_table", kernel_table, f32),
                                 ("kernel_bounds", kernel_bounds, f32),
                                 ("kernel_ids", kernel_ids, i32)):
            self.register_buffer(
                name, None if val is None else as_buffer(val, dtype))

    @property
    def empty(self) -> bool:
        return self.center.shape[0] == 0


class RectTable(nn.Module):
    """Q axis-aligned rects: axis (Q,) int32 normal axis 0/1/2, in-plane
    ranges a0..a1 / b0..b1 and plane offset k (Q,) float32, mat_id (Q,)
    int32."""

    def __init__(self, axis, a0, a1, b0, b1, k, mat_id):
        super().__init__()
        f32, i32 = torch.float32, torch.int32
        _buffers(self, axis=(axis, i32), a0=(a0, f32), a1=(a1, f32),
                 b0=(b0, f32), b1=(b1, f32), k=(k, f32), mat_id=(mat_id, i32))

    @property
    def empty(self) -> bool:
        return self.axis.shape[0] == 0


class MeshGeom(nn.Module):
    """One triangle mesh with its host-built cluster BVH and the fused
    kernel's tables (the reference's MeshGeom with use_bvh set):

    verts/normals (V, 3), uvs (V, 2), indices (T, 3) int32, mat_id ()
    int32; cluster_id (K, L) int32 global triangle ids (-1 pad);
    cluster_bmin/bmax (K, 3); tri_soa (K, 24, L), read by kernel K1, or
    the (K, 32, L) streaming layout with the ids bit-cast in row 24, read
    by kernel K2 (scene/build.py picks the layout by the reference's rule);
    bounds8 (8, K)."""

    def __init__(self, verts, normals, uvs, indices, mat_id, cluster_id,
                 cluster_bmin, cluster_bmax, tri_soa, bounds8):
        super().__init__()
        f32, i32 = torch.float32, torch.int32
        _buffers(self, verts=(verts, f32), normals=(normals, f32),
                 uvs=(uvs, f32), indices=(indices, i32),
                 mat_id=(mat_id, i32), cluster_id=(cluster_id, i32),
                 cluster_bmin=(cluster_bmin, f32),
                 cluster_bmax=(cluster_bmax, f32), tri_soa=(tri_soa, f32),
                 bounds8=(bounds8, f32))


class Instance(nn.Module):
    """One sphere table, rect table or mesh with an optional Transform."""

    def __init__(self, kind: str, rects: Optional[RectTable] = None,
                 mesh: Optional[MeshGeom] = None,
                 transform: Optional[Transform] = None,
                 spheres: Optional[SphereTable] = None):
        super().__init__()
        if kind not in ("sphere", "rect", "mesh"):
            raise ValueError(f"instance kind {kind!r}: expected 'sphere', "
                             "'rect' or 'mesh'")
        self.kind = kind
        self.spheres = spheres
        self.rects = rects
        self.mesh = mesh
        self.transform = transform


class SceneIR(nn.Module):
    """The whole scene: pooled spheres and rects, instances, materials,
    textures and the background texture id (a () int32 buffer). `spheres`
    defaults to an empty table."""

    def __init__(self, rects: RectTable, instances: Sequence[Instance],
                 materials: MaterialTable, textures: TextureTable,
                 background_tex: int,
                 spheres: Optional[SphereTable] = None):
        super().__init__()
        if spheres is None:
            spheres = SphereTable(np.zeros((0, 3), np.float32),
                                  np.zeros((0,), np.float32),
                                  np.zeros((0,), np.int32))
        self.spheres = spheres
        self.rects = rects
        self.instances = nn.ModuleList(instances)
        self.materials = materials
        self.textures = textures
        self.register_buffer("background_tex",
                             as_buffer(background_tex, torch.int32))


def _intersect_instance(inst: Instance, rays: Rays, t_min,
                        ray_valid=None, need_uv: bool = True,
                        plain: bool = False) -> Hits:
    r = inst.transform.ray_to_object(rays) if inst.transform else rays
    if inst.kind == "sphere":
        # a transformed sphere takes the dense scan, as in the reference
        sp = inst.spheres
        h = isect.intersect_spheres(r, sp.center, sp.radius, sp.mat_id,
                                    t_min, BIG)
    elif inst.kind == "rect":
        rt = inst.rects
        h = isect.intersect_rects(r, rt.axis, rt.a0, rt.a1, rt.b0, rt.b1,
                                  rt.k, rt.mat_id, t_min, BIG)
    else:
        m = inst.mesh
        h = isect.intersect_triangles_bvh(
            r, m.cluster_id, m.tri_soa, m.bounds8, m.mat_id, BIG,
            ray_valid=ray_valid, need_uv=need_uv, plain=plain)
    if inst.transform is not None:
        p = inst.transform.point_to_world(h.p)
        nrm = inst.transform.normal_to_world(h.normal)
        # the wrapper chain ends with setFaceNormal against the incoming
        # (world) ray (translate.cpp:16)
        nrm, front = set_face_normal(rays.d, nrm)
        h = Hits(hit=h.hit, t=h.t, p=p, normal=nrm, uv=h.uv,
                 front_face=front, mat_id=h.mat_id)
    return h


def intersect_scene(scene: SceneIR, rays: Rays, t_min: float = T_MIN,
                    ray_valid=None, plain: bool = False) -> Hits:
    """Closest hit against the whole scene (vectorized HittableList::hit):
    pooled spheres, pooled rects, then every instance, min-merged.

    ray_valid: optional (N,) bool of live wavefront lanes; dead lanes open
    no mesh or sphere clusters and report no hit there. plain=True runs the
    mesh find and the clustered sphere find through the kernels' plain
    PyTorch versions (a comparison switch).
    """
    n = rays.o.shape[0]
    best = Hits.none(n, rays.o.device)
    if not scene.spheres.empty:
        sp = scene.spheres
        # the reference's routing: the clustered find is opt-in
        # (isect.SPHERE_KERNEL) and needs the pool's cluster tables
        if isect.SPHERE_KERNEL and sp.kernel_table is not None:
            best = closer(best, isect.intersect_spheres_clustered(
                rays, sp.center, sp.radius, sp.mat_id, sp.kernel_table,
                sp.kernel_bounds, sp.kernel_ids, t_min, BIG,
                ray_valid=ray_valid, plain=plain))
        else:
            best = closer(best, isect.intersect_spheres(
                rays, sp.center, sp.radius, sp.mat_id, t_min, BIG))
    if not scene.rects.empty:
        rt = scene.rects
        best = closer(best, isect.intersect_rects(
            rays, rt.axis, rt.a0, rt.a1, rt.b0, rt.b1, rt.k, rt.mat_id,
            t_min, BIG))
    # no material samples a texture -> hit UVs are never read, and the
    # traversal kernel skips interpolating them
    need_uv = len(scene.materials.textured) > 0
    for inst in scene.instances:
        best = closer(best, _intersect_instance(inst, rays, t_min,
                                                ray_valid=ray_valid,
                                                need_uv=need_uv,
                                                plain=plain))
    return best
