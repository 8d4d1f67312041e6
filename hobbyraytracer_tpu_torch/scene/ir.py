"""Scene tables as `nn.Module`s + world intersection (counterpart of
hobbyraytracer_tpu/scene/ir.py).

- untransformed spheres and rects are pooled into one `SphereTable` and
  one `RectTable`;
- each transformed object and each mesh is an `Instance` whose TRS
  `Transform` maps rays into object space on entry and hits back on exit;
- constant media (`Medium`: sphere, box or closed-mesh boundary) are
  resolved after the solids, with the closest solid t as the far end of
  their window (constantMedium.cpp:4-38); their free-flight draw needs the
  sampler, so `intersect_scene` takes it and raises for a scene with media
  when it has none;
- `SceneIR.to(device)` moves every table; `replace` rebuilds a table or
  the scene with some buffers or parts swapped and shares the rest (the
  fit's way to put its parameters into a scene).

t stays in world units through the transforms (o' = q^-1((o-T)/S),
d' = q^-1(d/S)), as in the reference.

A mesh goes one of four ways. Without cluster tables (`use_bvh` false:
under scene/build.py:BVH_MIN_TRIS triangles, or a standalone triangle) it
takes the dense scan. With them, `mesh_backend` chooses: "kernel" (the
default; the reference's "auto" / "pallas") is the fused kernel over the
mesh's tables; "kernel_replay" (the reference's "auto_diff" /
"pallas_replay", the fit's) finds the winner through the same kernel
without gradients and replays it from the live vertices; "lockstep" (the
reference's "xla") is the exact lockstep find over the live vertices with
the cluster bounds recomputed from them, replayed the same way. A vertex
fit keeps the tables in step with its vertices through
`refresh_kernel_tables`. The tensor's device decides between a kernel and
its plain version (a CUDA tensor launches K1 / K2 or raises, a CPU tensor
runs the plain version), so the reference's platform checks
(_resolve_mesh_backend's TPU test, HRT_NO_PALLAS, HRT_PALLAS_INTERPRET)
have no counterpart, and nothing here moves from a kernel to the lockstep
find on its own.

The pooled spheres take the reference's routing: the dense scan by
default (on a CUDA tensor the sphere_scan kernel), the clustered find of
kernel K4 when `ops.intersect.SPHERE_KERNEL` is set (HRT_SPHERE_KERNEL=1)
and the table carries cluster tables. The reference also asks whether its
backend can run a Pallas kernel at all; here the tensor's device decides
(a CUDA tensor launches the kernel or raises, a CPU tensor runs the plain
version), so that check has no counterpart.
"""
from __future__ import annotations

import copy
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from .. import tracing
from ..core import quat
from ..core import rng as rng_mod
from ..core.mathx import BIG, T_MIN, length, ray_at
from ..core.types import Hits, Rays, as_buffer, closer, set_face_normal
from ..kernels import mesh_traverse as kmod
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
    """One triangle mesh: verts/normals (V, 3), uvs (V, 2), indices (T, 3)
    int32, mat_id () int32.

    With a host-built cluster BVH (the reference's use_bvh) it also holds
    the fused kernel's tables: cluster_id (K, L) int32 global triangle ids
    (-1 pad); cluster_bmin/bmax (K, 3); tri_soa (K, 24, L), read by kernel
    K1, or the (K, 32, L) streaming layout with the ids bit-cast in row 24,
    read by kernel K2 (scene/build.py picks the layout by the reference's
    rule); bounds8 (8, K). Without one (a small mesh, a standalone
    triangle) the five tables are None and the mesh takes the dense scan."""

    def __init__(self, verts, normals, uvs, indices, mat_id, cluster_id=None,
                 cluster_bmin=None, cluster_bmax=None, tri_soa=None,
                 bounds8=None):
        super().__init__()
        f32, i32 = torch.float32, torch.int32
        _buffers(self, verts=(verts, f32), normals=(normals, f32),
                 uvs=(uvs, f32), indices=(indices, i32),
                 mat_id=(mat_id, i32))
        tables = (("cluster_id", cluster_id, i32),
                  ("cluster_bmin", cluster_bmin, f32),
                  ("cluster_bmax", cluster_bmax, f32),
                  ("tri_soa", tri_soa, f32), ("bounds8", bounds8, f32))
        given = [val is not None for _, val, _ in tables]
        if any(given) != all(given):
            raise ValueError("a mesh has all five cluster tables or none")
        for name, val, dtype in tables:
            self.register_buffer(
                name, None if val is None else as_buffer(val, dtype))

    @property
    def use_bvh(self) -> bool:
        return self.cluster_id is not None


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


class Medium(nn.Module):
    """Constant-density medium (reference constantMedium.h/.cpp) inside a
    boundary `btype`: "sphere" (center (3,), radius ()), "box" (bmin, bmax
    (3,)) or "mesh" (a closed MeshGeom); the buffers of the other forms
    are None. neg_inv_density () = -1 / density; mat_id () int32 is the
    isotropic phase material; an optional Transform places the boundary."""

    def __init__(self, btype: str, neg_inv_density, mat_id, center=None,
                 radius=None, bmin=None, bmax=None,
                 mesh: Optional[MeshGeom] = None,
                 transform: Optional[Transform] = None):
        super().__init__()
        needs = {"sphere": (center, radius), "box": (bmin, bmax),
                 "mesh": (mesh,)}
        if btype not in needs:
            raise ValueError(f"medium boundary {btype!r}: expected 'sphere', "
                             "'box' or 'mesh'")
        if any(v is None for v in needs[btype]):
            raise ValueError(f"a {btype} medium needs its boundary's fields")
        self.btype = btype
        f32 = torch.float32
        _buffers(self, neg_inv_density=(neg_inv_density, f32),
                 mat_id=(mat_id, torch.int32))
        for name, val in (("center", center), ("radius", radius),
                          ("bmin", bmin), ("bmax", bmax)):
            self.register_buffer(
                name, None if val is None else as_buffer(val, f32))
        self.mesh = mesh
        self.transform = transform


class SceneIR(nn.Module):
    """The whole scene: pooled spheres and rects, instances, media,
    materials, textures and the background texture id (a () int32 buffer).
    `spheres` defaults to an empty table, `media` to none."""

    def __init__(self, rects: RectTable, instances: Sequence[Instance],
                 materials: MaterialTable, textures: TextureTable,
                 background_tex: int,
                 spheres: Optional[SphereTable] = None,
                 media: Sequence[Medium] = ()):
        super().__init__()
        if spheres is None:
            spheres = SphereTable(np.zeros((0, 3), np.float32),
                                  np.zeros((0,), np.float32),
                                  np.zeros((0,), np.int32))
        self.spheres = spheres
        self.rects = rects
        self.instances = nn.ModuleList(instances)
        self.media = nn.ModuleList(media)
        self.materials = materials
        self.textures = textures
        self.register_buffer("background_tex",
                             as_buffer(background_tex, torch.int32))


def replace(module: nn.Module, **fields) -> nn.Module:
    """A shallow copy of `module` with the named buffers or submodules
    swapped (the counterpart of flax's `.replace`); every other buffer and
    submodule is the original's own object. A swapped-in buffer may carry
    gradients: the fit puts its parameters into the scene so."""
    new = copy.copy(module)
    new._buffers = dict(module._buffers)
    new._modules = dict(module._modules)
    for name, val in fields.items():
        if name in new._buffers:
            new._buffers[name] = val
        elif name in new._modules:
            new._modules[name] = val
        else:
            raise ValueError(f"{type(module).__name__} has no buffer or "
                             f"submodule {name!r}")
    return new


def refresh_kernel_tables(m: MeshGeom) -> MeshGeom:
    """The mesh with its kernel tables (tri_soa, bounds8, cluster_bmin,
    cluster_bmax) rebuilt on its device from its live vertices, without
    gradients: pads masked out of the bounds and zeroed in the table, boxes
    inflated by 1e-4 as the host build inflates them. The table keeps the
    mesh's own layout, 24 or 32 rows.

    A vertex fit moves `verts` every step, and a find over the build-time
    tables would go on reporting hits where the triangles used to be. The
    tables feed only the find of "kernel_replay", which runs without
    gradients anyway; everything differentiable is replayed from the live
    vertices (ops/intersect.py:intersect_triangles_bvh). A mesh without
    cluster tables comes back as it is."""
    if not m.use_bvh:
        return m
    with torch.no_grad():
        v = m.verts.detach()
        corner = m.indices[torch.clamp(m.cluster_id, min=0).long()].long()
        pad = (m.cluster_id < 0)[..., None]                   # (K, L, 1)
        tri_verts = torch.where(pad[..., None], 0.0, v[corner])
        tmin = torch.where(pad, BIG, tri_verts.min(dim=2).values).min(
            dim=1).values - 1e-4
        tmax = torch.where(pad, -BIG, tri_verts.max(dim=2).values).max(
            dim=1).values + 1e-4
        soa = kmod.pack_mesh_soa_torch(tri_verts, m.normals[corner],
                                       m.uvs[corner])
        if m.tri_soa.shape[1] == kmod.STREAM_ROWS:
            soa = kmod.pack_mesh_stream_torch(soa, m.cluster_id)
        bounds8 = kmod.pack_bounds_torch(tmin, tmax)
    return replace(m, tri_soa=soa, bounds8=bounds8, cluster_bmin=tmin,
                   cluster_bmax=tmax)


MESH_BACKENDS = ("kernel", "kernel_replay", "lockstep")


def _live_clusters(m: MeshGeom):
    """Leaf vertices regathered from the mesh's live vertex array, and the
    cluster bounds recomputed from them (pads masked, boxes inflated by
    1e-4 like the host build's), detached: culling carries no derivative.
    -> (tri_verts (K, L, 3, 3), bmin (K, 3), bmax (K, 3))."""
    safe_id = torch.clamp(m.cluster_id, min=0).long()
    tri_verts = m.verts[m.indices[safe_id].long()]
    pad = (m.cluster_id < 0)[..., None]                   # (K, L, 1)
    tmin = torch.where(pad, BIG, tri_verts.min(dim=2).values)
    tmax = torch.where(pad, -BIG, tri_verts.max(dim=2).values)
    return (tri_verts, (tmin.min(dim=1).values - 1e-4).detach(),
            (tmax.max(dim=1).values + 1e-4).detach())


def _kernel_meshes(scene: SceneIR):
    """The mesh instances that go through the fused kernel."""
    return [inst for inst in scene.instances
            if inst.kind == "mesh" and inst.mesh.use_bvh]


def has_wavefront_sort_key(scene: SceneIR) -> bool:
    """Does wavefront_sort_key give a key for this scene? True when some
    mesh instance goes through the fused kernel."""
    return bool(_kernel_meshes(scene))


def finds_read_host(scene: SceneIR) -> bool:
    """Does intersect_scene read a value on the host on the default route?
    True when a medium is bounded by a clustered mesh: its span comes from
    the lockstep find (ops/intersect.py:intersect_mesh_clustered), which
    reads a count a visit round. No other find reads one (a kernel find is
    one launch), so such a scene's wavefront segment can be captured into a
    CUDA graph (integrator/wavefront.py:graph_route)."""
    return any(med.btype == "mesh" and med.mesh.use_bvh
               for med in scene.media)


def wavefront_sort_key(scene: SceneIR, rays: Rays, ray_valid=None):
    """Coherence sort key (N,) int32 for a whole wavefront, or None for a
    scene without a kernel mesh: cheap_key_from_box against the world-space
    union of every kernel mesh's root box (a transformed mesh adds the
    box of its root box's eight corners), so that rays heading for any of
    the meshes stay grouped. Always the octant form, whatever KEY_MODE
    says and however many clusters the meshes have: the reference keys its
    pool sort so."""
    bmin = bmax = None
    for inst in _kernel_meshes(scene):
        b8 = inst.mesh.bounds8
        lo = b8[:3, :].min(dim=1).values
        hi = b8[3:6, :].max(dim=1).values
        if inst.transform is not None:
            pick = torch.tensor([[(i >> ax) & 1 for ax in range(3)]
                                 for i in range(8)], dtype=torch.bool,
                                device=lo.device)
            wc = inst.transform.point_to_world(torch.where(pick, hi, lo))
            lo, hi = wc.min(dim=0).values, wc.max(dim=0).values
        bmin = lo if bmin is None else torch.minimum(bmin, lo)
        bmax = hi if bmax is None else torch.maximum(bmax, hi)
    if bmin is None:
        return None
    if ray_valid is None:
        ray_valid = torch.ones(rays.o.shape[:1], dtype=torch.bool,
                               device=rays.o.device)
    return isect.cheap_key_from_box(rays.o, rays.d, ray_valid, bmin, bmax,
                                    float(BIG))


def _intersect_instance(inst: Instance, rays: Rays, t_min,
                        ray_valid=None, need_uv: bool = True,
                        mesh_backend: str = "kernel",
                        mesh_cohsort=None) -> Hits:
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
        if not m.use_bvh:
            h = isect.intersect_triangles(r, m.verts, m.normals, m.uvs,
                                          m.indices, m.mat_id, BIG)
        elif mesh_backend == "kernel":
            h = isect.intersect_triangles_bvh(
                r, m.cluster_id, m.tri_soa, m.bounds8, m.mat_id, BIG,
                ray_valid=ray_valid, need_uv=need_uv, cohsort=mesh_cohsort)
        elif mesh_backend == "kernel_replay":
            h = isect.intersect_triangles_bvh(
                r, m.cluster_id, m.tri_soa, m.bounds8, m.mat_id, BIG,
                ray_valid=ray_valid, cohsort=mesh_cohsort,
                backend="kernel_replay", verts=m.verts, normals=m.normals,
                uvs=m.uvs, indices=m.indices)
        elif mesh_backend == "lockstep":
            tri_verts, bmin, bmax = _live_clusters(m)
            h = isect.intersect_triangles_bvh(
                r, m.cluster_id, None, None, m.mat_id, BIG,
                ray_valid=ray_valid, backend="lockstep", verts=m.verts,
                normals=m.normals, uvs=m.uvs, indices=m.indices,
                tri_verts=tri_verts, bmin=bmin, bmax=bmax)
        else:
            raise ValueError(f"mesh_backend {mesh_backend!r}: expected one "
                             f"of {MESH_BACKENDS}")
    if inst.transform is not None:
        p = inst.transform.point_to_world(h.p)
        nrm = inst.transform.normal_to_world(h.normal)
        # the wrapper chain ends with setFaceNormal against the incoming
        # (world) ray (translate.cpp:16)
        nrm, front = set_face_normal(rays.d, nrm)
        h = Hits(hit=h.hit, t=h.t, p=p, normal=nrm, uv=h.uv,
                 front_face=front, mat_id=h.mat_id)
    return h


def _mesh_first_t(m: MeshGeom, r: Rays, t_max):
    """Nearest-hit parameter against a mesh, t only: (t (R,), hit (R,)).
    A clustered mesh goes through the lockstep find over its live
    vertices, as in the reference; a small one through the dense scan."""
    if m.use_bvh:
        tri_verts, bmin, bmax = _live_clusters(m)
        t, _, hit = isect.intersect_mesh_clustered(
            r, tri_verts, m.cluster_id, bmin, bmax, t_max)
        return t, hit
    h = isect.intersect_triangles(r, m.verts, m.normals, m.uvs, m.indices,
                                  m.mat_id, t_max)
    return h.t, h.hit


def _medium_span(med: Medium, r: Rays):
    """Where the ray is inside the boundary, in the ray's own parameter:
    (t_enter (R,), t_exit (R,), valid (R,) bool)."""
    if med.btype == "sphere":
        oc = r.o - med.center
        a = (r.d * r.d).sum(dim=-1)
        half_b = (oc * r.d).sum(dim=-1)
        c = (oc * oc).sum(dim=-1) - med.radius * med.radius
        disc = half_b * half_b - a * c
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        return (-half_b - sq) / a, (-half_b + sq) / a, disc > 0.0
    if med.btype == "box":
        lo = hi = None
        for ax in range(3):
            # an axis-parallel ray divides by zero here, as in the
            # reference: +-inf bounds, or NaN on a face, which the min/max
            # order below carries the same way
            inv = 1.0 / r.d[:, ax]
            t0 = (med.bmin[ax] - r.o[:, ax]) * inv
            t1 = (med.bmax[ax] - r.o[:, ax]) * inv
            lo_ax = torch.minimum(t0, t1)
            hi_ax = torch.maximum(t0, t1)
            lo = lo_ax if lo is None else torch.maximum(lo, lo_ax)
            hi = hi_ax if hi is None else torch.minimum(hi, hi_ax)
        return lo, hi, hi > lo
    # mesh: the first hit is the entry, and the exit is the first hit of a
    # ray cast again from just past it. A ray that starts inside a closed
    # boundary sees its first hit as the exit (span [0, t1]); a non-convex
    # boundary gives its first span only, as in the reference.
    t1, h1 = _mesh_first_t(med.mesh, r, BIG)
    eps = 1e-4  # constantMedium.cpp:11
    o2 = r.o + r.d * (t1 + eps)[:, None]
    t2r, h2 = _mesh_first_t(med.mesh, Rays(o=o2, d=r.d), BIG)
    t2 = t1 + eps + t2r
    return torch.where(h2, t1, 0.0), torch.where(h2, t2, t1), h1


def _intersect_medium(med: Medium, rays: Rays, sampler, bounce,
                      med_index: int, t_min, t_max, span=None) -> Hits:
    """ConstantMedium::hit for a wavefront (constantMedium.cpp:4-38): the
    two boundary hits, clamped to [t_min, t_max] (t_max a float or (R,)),
    an exponential free flight drawn from the stream (MEDIUM_FLIGHT,
    bounce * 131 + med_index; span: the rays are rows of a larger batch),
    and a scatter point where it ends inside."""
    r = med.transform.ray_to_object(rays) if med.transform else rays
    t1, t2, valid = _medium_span(med, r)
    valid = valid & (t2 > t1 + 1e-4)
    t1 = torch.clamp(t1, min=t_min)
    t2 = torch.minimum(t2, torch.as_tensor(t_max, dtype=t2.dtype,
                                           device=t2.device))
    valid = valid & (t1 < t2)
    ray_len = length(rays.d)   # t is in world units of the ray's parameter
    dist_inside = (t2 - t1) * ray_len
    u = sampler.uniform(rng_mod.MEDIUM_FLIGHT, bounce * 131 + med_index,
                        t1.shape, span)
    hit_dist = med.neg_inv_density * torch.log(torch.clamp(u, min=1e-37))
    valid = valid & (hit_dist <= dist_inside)
    t = t1 + hit_dist / ray_len
    n = rays.o.shape[0]
    dev = rays.o.device
    return Hits(
        hit=valid, t=torch.where(valid, t, BIG),
        p=ray_at(rays.o, rays.d, torch.where(valid, t, 1.0)),
        normal=torch.nn.functional.one_hot(
            torch.zeros((n,), dtype=torch.int64, device=dev), 3).to(
                torch.float32),
        uv=torch.zeros((n, 2), dtype=torch.float32, device=dev),
        front_face=torch.ones((n,), dtype=torch.bool, device=dev),
        mat_id=torch.where(valid, med.mat_id, -1).to(torch.int32))


def sphere_route(scene: SceneIR, mesh_backend: str = "kernel"):
    """How intersect_scene finds the pooled spheres: "clustered" (kernel
    K4; the reference's routing: opt-in by isect.SPHERE_KERNEL, with the
    pool's cluster tables and a kernel mesh backend), "dense" (the scan,
    the default), or None without pooled spheres."""
    sp = scene.spheres
    if sp.empty:
        return None
    if (isect.SPHERE_KERNEL and sp.kernel_table is not None
            and mesh_backend in ("kernel", "kernel_replay")):
        return "clustered"
    return "dense"


def intersect_scene(scene: SceneIR, rays: Rays, t_min: float = T_MIN,
                    ray_valid=None, sampler=None,
                    bounce: int = 0, mesh_backend: str = "kernel",
                    mesh_cohsort=None, rng_span=None) -> Hits:
    """Closest hit against the whole scene (vectorized HittableList::hit):
    pooled spheres, pooled rects, then every instance, min-merged; media
    last, each with the closest hit so far as the far end of its window.

    ray_valid: optional (N,) bool of live wavefront lanes; dead lanes open
    no mesh or sphere clusters and report no hit there. sampler and bounce
    (the sampler's stream index: the wavefront's iteration, or the batch
    integrator's bounce) feed the media's free-flight draws; a scene with
    media and no sampler raises. mesh_backend: "kernel", "kernel_replay"
    or "lockstep", see the module docstring. mesh_cohsort=False tells
    every mesh find that the rays are sorted already. rng_span: the rays
    are rows of a larger batch, and the media's draws take those rows of
    the batch's draw (core/rng.py).
    """
    if len(scene.media) and sampler is None:
        raise ValueError("the scene has participating media: intersect_scene "
                         "needs the sampler (and the bounce) for their "
                         "free-flight draws")
    n = rays.o.shape[0]
    best = Hits.none(n, rays.o.device)
    route = sphere_route(scene, mesh_backend)
    if route is not None:
        sp = scene.spheres
        with tracing.subphase("segment.find.spheres", inside="segment.find"):
            if route == "clustered":
                sph = isect.intersect_spheres_clustered(
                    rays, sp.center, sp.radius, sp.mat_id, sp.kernel_table,
                    sp.kernel_bounds, sp.kernel_ids, t_min, BIG,
                    ray_valid=ray_valid)
            else:
                sph = isect.intersect_spheres(
                    rays, sp.center, sp.radius, sp.mat_id, t_min, BIG)
        # the closest hit is a sphere where nothing later is strictly closer
        tracing.note_lanes("lanes.sphere_hit",
                           lambda final: sph.hit & (final.t == sph.t))
        best = closer(best, sph)
    if not scene.rects.empty:
        rt = scene.rects
        best = closer(best, isect.intersect_rects(
            rays, rt.axis, rt.a0, rt.a1, rt.b0, rt.b1, rt.k, rt.mat_id,
            t_min, BIG))
    # no material samples a texture -> hit UVs are never read, and the
    # traversal kernel skips interpolating them
    need_uv = len(scene.materials.textured) > 0
    for inst in scene.instances:
        best = closer(best, _intersect_instance(
            inst, rays, t_min, ray_valid=ray_valid, need_uv=need_uv,
            mesh_backend=mesh_backend, mesh_cohsort=mesh_cohsort))
    for i, med in enumerate(scene.media):
        best = closer(best, _intersect_medium(med, rays, sampler, bounce, i,
                                              t_min, best.t, rng_span))
    return best
