"""Intersection and shading of the reference: the scene's tables on a
device, the nearest hit over rects and meshes, the miss lookup in the
environment map, emission and the three lobes (lambertian, metal,
diffuse light).

The arithmetic follows the renderer's formulas operation by operation
(Moller-Trumbore for the find; the watertight test for the fit's replay
of the winning triangle), so that on the same draws the reference takes
the same paths. The mesh find tests every triangle of every cluster whose
box the ray crosses and keeps the smallest t; on an exact tie it keeps the
triangle the renderer's find meets first, which is why the clusters are
the renderer's own (scene.clusters): the one met first is in the cluster
of least (box entry, index), and in it of least slot.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from . import rng
from .scene import LEAF, MAT_DIFFUSE_LIGHT, MAT_METAL, Scene

BIG = 1e30
T_MIN = 1e-3
EPS_F32 = 1.1920929e-07
PAIR_CHUNK = 32768      # (ray, cluster) pairs a pass of the leaf test


@dataclass
class Hits:
    hit: torch.Tensor
    t: torch.Tensor
    p: torch.Tensor
    normal: torch.Tensor
    front: torch.Tensor
    mat: torch.Tensor


def _closer(a: Hits, b: Hits) -> Hits:
    take = b.hit & (~a.hit | (b.t < a.t))
    t3 = take[:, None]
    return Hits(a.hit | b.hit, torch.where(take, b.t, a.t),
                torch.where(t3, b.p, a.p), torch.where(t3, b.normal, a.normal),
                torch.where(take, b.front, a.front),
                torch.where(take, b.mat, a.mat))


def _face(d, outward):
    front = (d * outward).sum(dim=-1) < 0.0
    return torch.where(front[:, None], outward, -outward), front


def _cross(a, b):
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz,
                        ax * by - ay * bx], dim=-1)


def _rotate(q, v):
    qv = q[1:4].expand_as(v)
    t = 2.0 * _cross(qv, v)
    return v + q[0:1] * t + _cross(qv, t)


def _conj(q):
    return torch.cat([q[:1], -q[1:]])


def normalize(v, eps: float = 0.0):
    n2 = (v * v).sum(dim=-1)
    if eps:
        n2 = torch.clamp(n2, min=eps * eps)
    return v * torch.rsqrt(n2)[..., None]


class _SafeArccos(torch.autograd.Function):
    """arccos of x clipped to [-1, 1], derivative -1 / sqrt(max(1 - x^2,
    1e-12)) (bounded at the poles)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.arccos(torch.clamp(x, -1.0, 1.0))

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        return grad * (-1.0 / torch.sqrt(torch.clamp(1.0 - x * x,
                                                     min=1e-12)))


class MeshTables:
    """One mesh on the device: corners for the fit's replay, and the leaf
    rows [v0 e1 e2] (K, 9, L), ids (K, L) and boxes (padded by 1e-4) of
    its clusters."""

    def __init__(self, mesh, device, dtype):
        f = dict(device=device, dtype=dtype)
        tri = mesh.verts[mesh.indices]                      # (T, 3, 3)
        v0 = tri[:, 0]
        rows = np.concatenate([v0, tri[:, 1] - v0, tri[:, 2] - v0], axis=1)
        k = len(mesh.groups)
        blk = np.zeros((k, LEAF, 9), np.float32)
        ids = np.full((k, LEAF), -1, np.int64)
        lo = np.zeros((k, 3), np.float32)
        hi = np.zeros((k, 3), np.float32)
        for i, g in enumerate(mesh.groups):
            blk[i, :len(g)] = rows[g]
            ids[i, :len(g)] = g
            lo[i] = tri[g].reshape(-1, 3).min(axis=0) - 1e-4
            hi[i] = tri[g].reshape(-1, 3).max(axis=0) + 1e-4
        self.blk = torch.as_tensor(blk.transpose(0, 2, 1).copy(), **f)
        self.ids = torch.as_tensor(ids, device=device)
        self.lo = torch.as_tensor(lo, **f)
        self.hi = torch.as_tensor(hi, **f)
        self.rows = torch.as_tensor(rows, **f)              # (T, 9)
        self.verts = torch.as_tensor(mesh.verts, **f)
        self.normals = torch.as_tensor(mesh.normals, **f)
        self.indices = torch.as_tensor(mesh.indices.astype(np.int64),
                                       device=device)
        self.corner_n = self.normals[self.indices]          # (T, 3, 3)
        self.mat = int(mesh.mat_id)
        self.translate = torch.as_tensor(mesh.translate, **f)
        self.scale = torch.as_tensor(mesh.scale, **f)
        self.quat = torch.as_tensor(mesh.quat, **f)
        self.transformed = mesh.transformed


class DeviceScene:
    """The scene's tables on `device`, floats in `dtype`."""

    def __init__(self, scene: Scene, device, dtype=torch.float32):
        f = dict(device=device, dtype=dtype)
        self.device, self.dtype = torch.device(device), dtype
        self.width, self.height = scene.width, scene.height
        self.cam = {k: torch.as_tensor(v, **f)
                    for k, v in scene.camera.items()}
        m = scene.materials
        self.mtype = torch.as_tensor(m["mtype"], device=device)
        self.present = {int(t) for t in m["mtype"]}
        self.mats = {k: torch.as_tensor(m[k], **f)
                     for k in ("albedo", "roughness", "strength", "ior",
                               "metallness")}
        self.rects = {k: torch.as_tensor(v, device=device,
                                         dtype=dtype if v.dtype == np.float32
                                         else torch.int64)
                      for k, v in scene.rects.items()}
        self.meshes = [MeshTables(ms, device, dtype) for ms in scene.meshes]
        self.bg_is_map = scene.background_is_map
        bg = np.asarray(scene.background, np.float32)
        if self.bg_is_map:
            self.bg_h, self.bg_w = bg.shape[:2]
            bg = bg.reshape(-1, 3)
        self.bg = torch.as_tensor(bg, **f)


# ----------------------------------------------------------------- finds

def _none(n, dev, dtype):
    z3 = torch.zeros((n, 3), device=dev, dtype=dtype)
    return Hits(torch.zeros((n,), dtype=torch.bool, device=dev),
                torch.full((n,), BIG, device=dev, dtype=dtype), z3, z3,
                torch.zeros((n,), dtype=torch.bool, device=dev),
                torch.full((n,), -1, dtype=torch.int64, device=dev))


def hit_rects(sc: DeviceScene, o, d) -> Hits:
    """The nearest rect in [T_MIN, BIG] (the plane of the rect's own axis,
    then its in-plane ranges), its one-hot normal faced against d."""
    r = sc.rects
    n_rect = r["axis"].shape[0]
    if n_rect == 0:
        return _none(o.shape[0], o.device, o.dtype)
    oc = [o[:, i, None] for i in range(3)]
    dc = [d[:, i, None] for i in range(3)]
    t = torch.zeros((o.shape[0], n_rect), device=o.device, dtype=o.dtype)
    pa, pb = torch.zeros_like(t), torch.zeros_like(t)
    par = torch.zeros(t.shape, dtype=torch.bool, device=o.device)
    for ax, (ia, ib) in enumerate(((1, 2), (0, 2), (0, 1))):
        sel = (r["axis"] == ax)[None, :]
        inv = 1.0 / torch.where(dc[ax] == 0.0, 1.0, dc[ax])
        t_ax = (r["k"][None, :] - oc[ax]) * inv
        t = torch.where(sel, t_ax, t)
        pa = torch.where(sel, oc[ia] + t_ax * dc[ia], pa)
        pb = torch.where(sel, oc[ib] + t_ax * dc[ib], pb)
        par = torch.where(sel, (dc[ax] == 0.0).expand_as(par), par)
    ok = (~par & (t >= T_MIN) & (t <= BIG) & (pa >= r["a0"][None, :])
          & (pa <= r["a1"][None, :]) & (pb >= r["b0"][None, :])
          & (pb <= r["b1"][None, :]))
    t = torch.where(ok, t, BIG)
    tb = t.min(dim=1).values
    lane = torch.arange(n_rect, device=o.device)
    ib = torch.where(t == tb[:, None], lane, n_rect).min(dim=1).values
    hit = tb < BIG
    safe = torch.clamp(ib, 0, n_rect - 1)
    ax = r["axis"][safe]
    p = o + torch.where(hit, tb, 1.0)[:, None] * d
    outward = torch.nn.functional.one_hot(ax, 3).to(o.dtype)
    nrm, front = _face(d, outward)
    return Hits(hit, torch.where(hit, tb, BIG), p, nrm, front,
                torch.where(hit, r["mat"][safe], -1))


def _leaf_t(o, d, blk):
    """Moller-Trumbore of A rays against L triangles each: o, d (A, 3),
    blk (A, 9, L) -> t, u, v (A, L) (t unmasked) and the masks."""
    ox, oy, oz = (o[:, c:c + 1] for c in range(3))
    dx, dy, dz = (d[:, c:c + 1] for c in range(3))
    v0x, v0y, v0z = blk[:, 0], blk[:, 1], blk[:, 2]
    e1x, e1y, e1z = blk[:, 3], blk[:, 4], blk[:, 5]
    e2x, e2y, e2z = blk[:, 6], blk[:, 7], blk[:, 8]
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    inv = 1.0 / torch.where(det == 0.0, 1.0, det)
    tx = ox - v0x
    ty = oy - v0y
    tz = oz - v0z
    u = (tx * px + ty * py + tz * pz) * inv
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv
    t = (e2x * qx + e2y * qy + e2z * qz) * inv
    good = ((det != 0.0) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
            & (t > 0.0) & (t <= BIG))
    return t, u, v, good


def mesh_find(mt: MeshTables, o, d, valid):
    """Nearest triangle of the mesh (object-space rays; t > 0, no t_min)
    -> (t (R,), BIG on a miss; triangle id (R,) int64, -1; interpolated
    normal (R, 3), zero on a miss). Without gradients."""
    with torch.no_grad():
        n = o.shape[0]
        dev, dt = o.device, o.dtype
        lo = hi = None
        for ax in range(3):
            o_ax, d_ax = o[:, ax:ax + 1], d[:, ax:ax + 1]
            inv = 1.0 / torch.where(d_ax.abs() < 1e-30, 1e-30, d_ax)
            t0 = (mt.lo[None, :, ax] - o_ax) * inv
            t1 = (mt.hi[None, :, ax] - o_ax) * inv
            lo_ax, hi_ax = torch.minimum(t0, t1), torch.maximum(t0, t1)
            lo = lo_ax if lo is None else torch.maximum(lo, lo_ax)
            hi = hi_ax if hi is None else torch.minimum(hi, hi_ax)
        entry = torch.clamp(lo, min=0.0)
        cand = (hi > entry) & (entry < BIG) & valid[:, None]
        ri, ki = cand.nonzero(as_tuple=True)
        e_pair = entry[ri, ki].float()
        lane = torch.arange(LEAF, device=dev)
        t_pair, slot = [], []
        for s in range(0, ri.shape[0], PAIR_CHUNK):
            r_c, k_c = ri[s:s + PAIR_CHUNK], ki[s:s + PAIR_CHUNK]
            t, _, _, good = _leaf_t(o[r_c], d[r_c], mt.blk[k_c])
            t = torch.where(good & (mt.ids[k_c] >= 0), t, BIG).float()
            t_min = t.min(dim=1).values
            t_pair.append(t_min)
            slot.append(torch.where(t == t_min[:, None], lane,
                                    LEAF).min(dim=1).values)
        t_pair = torch.cat(t_pair) if t_pair else e_pair
        slot = torch.cat(slot) if slot else ki
        # the winner: least t; on a tie the cluster met first, in order of
        # (entry, cluster index); in it the lowest slot
        t_best = torch.full((n,), float("inf"), device=dev).scatter_reduce(
            0, ri, t_pair, "amin")
        tie = (t_pair == t_best[ri]) & (t_pair < BIG)
        inf = torch.full((n,), float("inf"), device=dev)
        e_best = inf.scatter_reduce(0, ri, torch.where(tie, e_pair, inf[ri]),
                                    "amin")
        tie = tie & (e_pair == e_best[ri])
        k_none = torch.full((n,), 2 ** 62, device=dev)
        k_best = k_none.scatter_reduce(
            0, ri, torch.where(tie, ki, k_none[ri]), "amin")
        win = tie & (ki == k_best[ri])
        gid = torch.full((n,), -1, dtype=torch.int64, device=dev)
        gid[ri[win]] = mt.ids[ki[win], slot[win]]
        hit = gid >= 0
        # the winner's t and barycentrics again, by the same arithmetic
        safe = torch.clamp(gid, min=0)
        t, u, v, _ = _leaf_t(o, d, mt.rows[safe][:, :, None])
        t, u, v = t[:, 0], u[:, 0], v[:, 0]
        w0 = 1.0 - u - v
        cn = mt.corner_n[safe]
        nrm = (w0[:, None] * cn[:, 0] + u[:, None] * cn[:, 1]
               + v[:, None] * cn[:, 2])
        zero = torch.zeros((), device=dev, dtype=dt)
        return (torch.where(hit, t, BIG), gid,
                torch.where(hit[:, None], nrm, zero))


def _shear(d):
    kz = d.abs().argmax(dim=-1, keepdim=True)
    kx = (kz + 1) % 3
    return kx, (kx + 1) % 3, kz


def triangle_t(o, d, v0, v1, v2):
    """The watertight test (PBRT-3) of each ray against its own triangle,
    o, d, v0..v2 (R, 3) -> t (R,), BIG where missed."""
    kx, ky, kz = _shear(d)
    inv_dz = 1.0 / d.gather(1, kz)
    sx = -d.gather(1, kx) * inv_dz
    sy = -d.gather(1, ky) * inv_dz
    sz = inv_dz

    def perm(v):
        rel = v[:, None, :] - o[:, None, :]
        return tuple(rel.gather(2, k[:, :, None])[..., 0] for k in
                     (kx, ky, kz))

    p0x, p0y, p0z = perm(v0)
    p1x, p1y, p1z = perm(v1)
    p2x, p2y, p2z = perm(v2)
    p0x = p0x + sx * p0z
    p0y = p0y + sy * p0z
    p1x = p1x + sx * p1z
    p1y = p1y + sy * p1z
    p2x = p2x + sx * p2z
    p2y = p2y + sy * p2z
    e0 = p1x * p2y - p1y * p2x
    e1 = p2x * p0y - p2y * p0x
    e2 = p0x * p1y - p0y * p1x
    inside = ~(((e0 < 0) | (e1 < 0) | (e2 < 0))
               & ((e0 > 0) | (e1 > 0) | (e2 > 0)))
    det = e0 + e1 + e2
    ts = (e0 * p0z + e1 * p1z + e2 * p2z) * sz
    neg = (det < 0) & (ts < 0) & (ts >= BIG * det)
    pos = (det > 0) & (ts > 0) & (ts <= BIG * det)
    ok = inside & (det != 0) & (neg | pos)
    t = ts / torch.where(det == 0, 1.0, det)
    return torch.where(ok, t, BIG)[:, 0]


def triangle_bary(o, d, v0, v1, v2):
    """Barycentrics of each ray's own triangle by the watertight edge
    functions over their sum."""
    kx, ky, kz = _shear(d)
    dz = d.gather(1, kz)[:, 0]
    sx = -d.gather(1, kx)[:, 0] / dz
    sy = -d.gather(1, ky)[:, 0] / dz

    def perm(v):
        rel = v - o
        pz = rel.gather(1, kz)[:, 0]
        return (rel.gather(1, kx)[:, 0] + sx * pz,
                rel.gather(1, ky)[:, 0] + sy * pz)

    p0x, p0y = perm(v0)
    p1x, p1y = perm(v1)
    p2x, p2y = perm(v2)
    e0 = p1x * p2y - p1y * p2x
    e1 = p2x * p0y - p2y * p0x
    e2 = p0x * p1y - p0y * p1x
    det = e0 + e1 + e2
    inv = 1.0 / torch.where(det == 0, 1.0, det)
    return e0 * inv, e1 * inv, e2 * inv


def hit_mesh(mt: MeshTables, o, d, valid, replay: bool) -> Hits:
    """A mesh's hit, in world space through its transform if it has one
    (the normal then faced against the world ray; without one the normal
    stays as interpolated). replay=False: the find's
    own t and normal (the render). replay=True: the winner's t and
    barycentrics again by the watertight test from the vertices (the
    fit), keeping the find's t where the replay misses."""
    ob, db = o, d
    if mt.transformed:
        ob = _rotate(_conj(mt.quat), (o - mt.translate) / mt.scale)
        db = _rotate(_conj(mt.quat), d / mt.scale)
    t, gid, nrm = mesh_find(mt, ob.detach(), db.detach(), valid)
    hit = gid >= 0
    if replay:
        safe = torch.clamp(gid, min=0)
        idx = mt.indices[safe]
        c = [mt.verts[idx[:, i]] for i in range(3)]
        t_r = triangle_t(ob, db, c[0], c[1], c[2])
        t = torch.where(t_r < BIG, t_r, t)
        b0, b1, b2 = (b[:, None] for b in triangle_bary(ob, db, *c))
        n3 = [mt.normals[idx[:, i]] for i in range(3)]
        nrm = b0 * n3[0] + b1 * n3[1] + b2 * n3[2]
    p = ob + torch.where(hit, t, 1.0)[:, None] * db
    if mt.transformed:
        p = mt.scale * _rotate(mt.quat, p) + mt.translate
        nrm, front = _face(d, _rotate(mt.quat, nrm))
    else:
        front = (d * nrm).sum(dim=-1) < 0.0
    return Hits(hit, torch.where(hit, t, BIG), p, nrm, front,
                torch.where(hit, mt.mat, -1))


def intersect(sc: DeviceScene, o, d, valid, replay: bool = False) -> Hits:
    """The nearest hit over the rects, then each mesh."""
    best = _closer(_none(o.shape[0], o.device, o.dtype), hit_rects(sc, o, d))
    for mt in sc.meshes:
        best = _closer(best, hit_mesh(mt, o, d, valid, replay))
    return best


# ---------------------------------------------------------------- shading

def background(sc: DeviceScene, d):
    """Miss radiance: the environment map's nearest texel in the
    equirectangular direction (u = atan2(z, x) / 2pi + 0.5, v = acos(y) /
    pi; +0.5 rounding on dim - 1), or the solid colour."""
    if not sc.bg_is_map:
        return sc.bg.expand(d.shape[0], 3)
    nd = normalize(d)
    u = torch.atan2(nd[:, 2], nd[:, 0]) / (2.0 * math.pi) + 0.5
    v = _SafeArccos.apply(nd[:, 1]) / math.pi
    w, h = sc.bg_w, sc.bg_h
    i = (torch.clamp(u, 0.0, 1.0) * float(w - 1) + 0.5).to(torch.int32)
    j = (torch.clamp(v, 0.0, 1.0) * float(h - 1) + 0.5).to(torch.int32)
    idx = torch.clamp(j, 0, h - 1) * w + torch.clamp(i, 0, w - 1)
    return sc.bg[idx.long()]


def emitted(sc: DeviceScene, mats: dict, h: Hits):
    """Diffuse light's albedo * strength where hit; zero elsewhere."""
    if MAT_DIFFUSE_LIGHT not in sc.present:
        return torch.zeros(h.p.shape, device=h.p.device, dtype=h.p.dtype)
    mid = torch.clamp(h.mat, min=0)
    e = (torch.index_select(mats["albedo"], 0, mid)
         * torch.index_select(mats["strength"], 0, mid)[:, None])
    light = (sc.mtype[mid] == MAT_DIFFUSE_LIGHT) & h.hit
    return torch.where(light[:, None], e, torch.zeros_like(e))


def unit_sphere(key: tuple, n: int, device, dtype):
    """Uniform directions (n, 3) from the key's two split draws."""
    u = rng.uniforms([rng.fold(key, 0), rng.fold(key, 1)], n, device, dtype)
    return on_sphere(u[0], u[1])


def on_sphere(u1, u2):
    z = u1 * 2.0 - 1.0
    phi = u2 * (2.0 * math.pi)
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def scatter(sc: DeviceScene, mats: dict, d, h: Hits, sph):
    """(scattered, attenuation, new direction): lambertian (normal + a
    sphere direction, the normal where that is near zero), metal (reflect
    + min(|roughness|, 1) * sphere + FLT_EPSILON, absorbed unless it leaves
    above the normal); diffuse light does not scatter."""
    mid = torch.clamp(h.mat, min=0)
    mt = sc.mtype[mid]
    nrm = h.normal
    albedo = torch.index_select(mats["albedo"], 0, mid)
    lam = nrm + sph
    new_d = torch.where((lam.abs() < 1e-8).all(dim=-1)[:, None], nrm, lam)
    ok = mt != MAT_DIFFUSE_LIGHT
    if MAT_METAL in sc.present:
        rough = torch.index_select(mats["roughness"], 0, mid)
        unit_d = normalize(d)
        unit_n = normalize(nrm, eps=1e-12)
        r = torch.minimum(torch.where(rough >= 0.0, rough, -rough),
                          rough.new_ones(()))
        refl = unit_d - 2.0 * (unit_n * unit_d).sum(dim=-1)[:, None] * unit_n
        met = refl + r[:, None] * sph + EPS_F32
        met_ok = (met * unit_n).sum(dim=-1) > 0.0
        sel = mt == MAT_METAL
        new_d = torch.where(sel[:, None], met, new_d)
        ok = torch.where(sel, met_ok, ok)
    return ok & h.hit, albedo, new_d


def camera_rays(sc: DeviceScene, s, t):
    """Pinhole rays through (s, t) in [0, 1]: directions not normalized."""
    c = sc.cam
    d = (c["llc"] + s[:, None] * c["horizontal"]
         + t[:, None] * c["vertical"] - c["origin"])
    return c["origin"].expand(s.shape + (3,)).contiguous(), d


def tonemap(c, grad_eps: float = 0.0):
    """NaN to 0, +inf to 1e4; Narkowicz ACES; clamp to [0, 1]; gamma 2."""
    c = torch.nan_to_num(c, nan=0.0, posinf=1e4, neginf=0.0)
    c = (c * (2.51 * c + 0.03)) / (c * (2.43 * c + 0.59) + 0.14)
    c = torch.minimum(torch.maximum(c, c.new_zeros(())), c.new_ones(()))
    return torch.sqrt(c + grad_eps) if grad_eps else torch.sqrt(c)
