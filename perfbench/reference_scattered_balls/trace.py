"""Intersection and shading of this reference: the shared reference's
(`perfbench.reference.trace`: the camera rays, the background, emission,
the lambertian and metal lobes, the film) with the pooled spheres and the
dielectric lobe added.

The sphere find is the program's default route, the dense scan: each ray
against every sphere by the half-b quadratic, the smaller root if it lies
in [T_MIN, BIG], else the larger; a ray counts as hitting from disc >= 0,
and the square root is taken of 1 where disc <= 0 (so at disc == 0 the
roots are (-half_b -+ 1) / a, as the program computes them). The closest
sphere is kept by a strict-< running minimum over the pool in its order,
so an exact tie goes to the earlier sphere. The hit record: p = o + t d,
the outward normal (p - center) / radius faced against the ray, and the
sphere's material.

The dielectric lobe (material.h:199-242 of upstream HobbyRaytracer, as the
program runs it): the ratio 1 / ior on a front face, ior on a back face;
with cos = min(dot(-unit d, n), 1) against the raw hit normal, total
internal reflection where ratio * sin > 1, else reflection where Schlick's
reflectance (given the ratio, as upstream passes it) exceeds the lane's
choice uniform, else refraction (zero where k < 0); plus roughness times
the lane's scatter-sphere direction; attenuation 1. The choice uniform is
the (DIELECTRIC_CHOICE, it) stream's, one a lane, which the render draws
into `DeviceScene.choice` before each iteration.
"""
from __future__ import annotations

import torch

from perfbench.reference import trace as shared
from perfbench.reference.trace import (BIG, T_MIN, Hits, _closer, _face,
                                       _none, normalize)
# the shared render's iteration reads these through this module (render.py)
from perfbench.reference.trace import (  # noqa: F401
    background, camera_rays, emitted, on_sphere, tonemap)

from .scene import MAT_DIELECTRIC, Scene

SPHERE_CHUNK = 128      # spheres a pass of the scan (bounds (R, chunk))


class DeviceScene(shared.DeviceScene):
    """The shared reference's tables on `device` and the sphere pool:
    center (S, 3), radius (S,) in `dtype`, sphere_mat (S,) int64. `choice`:
    the current iteration's dielectric choice uniforms (pool,), set by the
    render."""

    def __init__(self, scene: Scene, device, dtype=torch.float32):
        super().__init__(scene, device, dtype)
        f = dict(device=device, dtype=dtype)
        s = scene.spheres
        self.center = torch.as_tensor(s["center"], **f).reshape(-1, 3)
        self.radius = torch.as_tensor(s["radius"], **f)
        self.sphere_mat = torch.as_tensor(s["mat"], device=device).long()
        self.choice = None


def sphere_t(o, d, center, radius):
    """t of each ray (R, 3) against each sphere (S, 3), (S,) -> (R, S),
    BIG where missed (see the module's docstring)."""
    ox, oy, oz = (o[:, i, None] for i in range(3))
    dx, dy, dz = (d[:, i, None] for i in range(3))
    cx, cy, cz = (center[None, :, i] for i in range(3))
    ocx = ox - cx
    ocy = oy - cy
    ocz = oz - cz
    a = dx * dx + dy * dy + dz * dz
    half_b = ocx * dx + ocy * dy + ocz * dz
    c = ocx * ocx + ocy * ocy + ocz * ocz - (radius * radius)[None, :]
    disc = half_b * half_b - a * c
    sqrtd = torch.sqrt(torch.where(disc > 0.0, disc, 1.0))
    inv_a = 1.0 / a
    r1 = (-half_b - sqrtd) * inv_a
    r2 = (-half_b + sqrtd) * inv_a
    in1 = (r1 >= T_MIN) & (r1 <= BIG)
    in2 = (r2 >= T_MIN) & (r2 <= BIG)
    root = torch.where(in1, r1, torch.where(in2, r2, BIG))
    return torch.where(disc >= 0.0, root, BIG)


def hit_spheres(sc: DeviceScene, o, d) -> Hits:
    """The closest sphere of each ray by the dense scan, and its record."""
    n, s_all = o.shape[0], sc.center.shape[0]
    dev, dt = o.device, o.dtype
    if s_all == 0:
        return _none(n, dev, dt)
    t_best = torch.full((n,), BIG, device=dev, dtype=dt)
    i_best = torch.full((n,), -1, dtype=torch.int64, device=dev)
    for s in range(0, s_all, SPHERE_CHUNK):
        t = sphere_t(o, d, sc.center[s:s + SPHERE_CHUNK],
                     sc.radius[s:s + SPHERE_CHUNK])
        t_c = t.min(dim=1).values
        lane = torch.arange(t.shape[1], device=dev)
        i_c = torch.where(t == t_c[:, None], lane,
                          t.shape[1]).min(dim=1).values
        take = t_c < t_best
        t_best = torch.where(take, t_c, t_best)
        i_best = torch.where(take, i_c + s, i_best)
    hit = (t_best < BIG) & (i_best >= 0)
    safe = torch.clamp(i_best, 0, s_all - 1)
    c = sc.center[safe]
    r = torch.clamp(sc.radius[safe], min=1e-20)
    p = o + torch.where(hit, t_best, 1.0)[:, None] * d
    nrm, front = _face(d, (p - c) / r[:, None])
    return Hits(hit, torch.where(hit, t_best, BIG), p, nrm, front,
                torch.where(hit, sc.sphere_mat[safe], -1))


def intersect(sc: DeviceScene, o, d, valid, replay: bool = False) -> Hits:
    """The nearest hit: the spheres (the scene has nothing else)."""
    return _closer(_none(o.shape[0], o.device, o.dtype),
                   hit_spheres(sc, o, d))


def dielectric(sc: DeviceScene, mats: dict, d, h: Hits, sph):
    """The dielectric lobe on every lane -> (its lanes: hit a dielectric;
    new direction; of its lanes those that refracted, and those that met
    total internal reflection)."""
    mid = torch.clamp(h.mat, min=0)
    sel = (sc.mtype[mid] == MAT_DIELECTRIC) & h.hit
    ior = torch.index_select(mats["ior"], 0, mid)
    rough = torch.index_select(mats["roughness"], 0, mid)
    nrm = h.normal
    unit_d = normalize(d)
    ratio = torch.where(h.front, 1.0 / ior, ior)
    cos_t = torch.clamp(((-unit_d) * nrm).sum(dim=-1), max=1.0)
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    cannot = ratio * sin_t > 1.0
    r0 = (1.0 - ratio) / (1.0 + ratio)
    r0 = r0 * r0
    x = 1.0 - cos_t
    x2 = x * x
    reflect = cannot | (r0 + (1.0 - r0) * (x2 * x2 * x) > sc.choice)
    cos_i = (nrm * unit_d).sum(dim=-1)
    d_reflect = unit_d - 2.0 * cos_i[:, None] * nrm
    k = 1.0 - ratio * ratio * (1.0 - cos_i * cos_i)
    d_refract = (ratio[:, None] * unit_d
                 - (ratio * cos_i
                    + torch.sqrt(torch.where(k > 0.0, k, 1.0)))[:, None]
                 * nrm)
    d_refract = torch.where((k < 0.0)[:, None], torch.zeros_like(d_refract),
                            d_refract)
    new_d = (torch.where(reflect[:, None], d_reflect, d_refract)
             + rough[:, None] * sph)
    return sel, new_d, sel & ~reflect, sel & cannot


def scatter(sc: DeviceScene, mats: dict, d, h: Hits, sph):
    """(scattered, attenuation, new direction): the shared lobes, then the
    dielectric's direction and attenuation 1 on its lanes."""
    ok, atten, new_d = shared.scatter(sc, mats, d, h, sph)
    if MAT_DIELECTRIC not in sc.present:
        return ok, atten, new_d
    sel, die_d, _, _ = dielectric(sc, mats, d, h, sph)
    new_d = torch.where(sel[:, None], die_d, new_d)
    atten = torch.where(sel[:, None], torch.ones_like(atten), atten)
    return ok, atten, new_d
