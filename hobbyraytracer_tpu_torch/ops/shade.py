"""Material table + batched emission and scatter (reference material.h;
counterpart of hobbyraytracer_tpu/ops/shade.py).

MatVec3/MatScalar (constant-or-texture) become (constant, tex_id) pairs
with tex_id == -1 meaning "use the constant". All seven lobes of the
reference are here: lambertian, metal, dielectric, diffuse_light,
isotropic, PBR and UVTest. The reference gathers every per-lane material
channel as one packed row (a TPU cost choice); here each channel is its own
`index_select` (`rows`), the same values.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .. import tracing
from ..core import mathx
from ..core import rng as rng_mod
from ..core.types import Hits, Rays, as_buffer
from . import texture as tex_ops

MAT_LAMBERTIAN = 0
MAT_METAL = 1
MAT_DIELECTRIC = 2
MAT_DIFFUSE_LIGHT = 3
MAT_ISOTROPIC = 4
MAT_PBR = 5
MAT_UVTEST = 6

_CHANNELS = ("albedo", "roughness", "strength", "metallness")


class MaterialTable(nn.Module):
    """M materials as buffers; index 0 is a reserved default lambertian.

    Static gating, as in the reference: `present` is the set of material
    types in the table (absent lobes draw nothing), `textured` the
    channels some material reads from a texture (the others skip the
    lookup), `tex_types` the texture types those channels can reach."""

    def __init__(self, mtype, albedo, albedo_tex, roughness, roughness_tex,
                 strength, strength_tex, ior, metallness, metallness_tex,
                 present, textured, tex_types):
        super().__init__()
        present = tuple(int(t) for t in present)
        i32, f32 = torch.int32, torch.float32
        for name, val, dt in (
                ("mtype", mtype, i32), ("albedo", albedo, f32),
                ("albedo_tex", albedo_tex, i32),
                ("roughness", roughness, f32),
                ("roughness_tex", roughness_tex, i32),
                ("strength", strength, f32),
                ("strength_tex", strength_tex, i32), ("ior", ior, f32),
                ("metallness", metallness, f32),
                ("metallness_tex", metallness_tex, i32)):
            self.register_buffer(name, as_buffer(val, dt))
        self.present = present
        self.textured = tuple(textured)
        self.tex_types = tuple(int(t) for t in tex_types)


def build_table(specs, tex_ttypes=None) -> MaterialTable:
    """specs: list of dicts with keys mtype, albedo, albedo_tex, roughness,
    roughness_tex, strength, strength_tex, ior, metallness, metallness_tex
    (missing keys get the reference's defaults). tex_ttypes: the texture
    table's ttype column; narrows tex_types to the types some material
    channel references."""
    def col(key, default, dtype=np.float32):
        return np.asarray([s.get(key, default) for s in specs], dtype)
    tex_types = (0, 1, 2, 3)
    if tex_ttypes is not None:
        tex_ttypes = [int(t) for t in tex_ttypes]
        used = set()
        for s in specs:
            for f in _CHANNELS:
                t = int(s.get(f + "_tex", -1))
                if 0 <= t < len(tex_ttypes):
                    used.add(tex_ttypes[t])
        tex_types = tuple(sorted(used))
    return MaterialTable(
        mtype=col("mtype", MAT_LAMBERTIAN, np.int32),
        albedo=col("albedo", (0.5, 0.5, 0.5)),
        albedo_tex=col("albedo_tex", -1, np.int32),
        roughness=col("roughness", 0.0),
        roughness_tex=col("roughness_tex", -1, np.int32),
        strength=col("strength", 1.0),
        strength_tex=col("strength_tex", -1, np.int32),
        ior=col("ior", 1.5),
        metallness=col("metallness", 0.0),
        metallness_tex=col("metallness_tex", -1, np.int32),
        present=tuple(sorted({int(s.get("mtype", MAT_LAMBERTIAN))
                              for s in specs})),
        textured=tuple(f for f in _CHANNELS
                       if any(int(s.get(f + "_tex", -1)) >= 0
                              for s in specs)),
        tex_types=tex_types)


def rows(table: torch.Tensor, mid: torch.Tensor) -> torch.Tensor:
    """table[mid]: the material rows of each lane, bit for bit, as an
    index_select. Its backward is an index_add_ into the table, where
    indexing's is the sort-based index_put_(accumulate=True), which sums
    the duplicates of an index one after another: a wavefront falls into a
    handful of materials, so every index has thousands of them."""
    return torch.index_select(table, 0, mid)


def _vec3_value(constant, tex_id, tab, u, v, p, textured, types):
    """MatVec3::valueAt — the constant unless tex_id >= 0."""
    if not textured:
        return constant
    from_tex = tex_ops.colour_value(tab, tex_id, u, v, p, types)
    return torch.where((tex_id >= 0)[..., None], from_tex, constant)


def _scalar_value(constant, tex_id, tab, u, v, p, textured, types):
    """MatScalar::valueAt — the constant or length(texture rgb)."""
    if not textured:
        return constant
    from_tex = tex_ops.scalar_value(tab, tex_id, u, v, p, types)
    return torch.where(tex_id >= 0, from_tex, constant)


def emitted(mats: MaterialTable, tab: tex_ops.TextureTable,
            hits: Hits) -> torch.Tensor:
    """Material::emitted: black except DiffuseLight's albedo * strength
    (material.h:67-70, 101-104). Returns (N, 3)."""
    if MAT_DIFFUSE_LIGHT not in mats.present:
        return torch.zeros(hits.t.shape + (3,), dtype=torch.float32,
                           device=hits.t.device)
    mid = torch.clamp(hits.mat_id, min=0).long()
    u, v = hits.uv[..., 0], hits.uv[..., 1]
    alb = _vec3_value(rows(mats.albedo, mid), rows(mats.albedo_tex, mid),
                      tab, u, v, hits.p, "albedo" in mats.textured,
                      mats.tex_types)
    s = _scalar_value(rows(mats.strength, mid), rows(mats.strength_tex, mid),
                      tab, u, v, hits.p, "strength" in mats.textured,
                      mats.tex_types)
    e = alb * s[..., None]
    is_light = (rows(mats.mtype, mid) == MAT_DIFFUSE_LIGHT) & hits.hit
    return torch.where(is_light[..., None], e, torch.zeros_like(e))


def scatter(mats: MaterialTable, tab: tex_ops.TextureTable, rays: Rays,
            hits: Hits, sampler, bounce: int, span=None) -> tuple:
    """Batched Material::scatter over the wavefront, drawing from `sampler`
    at iteration `bounce` (span: the rays are rows of a larger batch, see
    core/rng.py).

    Returns (did_scatter (N,) bool, attenuation (N, 3), new_d (N, 3)); the
    new origin is hits.p for every material. Each lobe follows its
    reference implementation (see the comments); a lobe whose type is not
    in `mats.present` computes and draws nothing, so the streams a scene
    uses are the reference's. Discrete decisions (absorb, reflect or
    refract) carry no gradient."""
    n = hits.t.shape[0]
    dev = hits.t.device
    mid = torch.clamp(hits.mat_id, min=0).long()
    mt = rows(mats.mtype, mid)
    u, v = hits.uv[..., 0], hits.uv[..., 1]
    p = hits.p
    nrm = hits.normal
    present = set(mats.present)
    has_metal = MAT_METAL in present
    has_dielectric = MAT_DIELECTRIC in present
    has_isotropic = MAT_ISOTROPIC in present
    has_pbr = MAT_PBR in present
    has_uvtest = MAT_UVTEST in present

    albedo = _vec3_value(rows(mats.albedo, mid), rows(mats.albedo_tex, mid),
                         tab, u, v, p, "albedo" in mats.textured,
                         mats.tex_types)
    if has_metal or has_dielectric or has_pbr:
        rough = _scalar_value(rows(mats.roughness, mid),
                              rows(mats.roughness_tex, mid), tab, u, v, p,
                              "roughness" in mats.textured, mats.tex_types)
    else:
        rough = torch.zeros((n,), dtype=torch.float32, device=dev)

    # one draw per purpose per iteration, shared by the lobes
    sph = sampler.unit_sphere(rng_mod.SCATTER_SPHERE, bounce, (n,), span)

    unit_d = mathx.normalize(rays.d)
    unit_n = (mathx.normalize(nrm, eps=1e-12) if has_metal or has_pbr
              else nrm)

    # Lambertian (material.h:132-157): normal + unit_sphere with the
    # near-zero fallback to the raw (unnormalized) hit normal
    lam_dir = nrm + sph
    new_d = torch.where(mathx.near_zero(lam_dir)[..., None], nrm, lam_dir)
    atten = albedo
    ok = mt != MAT_DIFFUSE_LIGHT

    if has_metal or has_pbr:
        # Metal (material.h:159-182): reflect(unit_d, unit_n) +
        # min(|roughness|, 1) * unit_sphere + FLT_EPSILON; absorbed when
        # dot(scattered, unit_n) <= 0. |r| as a select and the cap as a
        # minimum, so that their derivatives at 0 and at 1 (where the fit's
        # projection leaves a roughness) are the reference's: 1 and 1/2
        met_rough = torch.minimum(torch.where(rough >= 0.0, rough, -rough),
                                  rough.new_ones(()))
        met_dir = (mathx.reflect(unit_d, unit_n)
                   + met_rough[..., None] * sph + mathx.EPS_F32)
        met_ok = mathx.dot(met_dir, unit_n) > 0.0
        if has_metal:
            sel = mt == MAT_METAL
            new_d = torch.where(sel[..., None], met_dir, new_d)
            ok = torch.where(sel, met_ok, ok)

    if has_dielectric:
        # Dielectric (material.h:199-242): Schlick + stochastic reflect or
        # refract with the rough offset; attenuation (1, 1, 1). The raw hit
        # normal is used, and schlick gets the refraction ratio, both as
        # the reference passes them
        u_choice = sampler.uniform(rng_mod.DIELECTRIC_CHOICE, bounce, (n,),
                                   span)
        ior = rows(mats.ior, mid)
        ratio = torch.where(hits.front_face, 1.0 / ior, ior)
        cos_t = torch.clamp(mathx.dot(-unit_d, nrm), max=1.0)
        sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
        cannot = ratio * sin_t > 1.0
        refl_p = mathx.schlick(cos_t, ratio)
        choose_reflect = (cannot | (refl_p > u_choice)).detach()
        d_reflect = mathx.reflect(unit_d, nrm)
        d_refract = mathx.refract(unit_d, nrm, ratio)
        die_dir = (torch.where(choose_reflect[..., None], d_reflect,
                               d_refract) + rough[..., None] * sph)
        sel = mt == MAT_DIELECTRIC
        tracing.note_lanes("lanes.dielectric", lambda hits: sel)
        new_d = torch.where(sel[..., None], die_dir, new_d)
        atten = torch.where(sel[..., None], torch.ones_like(atten), atten)

    if has_isotropic:
        # Isotropic (material.h:73-89): a direction uniform in the ball
        ball = sampler.in_ball(rng_mod.SCATTER_BALL, bounce, (n,), span)
        new_d = torch.where((mt == MAT_ISOTROPIC)[..., None], ball, new_d)

    if has_pbr:
        # PBR (material.cpp:4-27): |metallness value| > 0.5 -> the metal
        # lobe, else lambertian; both share the albedo
        metl = _scalar_value(rows(mats.metallness, mid),
                             rows(mats.metallness_tex, mid), tab, u, v, p,
                             "metallness" in mats.textured, mats.tex_types)
        sel = (mt == MAT_PBR) & (metl.abs() > 0.5)
        new_d = torch.where(sel[..., None], met_dir, new_d)
        ok = torch.where(sel, met_ok, ok)

    if has_uvtest:
        # UVTest (material.h:111-130): lambertian scatter, attenuation =
        # the raw normal
        atten = torch.where((mt == MAT_UVTEST)[..., None], nrm, atten)

    return ok & hits.hit, atten, new_d
