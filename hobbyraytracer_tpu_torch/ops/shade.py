"""Material table + batched emission and scatter (reference material.h;
counterpart of hobbyraytracer_tpu/ops/shade.py).

MatVec3/MatScalar (constant-or-texture) become (constant, tex_id) pairs
with tex_id == -1 meaning "use the constant". The slice ports the
lambertian and diffuse_light lobes; a table holding any other material
type raises NotImplementedError (ROADMAP Queue 1 item 7).
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

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

PORTED_TYPES = (MAT_LAMBERTIAN, MAT_DIFFUSE_LIGHT)
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
        unported = sorted(set(present) - set(PORTED_TYPES))
        if unported:
            raise NotImplementedError(
                f"material types {unported} are not ported yet (only "
                "lambertian and diffuse_light): ROADMAP Queue 1 item 7")
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
    alb = _vec3_value(mats.albedo[mid], mats.albedo_tex[mid], tab, u, v,
                      hits.p, "albedo" in mats.textured, mats.tex_types)
    s = _scalar_value(mats.strength[mid], mats.strength_tex[mid], tab, u,
                      v, hits.p, "strength" in mats.textured,
                      mats.tex_types)
    e = alb * s[..., None]
    is_light = (mats.mtype[mid] == MAT_DIFFUSE_LIGHT) & hits.hit
    return torch.where(is_light[..., None], e, torch.zeros_like(e))


def scatter(mats: MaterialTable, tab: tex_ops.TextureTable, rays: Rays,
            hits: Hits, sampler, bounce: int) -> tuple:
    """Batched Material::scatter over the wavefront, drawing from `sampler`
    (stream SCATTER_SPHERE, `bounce`).

    Returns (did_scatter (N,) bool, attenuation (N, 3), new_d (N, 3)); the
    new origin is hits.p. Lambertian (material.h:132-157): normal +
    unit_sphere with the near-zero fallback to the raw (unnormalized) hit
    normal; diffuse_light absorbs."""
    n = hits.t.shape[0]
    mid = torch.clamp(hits.mat_id, min=0).long()
    mt = mats.mtype[mid]
    u, v = hits.uv[..., 0], hits.uv[..., 1]
    nrm = hits.normal
    albedo = _vec3_value(mats.albedo[mid], mats.albedo_tex[mid], tab, u, v,
                         hits.p, "albedo" in mats.textured, mats.tex_types)
    sph = sampler.unit_sphere(rng_mod.SCATTER_SPHERE, bounce, (n,))
    lam_dir = nrm + sph
    new_d = torch.where(mathx.near_zero(lam_dir)[..., None], nrm, lam_dir)
    ok = (mt != MAT_DIFFUSE_LIGHT) & hits.hit
    return ok, albedo, new_d
