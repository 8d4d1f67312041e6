"""Texture table + batched lookups (reference texture.h / texture.cpp;
counterpart of hobbyraytracer_tpu/ops/texture.py).

All image and environment pixels live in one flat float32 atlas; solid and
checkered textures are arithmetic; dispatch is a masked select over the
four texture types. Image and environment lookups are the reference's
nearest-neighbour ones, or bilinear with `TextureTable.bilinear` (an
extension of the JAX package for the differentiable fit: it makes uv and
direction gradients smooth instead of zero almost everywhere).
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..core.types import as_buffer

TEX_SOLID = 0       # SolidColourTexture (texture.h:9-25)
TEX_IMAGE = 1       # ImageTexture (texture.cpp:30-74)
TEX_CHECKERED = 2   # CheckeredTexture (texture.cpp:17-28)
TEX_ENVIRONMENT = 3  # EnvironmentMap (texture.cpp:76-115)

DEBUG_CYAN = (0.0, 1.0, 1.0)  # missing-data fallback (texture.cpp:56-57)


class TextureTable(nn.Module):
    """All scene textures as buffers. T >= 1; index 0 is a reserved solid
    white so material tables always hold a valid id.

    ttype/offset/width/height (T,) int32; solid/solid2 (T, 3) float32
    (solid colour / checkered even, checkered odd); atlas (Npix, 3)
    float32 with at least one row. `bilinear` (a plain attribute, like the
    reference's static field; default False) switches image and
    environment lookups from nearest-neighbour to bilinear filtering."""

    def __init__(self, ttype, solid, solid2, atlas, offset, width, height,
                 bilinear: bool = False):
        super().__init__()
        self.bilinear = bool(bilinear)
        i32, f32 = torch.int32, torch.float32
        for name, val, dt in (("ttype", ttype, i32), ("solid", solid, f32),
                              ("solid2", solid2, f32), ("atlas", atlas, f32),
                              ("offset", offset, i32), ("width", width, i32),
                              ("height", height, i32)):
            self.register_buffer(name, as_buffer(val, dt))


def build_table(specs) -> TextureTable:
    """specs: list of dicts {"type": int, "solid": (3,), "solid2": (3,),
    "image": (H, W, 3) float32 or None} -> TextureTable."""
    ttypes, solids, solids2, offsets, widths, heights = [], [], [], [], [], []
    atlas_parts = [np.zeros((1, 3), np.float32)]  # keep atlas non-empty
    cursor = 1
    for s in specs:
        ttypes.append(s["type"])
        solids.append(np.asarray(s.get("solid", (0, 0, 0)), np.float32))
        solids2.append(np.asarray(s.get("solid2", (0, 0, 0)), np.float32))
        img = s.get("image")
        if img is not None and img.size > 0:
            h, w, _ = img.shape
            atlas_parts.append(np.asarray(img, np.float32).reshape(-1, 3))
            offsets.append(cursor)
            widths.append(w)
            heights.append(h)
            cursor += h * w
        else:
            offsets.append(0)
            widths.append(0)   # width 0 => "no data" => debug cyan
            heights.append(0)
    return TextureTable(
        ttype=np.asarray(ttypes, np.int32),
        solid=np.stack(solids).astype(np.float32),
        solid2=np.stack(solids2).astype(np.float32),
        atlas=np.concatenate(atlas_parts, axis=0).astype(np.float32),
        offset=np.asarray(offsets, np.int32),
        width=np.asarray(widths, np.int32),
        height=np.asarray(heights, np.int32))


def colour_value(tab: TextureTable, tex_id: torch.Tensor, u: torch.Tensor,
                 v: torch.Tensor, p: torch.Tensor, types=None) -> torch.Tensor:
    """Batched Texture::colourValue. tex_id (N,) int32; u, v (N,); p (N, 3).

    `types` (optional): the texture types tex_id can reference; lookups of
    other types are skipped (None computes all four). Semantics as the
    reference: solid constant; checkered by the sign of
    sin(10x)sin(10y)sin(10z); image clamps u, flips v and truncates;
    environment clamps both and rounds with +0.5 on (dim-1), no v flip;
    image/environment without data give debug cyan."""
    if types is None:
        types = (TEX_SOLID, TEX_IMAGE, TEX_CHECKERED, TEX_ENVIRONMENT)
    types = set(types) | {TEX_SOLID}   # id < 0 falls back to texture 0
    tid = torch.clamp(tex_id, min=0).long()
    tt = tab.ttype[tid]
    w = tab.width[tid]
    h = tab.height[tid]
    off = tab.offset[tid]
    c_solid = tab.solid[tid]

    if TEX_CHECKERED in types:
        sines = (torch.sin(10.0 * p[..., 0]) * torch.sin(10.0 * p[..., 1])
                 * torch.sin(10.0 * p[..., 2]))
        c_check = torch.where((sines < 0.0)[..., None], tab.solid2[tid],
                              c_solid)
    else:
        c_check = c_solid

    uc = torch.clamp(u, 0.0, 1.0)
    wi = torch.clamp(w, min=1)
    hi = torch.clamp(h, min=1)
    n_atlas = tab.atlas.shape[0]

    def fetch(i, j):
        idx = (off + torch.minimum(torch.clamp(j, min=0), hi - 1) * wi
               + torch.minimum(torch.clamp(i, min=0), wi - 1))
        return tab.atlas[torch.clamp(idx, 0, n_atlas - 1).long()]

    def bilerp(x, y):
        """Sample at continuous texel coordinates (x, y): smooth in both."""
        x0 = torch.floor(x)
        y0 = torch.floor(y)
        fx = (x - x0)[..., None]
        fy = (y - y0)[..., None]
        i0 = x0.to(torch.int32)
        j0 = y0.to(torch.int32)
        return ((1 - fx) * (1 - fy) * fetch(i0, j0)
                + fx * (1 - fy) * fetch(i0 + 1, j0)
                + (1 - fx) * fy * fetch(i0, j0 + 1)
                + fx * fy * fetch(i0 + 1, j0 + 1))

    # made on the device by fills (a copy from the host could not be
    # captured into a CUDA graph)
    cyan = torch.stack([torch.full((), c, dtype=torch.float32,
                                   device=u.device) for c in DEBUG_CYAN])
    has_data = (w > 0)[..., None]

    if TEX_IMAGE in types:
        vc = 1.0 - torch.clamp(v, 0.0, 1.0)
        if tab.bilinear:
            c_img = bilerp(uc * (w - 1).float(), vc * (h - 1).float())
        else:  # nearest by truncation (texture.cpp:63-74)
            i_img = torch.minimum((uc * w.float()).to(torch.int32), wi - 1)
            j_img = torch.minimum((vc * h.float()).to(torch.int32), hi - 1)
            c_img = fetch(i_img, j_img)
        c_img = torch.where(has_data, c_img, cyan)
    else:
        c_img = c_solid

    if TEX_ENVIRONMENT in types:
        ve = torch.clamp(v, 0.0, 1.0)
        if tab.bilinear:
            c_env = bilerp(uc * (w - 1).float(), ve * (h - 1).float())
        else:  # +0.5 rounding on (dim - 1) (texture.cpp:86-97)
            i_env = (uc * (w - 1).float() + 0.5).to(torch.int32)
            j_env = (ve * (h - 1).float() + 0.5).to(torch.int32)
            c_env = fetch(i_env, j_env)
        c_env = torch.where(has_data, c_env, cyan)
    else:
        c_env = c_solid

    return torch.where((tt == TEX_SOLID)[..., None], c_solid,
           torch.where((tt == TEX_CHECKERED)[..., None], c_check,
           torch.where((tt == TEX_IMAGE)[..., None], c_img, c_env)))


def scalar_value(tab: TextureTable, tex_id, u, v, p, types=None):
    """MatScalar from a texture = length(rgb) (material.h:49)."""
    c = colour_value(tab, tex_id, u, v, p, types)
    return torch.sqrt((c * c).sum(dim=-1))
