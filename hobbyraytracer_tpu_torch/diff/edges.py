"""Edge-sampled visibility gradients for vertex positions (counterpart of
hobbyraytracer_tpu/diff/edges.py).

The shading-chain vertex gradients of diff/fit.py miss the discontinuous
part of the pixel integral: moving a vertex sweeps the mesh's silhouette
across pixels, and hit/miss has no derivative. The missing term is a
boundary integral over the silhouette edges (Li et al. 2018,
"Differentiable Monte Carlo Ray Tracing through Edge Sampling"), estimated
here for primary visibility by sampling points on the silhouette edges in
image space:

    dL/dθ += (1/A_pix) Σ_edges ∮ w(x) (f_in(x) - f_out(x))
                               (n̂(x) · ∂x_img/∂θ) dl

w is the per-pixel loss weight, f_in / f_out the radiance on the two
sides of the edge (the forward integrator at x ± ε n̂), n̂ the image-space
edge normal, and ∂x_img/∂θ the image-space velocity of the edge point (a
vector-Jacobian product through the camera projection).

`shadow_boundary_grad` does the same for the shadow a blocker casts from a
compact emitter at l: the blocker's l-silhouette edges are projected
through l onto the receiver's local tangent plane (found by one forward
cast) and then through the camera, and the estimator follows that whole
chain. The emitter is treated as a point (exact in the small-emitter
limit; eps_px should span the penumbra).

Edge picks and positions draw from the sampler's streams EDGE_PICK /
EDGE_S (and EDGE_PICK_SH / EDGE_S_SH for shadows), iteration 0.
"""
from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from ..core import rng as rng_mod
from ..core.mathx import cross
from ..core.types import Rays
from ..ops.camera import Camera, get_rays


def build_edge_table(indices: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Host side: the mesh's unique undirected edges and their faces.

    indices (T, 3) int -> (edges (E, 2) int32 vertex ids, efaces (E, 2)
    int32 face ids, -1 for a boundary edge's missing side)."""
    indices = np.asarray(indices)
    emap = {}
    for f, (a, b, c) in enumerate(indices):
        for i, j in ((a, b), (b, c), (c, a)):
            k = (min(int(i), int(j)), max(int(i), int(j)))
            if k in emap:
                emap[k].append(f)
            else:
                emap[k] = [f]
    edges = np.array(sorted(emap.keys()), np.int32).reshape(-1, 2)
    efaces = np.full((len(edges), 2), -1, np.int32)
    for r, k in enumerate(sorted(emap.keys())):
        fs = emap[k][:2]
        efaces[r, :len(fs)] = fs
    return edges, efaces


def project(cam: Camera, p: torch.Tensor) -> torch.Tensor:
    """World points (N, 3) -> image coordinates (N, 2) = (s, t), the
    parameters of ops/camera.py:get_rays: the origin -> p line met with the
    focal plane spanned by (horizontal, vertical) at lower_left_corner."""
    d = p - cam.origin
    f = -torch.dot(cam.lower_left_corner - cam.origin, cam.w)
    denom = d @ cam.w                      # negative for points in front
    alpha = -f / denom
    x = cam.origin + alpha[:, None] * d
    rel = x - cam.lower_left_corner
    s = (rel @ cam.u) / torch.dot(cam.horizontal, cam.u)
    t = (rel @ cam.v) / torch.dot(cam.vertical, cam.v)
    return torch.stack([s, t], dim=-1)


def silhouette_mask(verts, indices, edges, efaces,
                    cam_origin) -> torch.Tensor:
    """(E,) bool: the edge is on the silhouette seen from cam_origin, a
    boundary edge (one face) or one between faces facing opposite ways."""
    tri = verts[indices.long()]                           # (T, 3, 3)
    n = cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    centroid = tri.mean(dim=1)
    facing = (n * (centroid - cam_origin)).sum(dim=-1) < 0.0
    f0, f1 = efaces[:, 0].long(), efaces[:, 1].long()
    flip = (facing[torch.clamp(f0, min=0)]
            != facing[torch.clamp(f1, min=0)])
    return (f1 < 0) | flip


def _to_int(x: torch.Tensor) -> torch.Tensor:
    """float -> int64 as XLA converts to int32: NaN to 0, out of range
    saturated (here to +-2^30, far outside any image)."""
    return torch.clamp(torch.nan_to_num(x, nan=0.0), -2.0 ** 30,
                       2.0 ** 30).to(torch.int64)


def _edge_estimator(pull, x_img, pa_img, pb_img, valid, weight, width,
                    height, radiance_fn, n_edges, n_samples, eps_px, cam):
    """The boundary-integral estimator both terms share: given the
    image-space edge samples x_img (K, 2) (pull(cot) maps a (K, 2)
    cotangent back to the vertices), weight each sample by the two-sided
    radiance difference and the pixel's loss weight, and pull the
    image-space normal velocity back to the vertices."""
    # the image-space edge direction and its normal (the orientation
    # cancels in w * (f_- - f_+) * (n̂ · v), so either perpendicular works)
    ev = pb_img - pa_img
    elen = torch.linalg.norm(ev, dim=-1)
    ehat = ev / torch.clamp(elen, min=1e-12)[:, None]
    nhat = torch.stack([-ehat[:, 1], ehat[:, 0]], dim=-1)

    # radiance on both sides: two offset rays a sample
    eps = torch.tensor([eps_px / (width - 1), eps_px / (height - 1)],
                       dtype=torch.float32, device=x_img.device)
    x_p = x_img + eps * nhat
    x_m = x_img - eps * nhat
    f_p = radiance_fn(get_rays(cam, x_p[:, 0], x_p[:, 1]))
    f_m = radiance_fn(get_rays(cam, x_m[:, 0], x_m[:, 1]))

    # the loss weight at the sample's pixel (0 outside the image): pixel
    # (row r, col c) owns s in [c, c+1) / (W-1) and t in [y, y+1) / (H-1)
    # with y = H - r (the reference's y flip, main.cpp:116-121)
    col = _to_int(torch.floor(x_img[:, 0] * (width - 1)))
    y = _to_int(torch.floor(x_img[:, 1] * (height - 1)))
    row = height - y
    inside = (col >= 0) & (col < width) & (row >= 0) & (row < height)
    w_pix = torch.where(
        inside[:, None],
        weight[torch.clamp(row, 0, height - 1), torch.clamp(col, 0,
                                                            width - 1)],
        0.0)

    # a scalar a sample; A_pix is a pixel's footprint in (s, t). (f_- -
    # f_+) along n̂ is (f_in - f_out) along the outward normal whichever
    # way n̂ points (both factors flip together)
    a_pix = (1.0 / (width - 1)) * (1.0 / (height - 1))
    df = (w_pix * (f_m - f_p)).sum(dim=-1)
    valid = valid & torch.isfinite(elen)
    coeff = (torch.where(valid, 1.0, 0.0) * df * elen
             * (n_edges / n_samples) / a_pix)
    cot = torch.where(valid[:, None], coeff[:, None] * nhat, 0.0)
    return pull(cot.detach())


def _vjp(img_pos, verts):
    """(x_img (K, 2) without gradients, pull): pull(cot) is the
    vector-Jacobian product of img_pos at verts with the cotangent."""
    v = verts.detach().requires_grad_(True)
    with torch.enable_grad():
        x_img = img_pos(v)

    def pull(cot):
        (g,) = torch.autograd.grad(x_img, v, grad_outputs=cot)
        return g

    return x_img.detach(), pull


def boundary_grad(verts: torch.Tensor, edges, efaces, indices, cam: Camera,
                  weight: torch.Tensor, width: int, height: int,
                  radiance_fn: Callable[[Rays], torch.Tensor], sampler,
                  n_samples: int = 4096,
                  eps_px: float = 0.35) -> torch.Tensor:
    """d(sum(weight * image)) / d(verts), the boundary term only.

    weight (H, W, 3): the per-pixel loss weight (dL/dI). radiance_fn maps
    a Rays batch to (N, 3) linear radiance by the forward integrator. The
    image convention is integrator/path.py's: pixel (row r, col c) samples
    s = (c + U) / (W - 1), t = (H - r + U) / (H - 1)."""
    n_edges = edges.shape[0]
    e_sel = sampler.fold_in(rng_mod.EDGE_PICK).key_randint((n_samples,),
                                                           n_edges)
    s_par = sampler.fold_in(rng_mod.EDGE_S).key_uniform((n_samples,))
    with torch.no_grad():
        sil = silhouette_mask(verts, indices, edges, efaces,
                              cam.origin)[e_sel]
    va_idx = edges[e_sel, 0].long()
    vb_idx = edges[e_sel, 1].long()

    def img_pos(vs):
        p = (1.0 - s_par)[:, None] * vs[va_idx] + s_par[:, None] * vs[vb_idx]
        return project(cam, p)

    x_img, pull = _vjp(img_pos, verts)
    with torch.no_grad():
        v = verts.detach()
        return _edge_estimator(pull, x_img, project(cam, v[va_idx]),
                               project(cam, v[vb_idx]), sil, weight, width,
                               height, radiance_fn, n_edges, n_samples,
                               eps_px, cam)


def shadow_boundary_grad(verts: torch.Tensor, edges, efaces, indices,
                         light_pos: torch.Tensor, cam: Camera,
                         weight: torch.Tensor, width: int, height: int,
                         radiance_fn: Callable[[Rays], torch.Tensor],
                         hit_fn: Callable[[Rays], object], sampler,
                         n_samples: int = 4096,
                         eps_px: float = 0.5) -> torch.Tensor:
    """d(sum(weight * image)) / d(verts): the shadow-silhouette boundary
    term of a blocker mesh lit by a compact emitter at light_pos (3,).

    hit_fn maps a Rays batch to a Hits record (the forward scene find;
    only .p, .normal and .hit are read, without gradients): it finds the
    receiver behind each edge point along the light -> edge line.
    radiance_fn is the forward integrator; the radiance difference across
    the projected shadow edge supplies f_in - f_out."""
    light = light_pos.to(torch.float32)
    n_edges = edges.shape[0]
    e_sel = sampler.fold_in(rng_mod.EDGE_PICK_SH).key_randint((n_samples,),
                                                              n_edges)
    s_par = sampler.fold_in(rng_mod.EDGE_S_SH).key_uniform((n_samples,))
    va_idx = edges[e_sel, 0].long()
    vb_idx = edges[e_sel, 1].long()

    with torch.no_grad():
        v = verts.detach()
        sil = silhouette_mask(v, indices, edges, efaces, light)[e_sel]
        # the receiver behind the edge point along the light ray (a
        # forward cast without gradients), from just past the blocker
        x0 = (1.0 - s_par)[:, None] * v[va_idx] + s_par[:, None] * v[vb_idx]
        dvec = x0 - light
        dist = torch.linalg.norm(dvec, dim=-1, keepdim=True)
        dhat = dvec / torch.clamp(dist, min=1e-12)
        h = hit_fn(Rays(o=x0 + 1e-3 * dhat, d=dhat))
        y0, n0 = h.p, h.normal
        # a receiver seen edge-on drops the sample
        ok_recv = h.hit & (((x0 - light) * n0).sum(dim=-1).abs() > 1e-6)

    def shadow_img(p):
        """Blocker points (K, 3) -> the image position of their shadow on
        the receiver's local tangent plane (differentiable in p)."""
        tau = (((y0 - light) * n0).sum(dim=-1)
               / ((p - light) * n0).sum(dim=-1))
        return project(cam, light + tau[:, None] * (p - light))

    def img_pos(vs):
        return shadow_img((1.0 - s_par)[:, None] * vs[va_idx]
                          + s_par[:, None] * vs[vb_idx])

    x_img, pull = _vjp(img_pos, verts)
    with torch.no_grad():
        # the image-space direction of the projected edge
        return _edge_estimator(pull, x_img, shadow_img(v[va_idx]),
                               shadow_img(v[vb_idx]), sil & ok_recv, weight,
                               width, height, radiance_fn, n_edges,
                               n_samples, eps_px, cam)
