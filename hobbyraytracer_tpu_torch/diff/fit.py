"""Inverse rendering: the differentiable material / vertex fit (counterpart
of hobbyraytracer_tpu/diff/fit.py).

The scene's tables are the parameter vector. `select_params` takes the
differentiable ones out of a SceneIR (the material table's floats, and the
mesh vertices for a vertex fit) as leaf tensors that require grad, and
gives back `rebuild`, which puts them into a copy of the scene that shares
every other buffer (scene/ir.py:replace). `render_loss` renders that scene
with the differentiable integrator (integrator/path.py:trace_diff) and
`fit_materials` runs torch.optim.Adam on top (optax.adam's defaults:
betas 0.9 / 0.999, eps 1e-8). The gradients flow through each path's
shading chain; the discrete decisions are replayed without gradients.

Mesh finds take "kernel_replay": the fused kernel (K1 / K2 on the card)
finds the winning triangle without gradients and the winner is replayed
from the live vertices. A vertex fit's `rebuild` refreshes the kernel's
tables from the live vertices (scene/ir.py:refresh_kernel_tables), so the
find follows the moving geometry.

`render_linear_slice` renders one worker's pixels of the sharded fit
(parallel/shard.py) with the whole image's draws sliced to them.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core.rng import Sampler
from ..integrator import path as path_mod
from ..ops import film
from ..ops.camera import get_rays
from ..scene import ir as scene_ir

# material-table floats that are fit targets
MAT_FIELDS = ("albedo", "roughness", "strength", "ior", "metallness")


def project_materials(params: dict) -> dict:
    """Clamp the fitted material parameters to their physical ranges, in
    place and without gradients (after an optimizer step): albedo and
    roughness to [0, 1], ior to [1, 3], strength to >= 0."""
    m = params.get("materials")
    if m is not None:
        with torch.no_grad():
            m["albedo"].clamp_(0.0, 1.0)
            m["roughness"].clamp_(0.0, 1.0)
            m["ior"].clamp_(1.0, 3.0)
            m["strength"].clamp_(min=0.0)
    return params


def select_params(scene: scene_ir.SceneIR, fit_vertices: bool = False):
    """-> (params, rebuild). params: {"materials": {field: (M, ...)},
    "verts": [(V, 3) for each mesh instance]} ("verts" only for a vertex
    fit), leaf tensors that require grad, copies of the scene's buffers.
    rebuild(params) -> the scene with those tensors in place of its own
    (and, for a vertex fit, each mesh's kernel tables refreshed from
    them)."""
    def leaf(t):
        return t.detach().clone().requires_grad_(True)

    params = {"materials": {f: leaf(getattr(scene.materials, f))
                            for f in MAT_FIELDS}}
    if fit_vertices:
        params["verts"] = [leaf(inst.mesh.verts) for inst in scene.instances
                           if inst.kind == "mesh"]

    def rebuild(p) -> scene_ir.SceneIR:
        mats = scene_ir.replace(scene.materials, **p["materials"])
        if not fit_vertices:
            return scene_ir.replace(scene, materials=mats)
        verts = iter(p["verts"])
        instances = []
        for inst in scene.instances:
            if inst.kind == "mesh":
                mesh = scene_ir.refresh_kernel_tables(
                    scene_ir.replace(inst.mesh, verts=next(verts)))
                inst = scene_ir.replace(inst, mesh=mesh)
            instances.append(inst)
        return scene_ir.replace(scene, materials=mats,
                                instances=nn.ModuleList(instances))

    return params, rebuild


def render_linear(scene: scene_ir.SceneIR, camera, width: int, height: int,
                  sampler, n_samples: int, max_depth: int = 6,
                  mesh_backend: str = "kernel_replay") -> torch.Tensor:
    """Linear radiance (W*H, 3), before the tonemap, averaged over
    n_samples jittered samples of the differentiable integrator; sample s
    draws from sampler.fold_in(s), as integrator/path.py:sample_radiance.
    Each sample runs under torch.utils.checkpoint, so the backward pass
    holds one sample's bounce chain at a time, whatever n_samples."""
    return render_linear_slice(scene, camera, width, height, sampler,
                               n_samples, 0, width * height, max_depth,
                               mesh_backend)


def render_linear_slice(scene: scene_ir.SceneIR, camera, width: int,
                        height: int, sampler, n_samples: int, pix0: int,
                        n_pix: int, max_depth: int = 6,
                        mesh_backend: str = "kernel_replay") -> torch.Tensor:
    """render_linear for the n_pix pixels from flat index pix0 on -> (n_pix,
    3). Every draw is the whole image's draw sliced to these pixels
    (core/rng.py span), so the result equals render_linear(...)[pix0:pix0 +
    n_pix] bit for bit: one worker's share of the sharded fit
    (parallel/shard.py:sharded_render_loss)."""
    wh = width * height
    x, y = path_mod.pixel_grid(width, height, sampler.device, pix0, n_pix)
    span = None if n_pix == wh else (pix0, wh)

    def one_sample(s):
        ku, kv, kt = sampler.fold_in(s).split(3)
        ju = ku.key_uniform(x.shape, span)
        jv = kv.key_uniform(y.shape, span)
        rays = get_rays(camera, (x + ju) / (width - 1),
                        (y + jv) / (height - 1), kt, 0, span)
        return path_mod.trace_diff(scene, rays, kt, max_depth,
                                   mesh_backend=mesh_backend, rng_span=span)

    acc = torch.zeros((n_pix, 3), dtype=torch.float32,
                      device=sampler.device)
    for s in range(n_samples):
        acc = acc + checkpoint(one_sample, s, use_reentrant=False)
    return acc / float(n_samples)


def _loss_from_image(img, target, tonemapped: bool = True):
    """Mean squared error between (W*H, 3) linear radiance images, in
    tonemapped space unless told otherwise."""
    if tonemapped:
        img = film.tonemap(img, grad_eps=1e-6)
        target = film.tonemap(target, grad_eps=1e-6)
    return ((img - target) ** 2).mean()


def render_loss(params, rebuild, camera, width, height, sampler, n_samples,
                target, max_depth: int = 6, tonemapped: bool = True,
                mesh_backend: str = "kernel_replay"):
    """The image loss of the scene rebuilt from params against `target`
    ((W*H, 3) linear radiance): a scalar tensor with gradients to params."""
    img = render_linear(rebuild(params), camera, width, height, sampler,
                        n_samples, max_depth, mesh_backend=mesh_backend)
    return _loss_from_image(img, target, tonemapped)


class FitResult(NamedTuple):
    scene: scene_ir.SceneIR
    losses: np.ndarray
    params: dict


def fit_materials(scene: scene_ir.SceneIR, camera, target, width, height,
                  steps: int = 50, lr: float = 2e-2, n_samples: int = 4,
                  max_depth: int = 6, sampler=None,
                  fit_vertices: bool = False, verbose: bool = True,
                  correlated: bool = True, boundary: bool = False,
                  boundary_samples: int = 4096,
                  shadow_light=None) -> FitResult:
    """Adam fit of the material parameters (and the mesh vertices with
    fit_vertices) to a target image, target (W*H, 3) linear radiance on the
    scene's device. losses[i] is the loss at the parameters step i started
    from.

    correlated=True (the default) renders every step from the same
    sampler: when the target was rendered with it at the same spp, the
    Monte Carlo noise cancels between render and target and the optimum is
    exact. correlated=False draws step i from sampler.fold_in(i), for
    targets with noise of their own.

    boundary=True (with fit_vertices) adds the edge-sampled silhouette
    term (diff/edges.py:boundary_grad) to each mesh's vertex gradient;
    shadow_light, a (3,) emitter position, adds the shadow-silhouette term
    as well (shadow_boundary_grad). Without them the vertices feel only the
    smooth shading-chain gradient."""
    if sampler is None:
        sampler = Sampler(0, target.device)
    params, rebuild = select_params(scene, fit_vertices)
    leaves = list(params["materials"].values()) + list(
        params.get("verts", []))
    opt = torch.optim.Adam(leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    edge_tables = None
    if boundary and fit_vertices:
        from . import edges as edge_mod
        edge_tables = []
        for inst in scene.instances:
            if inst.kind == "mesh":
                e, f = edge_mod.build_edge_table(
                    inst.mesh.indices.cpu().numpy())
                dev = inst.mesh.indices.device
                edge_tables.append((torch.from_numpy(e).to(dev),
                                    torch.from_numpy(f).to(dev),
                                    inst.mesh.indices))

    def boundary_terms(k):
        """Silhouette gradients of every fitted mesh at the current
        parameters, weighted by dL/dI of the current render."""
        from . import edges as edge_mod
        with torch.no_grad():
            cur = rebuild(params)
            img = render_linear(cur, camera, width, height, k, n_samples,
                                max_depth)
        img.requires_grad_(True)
        (w_img,) = torch.autograd.grad(_loss_from_image(img, target), img)
        w2d = w_img.reshape(height, width, 3)

        def radiance_fn(rays):
            # the forward integrator over the live vertices
            return path_mod.trace(cur, rays, k, max_depth,
                                  mesh_backend="lockstep")

        def hit_fn(rays):
            return scene_ir.intersect_scene(cur, rays, sampler=k, bounce=0,
                                            mesh_backend="lockstep")

        out = []
        for v, (e, f, idx) in zip(params["verts"], edge_tables):
            g = edge_mod.boundary_grad(v, e, f, idx, camera, w2d, width,
                                       height, radiance_fn, k,
                                       n_samples=boundary_samples)
            if shadow_light is not None:
                light = torch.as_tensor(shadow_light, dtype=torch.float32,
                                        device=v.device)
                g = g + edge_mod.shadow_boundary_grad(
                    v, e, f, idx, light, camera, w2d, width, height,
                    radiance_fn, hit_fn, k, n_samples=boundary_samples)
            out.append(g)
        return out

    losses = []
    for i in range(steps):
        k = sampler if correlated else sampler.fold_in(i)
        opt.zero_grad(set_to_none=True)
        loss = render_loss(params, rebuild, camera, width, height, k,
                           n_samples, target, max_depth)
        loss.backward()
        if edge_tables is not None:
            for v, b in zip(params["verts"], boundary_terms(k)):
                v.grad = b if v.grad is None else v.grad + b
        for p in leaves:
            # optax updates a parameter with no gradient as one with a zero
            # gradient (its step count advances); torch's Adam would skip it
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        opt.step()
        project_materials(params)
        losses.append(float(loss.detach()))
        if verbose and (i % max(1, steps // 10) == 0 or i == steps - 1):
            print(f"fit step {i}: loss {losses[-1]:.6f}")
    with torch.no_grad():
        fitted = rebuild(params)
    return FitResult(scene=fitted, losses=np.asarray(losses),
                     params=params)
