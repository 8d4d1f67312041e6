"""The material fit of the reference: the differentiable render (a fixed
number of bounces, jittered camera samples, each sample from its own
folds of the key), the tonemapped mean squared error against a target,
its gradients by autograd, Adam (betas 0.9 / 0.999, eps 1e-8) and the
clamp of the materials into their ranges after each step.

The mesh find runs without gradients; the winning triangle's t and
barycentrics are computed again from its vertices by the watertight test,
so that the hit point carries the rays' gradients. Every step draws from
the same key (correlated sampling).
"""
from __future__ import annotations

import torch

from . import rng
from . import trace as tr
from .scene import MAT_FIELDS


def perturb(mats: dict) -> dict:
    """The fit's start: albedo * 0.3 + 0.3 and roughness + 0.4, both
    clipped to [0, 1]; the other fields as they are."""
    out = dict(mats)
    out["albedo"] = torch.clamp(mats["albedo"] * 0.3 + 0.3, 0.0, 1.0)
    out["roughness"] = torch.clamp(mats["roughness"] + 0.4, 0.0, 1.0)
    return out


def trace_diff(sc: tr.DeviceScene, mats: dict, o, d, key: tuple,
               max_depth: int):
    """Radiance (N, 3) after exactly max_depth bounces; the draws of bounce
    b are the (SCATTER_SPHERE, b) stream of `key`."""
    n = o.shape[0]
    dev, dt = sc.device, sc.dtype
    result = torch.zeros((n, 3), dtype=dt, device=dev)
    throughput = torch.ones((n, 3), dtype=dt, device=dev)
    active = torch.ones((n,), dtype=torch.bool, device=dev)
    every = torch.ones((n,), dtype=torch.bool, device=dev)
    for b in range(max_depth):
        h = tr.intersect(sc, o, d, every, replay=True)
        miss = active & ~h.hit
        result = result + torch.where(
            miss[:, None], throughput * tr.background(sc, d), 0.0)
        hit_active = active & h.hit
        result = result + torch.where(hit_active[:, None],
                                      throughput * tr.emitted(sc, mats, h),
                                      0.0)
        sph = tr.unit_sphere(rng.stream(key, rng.SCATTER_SPHERE, b), n, dev,
                             dt)
        ok, atten, new_d = tr.scatter(sc, mats, d, h, sph)
        active = hit_active & ok
        throughput = torch.where(active[:, None], throughput * atten,
                                 throughput)
        o = torch.where(active[:, None], h.p, o)
        d = torch.where(active[:, None], new_d, d)
    return result


def render_linear(sc: tr.DeviceScene, mats: dict, width: int, height: int,
                  seed: int, n_samples: int, max_depth: int):
    """Linear radiance (W*H, 3) averaged over n_samples; sample s jitters
    by the uniforms of fold(fold(key, s), 0) and fold(..., 1) and traces
    with fold(fold(key, s), 2)."""
    dev, dt = sc.device, sc.dtype
    key = rng.seed_key(seed)
    pix = torch.arange(width * height, dtype=torch.int32, device=dev)
    x = torch.remainder(pix, width).to(dt)
    y = (height - torch.div(pix, width, rounding_mode="floor")).to(dt)
    acc = torch.zeros((width * height, 3), dtype=dt, device=dev)
    for s in range(n_samples):
        ks = rng.fold(key, s)
        u = rng.uniforms([rng.fold(ks, 0), rng.fold(ks, 1)], width * height,
                         dev, dt)
        o, d = tr.camera_rays(sc, (x + u[0]) / (width - 1),
                              (y + u[1]) / (height - 1))
        acc = acc + trace_diff(sc, mats, o, d, rng.fold(ks, 2), max_depth)
    return acc / float(n_samples)


def loss_of(img, target):
    """Mean squared error of the tonemapped images (sqrt's epsilon 1e-6)."""
    return ((tr.tonemap(img, 1e-6) - tr.tonemap(target, 1e-6)) ** 2).mean()


def fit(sc: tr.DeviceScene, target, width: int, height: int, seed: int,
        steps: int, lr: float, n_samples: int, max_depth: int):
    """Adam from the perturbed materials towards `target` -> (the loss at
    the start of each step, {field: fitted tensor})."""
    start = perturb(sc.mats)
    params = {f: start[f].detach().clone().requires_grad_(True)
              for f in MAT_FIELDS}
    leaves = list(params.values())
    for p in leaves:
        p.grad = torch.zeros_like(p)
    opt = torch.optim.Adam(leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                           capturable=sc.device.type == "cuda")
    losses = []
    for _ in range(steps):
        for p in leaves:
            p.grad.zero_()
        loss = loss_of(render_linear(sc, params, width, height, seed,
                                     n_samples, max_depth), target)
        loss.backward()
        opt.step()
        with torch.no_grad():
            params["albedo"].clamp_(0.0, 1.0)
            params["roughness"].clamp_(0.0, 1.0)
            params["ior"].clamp_(1.0, 3.0)
            params["strength"].clamp_(min=0.0)
        losses.append(float(loss.detach()))
    return losses, {f: p.detach() for f, p in params.items()}
