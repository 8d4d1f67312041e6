"""Regenerative wavefront integrator, the main path (counterpart of
hobbyraytracer_tpu/integrator/wavefront.py).

A fixed pool of P lanes traces one path segment per lane per iteration;
a lane whose path ends starts the next sample of its work item in place,
or takes the next work item off the queue. One work item covers
SAMPLE_CHUNK consecutive samples of one pixel; the finished chunk's
radiance retires to a planar (3, W*H) framebuffer through a stable
argsort compaction capped at max(pool // RETIRE_DIV, 64) lanes per
segment (the overflow keeps `defer` and retires later). Work items are
sample-chunk-major: item i covers pixel i % (W*H) of chunk i // (W*H).

The radiance recurrence is the reference's (main.cpp:43-76): a miss adds
throughput * background, a hit adds throughput * emitted, a scatter
multiplies the throughput or ends the sample, with unbiased Russian
roulette from depth RR_START.

Differences from the JAX version: `_regenerate` and `_segment` update the
pool state in place (and return it) where the reference rebuilt it; the
render loop is a Python loop that checks completion on the host every
`steps_per_call` iterations. Iterations after completion are no-ops (no
lane active, nothing issued), but they still advance `it`, the sampler's
iteration index. Pool sort and checkpoint callbacks are ROADMAP Queue 1
items 8 and 15.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from ..core import rng as rng_mod
from ..core.types import Rays
from ..ops import film as film_ops
from ..ops import shade as shade_ops
from ..ops.camera import Camera, get_rays
from ..scene import ir as scene_ir
from .path import MAX_DEPTH, background_colour

DEFAULT_POOL = 196_608   # lanes; the reference's default
SAMPLE_CHUNK = 4         # samples per work item
RETIRE_DIV = 12          # retirement cap = max(pool // RETIRE_DIV, 64)
RR_START = 4             # bounces before Russian roulette begins
RR_MIN_P = 0.05          # survival-probability floor
_BIGI = 2 ** 30          # sort key of lanes with nothing to retire


@dataclass
class PoolState:
    """The whole render state (updated in place by _regenerate/_segment).

    fb (3, W*H) f32 planar radiance sum; o/d/thr/rad (P, 3) f32 ray
    origin, direction, path throughput, radiance of the current item;
    item (P,) int32 work item (-1 idle); depth (P,) int32 segments of the
    current sample (-1: sample done, needs a fresh camera ray); sub (P,)
    int32 samples of the chunk complete; defer (P,) bool chunk finished
    but retirement deferred by the cap; counter () int32 next unissued
    item; retired () int32 completed samples; it: host int, the iteration
    index (the sampler's stream index)."""
    fb: torch.Tensor
    o: torch.Tensor
    d: torch.Tensor
    thr: torch.Tensor
    rad: torch.Tensor
    item: torch.Tensor
    depth: torch.Tensor
    sub: torch.Tensor
    defer: torch.Tensor
    counter: torch.Tensor
    retired: torch.Tensor
    it: int = 0


def framebuffer(state: PoolState) -> torch.Tensor:
    """The (W*H, 3) radiance-sum image."""
    return state.fb.T


def init_state(width: int, height: int, pool: int, device) -> PoolState:
    """An empty pool of `pool` idle lanes on `device`."""
    f32 = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    return PoolState(
        fb=torch.zeros((3, width * height), **f32),
        o=torch.zeros((pool, 3), **f32),
        d=torch.ones((pool, 3), **f32),
        thr=torch.zeros((pool, 3), **f32),
        rad=torch.zeros((pool, 3), **f32),
        item=torch.full((pool,), -1, **i32),
        depth=torch.zeros((pool,), **i32),
        sub=torch.zeros((pool,), **i32),
        defer=torch.zeros((pool,), dtype=torch.bool, device=device),
        counter=torch.zeros((), **i32),
        retired=torch.zeros((), **i32),
        it=0)


def _chunk_geometry(samples: int, chunk: int):
    """(chunk, n_chunks, last_chunk_size) for spp = samples."""
    chunk = max(1, min(chunk, samples))
    n_chunks = -(-samples // chunk)
    return chunk, n_chunks, samples - (n_chunks - 1) * chunk


def _floordiv(a: torch.Tensor, b: int) -> torch.Tensor:
    return torch.div(a, b, rounding_mode="floor")


def _regenerate(state: PoolState, camera: Camera, width: int, height: int,
                total_items: int, sampler) -> PoolState:
    """Issue new items to idle lanes and fresh camera rays to every lane
    that needs one (newly issued, or starting the next sample of its chunk,
    flagged by depth == -1). Updates `state` in place."""
    pool = state.item.shape[0]
    wh = width * height
    idle = state.item < 0
    # exclusive prefix rank among idle lanes -> contiguous item ids
    rank = torch.cumsum(idle.to(torch.int32), 0, dtype=torch.int32) - 1
    new_item = state.counter + rank
    issue = idle & (new_item < total_items)
    fresh = issue | ((state.item >= 0) & (state.depth < 0))
    item = torch.where(issue, new_item, state.item)
    pix = torch.remainder(torch.clamp(item, min=0), wh)
    x = torch.remainder(pix, width).to(torch.float32)
    y = (height - _floordiv(pix, width)).to(torch.float32)  # y-flip
    ju = sampler.uniform(rng_mod.PIXEL_JITTER_U, state.it, (pool,))
    jv = sampler.uniform(rng_mod.PIXEL_JITTER_V, state.it, (pool,))
    cam = get_rays(camera, (x + ju) / (width - 1), (y + jv) / (height - 1))

    f3 = fresh[:, None]
    i3 = issue[:, None]
    n_issued = torch.clamp(torch.minimum(idle.sum(dtype=torch.int32),
                                         total_items - state.counter), min=0)
    state.o = torch.where(f3, cam.o, state.o)
    state.d = torch.where(f3, cam.d, state.d)
    state.thr = torch.where(f3, 1.0, state.thr)
    state.rad = torch.where(i3, 0.0, state.rad)  # rad persists per chunk
    state.item = item
    state.depth = torch.where(fresh, 0, state.depth)
    state.sub = torch.where(issue, 0, state.sub)
    state.counter = state.counter + n_issued
    return state


def _segment(state: PoolState, scene: scene_ir.SceneIR, width: int,
             height: int, sampler, max_depth: int, samples: int,
             sample_chunk: int = SAMPLE_CHUNK, rr: bool = True,
             plain_mesh: bool = False) -> PoolState:
    """Trace one path segment for every active lane, roll finished samples
    into the next sample of their chunk, and retire finished chunks into
    the framebuffer. Updates `state` in place; it advances by one."""
    wh = width * height
    pool = state.item.shape[0]
    chunk, n_chunks, last = _chunk_geometry(samples, sample_chunk)
    active = (state.item >= 0) & (state.depth >= 0) & ~state.defer
    r = Rays(o=state.o, d=state.d)
    hits = scene_ir.intersect_scene(scene, r, ray_valid=active,
                                    plain_mesh=plain_mesh)

    miss = active & ~hits.hit
    rad = state.rad + torch.where(miss[:, None],
                                  state.thr * background_colour(scene, r.d),
                                  0.0)
    emit = shade_ops.emitted(scene.materials, scene.textures, hits)
    hit_active = active & hits.hit
    rad = rad + torch.where(hit_active[:, None], state.thr * emit, 0.0)

    ok, atten, new_d = shade_ops.scatter(scene.materials, scene.textures, r,
                                         hits, sampler, state.it)
    depth = state.depth + 1
    cont = hit_active & ok & (depth < max_depth)  # bounce cap, main.cpp:43
    thr = torch.where(cont[:, None], state.thr * atten, state.thr)
    if rr:
        # Russian roulette: unbiased (survivors scaled by 1/p); the
        # reference traces every path to depth 50
        p = torch.clamp(thr.max(dim=1).values, RR_MIN_P, 1.0)
        u_rr = sampler.uniform(rng_mod.RUSSIAN_ROULETTE, state.it, (pool,))
        rr_on = cont & (depth >= RR_START)
        kill = rr_on & (u_rr >= p)
        thr = torch.where((rr_on & ~kill)[:, None], thr / p[:, None], thr)
        cont = cont & ~kill
    state.o = torch.where(cont[:, None], hits.p, state.o)
    state.d = torch.where(cont[:, None], new_d, state.d)

    # a lane whose sample ended starts the next sample of its chunk
    # (depth -1: fresh ray at the next regenerate) or owes a retirement
    chunk_n = torch.where(_floordiv(state.item, wh) == n_chunks - 1, last,
                          chunk).to(torch.int32)
    sample_end = active & ~cont
    more = sample_end & (state.sub + 1 < chunk_n)
    finished = sample_end & (state.sub + 1 >= chunk_n)
    sub = torch.where(more, state.sub + 1, state.sub)
    depth = torch.where(more, -1, depth)

    # retirement: stable-argsort compaction of finished chunks, at most
    # `cap` per segment, then per-channel scatter-adds into the planar fb
    cap = min(max(pool // RETIRE_DIV, 64), pool)
    done = finished | state.defer
    skey = torch.where(done, torch.remainder(state.item, wh), _BIGI)
    order = torch.argsort(skey, stable=True)[:cap]
    pix_c = skey[order]
    ok_c = pix_c < _BIGI
    tgt = torch.where(ok_c, pix_c, 0).long()
    vals = torch.where(ok_c[:, None], rad[order], 0.0)
    state.fb.index_add_(1, tgt, vals.T.contiguous())
    # the first `cap` ranks landed; when fewer than `cap` lanes were done
    # those are exactly the done lanes
    retired_mask = torch.zeros((pool,), dtype=torch.bool, device=done.device)
    retired_mask[order] = ok_c

    state.thr = thr
    state.rad = rad
    state.item = torch.where(retired_mask, -1, state.item)
    state.depth = depth
    state.sub = sub
    state.defer = done & ~retired_mask
    state.retired = state.retired + torch.where(
        retired_mask, chunk_n, 0).sum(dtype=torch.int32)
    state.it += 1
    return state


def render_state(scene: scene_ir.SceneIR, camera: Camera, width: int,
                 height: int, samples: int, sampler,
                 max_depth: int = MAX_DEPTH, pool: int = DEFAULT_POOL,
                 steps_per_call: int = 8,
                 progress_cb: Optional[Callable[[int, int], None]] = None,
                 sample_chunk: int = SAMPLE_CHUNK, rr: bool = True,
                 plain_mesh: bool = False) -> PoolState:
    """Run the pool to completion on `sampler.device` (scene and camera
    must already be there); fb holds the radiance SUM over `samples`.

    Completion (retired == W*H*samples) is read on the host after every
    `steps_per_call` iterations, where progress_cb(retired, total) fires.
    plain_mesh=True runs the mesh find through the kernel's plain PyTorch
    version (a comparison switch)."""
    wh = width * height
    _, n_chunks, _ = _chunk_geometry(samples, sample_chunk)
    total_items = wh * n_chunks
    total_samples = wh * samples
    state = init_state(width, height, min(pool, total_items),
                       device=sampler.device)
    while True:
        for _ in range(steps_per_call):
            _regenerate(state, camera, width, height, total_items, sampler)
            _segment(state, scene, width, height, sampler, max_depth,
                     samples, sample_chunk, rr, plain_mesh)
        retired = int(state.retired)
        if progress_cb is not None:
            progress_cb(retired, total_samples)
        if retired >= total_samples:
            return state


def render_image(scene: scene_ir.SceneIR, camera: Camera, width: int,
                 height: int, samples: int, sampler,
                 max_depth: int = MAX_DEPTH, pool: int = DEFAULT_POOL,
                 progress_cb=None, sample_chunk: int = SAMPLE_CHUNK,
                 rr: bool = True, plain_mesh: bool = False) -> torch.Tensor:
    """Full render -> tonemapped (H, W, 3) float image in [0, 1] (average
    -> ACES -> gamma, as the reference)."""
    state = render_state(scene, camera, width, height, samples, sampler,
                         max_depth=max_depth, pool=pool,
                         progress_cb=progress_cb, sample_chunk=sample_chunk,
                         rr=rr, plain_mesh=plain_mesh)
    mean = framebuffer(state) / float(samples)
    return film_ops.tonemap(mean).reshape(height, width, 3)
