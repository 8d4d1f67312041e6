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
render loop checks completion on the host every `steps_per_call`
iterations (the reference's while_loop stops on the device). Iterations
after completion are no-ops (no lane active, nothing issued);
`render_state` returns with `it` set to the iteration at which the pool ran
dry, where the reference's loop stops.

The block as a CUDA graph (`_pool_run`, the counterpart of the reference's
_pool_run: one device program a block). On a CUDA device the first block
of a render runs eagerly (the warm-up: kernels built and loaded, the
allocator and the sorts' scratch settled); the next is captured into a
torch.cuda.CUDAGraph and replayed for every later block. The state's
tensors are the graph's static buffers and `it` a 0-d int32 device tensor
that the captured draws read (core/rng.py), so each replay draws new
numbers. The graph outlives its render (`RENDER_GRAPHS`): a later render
of the same configuration (the same scene and camera objects, their
buffers and flags as they were, the same film, spp, depth, pool and
knobs) resets the kept state in place and replays every block from the
first, its draws under its own key, which the graph reads from a key slot
(core/rng.py:KeySlot). A configuration whose segment reads the host runs
every block eagerly, by rule (`graph_route`): the CPU, a pool sort, and a
scene whose finds read the host (and either comparison switch of
kernels/build.py). A failed capture or replay raises.

Pool sort (pool_sort=N, default POOL_SORT from HRT_POOL_SORT, 0 = off):
every N segments the whole pool is permuted by
scene/ir.py:wavefront_sort_key, and every mesh find of every segment skips
its own sort (cohsort=False). The state's tensors are indexed by the
permutation one by one; the reference's packed (P, 16) gather is a TPU
cost choice.

Checkpoint and resume: the state is the whole render (io/checkpoint.py
writes it), `render_state(checkpoint_cb=)` hands it over after every block
of `steps_per_call` iterations, and `render_state(state=)` goes on from a
saved one, so an interrupted and resumed render equals the uninterrupted
one bit for bit where the device's sums are deterministic (on the card,
under torch.use_deterministic_algorithms: the framebuffer's index_add_
otherwise adds in the order its atomics land). A multi-worker render
(parallel/shard.py) drains one slice of the work items a worker through
`_regenerate(item0=)`.

Tracing (tracing.py): a render traced as a whole (a profiler recording, or
tracing.recording(), at its start) records the spans hrt.render (its
attribute `graph`: "hit", "capture" or "eager"), hrt.block, hrt.host_read
and hrt.film, times each segment's phases
(regenerate, find, shade, retire; the sphere find nested in the find) by
events that a block's CUDA graph captures, and counts the lanes active,
hit and deferred and the rows retired a segment on the device (and where
the scene has them, the lanes whose closest hit is a pooled sphere and
those the dielectric lobe scattered). Untraced, the same sites do
nothing.
The sharded render (parallel/shard.py) is never traced.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
from dataclasses import dataclass, field
from typing import Callable, Optional

import torch

from .. import tracing
from ..core import rng as rng_mod
from ..core.types import Rays
from ..kernels import build as kbuild
from ..ops import film as film_ops
from ..ops import intersect as isect
from ..ops import shade as shade_ops
from ..ops.camera import Camera, get_rays
from ..scene import ir as scene_ir
from .path import MAX_DEPTH, background_colour

DEFAULT_POOL = 196_608   # lanes; the reference's default
# samples per work item, and the retirement cap's divisor (cap = max(pool //
# RETIRE_DIV, 64) lanes a segment): the reference's knobs HRT_SAMPLE_CHUNK
# and HRT_RETIRE_DIV, read once at import with its defaults
SAMPLE_CHUNK = int(os.environ.get("HRT_SAMPLE_CHUNK", "4"))
RETIRE_DIV = int(os.environ.get("HRT_RETIRE_DIV", "12"))
if RETIRE_DIV < 1:
    raise ValueError(
        f"HRT_RETIRE_DIV={RETIRE_DIV}: the retirement-cap divisor must be "
        ">= 1 (cap = pool // HRT_RETIRE_DIV rows scattered per segment)")
STEPS_PER_CALL = 8       # segments a block (completion read after each)
RR_START = 4             # bounces before Russian roulette begins
RR_MIN_P = 0.05          # survival-probability floor
_BIGI = 2 ** 30          # sort key of lanes with nothing to retire
# Pool-level coherence sort period, read once at import like the reference's:
# 0 = off (each mesh find sorts for itself), N >= 1 = permute the pool every
# N segments and skip the per-mesh sorts. A module attribute read at call
# time, so a caller may switch it in-process.
POOL_SORT = int(os.environ.get("HRT_POOL_SORT", "0") or 0)
_LANE_FIELDS = ("o", "d", "thr", "rad", "item", "depth", "sub", "defer")


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
    index (the sampler's stream index; inside a block captured into a CUDA
    graph, a 0-d int32 tensor on the device, advanced in place)."""
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
    return reset_state(PoolState(
        fb=torch.empty((3, width * height), **f32),
        o=torch.empty((pool, 3), **f32),
        d=torch.empty((pool, 3), **f32),
        thr=torch.empty((pool, 3), **f32),
        rad=torch.empty((pool, 3), **f32),
        item=torch.empty((pool,), **i32),
        depth=torch.empty((pool,), **i32),
        sub=torch.empty((pool,), **i32),
        defer=torch.empty((pool,), dtype=torch.bool, device=device),
        counter=torch.empty((), **i32),
        retired=torch.empty((), **i32)))


# init_state's value of each tensor field: every lane idle, nothing issued
_EMPTY = {"fb": 0, "o": 0, "d": 1, "thr": 0, "rad": 0, "item": -1,
          "depth": 0, "sub": 0, "defer": False, "counter": 0, "retired": 0}


def reset_state(state: PoolState) -> PoolState:
    """Make `state` an empty pool, in place: every tensor at init_state's
    value, `it` 0."""
    for f, v in _EMPTY.items():
        getattr(state, f).fill_(v)
    state.it = 0
    return state


def _chunk_geometry(samples: int, chunk: int):
    """(chunk, n_chunks, last_chunk_size) for spp = samples."""
    chunk = max(1, min(chunk, samples))
    n_chunks = -(-samples // chunk)
    return chunk, n_chunks, samples - (n_chunks - 1) * chunk


def _floordiv(a: torch.Tensor, b: int) -> torch.Tensor:
    return torch.div(a, b, rounding_mode="floor")


def _regenerate(state: PoolState, camera: Camera, width: int, height: int,
                total_items: int, sampler, item0: int = 0) -> PoolState:
    """Issue new items to idle lanes and fresh camera rays to every lane
    that needs one (newly issued, or starting the next sample of its chunk,
    flagged by depth == -1). Updates `state` in place.

    item0: the first work item of this worker's slice (reference
    parallel/shard.py:210). `counter` and `total_items` count within the
    slice; the stored ids, and so the pixels, are the image's."""
    pool = state.item.shape[0]
    wh = width * height
    idle = state.item < 0
    # exclusive prefix rank among idle lanes -> contiguous item ids
    rank = torch.cumsum(idle.to(torch.int32), 0, dtype=torch.int32) - 1
    new_local = state.counter + rank
    new_item = new_local + item0
    issue = idle & (new_local < total_items)
    fresh = issue | ((state.item >= 0) & (state.depth < 0))
    item = torch.where(issue, new_item, state.item)
    pix = torch.remainder(torch.clamp(item, min=0), wh)
    x = torch.remainder(pix, width).to(torch.float32)
    y = (height - _floordiv(pix, width)).to(torch.float32)  # y-flip
    ju = sampler.uniform(rng_mod.PIXEL_JITTER_U, state.it, (pool,))
    jv = sampler.uniform(rng_mod.PIXEL_JITTER_V, state.it, (pool,))
    # the lens streams the (LENS, it) key again by LENS, as the reference's
    # get_rays(key=stream(key, LENS, it)) does
    cam = get_rays(camera, (x + ju) / (width - 1), (y + jv) / (height - 1),
                   sampler.stream(rng_mod.LENS, state.it))

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


def _active(state: PoolState) -> torch.Tensor:
    return (state.item >= 0) & (state.depth >= 0) & ~state.defer


def _pool_permute(state: PoolState, scene: scene_ir.SceneIR) -> PoolState:
    """Permute every lane of the pool by the stable order of the scene's
    wavefront sort key (in place; fb, counter and retired are not per
    lane)."""
    key = scene_ir.wavefront_sort_key(scene, Rays(o=state.o, d=state.d),
                                      _active(state))
    perm = torch.argsort(key, stable=True)
    for f in _LANE_FIELDS:
        setattr(state, f, getattr(state, f)[perm])
    return state


def _segment(state: PoolState, scene: scene_ir.SceneIR, width: int,
             height: int, sampler, max_depth: int, samples: int,
             sample_chunk: int = SAMPLE_CHUNK, rr: bool = True,
             pool_sort: Optional[int] = None) -> PoolState:
    """Trace one path segment for every active lane, roll finished samples
    into the next sample of their chunk, and retire finished chunks into
    the framebuffer. Updates `state` in place; it advances by one.

    pool_sort: the pool sort's period (None: POOL_SORT). With a period N >=
    1 and a scene that has a kernel mesh, the pool is permuted when it is
    a multiple of N, and the mesh finds of every segment skip their own
    sort. Wavefronts change slowly (a path lasts a few segments), so a
    stale permutation keeps most of the coherence."""
    wh = width * height
    pool = state.item.shape[0]
    chunk, n_chunks, last = _chunk_geometry(samples, sample_chunk)
    period = int(POOL_SORT if pool_sort is None else pool_sort)
    with tracing.phase("segment.find"):
        mesh_cohsort = None
        if period > 0 and scene_ir.has_wavefront_sort_key(scene):
            if state.it % period == 0:
                _pool_permute(state, scene)
            mesh_cohsort = False
        active = _active(state)
        r = Rays(o=state.o, d=state.d)
        hits = scene_ir.intersect_scene(scene, r, ray_valid=active,
                                        sampler=sampler, bounce=state.it,
                                        mesh_cohsort=mesh_cohsort)

    with tracing.phase("segment.shade"):
        miss = active & ~hits.hit
        rad = state.rad + torch.where(
            miss[:, None], state.thr * background_colour(scene, r.d), 0.0)
        emit = shade_ops.emitted(scene.materials, scene.textures, hits)
        hit_active = active & hits.hit
        rad = rad + torch.where(hit_active[:, None], state.thr * emit, 0.0)

        ok, atten, new_d = shade_ops.scatter(scene.materials,
                                             scene.textures, r, hits,
                                             sampler, state.it)
        depth = state.depth + 1
        # bounce cap, main.cpp:43
        cont = hit_active & ok & (depth < max_depth)
        thr = torch.where(cont[:, None], state.thr * atten, state.thr)
        if rr:
            # Russian roulette: unbiased (survivors scaled by 1/p); the
            # reference traces every path to depth 50
            p = torch.clamp(thr.max(dim=1).values, RR_MIN_P, 1.0)
            u_rr = sampler.uniform(rng_mod.RUSSIAN_ROULETTE, state.it,
                                   (pool,))
            rr_on = cont & (depth >= RR_START)
            kill = rr_on & (u_rr >= p)
            thr = torch.where((rr_on & ~kill)[:, None], thr / p[:, None],
                              thr)
            cont = cont & ~kill
        state.o = torch.where(cont[:, None], hits.p, state.o)
        state.d = torch.where(cont[:, None], new_d, state.d)

        # a lane whose sample ended starts the next sample of its chunk
        # (depth -1: fresh ray at the next regenerate) or owes a retirement
        chunk_n = torch.where(_floordiv(state.item, wh) == n_chunks - 1,
                              last, chunk).to(torch.int32)
        sample_end = active & ~cont
        more = sample_end & (state.sub + 1 < chunk_n)
        finished = sample_end & (state.sub + 1 >= chunk_n)
        sub = torch.where(more, state.sub + 1, state.sub)
        depth = torch.where(more, -1, depth)

    with tracing.phase("segment.retire"):
        # retirement: stable-argsort compaction of finished chunks, at
        # most `cap` per segment, then per-channel scatter-adds into the
        # planar fb
        cap = retire_cap(pool)
        done = finished | state.defer
        skey = torch.where(done, torch.remainder(state.item, wh), _BIGI)
        order = torch.argsort(skey, stable=True)[:cap]
        pix_c = skey[order]
        ok_c = pix_c < _BIGI
        tgt = torch.where(ok_c, pix_c, 0).long()
        vals = torch.where(ok_c[:, None], rad[order], 0.0)
        state.fb.index_add_(1, tgt, vals.T.contiguous())
        # the first `cap` ranks landed; when fewer than `cap` lanes were
        # done those are exactly the done lanes
        retired_mask = torch.zeros((pool,), dtype=torch.bool,
                                   device=done.device)
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
    tracing.count_lanes(active, hit_active, state.defer, ok_c, hits)
    return state


def retire_cap(pool: int) -> int:
    """The most chunks a segment retires: max(pool // RETIRE_DIV, 64),
    at most the pool."""
    return min(max(pool // RETIRE_DIV, 64), pool)


def _samples_of(items: range, wh: int, samples: int,
                sample_chunk: int) -> int:
    """The samples that the work items `items` cover (the last sample
    chunk's items cover `last` samples, the others `chunk`)."""
    chunk, n_chunks, last = _chunk_geometry(samples, sample_chunk)
    in_last = max(0, items.stop - max(items.start, (n_chunks - 1) * wh))
    return len(items) * chunk - in_last * (chunk - last)


def _issue_block(state: PoolState, scene, camera, width: int, height: int,
                 samples: int, sampler, items: range, steps: int,
                 max_depth: int, sample_chunk: int, rr: bool,
                 pool_sort: Optional[int]) -> list:
    """Advance one worker's pool by `steps` iterations over its work items
    `items` (in place; no host read on a configuration of `graph_route`)
    -> each iteration's retired count, a () tensor each (keeping them
    costs the device nothing)."""
    counts = []
    for _ in range(steps):
        with tracing.phase("segment.regenerate"):
            _regenerate(state, camera, width, height, len(items), sampler,
                        item0=items.start)
        _segment(state, scene, width, height, sampler, max_depth, samples,
                 sample_chunk, rr, pool_sort)
        counts.append(state.retired)
    return counts


def _close_block(state: PoolState, counts: list, need: int) -> int:
    """The retired samples after a block, read on the host. When the pool
    ran dry inside the block (all `need` samples retired), `it` is set
    back to the iteration at which it did (the trailing iterations were
    no-ops), where the reference's loop stops."""
    retired = int(state.retired)
    if retired >= need:
        last = int((torch.stack(counts) >= need).int().argmax())
        state.it -= len(counts) - 1 - last
    return retired


def graph_route(scene: scene_ir.SceneIR, device,
                pool_sort: Optional[int] = None) -> bool:
    """Does render_state replay its blocks from a CUDA graph? Where graphs
    are on (kernels/build.py:graphs_on), unless the configuration's segment
    reads the host: a pool sort (a period > 0, from pool_sort or POOL_SORT,
    on a scene with a kernel mesh: _segment picks the permuting iterations
    by the host `it`) or a scene whose finds read the host
    (scene/ir.py:finds_read_host). Those run eagerly. The route follows
    from the configuration alone, never from a failure."""
    period = int(POOL_SORT if pool_sort is None else pool_sort)
    return (kbuild.graphs_on(device)
            and not (period > 0 and scene_ir.has_wavefront_sort_key(scene))
            and not scene_ir.finds_read_host(scene))


def _static_block(state: PoolState, it: torch.Tensor,
                  run: Callable[[PoolState], list]) -> list:
    """One block on the state's tensors as static buffers: `run` advances a
    copy of the state whose `it` is the 0-d device tensor `it` (in place),
    then its results are copied into the state's own tensors (fb is summed
    into in place) -> each iteration's retired count. What _BlockGraph
    captures."""
    work = dataclasses.replace(state, it=it)
    counts = run(work)
    for f in _LANE_FIELDS + ("counter", "retired"):
        out, static = getattr(work, f), getattr(state, f)
        if out is not static:
            static.copy_(out)
    return counts


class _BlockGraph(kbuild.GraphReplay):
    """One render's block as a CUDA graph (kernels/build.py:GraphReplay):
    run eagerly the first time (the warm-up), captured the second,
    replayed from then on, the launch counts kept equal to an eager
    render's.

    The state's tensors are the static buffers (_static_block). `it` is
    the 0-d int32 device tensor of the iteration, set from the state's
    host int before each block and advanced by the block itself.

    Every block runs with the state's device current, and the capture is
    made on a stream of that device, whichever card is current when the
    render starts. The capture is thread-local: another thread may use the
    card meanwhile (the CLI's checkpoint writer fetching a snapshot)."""

    def __init__(self, device):
        super().__init__(device)
        self.it = torch.zeros((), dtype=torch.int32, device=self.device)

    def run(self, state: PoolState, block) -> list:
        """Advance the state by one block -> each iteration's retired count
        (after a replay, the graph's own tensors, valid until the next)."""
        if state.fb.device != self.device:
            raise ValueError(f"the block graph of {self.device} was given a "
                             f"state on {state.fb.device}")
        with torch.cuda.device(self.device):
            self.it.fill_(state.it)
            counts = self(lambda: _static_block(state, self.it, block))
        state.it += len(counts)
        return counts


def _pool_run(state: PoolState, scene, camera, width: int, height: int,
              samples: int, sampler, steps: int, max_depth: int,
              sample_chunk: int, rr: bool, pool_sort: Optional[int],
              graph: Optional[_BlockGraph]) -> list:
    """Advance the pool by one block of `steps` iterations (in place) ->
    each iteration's retired count, a () tensor each. graph: None runs the
    block eagerly (the eager route); else the render's _BlockGraph runs
    it."""
    _, n_chunks, _ = _chunk_geometry(samples, sample_chunk)

    def block(st: PoolState) -> list:
        return _issue_block(st, scene, camera, width, height, samples,
                            sampler, range(width * height * n_chunks),
                            steps, max_depth, sample_chunk, rr, pool_sort)

    return block(state) if graph is None else graph.run(state, block)


@dataclass(eq=False)
class _KeptRender:
    """A render's block graph kept across renders (RenderGraphs): its cache
    key, the pool state whose tensors are the graph's static buffers, the
    _BlockGraph, the key slot that its draws read, the scene and camera
    that the key names and the tensors whose addresses it holds (`held`,
    kept alive so that no other tensor takes an address the graph reads),
    and for a traced graph the phase marks of its capture and the lane
    counters it adds to (tracing.py)."""
    key: tuple
    state: PoolState
    graph: _BlockGraph
    slot: rng_mod.KeySlot
    scene: scene_ir.SceneIR
    camera: Camera
    held: list
    marks: list = field(default_factory=list)
    lanes: Optional[tuple] = None
    kinds: dict = field(default_factory=dict)


class RenderGraphs:
    """The block graphs kept across renders, in one process
    (RENDER_GRAPHS): at most one for each (device, traced) pair, since a
    traced graph holds timing events and lane counters that an untraced
    one lacks. A render takes the kept graph of its cache key out (`take`)
    and gives it back when it has completed (`give`); a render that raises
    never gives it back, so no half-run state is kept. `hits` counts the
    renders that replayed a kept graph, `captures` those that made one to
    keep. A kept graph holds its memory pool, its state and its scene and
    camera until a miss replaces it or `clear` drops it."""

    def __init__(self):
        self.kept = {}
        self.hits = 0
        self.captures = 0

    def clear(self) -> None:
        """Drop every kept graph, with its state, scene and camera (the
        counts stay): the next render captures again."""
        self.kept.clear()

    def take(self, key: tuple) -> Optional[_KeptRender]:
        """The kept graph of `key`, taken out, or None. A kept graph of
        another key on the same (device, traced) pair is dropped (a miss
        replaces it), so its memory is free before the new capture."""
        entry = self.kept.pop(key[:2], None)
        return entry if entry is not None and entry.key == key else None

    def give(self, entry: _KeptRender) -> None:
        self.kept[entry.key[:2]] = entry


RENDER_GRAPHS = RenderGraphs()


def _cuda_index(device) -> torch.device:
    """`device` with the current card's index where a CUDA device names
    none."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _kept_render(scene, camera, width: int, height: int, samples: int,
                 max_depth: int, pool: int, steps_per_call: int,
                 sample_chunk: int, rr: bool, pool_sort: Optional[int],
                 device: torch.device, traced: bool):
    """The kept graph of this render's configuration, reset to an empty
    pool, or a new one to keep -> (entry, "hit" or "capture"). The key is
    everything the graph's capture holds fixed: the scene and camera
    objects, each tensor's address and layout and each plain attribute in
    them, ops/intersect.py's switches, the film, spp, depth, pool, block
    length, sample chunk, RR, the pool sort's period, RETIRE_DIV, the
    device and whether the render is traced."""
    held = []
    period = int(POOL_SORT if pool_sort is None else pool_sort)
    key = (device, traced, isect.switches(), id(scene), id(camera),
           kbuild.held(scene, held), kbuild.held(camera, held), width,
           height, samples, max_depth, pool, steps_per_call, sample_chunk,
           rr, period, RETIRE_DIV)
    entry = RENDER_GRAPHS.take(key)
    if entry is not None:
        RENDER_GRAPHS.hits += 1
        reset_state(entry.state)
        return entry, "hit"
    RENDER_GRAPHS.captures += 1
    return _KeptRender(key, init_state(width, height, pool, device),
                       _BlockGraph(device),
                       rng_mod.KeySlot(device, rng_mod.STREAM_TAGS), scene,
                       camera, held), "capture"


@contextlib.contextmanager
def _rendering(scene, camera, width: int, height: int, samples: int,
               sampler, max_depth: int, pool: int, steps_per_call: int,
               progress_cb, state: Optional[PoolState], checkpoint_cb,
               sample_chunk: int, rr: bool, pool_sort: Optional[int]):
    """Run the render (render_state's arguments) -> (its finished state,
    kept): with kept true the state is a kept graph's buffers, which the
    next render writes into, and the graph is given back for that render
    when the with-block ends without an exception."""
    wh = width * height
    _, n_chunks, _ = _chunk_geometry(samples, sample_chunk)
    total_items = wh * n_chunks
    total_samples = wh * samples
    if state is None:
        device, pool = _cuda_index(sampler.device), min(pool, total_items)
    elif state.retired.ndim != 0:
        raise ValueError(
            f"checkpoint holds {state.retired.shape[0]} stacked worker "
            "states; resume it on a mesh of that size, not single-device")
    else:
        device, pool = state.fb.device, state.item.shape[0]
    on_graph = graph_route(scene, device, pool_sort)
    kept = None
    with tracing.job("render", device, width=width, height=height,
                     spp=samples, pool=pool, cap=retire_cap(pool),
                     steps=steps_per_call, **_sphere_attrs(scene)) as job:
        if on_graph and state is None:
            kept, how = _kept_render(
                scene, camera, width, height, samples, max_depth, pool,
                steps_per_call, sample_chunk, rr, pool_sort, device,
                job is not None)
            state, graph = kept.state, kept.graph
            kept.slot.fill(sampler.key)
            sampler = sampler.slotted(kept.slot)
        else:
            # a resumed render on the graph route captures a graph of its
            # own, as every render did before graphs were kept
            how = "capture" if on_graph else "eager"
            if state is None:
                state = init_state(width, height, pool, device)
            graph = _BlockGraph(device) if on_graph else None
        if job is not None:
            job.root.attrs["graph"] = how
            if how == "hit":
                # replays read the marks of the graph's capture and add to
                # its lane counters, zeroed
                job.captured = kept.marks
                job.lanes, job.kinds = kept.lanes, kept.kinds
                for counts in (*kept.lanes, *kept.kinds.values()):
                    counts.zero_()
        tracing.lane_counters(device, pool, retire_cap(pool),
                              _lane_kinds(scene))
        retired = int(state.retired)
        block = 0
        while retired < total_samples:
            with tracing.span("block", index=block):
                counts = _pool_run(state, scene, camera, width, height,
                                   samples, sampler, steps_per_call,
                                   max_depth, sample_chunk, rr, pool_sort,
                                   graph)
                with tracing.span("host_read"):
                    retired = _close_block(state, counts, total_samples)
                tracing.read_phases(len(counts))
            block += 1
            if progress_cb is not None:
                progress_cb(retired, total_samples)
            if checkpoint_cb is not None:
                checkpoint_cb(state)
        if kept is not None and job is not None:
            kept.marks, kept.lanes, kept.kinds = (job.captured, job.lanes,
                                                  job.kinds)
    yield state, kept is not None
    if kept is not None:
        RENDER_GRAPHS.give(kept)


def render_state(scene: scene_ir.SceneIR, camera: Camera, width: int,
                 height: int, samples: int, sampler,
                 max_depth: int = MAX_DEPTH, pool: int = DEFAULT_POOL,
                 steps_per_call: int = STEPS_PER_CALL,
                 progress_cb: Optional[Callable[[int, int], None]] = None,
                 state: Optional[PoolState] = None,
                 checkpoint_cb: Optional[Callable[[PoolState], None]] = None,
                 sample_chunk: int = SAMPLE_CHUNK, rr: bool = True,
                 pool_sort: Optional[int] = None) -> PoolState:
    """Run the pool to completion on `sampler.device` (scene and camera
    must already be there); fb holds the radiance SUM over `samples`.

    Each block of `steps_per_call` iterations goes through _pool_run: on
    the graph route (graph_route: a CUDA device and a segment that reads
    no host value) from a CUDA graph, otherwise eagerly. The graph is kept
    across renders (RENDER_GRAPHS) under a key of everything its capture
    holds fixed (_kept_render). The first render of a key runs its first
    block eagerly, captures the second and replays every later one; a
    later render of the key resets the kept state in place (reset_state)
    and replays every block, the first included, drawing under its own
    sampler's key (host words) from the graph's key slot. Every route
    gives the same state bit for bit where the device's sums are
    deterministic, and the state returned is the caller's own (on the
    graph route a copy of the kept one).

    Completion (retired == W*H*samples) is read on the host after every
    block of `steps_per_call` iterations, where progress_cb(retired, total)
    and then checkpoint_cb(state) fire, the latter with the live state
    (the next block updates it in place: copy what must outlive the call).
    The iterations of the last block that ran after the pool went dry (no
    item left to issue, none in a lane) are no-ops, and the state comes
    back with `it` set to the first of them, the iteration at which the
    reference's loop stops.
    state: resume from a saved state (io/checkpoint.py:load_state) of this
    render, on `sampler.device`; it goes on from its own `it` (updated in
    place and returned; on the graph route through a graph made for the
    call, never a kept one), and one whose pool is dry already comes back
    at once. A stacked multi-worker state belongs to
    parallel/shard.py:render_wavefront_sharded and is refused. pool_sort:
    the pool sort's period, see _segment."""
    with _rendering(scene, camera, width, height, samples, sampler,
                    max_depth, pool, steps_per_call, progress_cb, state,
                    checkpoint_cb, sample_chunk, rr, pool_sort) as (st, kept):
        return _copy_state(st) if kept else st


def _copy_state(state: PoolState) -> PoolState:
    """A copy of `state` that shares no tensor with it."""
    return dataclasses.replace(state, **{
        f: getattr(state, f).clone() for f in _EMPTY})


def _sphere_attrs(scene: scene_ir.SceneIR) -> dict:
    """A traced render's attributes of its pooled spheres (none without)."""
    route = scene_ir.sphere_route(scene)
    if route is None:
        return {}
    return {"spheres": scene.spheres.center.shape[0], "sphere_route": route}


def _lane_kinds(scene: scene_ir.SceneIR) -> tuple:
    """The tracing.LANE_KINDS counters that the scene has lanes for."""
    return tuple(name for name, has in zip(tracing.LANE_KINDS, (
        not scene.spheres.empty,
        shade_ops.MAT_DIELECTRIC in scene.materials.present)) if has)


def render_image(scene: scene_ir.SceneIR, camera: Camera, width: int,
                 height: int, samples: int, sampler,
                 max_depth: int = MAX_DEPTH, pool: int = DEFAULT_POOL,
                 progress_cb=None, state: Optional[PoolState] = None,
                 checkpoint_cb=None, sample_chunk: int = SAMPLE_CHUNK,
                 rr: bool = True,
                 pool_sort: Optional[int] = None) -> torch.Tensor:
    """Full render -> tonemapped (H, W, 3) float image in [0, 1] (average
    -> ACES -> gamma, as the reference); state / checkpoint_cb as in
    render_state."""
    with tracing.job("render", sampler.device), _rendering(
            scene, camera, width, height, samples, sampler, max_depth, pool,
            STEPS_PER_CALL, progress_cb, state, checkpoint_cb, sample_chunk,
            rr, pool_sort) as (st, _):
        with tracing.span("film"):
            return film_image(st.fb, width, height, samples)


def film_image(fb: torch.Tensor, width: int, height: int,
               samples: int) -> torch.Tensor:
    """A (3, W*H) radiance sum over `samples` -> the tonemapped (H, W, 3)
    image."""
    return film_ops.tonemap(fb.T / float(samples)).reshape(height, width, 3)
