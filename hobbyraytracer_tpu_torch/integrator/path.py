"""The batch path-tracing integrator (counterpart of
hobbyraytracer_tpu/integrator/path.py), and the pieces the wavefront
integrator shares with it: the bounce cap and the miss shading.

The whole pixel batch is one wavefront; the bounce loop's per-ray breaks
are updates of an active mask. Radiance per bounce (main.cpp:43-76):

    miss: result += throughput * background(dir); stop
    hit:  result += throughput * emitted
          scatter ? (throughput *= attenuation; continue) : stop

Where the reference runs a lax.while_loop, `trace` is a Python loop that
reads one flag from the device every bounce (is any ray still active?) and
stops when none is, or at max_depth. Lanes that ended keep riding along:
this integrator is the simple one, the wavefront integrator the fast one.
The sampler's stream index is the bounce.

On a CUDA device (batch_route) a render runs as the reference's jitted
sample loop does: BatchRun replays each sample's start, its bounces in
blocks of BOUNCE_BLOCK and its sum from CUDA graphs captured once a
render, with one host read a block and the sample's key in a device slot
(core/rng.py:KeySlot). Its radiance is `trace`'s bit for bit.

`trace_diff` is the differentiable variant the fit (diff/fit.py) renders
with: a fixed number of bounces with no host read, each bounce
checkpointed, the discrete decisions (which triangle, reflect or refract,
absorb) taken without gradients and the path's shading chain replayed
with them.
"""
from __future__ import annotations

import contextlib
import functools
import math

import torch
from torch.utils.checkpoint import checkpoint

from ..core import mathx
from ..core import rng as rng_mod
from ..core.types import Rays
from ..kernels import build as kbuild
from ..ops import film as film_ops
from ..ops import shade as shade_ops
from ..ops import texture as tex_ops
from ..ops.camera import Camera, get_rays
from ..scene import ir as scene_ir

MAX_DEPTH = 50  # main.cpp:32
# bounces a graph replays between two host reads: the whole default depth,
# since at 128x128 and 640x640 some lane of every sample lived through all
# 50 bounces (teapot, scattered_balls, cornell_smoke), so smaller blocks
# only added captures and host reads (scripts/time_batch_block.py)
BOUNCE_BLOCK = MAX_DEPTH


def background_colour(scene, d: torch.Tensor) -> torch.Tensor:
    """Miss shading: equirectangular lookup of the normalized direction
    (main.cpp:46-58): u = atan2(z, x)/2pi + 0.5, v = acos(y)/pi, through
    the background texture (solid textures ignore uv)."""
    nd = mathx.normalize(d)
    phi = torch.atan2(nd[..., 2], nd[..., 0])
    theta = mathx.safe_arccos(nd[..., 1])
    u = phi / (2.0 * math.pi) + 0.5
    v = theta / math.pi
    tex_id = scene.background_tex.expand(u.shape)
    p = torch.zeros(u.shape + (3,), dtype=torch.float32, device=d.device)
    return tex_ops.colour_value(scene.textures, tex_id, u, v, p)


def _bounce(scene: scene_ir.SceneIR, sampler, mesh_backend: str, span,
            bounce: int, o, d, result, throughput, active):
    """One bounce of the radiance recurrence for every ray -> the next
    (o, d, result, throughput, active). span: the rays are rows of a larger
    batch (core/rng.py)."""
    r = Rays(o=o, d=d)
    hits = scene_ir.intersect_scene(scene, r, sampler=sampler, bounce=bounce,
                                    mesh_backend=mesh_backend,
                                    rng_span=span)
    miss = active & ~hits.hit
    result = result + torch.where(
        miss[:, None], throughput * background_colour(scene, d), 0.0)
    emit = shade_ops.emitted(scene.materials, scene.textures, hits)
    hit_active = active & hits.hit
    result = result + torch.where(hit_active[:, None], throughput * emit,
                                  0.0)
    ok, atten, new_d = shade_ops.scatter(scene.materials, scene.textures, r,
                                         hits, sampler, bounce, span)
    active = hit_active & ok
    throughput = torch.where(active[:, None], throughput * atten, throughput)
    o = torch.where(active[:, None], hits.p, o)
    d = torch.where(active[:, None], new_d, d)
    return o, d, result, throughput, active


def _start(rays: Rays):
    """The carry of a fresh wavefront: (o, d, result 0, throughput 1,
    every ray active)."""
    n = rays.o.shape[0]
    dev = rays.o.device
    return (rays.o, rays.d,
            torch.zeros((n, 3), dtype=torch.float32, device=dev),
            torch.ones((n, 3), dtype=torch.float32, device=dev),
            torch.ones((n,), dtype=torch.bool, device=dev))


def trace(scene: scene_ir.SceneIR, rays: Rays, sampler,
          max_depth: int = MAX_DEPTH,
          mesh_backend: str = "kernel", rng_span=None) -> torch.Tensor:
    """Radiance (N, 3) for a wavefront of rays on `sampler.device`. Every
    draw is array-shaped, one value a ray, from the stream of (purpose,
    bounce); with rng_span=(offset, total) the rays are rows offset:offset+N
    of a batch of `total`, and each draw takes those rows of that batch's
    draw. The loop stops when no ray of these is active, which changes no
    ray's radiance."""
    carry = _start(rays)
    for bounce in range(max_depth):
        if not bool(carry[4].any()):      # the one host read of a bounce
            break
        carry = _bounce(scene, sampler, mesh_backend, rng_span, bounce,
                        *carry)
    return carry[2]


def trace_diff(scene: scene_ir.SceneIR, rays: Rays, sampler,
               max_depth: int = 8,
               mesh_backend: str = "kernel_replay",
               rng_span=None) -> torch.Tensor:
    """Radiance (N, 3) of `trace`, differentiable in the scene's buffers
    and the rays (reference integrator/path.py:88-142).

    The bounce loop runs exactly max_depth bounces: no early exit and no
    host read (lanes that ended ride along masked). Each bounce runs under
    torch.utils.checkpoint, so the backward pass keeps only the carry
    (o, d, result, throughput, active) between bounces and recomputes a
    bounce's intermediates when it reaches it: reverse-mode memory is
    O(max_depth x carry). The radiance is `trace`'s. Discrete decisions
    carry no gradient: the mesh find runs without gradients and is
    replayed from the winning triangle (mesh_backend "kernel_replay", the
    default: K1 / K2 over the mesh's tables; "lockstep": the lockstep
    find over the live vertices), and scatter's choices are detached.
    Every draw is threefry's (core/rng.py), none torch's generator's, so
    the checkpoints stash no generator state (preserve_rng_state=False):
    that changes no number, and a fit step captured into a CUDA graph
    (diff/fit.py) reads no generator's state. rng_span: as in `trace`."""
    carry = _start(rays)
    for bounce in range(max_depth):
        carry = checkpoint(_bounce, scene, sampler, mesh_backend, rng_span,
                           bounce, *carry, use_reentrant=False,
                           preserve_rng_state=False)
    return carry[2]


def pixel_grid(width: int, height: int, device, pix0: int = 0,
               n_pix=None):
    """Pixel positions in the reference's indexing (main.cpp:114-116):
    x = i % W, y = H - i // W, each (n_pix,) float32 for the pixels i =
    pix0 .. pix0 + n_pix - 1 (default all W*H) (y runs over [1, H], so v
    can pass 1 in the top row: the reference's quirk, kept)."""
    if n_pix is None:
        n_pix = width * height - pix0
    pidx = torch.arange(pix0, pix0 + n_pix, dtype=torch.int32, device=device)
    x = torch.remainder(pidx, width).to(torch.float32)
    y = (height - torch.div(pidx, width, rounding_mode="floor")).to(
        torch.float32)
    return x, y


def batch_route(scene: scene_ir.SceneIR, device,
                mesh_backend: str = "kernel") -> bool:
    """Does the batch integrator replay its samples from CUDA graphs
    (BatchRun)? Yes on a CUDA device, unless a bounce reads the host:
    mesh_backend "lockstep" (the lockstep find reads a count a visit round)
    or a scene whose finds read the host (scene/ir.py:finds_read_host).
    Those run `trace`'s per-bounce loop. The route follows from the
    configuration alone, never from a failure."""
    return (torch.device(device).type == "cuda" and mesh_backend != "lockstep"
            and not scene_ir.finds_read_host(scene))


class BatchRun:
    """The batch route of one render (or one worker's pixels
    pix0 .. pix0 + n_pix - 1): its static buffers and, where graphs are on
    (kernels/build.py:graphs_on), its CUDA graphs.

    A sample is three kinds of step on the static buffers, each a function
    of no argument that reads no host value (what a graph captures):
    `start` draws the jitters from split keys 0 and 1 of the sample's key
    and the camera rays (the lens from key 2) and resets the carry
    (o, d, result, throughput, active); `block(bounces)` runs those bounces
    of `_bounce` on the carry (host ints, B = BOUNCE_BLOCK of them as the
    run is made, the last block the remainder of max_depth) and sets
    `live` to whether any lane is still active; `add` sums the carry's
    radiance into `acc`. The sample's key, fold_in(key, s), is written into
    a KeySlot before its start, and every draw reads it there. Before each
    block the host reads `live` (the reference's while_loop stop); lanes
    that ended ride along masked, so the radiance is `trace`'s bit for bit
    whatever B is.

    With graphs the run's first sample runs eagerly (the warm-up), its
    second captures the start, every block and the add, in that order,
    into CUDA graphs that share one capture stream and one memory pool
    (kernels/build.py:GraphReplay), and every sample from then on replays
    them. Without, the same steps run eagerly. A capture or replay that
    fails raises."""

    def __init__(self, scene: scene_ir.SceneIR, camera: Camera, width: int,
                 height: int, sampler, max_depth: int = MAX_DEPTH,
                 mesh_backend: str = "kernel", pix0: int = 0, n_pix=None):
        self.scene, self.camera, self.mesh_backend = scene, camera, mesh_backend
        self.width, self.height = width, height
        self.device = torch.device(sampler.device)
        self.x, self.y = pixel_grid(width, height, self.device, pix0, n_pix)
        n = self.x.shape[0]
        self.span = None if n == width * height else (pix0, width * height)
        self.slot = rng_mod.KeySlot(self.device)
        self.ku, self.kv, self.kt = sampler.slotted(self.slot).split(3)
        self.carry = _start(Rays(
            o=torch.zeros((n, 3), dtype=torch.float32, device=self.device),
            d=torch.zeros((n, 3), dtype=torch.float32, device=self.device)))
        self.live = torch.zeros((), dtype=torch.bool, device=self.device)
        self.acc = torch.zeros((n, 3), dtype=torch.float32,
                               device=self.device)
        self.blocks = [range(b, min(b + BOUNCE_BLOCK, max_depth))
                       for b in range(0, max_depth, BOUNCE_BLOCK)]
        self.graphs = None
        if kbuild.graphs_on(self.device):
            stream = torch.cuda.Stream(self.device)
            pool = torch.cuda.graph_pool_handle()
            self.graphs = [kbuild.GraphReplay(self.device, stream, pool)
                           for _ in range(len(self.blocks) + 2)]
        self.samples = 0    # samples run
        self.bounces = 0    # bounces run (whole blocks)

    def _keep(self, carry) -> None:
        for buf, val in zip(self.carry, carry):
            buf.copy_(val)
        self.live.copy_(carry[4].any())

    def start(self) -> None:
        """The sample's camera rays and a fresh carry."""
        ju = self.ku.key_uniform(self.x.shape, self.span)
        jv = self.kv.key_uniform(self.y.shape, self.span)
        rays = get_rays(self.camera, (self.x + ju) / (self.width - 1),
                        (self.y + jv) / (self.height - 1), self.kt, 0,
                        self.span)
        self._keep(_start(rays))

    def block(self, bounces: range) -> None:
        """The bounces `bounces` of every lane, in place on the carry."""
        carry = self.carry
        for bounce in bounces:
            carry = _bounce(self.scene, self.kt, self.mesh_backend,
                            self.span, bounce, *carry)
        self._keep(carry)

    def add(self) -> None:
        """acc += the sample's radiance."""
        self.acc.add_(self.carry[2])

    def steps(self) -> list:
        """The sample's steps in their order: start, each block, add. (Made
        for each sample and not kept: a run holds no reference to itself,
        so it is freed when its render drops it, never by the garbage
        collector in the middle of another capture.)"""
        return ([self.start] + [functools.partial(self.block, b)
                                for b in self.blocks] + [self.add])

    def sample(self, key: rng_mod.Key) -> None:
        """Add one sample drawn under `key` (host words) to acc."""
        steps = self.steps()
        replay = self.graphs is not None and self.samples > 0

        def step(i):
            if replay:
                self.graphs[i].replay()
            else:
                steps[i]()

        on_card = self.device.type == "cuda"
        with (torch.cuda.device(self.device) if on_card
              else contextlib.nullcontext()):
            self.slot.fill(key)
            if replay and self.samples == 1:
                for graph, fn in zip(self.graphs, steps):
                    graph.capture(fn)
            step(0)
            for i, bounces in enumerate(self.blocks):
                if not bool(self.live):    # the one host read of a block
                    break
                step(1 + i)
                self.bounces += len(bounces)
            step(len(steps) - 1)
        self.samples += 1

    def sample_sum(self, sampler, n_samples: int) -> torch.Tensor:
        """The radiance sum of n_samples samples, sample s drawn under
        sampler.fold_in(s) as in sample_radiance -> `acc` (the run's
        buffer: valid until its next sample_sum)."""
        self.acc.zero_()
        for s in range(n_samples):
            self.sample(sampler.fold_in(s).key)
        return self.acc


def _batch_run(scene, camera, width, height, sampler, max_depth,
               mesh_backend, pix0, n_pix):
    """The render's BatchRun on the batch route, or None for the
    per-bounce loop."""
    if not batch_route(scene, sampler.device, mesh_backend):
        return None
    return BatchRun(scene, camera, width, height, sampler, max_depth,
                    mesh_backend, pix0, n_pix)


def _sample_loop(scene: scene_ir.SceneIR, camera: Camera, width: int,
                 height: int, sampler, n_samples: int,
                 max_depth: int = MAX_DEPTH, mesh_backend: str = "kernel",
                 pix0: int = 0, n_pix=None) -> torch.Tensor:
    """sample_radiance by `trace`'s per-bounce loop, its keys folded on the
    host."""
    wh = width * height
    x, y = pixel_grid(width, height, sampler.device, pix0, n_pix)
    span = None if x.shape[0] == wh else (pix0, wh)
    acc = torch.zeros((x.shape[0], 3), dtype=torch.float32,
                      device=sampler.device)
    for s in range(n_samples):
        ku, kv, kt = sampler.fold_in(s).split(3)
        ju = ku.key_uniform(x.shape, span)
        jv = kv.key_uniform(y.shape, span)
        rays = get_rays(camera, (x + ju) / (width - 1),
                        (y + jv) / (height - 1), kt, 0, span)
        acc = acc + trace(scene, rays, kt, max_depth,
                          mesh_backend=mesh_backend, rng_span=span)
    return acc


def sample_radiance(scene: scene_ir.SceneIR, camera: Camera, width: int,
                    height: int, sampler, n_samples: int,
                    max_depth: int = MAX_DEPTH,
                    mesh_backend: str = "kernel", pix0: int = 0,
                    n_pix=None) -> torch.Tensor:
    """Sum of radiance (n_pix, 3) over n_samples jittered samples a pixel
    for the pixels pix0 .. pix0 + n_pix - 1 (default the whole W*H image):
    u = (x + U) / (W - 1), v = (y + U) / (H - 1) (main.cpp:120-121).
    Sample s splits sampler.fold_in(s) into three keys, as the reference:
    the two jitters draw from the first two, the lens and the bounces
    stream the third. Every draw is the image's draw sliced to these
    pixels, so a slice equals the same rows of the whole image bit for bit
    (the batch render of parallel/shard.py).

    On batch_route's CUDA route the samples run through a BatchRun;
    otherwise through `trace`'s per-bounce loop. All give the same sum bit
    for bit."""
    run = _batch_run(scene, camera, width, height, sampler, max_depth,
                     mesh_backend, pix0, n_pix)
    if run is None:
        return _sample_loop(scene, camera, width, height, sampler,
                            n_samples, max_depth, mesh_backend, pix0, n_pix)
    return run.sample_sum(sampler, n_samples)


def radiance_sum(scene: scene_ir.SceneIR, camera: Camera, width: int,
                 height: int, samples: int, sampler,
                 max_depth: int = MAX_DEPTH, sample_chunk: int = 0,
                 progress_cb=None, pix0: int = 0,
                 n_pix=None) -> torch.Tensor:
    """The radiance sum (n_pix, 3) of render_image before its film, for the
    pixels pix0 .. pix0 + n_pix - 1 (default the whole image), equal to
    those rows of the whole image's bit for bit. One BatchRun (one set of
    graphs) serves every chunk."""
    n = width * height - pix0 if n_pix is None else n_pix
    run = _batch_run(scene, camera, width, height, sampler, max_depth,
                     "kernel", pix0, n)

    def chunk_sum(chunk_sampler, c):
        if run is None:
            return _sample_loop(scene, camera, width, height, chunk_sampler,
                                c, max_depth, pix0=pix0, n_pix=n)
        return run.sample_sum(chunk_sampler, c)

    if sample_chunk <= 0 or sample_chunk >= samples:
        total = chunk_sum(sampler, samples)
        if progress_cb is not None:
            progress_cb(n * samples, n * samples)
        return total
    total = torch.zeros((n, 3), dtype=torch.float32, device=sampler.device)
    done = 0
    chunk_i = 0
    while done < samples:
        c = min(sample_chunk, samples - done)
        total = total + chunk_sum(sampler.fold_in(1000003 + chunk_i), c)
        done += c
        chunk_i += 1
        if progress_cb is not None:
            progress_cb(n * done, n * samples)
    return total


def render_image(scene: scene_ir.SceneIR, camera: Camera, width: int,
                 height: int, samples: int, sampler,
                 max_depth: int = MAX_DEPTH, sample_chunk: int = 0,
                 progress_cb=None) -> torch.Tensor:
    """Full render on `sampler.device` -> tonemapped (H, W, 3) float image
    in [0, 1] (average -> ACES -> gamma).

    sample_chunk > 0 splits the samples into chunks of that many, chunk i
    drawing from sampler.fold_in(1000003 + i); progress_cb(done_samples,
    total_samples) fires after each chunk (a render in one chunk reports
    its completion only)."""
    total = radiance_sum(scene, camera, width, height, samples, sampler,
                         max_depth, sample_chunk, progress_cb)
    return film_ops.tonemap(total / float(samples)).reshape(height, width, 3)
