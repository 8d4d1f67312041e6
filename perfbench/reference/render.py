"""The wavefront render of the reference: a pool of lanes, each tracing one
path segment an iteration, a lane whose path ends starting the next sample
of its work item, finished items retired into a planar framebuffer.

The schedule is the renderer's: work items of SAMPLE_CHUNK consecutive
samples of one pixel, sample-chunk-major (item i is pixel i % (W*H) of
chunk i // (W*H)); idle lanes take new items in lane order; every draw of
iteration `it` is the (purpose, it) stream of the render's key, one value
a lane; Russian roulette from depth RR_START with survival floor RR_MIN_P;
at most max(pool // RETIRE_DIV, 64) lanes retire an iteration, in pixel
order, the rest later. The image is the radiance sum over the samples,
averaged and tonemapped.
"""
from __future__ import annotations

import torch

from . import rng
from . import trace as tr

SAMPLE_CHUNK = 4
RETIRE_DIV = 12
RR_START = 4
RR_MIN_P = 0.05
_BIGI = 2 ** 30


class Pool:
    """The render's whole state: the framebuffer fb (3, W*H) and the pool's
    lanes (origin o, direction d, throughput thr, radiance of the item rad,
    item, depth, sub: samples of the chunk done, defer: retirement owed),
    the next item `counter`, the retired samples and the iteration `it`.
    `step` runs one iteration: regenerate, then one segment."""

    def __init__(self, sc: tr.DeviceScene, width: int, height: int,
                 samples: int, seed: int, max_depth: int = 50,
                 pool: int = 196_608, rr: bool = True):
        dev, dt = sc.device, sc.dtype
        self.sc, self.width, self.height = sc, width, height
        self.samples, self.max_depth, self.rr = samples, max_depth, rr
        self.key = rng.seed_key(seed)
        self.wh = width * height
        self.chunk = max(1, min(SAMPLE_CHUNK, samples))
        self.n_chunks = -(-samples // self.chunk)
        self.last = samples - (self.n_chunks - 1) * self.chunk
        self.total_items = self.wh * self.n_chunks
        self.pool = pool = min(pool, self.total_items)
        self.cap = min(max(pool // RETIRE_DIV, 64), pool)
        i32 = dict(dtype=torch.int32, device=dev)
        self.fb = torch.zeros((3, self.wh), dtype=dt, device=dev)
        self.o = torch.zeros((pool, 3), dtype=dt, device=dev)
        self.d = torch.ones((pool, 3), dtype=dt, device=dev)
        self.thr = torch.zeros((pool, 3), dtype=dt, device=dev)
        self.rad = torch.zeros((pool, 3), dtype=dt, device=dev)
        self.item = torch.full((pool,), -1, **i32)
        self.depth = torch.zeros((pool,), **i32)
        self.sub = torch.zeros((pool,), **i32)
        self.defer = torch.zeros((pool,), dtype=torch.bool, device=dev)
        self.counter = torch.zeros((), **i32)
        self.retired = torch.zeros((), **i32)
        self.it = 0

    def done(self) -> bool:
        return int(self.retired) >= self.wh * self.samples

    def step(self) -> None:
        sc, key, it, wh = self.sc, self.key, self.it, self.wh
        width, height, pool = self.width, self.height, self.pool
        dev, dt = sc.device, sc.dtype
        u = rng.uniforms([rng.stream(key, rng.PIXEL_JITTER_U, it),
                          rng.stream(key, rng.PIXEL_JITTER_V, it),
                          rng.fold(rng.stream(key, rng.SCATTER_SPHERE, it), 0),
                          rng.fold(rng.stream(key, rng.SCATTER_SPHERE, it), 1),
                          rng.stream(key, rng.RUSSIAN_ROULETTE, it)],
                         pool, dev, dt)
        o, d, thr, rad = self.o, self.d, self.thr, self.rad
        item, depth, sub, defer = self.item, self.depth, self.sub, self.defer
        # issue new items to idle lanes, fresh camera rays where needed
        idle = item < 0
        rank = torch.cumsum(idle.to(torch.int32), 0, dtype=torch.int32) - 1
        new_item = self.counter + rank
        issue = idle & (new_item < self.total_items)
        fresh = issue | ((item >= 0) & (depth < 0))
        item = torch.where(issue, new_item, item)
        pix = torch.remainder(torch.clamp(item, min=0), wh)
        x = torch.remainder(pix, width).to(dt)
        y = (height - torch.div(pix, width, rounding_mode="floor")).to(dt)
        co, cd = tr.camera_rays(sc, (x + u[0]) / (width - 1),
                                (y + u[1]) / (height - 1))
        n_issued = torch.clamp(torch.minimum(
            idle.sum(dtype=torch.int32), self.total_items - self.counter),
            min=0)
        f3 = fresh[:, None]
        o = torch.where(f3, co, o)
        d = torch.where(f3, cd, d)
        thr = torch.where(f3, 1.0, thr)
        rad = torch.where(issue[:, None], 0.0, rad)
        depth = torch.where(fresh, 0, depth)
        sub = torch.where(issue, 0, sub)
        self.counter = self.counter + n_issued

        # one segment
        active = (item >= 0) & (depth >= 0) & ~defer
        h = tr.intersect(sc, o, d, active)
        miss = active & ~h.hit
        rad = rad + torch.where(miss[:, None], thr * tr.background(sc, d),
                                0.0)
        hit_active = active & h.hit
        rad = rad + torch.where(hit_active[:, None],
                                thr * tr.emitted(sc, sc.mats, h), 0.0)
        ok, atten, new_d = tr.scatter(sc, sc.mats, d, h,
                                      tr.on_sphere(u[2], u[3]))
        depth = depth + 1
        cont = hit_active & ok & (depth < self.max_depth)
        thr = torch.where(cont[:, None], thr * atten, thr)
        if self.rr:
            p = torch.clamp(thr.max(dim=1).values, RR_MIN_P, 1.0)
            rr_on = cont & (depth >= RR_START)
            kill = rr_on & (u[4] >= p)
            thr = torch.where((rr_on & ~kill)[:, None], thr / p[:, None], thr)
            cont = cont & ~kill
        self.o = torch.where(cont[:, None], h.p, o)
        self.d = torch.where(cont[:, None], new_d, d)

        chunk_n = torch.where(
            torch.div(item, wh, rounding_mode="floor") == self.n_chunks - 1,
            self.last, self.chunk).to(torch.int32)
        end = active & ~cont
        more = end & (sub + 1 < chunk_n)
        finished = end & (sub + 1 >= chunk_n)
        self.sub = torch.where(more, sub + 1, sub)
        self.depth = torch.where(more, -1, depth)

        done = finished | defer
        skey = torch.where(done, torch.remainder(item, wh), _BIGI)
        order = torch.argsort(skey, stable=True)[:self.cap]
        pix_c = skey[order]
        ok_c = pix_c < _BIGI
        vals = torch.where(ok_c[:, None], rad[order], 0.0)
        self.fb.index_add_(1, torch.where(ok_c, pix_c, 0).long(),
                           vals.T.contiguous())
        gone = torch.zeros((pool,), dtype=torch.bool, device=dev)
        gone[order] = ok_c
        self.thr, self.rad = thr, rad
        self.item = torch.where(gone, -1, item)
        self.defer = done & ~gone
        self.retired = self.retired + torch.where(gone, chunk_n, 0).sum(
            dtype=torch.int32)
        self.it += 1

    def image(self) -> torch.Tensor:
        """The tonemapped (H, W, 3) image of the radiance sums."""
        return tr.tonemap(self.fb.T / float(self.samples)).reshape(
            self.height, self.width, 3)


def render(sc: tr.DeviceScene, width: int, height: int, samples: int,
           seed: int, max_depth: int = 50, pool: int = 196_608,
           rr: bool = True) -> torch.Tensor:
    """The tonemapped (H, W, 3) image of a render of `samples` samples a
    pixel from `seed` (its completion read every 8 iterations)."""
    p = Pool(sc, width, height, samples, seed, max_depth, pool, rr)
    while not (p.it % 8 == 0 and p.done()):
        p.step()
    return p.image()
