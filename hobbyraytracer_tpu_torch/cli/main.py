"""CLI entry point (reference main.cpp:142-195; counterpart of
hobbyraytracer_tpu/cli/main.py).

    python -m hobbyraytracer_tpu_torch.cli.main render scenes/teapot_scene.yaml -o out.png --device cuda
    python -m hobbyraytracer_tpu_torch.cli.main fit scenes/shiny_teapot.yaml --device cuda
    python -m hobbyraytracer_tpu_torch.cli.main bench --device cuda

`render` renders a YAML scene (default cuda; nothing falls back to the CPU)
through the wavefront integrator, or with `--integrator batch` through the
batch integrator (integrator/path.py), and prints the reference's "Loaded
scene" / "Done!" lines plus the primary rays/s. A bare scene path means
`render`, like the reference binary.

--device names the workers, comma-separated ("cuda:0,cuda:0", "cpu,cpu");
"cuda" alone is every visible card, as the JAX CLI takes every device;
--cpu is --device cpu. With more than one worker `render` splits the work
over them (parallel/shard.py) and `fit` runs the sharded fit step.
--coordinator / --num-processes / --process-id join a render or fit across
processes (torch.distributed over gloo; the framebuffer, the gradients and
the loss are summed over the processes; process 0 writes the image).

--checkpoint FILE writes the render's whole state to FILE every
--checkpoint-every seconds (30) from a writer thread, and --resume goes on
from FILE when it exists (the geometry must match: io/checkpoint.py); a
multi-worker render writes the workers' states stacked, and resumes on a
mesh of the same size only. Checkpoints are refused across processes.
--profile DIR writes a torch.profiler trace of the render to DIR
(render_rank{r}.json, with the program's hrt.* spans as annotations) and
the program's own record of it (tracing.py: spans, device phase times,
counters) as DIR/spans_rank{r}.jsonl;
--debug-nans raises on the first non-finite value in the render's state,
checked after every block of iterations (the wavefront integrator).

`fit` is the differentiable fit's demonstration (diff/fit.py): it renders
the scene as authored at an eighth of its film (at least 16x16; 4 spp, max
depth 6) as the target, perturbs the material table (albedo * 0.3 + 0.3,
roughness + 0.4, both clipped to [0, 1]) and recovers it with --steps Adam
steps (30) from the same sampler; --fit-vertices also fits the mesh
vertices, --boundary adds their edge-sampled silhouette gradients. On a
card each step replays one CUDA graph of the forward, the backward and
Adam's update (diff/fit.py:fit_route says when it runs eagerly). It
prints its route, the loss every tenth of the steps and the final loss,
and returns 0 when the final loss is below the first. A command across
processes leaves its process group when it ends, by a return or an
error.

`bench` runs the benchmark of hobbyraytracer_tpu_torch/bench.py (the
counterpart of the repository's bench.py, configured by the same BENCH_*
variables) on --device (default cuda) and prints its JSON line.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import sys
import threading
import time

def _hms(seconds: float) -> str:
    h = int(seconds // 3600)
    m = int((seconds - h * 3600) // 60)
    s = seconds - h * 3600 - m * 60
    return f"{h}:{m}:{s:g}"


def _progress(done: int, total: int) -> None:
    print(f"\rPixels rendered: {done}/{total}", end="", flush=True)


def _sync(devices) -> None:
    import torch
    for dev in {d for d in devices if d.type == "cuda"}:
        torch.cuda.synchronize(dev)


def _mesh(args):
    """The workers of --device (or --cpu), or None with the reason printed
    when one of them is a CUDA device that is not there."""
    import torch

    from ..parallel.shard import parse_mesh
    spec = "cpu" if args.cpu else args.device
    if "cuda" in spec and not torch.cuda.is_available():
        print(f"device {spec!r} requested but CUDA is not available")
        return None
    mesh = parse_mesh(spec)
    if not mesh:
        print(f"device {spec!r} names no worker")
        return None
    return mesh


@contextlib.contextmanager
def _joined_processes(args):
    """Inside, this process is in the process group of --num-processes
    (gloo), if more than one; the group is left on the way out, whether
    the command returns or raises."""
    from ..parallel.shard import init_multihost, shutdown_multihost
    init_multihost(args.coordinator, args.num_processes, args.process_id)
    try:
        yield
    finally:
        shutdown_multihost()


def _snapshot(state):
    """A copy of a pool state on its device (the render goes on updating
    the live one in place)."""
    import copy

    import torch
    snap = copy.copy(state)
    for name, val in vars(state).items():
        if isinstance(val, torch.Tensor):
            setattr(snap, name, val.clone())
    snap.it = copy.copy(state.it)
    return snap


class AsyncCheckpoint:
    """The render's checkpoint_cb, writing off the render's thread: a call
    at least `every` seconds after the last write snapshots the state on
    its device and writes it (io/checkpoint.py:save_state, which fetches it
    to the host) on a thread; a call while a write is in flight is skipped;
    a failed write raises at the next call; close() waits for the last
    write and reports its failure."""

    def __init__(self, path: str, meta: dict, every: float):
        self.path, self.meta, self.every = path, meta, every
        self.last = time.time()
        self.thread = None
        self.error = None

    def _write(self, snap) -> None:
        from ..io import checkpoint as ckpt
        try:
            ckpt.save_state(self.path, snap, meta=self.meta)
        except Exception as e:   # raised in the render's thread, next call
            self.error = e

    def __call__(self, state) -> None:
        if self.error is not None:
            raise RuntimeError(
                f"checkpoint write failed: {self.error}") from self.error
        if time.time() - self.last < self.every:
            return
        if self.thread is not None and self.thread.is_alive():
            return
        self.thread = threading.Thread(target=self._write,
                                       args=(_snapshot(state),))
        self.thread.start()
        self.last = time.time()

    def close(self) -> None:
        if self.thread is not None:
            self.thread.join()   # never exit with a half-written file
        if self.error is not None:
            print(f"warning: final checkpoint write failed: {self.error}")


def check_finite(state) -> None:
    """--debug-nans: raise FloatingPointError on the first non-finite value
    of the state's float fields."""
    import torch
    for name in ("fb", "o", "d", "thr", "rad"):
        bad = ~torch.isfinite(getattr(state, name))
        if bool(bad.any()):
            idx = tuple(int(i) for i in bad.nonzero()[0])
            raise FloatingPointError(
                f"non-finite value in the render state's {name} at {idx} "
                f"after iteration {state.it}")


def cmd_render(args) -> int:
    t_start = time.time()
    mesh = _mesh(args)
    if mesh is None:
        return 1
    if args.checkpoint and (args.num_processes or 1) > 1:
        print("--checkpoint is not supported across processes: a process "
              "holds only its own workers' states; render on one process "
              "to checkpoint")
        return 1
    with _joined_processes(args):
        return _render(args, mesh, t_start)


def _render(args, mesh, t_start: float) -> int:
    import torch

    from .. import tracing
    from ..core.rng import Sampler
    from ..integrator import path as path_mod
    from ..integrator import wavefront
    from ..ops import film as film_ops
    from ..parallel import shard
    from ..scene import build_scene, load_scene_desc
    from ..scene.schema import SceneError

    n_proc = args.num_processes or 1
    rank = shard._process()[0]
    n_workers = len(mesh) * n_proc
    device = mesh[0]
    try:
        job = build_scene(load_scene_desc(args.scene))
    except SceneError as e:
        print(e)
        return -1
    scene = job.scene.to(device)
    camera = job.camera.to(device)
    width = args.width or job.width
    height = args.height or job.height
    samples = args.spp or job.samples
    output = args.output or job.output
    print(f"\nLoaded scene: {args.scene}! (completed in "
          f"{_hms(time.time() - t_start)})")

    total_px = width * height
    last = [0.0]

    def progress_cb(done, total):
        # done / total count samples, by either integrator
        now = time.time()
        if done >= total or now - last[0] >= 0.5:
            last[0] = now
            _progress(min(done // samples, total_px), total_px)

    sampler = Sampler(args.seed, device)
    state = None
    writer = None
    callbacks = [check_finite] if args.debug_nans else []
    if args.checkpoint and args.integrator == "wavefront":
        from ..io import checkpoint as ckpt
        meta = ckpt.render_meta(width, height, samples,
                                wavefront.SAMPLE_CHUNK, n_workers=n_workers)
        if args.resume and os.path.exists(args.checkpoint):
            state = ckpt.load_state(args.checkpoint, expect=meta,
                                    device=device)
            # a multi-worker checkpoint stacks the workers' states
            done = int(state.retired.sum())
            print(f"Resumed checkpoint: {args.checkpoint} ({done} samples "
                  "done)")
        writer = AsyncCheckpoint(args.checkpoint, meta, args.checkpoint_every)
        callbacks.append(writer)

    def checkpoint_cb(s):
        for cb in callbacks:
            cb(s)

    profiler = None
    with contextlib.ExitStack() as stack:
        if writer is not None:
            stack.callback(writer.close)   # after the profiler stops
        if args.profile:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if any(d.type == "cuda" for d in mesh):
                acts.append(ProfilerActivity.CUDA)
            profiler = stack.enter_context(profile(activities=acts))
        _sync(mesh)
        t_render0 = time.time()
        if args.integrator == "wavefront":
            pool = args.pool or wavefront.DEFAULT_POOL
            kwargs = dict(max_depth=args.max_depth, pool=pool,
                          progress_cb=progress_cb, state=state,
                          checkpoint_cb=checkpoint_cb if callbacks else None,
                          rr=not args.no_rr)
            if n_workers > 1:
                img = shard.render_wavefront_sharded(
                    scene, camera, width, height, samples, sampler, mesh,
                    **kwargs)
            else:
                img = wavefront.render_image(scene, camera, width, height,
                                             samples, sampler, **kwargs)
        else:
            chunk = args.chunk
            if chunk <= 0:
                # bound device memory: about 2M rays in flight at most
                chunk = max(1, min(samples, 2_000_000 // max(1, total_px)))
            if n_workers > 1:
                img = shard.render_sharded(
                    scene, camera, width, height, samples, sampler, mesh,
                    max_depth=args.max_depth, sample_chunk=chunk)
            else:
                img = path_mod.render_image(
                    scene, camera, width, height, samples, sampler,
                    max_depth=args.max_depth, sample_chunk=chunk,
                    progress_cb=progress_cb)
        img = img.cpu().numpy()
        t_render = time.time() - t_render0
    if profiler is not None:
        os.makedirs(args.profile, exist_ok=True)
        trace = os.path.join(args.profile, f"render_rank{rank}.json")
        profiler.export_chrome_trace(trace)
        spans = os.path.join(args.profile, f"spans_rank{rank}.jsonl")
        tracing.write_jsonl(spans, tracing.RECORDER.drain())
        print(f"\n[profile trace written to {trace}, the program's spans "
              f"to {spans}]")
    _progress(total_px, total_px)
    print()

    t_enc0 = time.time()
    rc = film_ops.output_film(film_ops.quantize(img), output) if rank == 0 \
        else 1
    t_enc = time.time() - t_enc0
    print(f"\nDone! (completed in {_hms(time.time() - t_start)})")
    rays = width * height * samples
    names = sorted({torch.cuda.get_device_name(d) if d.type == "cuda"
                    else "cpu" for d in mesh})
    on = ", ".join(names) + (f" ({n_workers} workers)" if n_workers > 1
                             else "")
    print(f"[{rays / max(t_render, 1e-9):,.0f} primary rays/s on {on} "
          f"({width}x{height} @ {samples}spp; load "
          f"{t_render0 - t_start:.1f}s render {t_render:.1f}s "
          f"encode {t_enc:.1f}s)]")
    return 0 if rc else 1


def perturb_materials(scene):
    """The fit demo's start: the scene with albedo * 0.3 + 0.3 and
    roughness + 0.4, both clipped to [0, 1] (a copy; every other buffer
    shared)."""
    import torch

    from ..scene import ir

    m = scene.materials
    return ir.replace(scene, materials=ir.replace(
        m, albedo=torch.clamp(m.albedo * 0.3 + 0.3, 0.0, 1.0),
        roughness=torch.clamp(m.roughness + 0.4, 0.0, 1.0)))


def fit_demo(scene_path: str, device, width=None, height=None, spp: int = 4,
             max_depth: int = 6, seed: int = 0, steps: int = 30,
             fit_vertices: bool = False, boundary: bool = False,
             verbose: bool = True, mesh=None):
    """The fit of `fit` as a function: build the scene on `device`, render
    the target at width x height (default the film / 8, at least 16 each
    way), perturb the materials and fit them back. With a mesh of more
    than one worker (counting every process's) and a material fit whose
    pixels divide over the workers, each step is the sharded step of
    parallel/shard.py, run eagerly; otherwise fit_materials's, through a
    CUDA graph on a card (diff/fit.py:fit_route). -> diff/fit.py's
    FitResult."""
    import numpy as np
    import torch

    from ..core.rng import Sampler
    from ..diff.fit import (FitResult, fit_materials, fit_route,
                            render_linear, select_params)
    from ..parallel import shard
    from ..scene import build_scene, load_scene_desc

    job = build_scene(load_scene_desc(scene_path))
    scene = job.scene.to(device)
    camera = job.camera.to(device)
    w = width or max(16, job.width // 8)
    h = height or max(16, job.height // 8)
    sampler = Sampler(seed, device)
    # the target: the scene as authored, from the sampler the fit renders
    # with (correlated sampling)
    with torch.no_grad():
        target = render_linear(scene, camera, w, h, sampler, spp, max_depth)
    start = perturb_materials(scene)
    n = len(mesh or [device]) * shard._process()[1]
    sharded = not (n == 1 or fit_vertices or boundary or (w * h) % n)
    if verbose:
        graph = fit_route(start, device, boundary,
                          workers=n if sharded else 1)
        print(f"fit: {steps} steps on {n if sharded else 1} worker(s), "
              f"{'through a CUDA graph' if graph else 'eagerly'}")
    if not sharded:
        return fit_materials(start, camera, target, w, h, steps=steps,
                             n_samples=spp, max_depth=max_depth,
                             sampler=sampler, fit_vertices=fit_vertices,
                             boundary=boundary, verbose=verbose)
    params, rebuild = select_params(start)
    opt = torch.optim.Adam(shard._leaves(params), lr=2e-2,
                           betas=(0.9, 0.999), eps=1e-8)
    step = shard.make_sharded_fit_step(rebuild, camera, w, h, spp, target,
                                       mesh, opt, max_depth=max_depth)
    losses = []
    for i in range(steps):
        losses.append(step(params, sampler))
        if verbose and (i % max(1, steps // 10) == 0 or i == steps - 1):
            print(f"fit step {i}: loss {losses[-1]:.6f} ({n}-device mesh)")
    with torch.no_grad():
        fitted = rebuild(params)
    return FitResult(scene=fitted, losses=np.asarray(losses), params=params)


def cmd_fit(args) -> int:
    from ..scene.schema import SceneError

    mesh = _mesh(args)
    if mesh is None:
        return 1
    try:
        with _joined_processes(args):
            res = fit_demo(args.scene, mesh[0], args.width, args.height,
                           args.spp, args.max_depth, args.seed, args.steps,
                           args.fit_vertices, args.boundary, mesh=mesh)
    except SceneError as e:
        print(e)
        return -1
    print(f"final loss: {res.losses[-1]:.6f} (start {res.losses[0]:.6f})")
    return 0 if res.losses[-1] < res.losses[0] else 1


def cmd_bench(args) -> int:
    from .. import bench
    return bench.main(["--device", args.device])


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="hobbyraytracer_tpu_torch")
    sub = p.add_subparsers(dest="cmd")

    def common(sp):
        sp.add_argument("scene", nargs="?", default="teapot_scene.yaml")
        sp.add_argument("--seed", type=int, default=0)
        sp.add_argument("--device", default="cuda",
                        help="the workers, comma-separated (cuda:0,cuda:0; "
                             "cpu,cpu); cuda: every visible card (default)")
        sp.add_argument("--cpu", action="store_true",
                        help="the same as --device cpu")
        # the process group of a render or fit across processes (gloo)
        sp.add_argument("--coordinator", default=None,
                        help="host:port where the processes meet")
        sp.add_argument("--num-processes", type=int, default=None)
        sp.add_argument("--process-id", type=int, default=None)

    sp = sub.add_parser("render", help="render a YAML scene")
    common(sp)
    sp.add_argument("-o", "--output", default=None)
    sp.add_argument("--spp", type=int, default=None)
    sp.add_argument("--width", type=int, default=None)
    sp.add_argument("--height", type=int, default=None)
    sp.add_argument("--max-depth", type=int, default=50)
    sp.add_argument("--pool", type=int, default=0,
                    help="wavefront pool lanes (0 = default)")
    sp.add_argument("--integrator", choices=["wavefront", "batch"],
                    default="wavefront",
                    help="wavefront: the regenerating lane pool (default); "
                         "batch: one wavefront per sample of the whole "
                         "image (integrator/path.py)")
    sp.add_argument("--chunk", type=int, default=0,
                    help="batch integrator: samples per chunk (0 = as many "
                         "as keep about 2M rays in flight)")
    sp.add_argument("--no-rr", action="store_true",
                    help="wavefront integrator: disable Russian roulette "
                         "(trace every path to --max-depth like the "
                         "reference)")
    sp.add_argument("--checkpoint", default=None,
                    help="checkpoint file; resumable with --resume")
    sp.add_argument("--resume", action="store_true",
                    help="resume from --checkpoint if it exists")
    sp.add_argument("--checkpoint-every", type=float, default=30.0,
                    help="seconds between checkpoint writes")
    sp.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler trace of the render and "
                    "the program's spans (spans_rank{r}.jsonl) to DIR")
    sp.add_argument("--debug-nans", action="store_true",
                    help="raise on the first non-finite value in the render "
                         "state, checked after every block of iterations")
    sp.set_defaults(fn=cmd_render)
    sp = sub.add_parser("fit", help="differentiable material fit demo")
    common(sp)
    sp.add_argument("--spp", type=int, default=4)
    sp.add_argument("--width", type=int, default=None,
                    help="default: the film's width / 8, at least 16")
    sp.add_argument("--height", type=int, default=None,
                    help="default: the film's height / 8, at least 16")
    sp.add_argument("--max-depth", type=int, default=6)
    sp.add_argument("--steps", type=int, default=30)
    sp.add_argument("--fit-vertices", action="store_true",
                    help="also optimize the mesh vertex positions")
    sp.add_argument("--boundary", action="store_true",
                    help="add edge-sampled silhouette gradients to the "
                         "vertex fit (diff/edges.py)")
    sp.set_defaults(fn=cmd_fit)
    sp = sub.add_parser("bench", help="the benchmark (BENCH_* variables, "
                        "hobbyraytracer_tpu_torch/bench.py)")
    sp.add_argument("--device", default="cuda",
                    help="the device to render on (default cuda)")
    sp.set_defaults(fn=cmd_bench)
    return p


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    # a bare `prog scene.yaml` means render (main.cpp:146-151)
    if not argv or argv[0] not in ("render", "fit", "bench", "-h",
                                   "--help"):
        argv = ["render"] + argv
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
