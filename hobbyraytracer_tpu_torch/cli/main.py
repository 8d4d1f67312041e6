"""CLI entry point (reference main.cpp:142-195; counterpart of
hobbyraytracer_tpu/cli/main.py).

    python -m hobbyraytracer_tpu_torch.cli.main render scenes/teapot_scene.yaml -o out.png --device cuda
    python -m hobbyraytracer_tpu_torch.cli.main fit scenes/shiny_teapot.yaml --device cuda

`render` renders a YAML scene on the named device (default cuda; nothing
falls back to the CPU) through the wavefront integrator, or with
`--integrator batch` through the batch integrator (integrator/path.py), and
prints the reference's "Loaded scene" / "Done!" lines plus the primary
rays/s. A bare scene path means `render`, like the reference binary.

`fit` is the differentiable fit's demonstration (diff/fit.py): it renders
the scene as authored at an eighth of its film (at least 16x16; 4 spp, max
depth 6) as the target, perturbs the material table (albedo * 0.3 + 0.3,
roughness + 0.4, both clipped to [0, 1]) and recovers it with --steps Adam
steps (30) from the same sampler; --fit-vertices also fits the mesh
vertices, --boundary adds their edge-sampled silhouette gradients. It
prints the loss every tenth of the steps and the final loss, and returns
0 when the final loss is below the first.

The `bench` subcommand and checkpointing are not ported yet; `bench` exits
with an error naming its ROADMAP item. Neither is the reference's
multi-device fit (ROADMAP Queue 1 item 14).
"""
from __future__ import annotations

import argparse
import sys
import time

_NOT_PORTED = {
    "bench": "ROADMAP Queue 1 item 9 (port bench)",
}


def _hms(seconds: float) -> str:
    h = int(seconds // 3600)
    m = int((seconds - h * 3600) // 60)
    s = seconds - h * 3600 - m * 60
    return f"{h}:{m}:{s:g}"


def _progress(done: int, total: int) -> None:
    print(f"\rPixels rendered: {done}/{total}", end="", flush=True)


def _sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def cmd_render(args) -> int:
    t_start = time.time()
    import numpy as np
    import torch

    from ..core.rng import Sampler
    from ..integrator import path as path_mod
    from ..integrator import wavefront
    from ..ops import film as film_ops
    from ..scene import build_scene, load_scene_desc
    from ..scene.schema import SceneError

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print(f"device {args.device!r} requested but CUDA is not available")
        return 1
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

    _sync(device)
    t_render0 = time.time()
    sampler = Sampler(args.seed, device)
    if args.integrator == "wavefront":
        img = wavefront.render_image(
            scene, camera, width, height, samples, sampler,
            max_depth=args.max_depth,
            pool=args.pool or wavefront.DEFAULT_POOL,
            progress_cb=progress_cb, rr=not args.no_rr)
    else:
        chunk = args.chunk
        if chunk <= 0:
            # bound device memory: about 2M rays in flight at most
            chunk = max(1, min(samples, 2_000_000 // max(1, total_px)))
        img = path_mod.render_image(
            scene, camera, width, height, samples, sampler,
            max_depth=args.max_depth, sample_chunk=chunk,
            progress_cb=progress_cb)
    img = img.cpu().numpy()
    t_render = time.time() - t_render0
    _progress(total_px, total_px)
    print()

    t_enc0 = time.time()
    rc = film_ops.output_film(film_ops.quantize(img), output)
    t_enc = time.time() - t_enc0
    print(f"\nDone! (completed in {_hms(time.time() - t_start)})")
    rays = width * height * samples
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"[{rays / max(t_render, 1e-9):,.0f} primary rays/s on {name} "
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
             verbose: bool = True):
    """The fit of `fit` as a function: build the scene on `device`, render
    the target at width x height (default the film / 8, at least 16 each
    way), perturb the materials and fit them back. -> diff/fit.py's
    FitResult."""
    import torch

    from ..core.rng import Sampler
    from ..diff.fit import fit_materials, render_linear
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
    return fit_materials(perturb_materials(scene), camera, target, w, h,
                         steps=steps, n_samples=spp, max_depth=max_depth,
                         sampler=sampler, fit_vertices=fit_vertices,
                         boundary=boundary, verbose=verbose)


def cmd_fit(args) -> int:
    import torch

    from ..scene.schema import SceneError

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print(f"device {args.device!r} requested but CUDA is not available")
        return 1
    try:
        res = fit_demo(args.scene, device, args.width, args.height, args.spp,
                       args.max_depth, args.seed, args.steps,
                       args.fit_vertices, args.boundary)
    except SceneError as e:
        print(e)
        return -1
    print(f"final loss: {res.losses[-1]:.6f} (start {res.losses[0]:.6f})")
    return 0 if res.losses[-1] < res.losses[0] else 1


def _not_ported(args) -> int:
    print(f"`{args.cmd}` is not ported yet: {_NOT_PORTED[args.cmd]}")
    return 2


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="hobbyraytracer_tpu_torch")
    sub = p.add_subparsers(dest="cmd")
    sp = sub.add_parser("render", help="render a YAML scene")
    sp.add_argument("scene", nargs="?", default="teapot_scene.yaml")
    sp.add_argument("-o", "--output", default=None)
    sp.add_argument("--spp", type=int, default=None)
    sp.add_argument("--width", type=int, default=None)
    sp.add_argument("--height", type=int, default=None)
    sp.add_argument("--max-depth", type=int, default=50)
    sp.add_argument("--seed", type=int, default=0)
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
    sp.add_argument("--device", default="cuda",
                    help="torch device to render on (default cuda)")
    sp.set_defaults(fn=cmd_render)
    sp = sub.add_parser("fit", help="differentiable material fit demo")
    sp.add_argument("scene", nargs="?", default="teapot_scene.yaml")
    sp.add_argument("--spp", type=int, default=4)
    sp.add_argument("--width", type=int, default=None,
                    help="default: the film's width / 8, at least 16")
    sp.add_argument("--height", type=int, default=None,
                    help="default: the film's height / 8, at least 16")
    sp.add_argument("--max-depth", type=int, default=6)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--steps", type=int, default=30)
    sp.add_argument("--fit-vertices", action="store_true",
                    help="also optimize the mesh vertex positions")
    sp.add_argument("--boundary", action="store_true",
                    help="add edge-sampled silhouette gradients to the "
                         "vertex fit (diff/edges.py)")
    sp.add_argument("--device", default="cuda",
                    help="torch device to fit on (default cuda)")
    sp.set_defaults(fn=cmd_fit)
    for name in _NOT_PORTED:
        sub.add_parser(name, help=f"not ported yet ({_NOT_PORTED[name]})"
                       ).set_defaults(fn=_not_ported)
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
