"""CLI entry point (reference main.cpp:142-195; counterpart of
hobbyraytracer_tpu/cli/main.py).

    python -m hobbyraytracer_tpu_torch.cli.main render scenes/teapot_scene.yaml -o out.png --device cuda

renders a YAML scene through the wavefront integrator on the named device
(default cuda; nothing falls back to the CPU) and prints the reference's
"Loaded scene" / "Done!" lines plus the primary rays/s. A bare scene path
means `render`, like the reference binary. The `fit` and `bench`
subcommands, checkpointing and the batch integrator are not ported yet and
exit with an error naming their ROADMAP item.
"""
from __future__ import annotations

import argparse
import sys
import time

_NOT_PORTED = {
    "fit": "ROADMAP Queue 1 item 13 (differentiable fit)",
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

    def progress_cb(retired, total):
        now = time.time()
        if retired >= total or now - last[0] >= 0.5:
            last[0] = now
            _progress(min(retired // samples, total_px), total_px)

    _sync(device)
    t_render0 = time.time()
    img = wavefront.render_image(
        scene, camera, width, height, samples, Sampler(args.seed, device),
        max_depth=args.max_depth, pool=args.pool or wavefront.DEFAULT_POOL,
        progress_cb=progress_cb, rr=not args.no_rr)
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
    sp.add_argument("--no-rr", action="store_true",
                    help="disable Russian roulette (trace every path to "
                         "--max-depth like the reference)")
    sp.add_argument("--device", default="cuda",
                    help="torch device to render on (default cuda)")
    sp.set_defaults(fn=cmd_render)
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
