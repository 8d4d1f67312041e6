"""Benchmark of the port: the reference's headline workload, one JSON line.

    python -m hobbyraytracer_tpu_torch.bench [--device cuda]
    python -m hobbyraytracer_tpu_torch.cli.main bench [--device cuda]

The counterpart of the repository's bench.py (which drives the JAX
package): the same environment variables and defaults, the same
discipline and the same JSON keys, on one device of the port (default
cuda; a device that is not there is refused, nothing moves to the CPU).

- BENCH_SCENE: teapot (default), cornell, balls, teapot_hires, two_teapots;
- BENCH_SIZE: the square image's side (640);
- BENCH_SPP: samples a pixel (100);
- BENCH_INTEGRATOR: wavefront (default) or batch;
- BENCH_POOL: the wavefront pool (integrator/wavefront.py:DEFAULT_POOL);
- BENCH_REPEATS: timed renders (3).

The generated assets are made first if missing (scene/fixtures.py). A
1-spp warm-up render is excluded from the timing; repeat r renders from
seed 100 + r; each is timed on the host clock, ended by
torch.cuda.synchronize on a card. The line reports the median primary
rays/s, its ratio to the reference C++ tracer's ~273k rays/s
(BASELINE.md), and with more than one repeat the count, min and max.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

BASELINE_PRIMARY_RAYS_PER_S = 273_000.0
SCENE_FILES = {
    "teapot": "teapot_scene.yaml",
    "cornell": "cornell_box.yaml",
    "balls": "scattered_balls.yaml",
    "teapot_hires": "teapot_hires.yaml",
    "two_teapots": "two_teapots.yaml",
}
SCENE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scenes")


def run(device) -> dict:
    """Run the benchmark the environment describes on `device` (a
    torch.device) -> the JSON line's dict."""
    import torch

    from .core.rng import Sampler
    from .integrator import path as path_mod
    from .integrator import wavefront
    from .scene import build_scene, load_scene_desc
    from .scene.fixtures import ensure_assets

    ensure_assets()
    which = os.environ.get("BENCH_SCENE", "teapot")
    scene_file = SCENE_FILES.get(which, "teapot_scene.yaml")
    width = height = int(os.environ.get("BENCH_SIZE", "640"))
    samples = int(os.environ.get("BENCH_SPP", "100"))
    integrator = os.environ.get("BENCH_INTEGRATOR", "wavefront")
    repeats = max(1, int(os.environ.get("BENCH_REPEATS", "3")))

    job = build_scene(load_scene_desc(os.path.join(SCENE_DIR, scene_file)))
    scene, camera = job.scene.to(device), job.camera.to(device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    if integrator == "wavefront":
        pool = int(os.environ.get("BENCH_POOL", str(wavefront.DEFAULT_POOL)))

        def render(spp, seed):
            wavefront.render_image(scene, camera, width, height, spp,
                                   Sampler(seed, device), pool=pool)
            sync()
    else:
        chunk = max(1, min(samples, 2_000_000 // (width * height)))

        def render(spp, seed):
            path_mod.render_image(scene, camera, width, height, spp,
                                  Sampler(seed, device), sample_chunk=chunk)
            sync()

    # warm-up (kernel loads, allocator), excluded from the timing like the
    # reference's load-vs-render split (main.cpp:164-192)
    render(1, 0)
    rates = []
    for rep in range(repeats):
        # a fresh seed a repeat, as bench.py takes a fresh key
        t0 = time.perf_counter()
        render(samples, 100 + rep)
        rates.append(width * height * samples / (time.perf_counter() - t0))

    rays_per_s = statistics.median(rates)
    line = {
        "metric": f"primary_rays_per_s_{which}_{width}x{height}@{samples}spp",
        "value": round(rays_per_s),
        "unit": "rays/s/chip",
        "vs_baseline": round(rays_per_s / BASELINE_PRIMARY_RAYS_PER_S, 3),
    }
    if repeats > 1:
        line["repeats"] = repeats
        line["min"] = round(min(rates))
        line["max"] = round(max(rates))
    return line


def main(argv=None) -> int:
    """Print the device's name, then the JSON line; rc 1 when the device
    is a CUDA device that is not there."""
    import torch

    p = argparse.ArgumentParser(prog="hobbyraytracer_tpu_torch.bench")
    p.add_argument("--device", default="cuda",
                   help="the device to render on (default cuda)")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print(f"device {args.device!r} requested but CUDA is not available")
        return 1
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else str(device))
    print(f"[bench] on {name}")
    print(json.dumps(run(device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
