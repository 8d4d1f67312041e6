#!/usr/bin/env python3
"""The pool sort against the per-mesh sort on one CUDA card, in one process.

    python3 scripts/time_pool_sort.py [--scene scenes/two_teapots.yaml]
                                      [--periods 0 1 2 4] [--rounds 2]
                                      [--width 640] [--height 640] [--spp 16]

Renders the scene through wavefront.render_image with each pool_sort period
in turn (0: each mesh find sorts its own rays; N: the whole pool is permuted
every N segments and the mesh finds skip their sort), forwards and then
backwards (0 1 2 4 4 2 1 0), `--rounds` times, after one warm-up render, so
that a drift of the host's speed falls on every period alike. Host-bound
renders wander by tens of percent between processes: only the numbers of one
run compare. Prints every render's seconds and primary rays/s, then each
period's median, with the card's name and power limit.
"""
import argparse
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="scenes/two_teapots.yaml")
    ap.add_argument("--periods", type=int, nargs="+", default=[0, 1, 2, 4])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=640)
    ap.add_argument("--spp", type=int, default=16)
    ap.add_argument("--pool", type=int, default=196_608)
    args = ap.parse_args()

    import torch

    from hobbyraytracer_tpu_torch.core.rng import Sampler
    from hobbyraytracer_tpu_torch.integrator import wavefront
    from hobbyraytracer_tpu_torch.scene import build_scene, load_scene_desc

    if not torch.cuda.is_available():
        raise RuntimeError("time_pool_sort.py needs a CUDA card")
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    job = build_scene(load_scene_desc(args.scene))
    scene, camera = job.scene.to(dev), job.camera.to(dev)
    rays = args.width * args.height * args.spp

    def render(period, seed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = wavefront.render_image(
            scene, camera, args.width, args.height, args.spp,
            Sampler(seed, dev), max_depth=50, pool=args.pool,
            pool_sort=period)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, img.mean().item()

    render(0, 0)    # warm-up: builds the kernel, fills the allocator
    print(card)
    seconds = {p: [] for p in args.periods}
    seed = 1
    for _ in range(args.rounds):
        for period in args.periods + args.periods[::-1]:
            s, mean = render(period, seed)
            seed += 1
            seconds[period].append(s)
            print(f"pool_sort={period}: {s:.3f} s, {rays / s:,.0f} primary "
                  f"rays/s, mean {mean:.5f}")
    base = statistics.median(seconds[args.periods[0]])
    for period, times in seconds.items():
        med = statistics.median(times)
        print(f"pool_sort={period}: median of {len(times)} renders "
              f"{med:.3f} s, {rays / med:,.0f} primary rays/s, "
              f"{base / med:.3f}x pool_sort={args.periods[0]} "
              f"({os.path.basename(args.scene)} {args.width}x{args.height} @ "
              f"{args.spp} spp, pool {args.pool}; {card})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
