#!/usr/bin/env python3
"""The batch integrator's bounces a graph (B, integrator/path.py:
BOUNCE_BLOCK) against its render time on a CUDA card.

    python3 scripts/time_batch_block.py                 # B = 2 4 8 16 50
    python3 scripts/time_batch_block.py --blocks 8 16 --size 320 --spp 8

Renders scenes/teapot_scene.yaml (or --scene) at SIZE x SIZE, --spp
samples, max depth 50, in the CLI's chunks of 2,000,000 // (SIZE * SIZE)
samples, through BatchRun's CUDA graphs with each B in turns (the list
forwards, then backwards), under deterministic algorithms. For each
render: the whole render's ms, the captures' ms, the median ms of a
replayed sample (a synchronize after each), the bounces run (whole
blocks) and the blocks a sample (each one host read). Smaller blocks read
the host more often, larger ones run more masked bounces after the last
lane ends and capture larger graphs. Every B must give the same radiance
sum bit for bit. A small eager render first builds the kernels. Prints
one line a render, then a JSON line with each B's numbers beside the
card's name and power limit.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default=os.path.join(ROOT, "scenes",
                                                    "teapot_scene.yaml"))
    ap.add_argument("--blocks", type=int, nargs="+", default=[2, 4, 8, 16,
                                                              50])
    ap.add_argument("--size", type=int, default=640)
    ap.add_argument("--spp", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    from hobbyraytracer_tpu_torch.core.rng import Sampler
    from hobbyraytracer_tpu_torch.integrator import path
    from hobbyraytracer_tpu_torch.kernels import build as kbuild
    from hobbyraytracer_tpu_torch.scene import build_scene, load_scene_desc

    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA card")
    dev = torch.device("cuda:0")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(card)
    job = build_scene(load_scene_desc(args.scene))
    scene, camera = job.scene.to(dev), job.camera.to(dev)
    size, spp = args.size, args.spp
    chunk = max(1, min(spp, 2_000_000 // (size * size)))
    capture_ms = []
    capture = kbuild.GraphReplay.capture
    default_block = path.BOUNCE_BLOCK

    def timed_capture(self, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        capture(self, fn)
        torch.cuda.synchronize()
        capture_ms.append((time.perf_counter() - t0) * 1e3)

    kbuild.GraphReplay.capture = timed_capture

    def render(block):
        """radiance_sum's chunks through one BatchRun with this block."""
        sampler = Sampler(args.seed, dev)
        path.BOUNCE_BLOCK = block
        run = path.BatchRun(scene, camera, size, size, sampler, 50)
        sample_ms = []
        sample = run.sample

        def timed_sample(key):
            t0 = time.perf_counter()
            sample(key)
            torch.cuda.synchronize()
            sample_ms.append((time.perf_counter() - t0) * 1e3)

        run.sample = timed_sample
        capture_ms.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        total = torch.zeros((size * size, 3), device=dev)
        done = c = 0
        while done < spp:
            n = min(chunk, spp - done)
            total = total + run.sample_sum(sampler.fold_in(1000003 + c), n)
            done, c = done + n, c + 1
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        return total, {"ms": ms, "capture_ms": sum(capture_ms),
                       "graphs": len(capture_ms),
                       "replayed_sample_ms": statistics.median(
                           sample_ms[2:]) if len(sample_ms) > 2 else None,
                       "bounces": run.bounces,
                       "blocks_a_sample": len(run.blocks)}

    with kbuild.eager():
        path.BatchRun(scene, camera, 32, 32, Sampler(0, dev)).sample_sum(
            Sampler(0, dev), 1)
    out = {b: [] for b in args.blocks}
    ref = None
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for block in args.blocks + args.blocks[::-1]:
            total, row = render(block)
            if ref is None:
                ref = total
            if not torch.equal(total, ref):
                raise RuntimeError(f"B = {block}: the sum differs from "
                                   f"B = {args.blocks[0]}'s")
            out[block].append(row)
            print(f"B = {block}: {row['ms']:.1f} ms ({row['graphs']} "
                  f"captures, {row['capture_ms']:.1f} ms), a replayed "
                  f"sample {row['replayed_sample_ms']:.2f} ms, "
                  f"{row['bounces']} bounces, up to "
                  f"{row['blocks_a_sample']} host reads a sample on {card}",
                  flush=True)
    finally:
        torch.use_deterministic_algorithms(False)
        kbuild.GraphReplay.capture = capture
        path.BOUNCE_BLOCK = default_block
    print(json.dumps({"card": card, "scene": args.scene, "size": size,
                      "spp": spp, "chunk": chunk, "bitwise_equal": True,
                      "by_block": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
