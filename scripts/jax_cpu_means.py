#!/usr/bin/env python3
"""Tonemapped image means of a scene rendered by the JAX package on the CPU:
the reference constants that chip_smoke.py holds the port's renders to.

    python3 scripts/jax_cpu_means.py scenes/two_teapots.yaml --spp 16 \\
        --runs 64:0 64:1 96:0 96:1 128:2

    python3 scripts/jax_cpu_means.py long-tail --spp 16 --runs 64:0 96:1

Each run is SIZE:SEED, a SIZE x SIZE render through
hobbyraytracer_tpu.integrator.wavefront.render_image at --spp samples, max
depth 50, Russian roulette on, pool 196,608 (chip_smoke.py's settings);
with --integrator batch through hobbyraytracer_tpu.integrator.path's
render_image instead (max depth 50, no Russian roulette, the CLI's chunks
of 2,000,000 // (SIZE * SIZE) samples):

    python3 scripts/jax_cpu_means.py scenes/teapot_scene.yaml \
        --integrator batch --spp 16 --runs 64:0 64:1
The scene `long-tail` is chip_smoke.py's phase aa scene (a binary PLY
teapot, an image texture, the thin lens on), its files written by
chip_smoke.py's own helpers into a temporary directory. Prints one line a
run and the mean of the means. Keep the sizes small: this runs on the
host.
"""
import argparse
import importlib.util
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("scene")
    ap.add_argument("--spp", type=int, default=16)
    ap.add_argument("--runs", nargs="+", default=["64:0", "64:1"])
    ap.add_argument("--integrator", choices=["wavefront", "batch"],
                    default="wavefront")
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from hobbyraytracer_tpu.integrator import path, wavefront
    from hobbyraytracer_tpu.scene import build_scene, load_scene_desc

    with tempfile.TemporaryDirectory() as tmp:
        if args.scene == "long-tail":
            spec = importlib.util.spec_from_file_location(
                "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
            smoke = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(smoke)
            job = build_scene(load_scene_desc(smoke.long_tail_scene(tmp)))
            job.camera = job.camera.replace(use_lens=True)
        else:
            job = build_scene(load_scene_desc(args.scene))
    means = []
    for run in args.runs:
        size, seed = (int(x) for x in run.split(":"))
        t0 = time.time()
        key = jax.random.PRNGKey(seed)
        if args.integrator == "batch":
            chunk = max(1, min(args.spp, 2_000_000 // (size * size)))
            img = np.asarray(path.render_image(
                job.scene, job.camera, size, size, args.spp, key,
                max_depth=50, sample_chunk=chunk))
        else:
            img = np.asarray(wavefront.render_image(
                job.scene, job.camera, size, size, args.spp, key,
                max_depth=50, pool=196_608, rr=True))
        means.append(float(img.mean()))
        print(f"{args.scene} ({args.integrator}) {size}x{size} @ "
              f"{args.spp} spp, seed {seed}: "
              f"mean {means[-1]:.5f} ({time.time() - t0:.1f} s)", flush=True)
    print(f"mean of the {len(means)} means: {np.mean(means):.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
