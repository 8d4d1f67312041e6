#!/usr/bin/env python3
"""Where a wavefront segment's time goes in the PyTorch/CUDA port.

    python3 scripts/profile_port.py [--width 640] [--height 640] [--spp 16]
                                    [--pool 196608] [--steps 24]
                                    [--trace build/profile/trace.json]

Renders scenes/teapot_scene.yaml on one CUDA card: warms up over the first
`--steps` iterations of the render, then times the next `--steps`
iterations (regenerate + segment) three ways:

- host clock around the window, ended by a synchronize (wall ms/segment);
- CUDA events around the window (device ms/segment, the stream's span);
- torch.profiler over the window: device time by kernel name, the summed
  kernel time, and the device's idle share of the window.

Prints the card's name and power limit beside the numbers, and writes the
profiler's chrome trace to --trace.
"""
import argparse
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=640)
    ap.add_argument("--spp", type=int, default=16)
    ap.add_argument("--pool", type=int, default=196_608)
    ap.add_argument("--steps", type=int, default=24)
    ap.add_argument("--trace", default="build/profile/trace.json")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    from hobbyraytracer_tpu_torch.core.rng import Sampler
    from hobbyraytracer_tpu_torch.integrator import wavefront
    from hobbyraytracer_tpu_torch.scene import build_scene, load_scene_desc

    if not torch.cuda.is_available():
        raise RuntimeError("profile_port.py needs a CUDA card")
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    job = build_scene(load_scene_desc("scenes/teapot_scene.yaml"))
    scene, camera = job.scene.to(dev), job.camera.to(dev)
    w, h, spp = args.width, args.height, args.spp
    _, n_chunks, _ = wavefront._chunk_geometry(spp, wavefront.SAMPLE_CHUNK)
    total = w * h * n_chunks
    state = wavefront.init_state(w, h, min(args.pool, total), device=dev)
    sampler = Sampler(0, dev)

    def step():
        wavefront._regenerate(state, camera, w, h, total, sampler)
        wavefront._segment(state, scene, w, h, sampler, 50, spp)

    for _ in range(args.steps):          # warm-up: the render's first part
        step()
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    a.record()
    for _ in range(args.steps):
        step()
    b.record()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / args.steps
    span = a.elapsed_time(b) / args.steps

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        for _ in range(args.steps):
            step()
        torch.cuda.synchronize()
        window = (time.perf_counter() - t1) * 1e3
    rows = []
    for evt in prof.key_averages():
        if not str(evt.device_type).endswith("CUDA"):
            continue   # host ops; their kernels are listed on their own
        dt = getattr(evt, "self_device_time_total", None)
        if dt is None:
            dt = getattr(evt, "self_cuda_time_total", 0.0)
        if dt > 0:
            rows.append((dt / 1e3, evt.count, evt.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    print(f"{card}")
    print(f"teapot {w}x{h} @ {spp} spp, pool {state.item.shape[0]}, "
          f"iterations {args.steps}..{2 * args.steps}: wall {wall:.3f} "
          f"ms/segment (host clock), stream span {span:.3f} ms/segment "
          "(CUDA events)")
    if not rows:
        print("torch.profiler saw no device time")
        return 0
    print(f"profiled window {window:.3f} ms ({window / args.steps:.3f} "
          f"ms/segment): kernels busy {busy:.3f} ms, device idle share "
          f"{max(0.0, 1 - busy / window):.1%}")
    print(f"{'device ms/seg':>13} {'share':>6} {'calls/seg':>9}  kernel")
    for ms, count, name in rows[:25]:
        print(f"{ms / args.steps:13.4f} {ms / busy:6.1%} "
              f"{count / args.steps:9.1f}  {name[:90]}")
    os.makedirs(os.path.dirname(args.trace) or ".", exist_ok=True)
    prof.export_chrome_trace(args.trace)
    print(f"trace: {args.trace}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
