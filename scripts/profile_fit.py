#!/usr/bin/env python3
"""Where a fit step's time goes in the PyTorch/CUDA port.

    python3 scripts/profile_fit.py [--scene scenes/shiny_teapot.yaml]
                                   [--width 240] [--height 135] [--spp 4]
                                   [--depth 6] [--steps 3]
                                   [--trace build/profile/fit_trace.json]

One step of the differentiable fit (diff/fit.py: render_loss through
"kernel_replay" and its backward, the Adam update left out) on one CUDA
card, at the CLI's `fit` defaults: shiny_teapot at the film / 8, 4 spp,
depth 6, from the CLI's perturbed materials. After two warm-up steps it
times `--steps` steps three ways:

- host clock around each, ended by a synchronize (wall ms a step), and
  around its forward alone;
- CUDA events around the steps (the stream's span);
- torch.profiler over one step: device time by kernel name, the summed
  kernel time, the kernel launches, and the device's idle share.

Prints the card's name and power limit beside the numbers, K1's launches
and share of device time, and writes the profiler's chrome trace to
--trace.
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
    ap.add_argument("--scene", default="scenes/shiny_teapot.yaml")
    ap.add_argument("--width", type=int, default=240)
    ap.add_argument("--height", type=int, default=135)
    ap.add_argument("--spp", type=int, default=4)
    ap.add_argument("--depth", type=int, default=6)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--trace", default="build/profile/fit_trace.json")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    from hobbyraytracer_tpu_torch.cli.main import perturb_materials
    from hobbyraytracer_tpu_torch.core.rng import Sampler
    from hobbyraytracer_tpu_torch.diff import fit as fit_mod
    from hobbyraytracer_tpu_torch.kernels import mesh_traverse as kmod
    from hobbyraytracer_tpu_torch.scene import build_scene, load_scene_desc

    if not torch.cuda.is_available():
        raise RuntimeError("profile_fit.py needs a CUDA card")
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    job = build_scene(load_scene_desc(args.scene))
    scene, camera = job.scene.to(dev), job.camera.to(dev)
    w, h, spp, depth = args.width, args.height, args.spp, args.depth
    sampler = Sampler(0, dev)
    with torch.no_grad():
        target = fit_mod.render_linear(scene, camera, w, h, sampler, spp,
                                       depth)
    params, rebuild = fit_mod.select_params(perturb_materials(scene))

    def forward():
        return fit_mod.render_loss(params, rebuild, camera, w, h, sampler,
                                   spp, target, depth)

    def step():
        for p in params["materials"].values():
            p.grad = None
        loss = forward()
        loss.backward()
        return float(loss.detach())      # the fit's host read a step

    for _ in range(2):                   # warm-up
        step()
    torch.cuda.synchronize()

    fwd_ms, step_ms = [], []
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(args.steps):
        t0 = time.perf_counter()
        with torch.no_grad():
            forward()
        torch.cuda.synchronize()
        fwd_ms.append((time.perf_counter() - t0) * 1e3)
    b.record()
    torch.cuda.synchronize()
    fwd_span = a.elapsed_time(b) / args.steps
    a.record()
    for _ in range(args.steps):
        t0 = time.perf_counter()
        step()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    b.record()
    torch.cuda.synchronize()
    span = a.elapsed_time(b) / args.steps

    kmod.KERNEL.launches = 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
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
    launches = sum(r[1] for r in rows)
    print(card)
    print(f"{os.path.basename(args.scene)} fit step {w}x{h} @ {spp} spp, "
          f"depth {depth} (render_loss + backward): wall median "
          f"{statistics.median(step_ms):.1f} ms a step (host clock; "
          f"{', '.join(f'{x:.1f}' for x in step_ms)}), stream span "
          f"{span:.1f} ms; the forward alone (no_grad) "
          f"{statistics.median(fwd_ms):.1f} ms, span {fwd_span:.1f} ms")
    if not rows:
        print("torch.profiler saw no device time")
        return 0
    k1 = sum(r[0] for r in rows if "traverse_kernel<24" in r[2])
    print(f"profiled step {window:.1f} ms: kernels busy {busy:.1f} ms, "
          f"{launches} kernel launches, device idle share "
          f"{max(0.0, 1 - busy / window):.1%}; K1 {kmod.KERNEL.launches} "
          f"launches, {k1:.3f} ms, {k1 / busy:.1%} of device time")
    print(f"{'device ms':>10} {'share':>6} {'calls':>6}  kernel")
    for ms, count, name in rows[:25]:
        print(f"{ms:10.3f} {ms / busy:6.1%} {count:6d}  {name[:90]}")
    os.makedirs(os.path.dirname(args.trace) or ".", exist_ok=True)
    prof.export_chrome_trace(args.trace)
    print(f"trace: {args.trace}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
