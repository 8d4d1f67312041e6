#!/usr/bin/env python3
"""How many of a window's kernel records torch.profiler reports on a card.

    python3 scripts/profiler_record_loss.py [--kernels 40000] [--windows 10]

Captures one CUDA graph of `--kernels` one-kernel ops on a 64-float tensor
(`x.mul_(1)` first, `x.abs_()` last, `x.add_(1)` between), then replays
it `--windows` times, each replay followed by one reduction and its read
to the host, under a torch.profiler of its own, profiler after profiler as
chip_smoke.py's ProfiledWindows opens them: with CUDA activity alone, the
same with one kernel run and waited for between the profiler's start and
the replay, and with CPU activity too. Prints, for each mode, the kernels
each window reported against the `--kernels` + 1 that ran (+ 2 with the
kernel before the replay), in how many windows the graph's first and its
last kernel were reported, and the card's name and power limit. A window
that reports fewer kernels than ran lost activity records.
"""
import argparse
import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile


def reported(prof):
    """{kernel name: records} of a finished profiler (no memcpy or
    memset)."""
    kernels = {}
    for evt in prof.key_averages():
        if not str(evt.device_type).endswith("CUDA"):
            continue
        if getattr(evt, "self_device_time_total", 0.0) <= 0:
            continue
        if not evt.key.startswith(("Memcpy", "Memset")):
            kernels[evt.key] = kernels.get(evt.key, 0) + evt.count
    return kernels


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[1])
    ap.add_argument("--kernels", type=int, default=40000)
    ap.add_argument("--windows", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip()
    x = torch.zeros(64, device="cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            x.add_(1)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        x.mul_(1)
        for _ in range(args.kernels - 2):
            x.add_(1)
        x.abs_()
    torch.cuda.synchronize()
    y = torch.zeros(64, device="cuda", dtype=torch.int32)

    def window(activities, first_kernel):
        torch.cuda.synchronize()
        prof = profile(activities=activities)
        prof.start()
        if first_kernel:
            y.add_(1)
            torch.cuda.synchronize()
        graph.replay()
        float(x.sum())
        torch.cuda.synchronize()
        prof.stop()
        return reported(prof)

    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {card}")
    cuda = [ProfilerActivity.CUDA]
    for label, acts, first_kernel in (
            ("CUDA", cuda, False),
            ("CUDA, a kernel before the replay", cuda, True),
            ("CUDA+CPU", cuda + [ProfilerActivity.CPU], False)):
        t0 = time.perf_counter()
        seen = [window(acts, first_kernel) for _ in range(args.windows)]
        ran = args.kernels + 1 + first_kernel

        def windows_with(op):
            return sum(any(op in k for k in s) for s in seen)
        print(f"{label}: kernels reported a window "
              f"{[sum(s.values()) for s in seen]} of {ran} that ran; the "
              f"first kernel (mul) reported in {windows_with('MulFunctor')} "
              f"and the last (abs) in {windows_with('abs_kernel')} of "
              f"{args.windows} windows; {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
