#!/usr/bin/env python3
"""Device ms a replayed segment, render by render, in several processes:
whether a render's block graph replays at one speed or another, and
whether renders that share a kept graph (integrator/wavefront.py:
RENDER_GRAPHS) share its speed.

Each process runs a benchmark cell's render jobs as the harness runs them
(perfbench/: the cell's scene, film and seeds), untraced: the warm-up job,
then --renders jobs. CUDA events around each replay of a block graph
(kernels/build.py:GraphReplay.replay) give a render's replayed device ms,
over its replayed segments (STEPS_PER_CALL a replay); the host clock
gives its wall. On a program without kept graphs each render replays a
graph of its own.

    python3 scripts/time_render_replays.py [--cells teapot.final640]
        [--processes 3] [--renders 8] [--seed N] [--out FILE]

Prints the card's name and power limit, then for each cell and process a
line of each render's ms a segment and wall s, and how many renders hit a
kept graph; then one JSON line (also written to --out).
"""
import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def one_process(cell_name: str, renders: int, seed: int) -> dict:
    """The render jobs of one cell in this process -> {"ms_a_segment",
    "wall_s", "hits"}."""
    import torch

    from hobbyraytracer_tpu_torch.integrator import wavefront
    from hobbyraytracer_tpu_torch.kernels import build as kbuild
    from perfbench import jobs, manifest

    events = []
    replay = kbuild.GraphReplay.replay

    def timed(graph):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        out = replay(graph)
        b.record()
        events.append((a, b))
        return out

    kbuild.GraphReplay.replay = timed
    device = torch.device("cuda", 0)
    cell = manifest.load_cell(cell_name)
    program = jobs.kind(cell)(cell.path(cell.config["scene"]), cell.traffic,
                              device, seed, ref=manifest.reference(cell))
    program.run(-1)
    torch.cuda.synchronize(device)
    graphs = getattr(wavefront, "RENDER_GRAPHS", None)
    hits0 = graphs.hits if graphs is not None else 0
    steps = getattr(wavefront, "STEPS_PER_CALL", 8)
    out = {"ms_a_segment": [], "wall_s": []}
    for j in range(renders):
        events.clear()
        t0 = time.perf_counter()
        program.run(j)
        torch.cuda.synchronize(device)
        out["wall_s"].append(time.perf_counter() - t0)
        ms = sum(a.elapsed_time(b) for a, b in events)
        out["ms_a_segment"].append(ms / (steps * len(events)))
    out["hits"] = graphs.hits - hits0 if graphs is not None else None
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", nargs="+", default=["teapot.final640"])
    ap.add_argument("--processes", type=int, default=3)
    ap.add_argument("--renders", type=int, default=8)
    ap.add_argument("--seed", type=int, default=2 ** 31 + 21)
    ap.add_argument("--out", default=None)
    ap.add_argument("--one", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print(json.dumps(one_process(args.one, args.renders, args.seed)))
        return 0
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()
    print(card[0] if card else "card: not read")
    result = {"card": card[0] if card else None, "cells": {}}
    for name in args.cells:
        runs = []
        for p in range(args.processes):
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--one", name,
                 "--renders", str(args.renders), "--seed",
                 str(args.seed + p)], capture_output=True, text=True,
                cwd=ROOT)
            if proc.returncode != 0:
                print(proc.stderr[-4000:], file=sys.stderr)
                return proc.returncode
            got = json.loads(proc.stdout.strip().splitlines()[-1])
            runs.append(got)
            print(f"{name} process {p}: ms a segment " + " ".join(
                f"{x:.4f}" for x in got["ms_a_segment"]) + "; wall s "
                + " ".join(f"{x:.4f}" for x in got["wall_s"])
                + f"; hits {got['hits']}", flush=True)
        result["cells"][name] = runs
    line = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
