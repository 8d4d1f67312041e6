#!/usr/bin/env python3
"""The cost of the program's own tracing (hobbyraytracer_tpu_torch/
tracing.py) on one CUDA card, and what it reads: jobs of benchmark cells
(perfbench/: teapot.final640's renders, shiny_teapot.fit's fits, as the
harness runs them: each cell's own job kind and reference) untraced and
under tracing.recording() (no profiler), in turns off, on, on, off,
--jobs jobs a turn, in one process.

    python3 scripts/time_tracing.py [--cells teapot.final640 shiny_teapot.fit]
        [--jobs 3] [--device cuda:0] [--out FILE]

Prints the card's name and power limit; for each cell each turn's job
seconds, the traced jobs' readings (device ms a replayed segment or step
by phase, the sphere find's where the scene has spheres, kernel nodes a
segment or step, lane occupancy, deferred lanes, the retirement cap's
fill) and each traced job's host split: the eager first block or step,
the capture (graph record, instantiate, the first replay) and the
replays; both modes' host ms a job in each pass of the
graph (eager, capture, replay) and device ms of its replays (CUDA events
around each); how many of each mode's jobs replayed the graph kept across
jobs (diff/fit.py:FIT_GRAPHS, integrator/wavefront.py:RENDER_GRAPHS:
"hits") and how many captured one ("captures"). A traced job's graph is
kept apart from an untraced one's, so the first job of the first "on"
turn captures and every later job of a mode hits: the "on" turns carry
one capture that the "off" turns, whose graph the warm-up captured, do
not. Then one JSON line (also written to --out).
"""
import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _split(records, kind: str) -> list:
    """Host ms of each traced job of `kind`: the eager pass, the capture
    pass (and its record / instantiate spans), the replays, the whole."""
    unit = "hrt.block" if kind == "render" else "hrt.fit.step"
    jobs = {s["id"]: s for s in records if s["type"] == "span"
            and s["parent"] is None and s["name"] == "hrt." + kind}
    out = []
    for j, root in jobs.items():
        row = dict.fromkeys(["eager", "capture", "replay", "graph.record",
                             "graph.instantiate"], 0.0)
        for s in records:
            if s["type"] != "span" or s["job"] != j:
                continue
            ms = 1e-6 * (s["end_ns"] - s["start_ns"])
            if s["name"] == unit:
                row[s["attrs"]["route"]] += ms
            elif s["name"][len("hrt."):] in row:
                row[s["name"][len("hrt."):]] += ms
        row["whole"] = 1e-6 * (root["end_ns"] - root["start_ns"])
        out.append(row)
    return out


class _GraphTimes:
    """Both modes alike: host ms of each GraphReplay call by pass (eager,
    capture, replay) and device ms of each replay (CUDA events around
    it), summed a job."""

    def __init__(self, kbuild):
        import torch
        self.host, self.events = {}, []
        call, replay = kbuild.GraphReplay.__call__, kbuild.GraphReplay.replay
        times = self

        def timed_call(graph, fn):
            kind = ("eager" if not graph.warm else
                    "capture" if graph.graph is None else "replay")
            t0 = time.perf_counter()
            out = call(graph, fn)
            times.host[kind] = (times.host.get(kind, 0.0)
                                + 1e3 * (time.perf_counter() - t0))
            return out

        def timed_replay(graph):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            out = replay(graph)
            b.record()
            times.events.append((a, b))
            return out

        kbuild.GraphReplay.__call__ = timed_call
        kbuild.GraphReplay.replay = timed_replay

    def take(self) -> dict:
        out = {"host_" + k: v for k, v in self.host.items()}
        out["replay_device"] = sum(a.elapsed_time(b) for a, b in self.events)
        out["replays"] = len(self.events)
        self.host, self.events = {}, []
        return out


def _readings(rec, kind: str) -> dict:
    from perfbench import program_trace as pt
    phases = (("segment.regenerate", "segment.find", "segment.find.spheres",
               "segment.shade", "segment.retire") if kind == "render" else
              ("fit.forward", "fit.backward", "fit.adam"))
    out = {}
    for name in phases:
        got = pt.phase_ms(rec, kind, name)
        out[name + "_ms"] = got and got[0]
    nodes = pt.graph_nodes(rec, kind, per="steps" if kind == "render"
                           else "")
    if nodes:
        out["kernel_nodes"] = nodes[0]
        out.update({k + "_nodes": v for k, v in nodes[1].items()})
    if kind == "render":
        out.update(pt.lane_shares(rec) or {})
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", nargs="+",
                    default=["teapot.final640", "shiny_teapot.fit"])
    ap.add_argument("--jobs", type=int, default=3)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--seed", type=int, default=2 ** 31 + 15)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()
    print(card[0] if card else "card: not read")
    import torch

    from hobbyraytracer_tpu_torch import tracing
    from hobbyraytracer_tpu_torch.diff import fit as fit_mod
    from hobbyraytracer_tpu_torch.integrator import wavefront
    from hobbyraytracer_tpu_torch.kernels import build as kbuild
    from perfbench import jobs, manifest
    graph_times = _GraphTimes(kbuild)

    device = torch.device(args.device)
    result = {"card": card[0] if card else None, "cells": {}}
    for name in args.cells:
        cell = manifest.load_cell(name)
        kind = cell.traffic["job"]
        program = jobs.kind(cell)(cell.path(cell.config["scene"]),
                                  cell.traffic, device, args.seed,
                                  ref=manifest.reference(cell))
        program.run(-1)                       # warm-up: builds, allocator
        torch.cuda.synchronize(device)
        graph_times.take()
        times = {"off": [], "on": []}
        graphs = {"off": [], "on": []}
        kept = {mode: {"hits": 0, "captures": 0} for mode in graphs}
        records = []
        j = 0
        for mode in ("off", "on", "on", "off"):
            for _ in range(args.jobs):
                cache = (fit_mod.FIT_GRAPHS if kind == "fit"
                         else wavefront.RENDER_GRAPHS)
                before = (cache.hits, cache.captures)
                with (tracing.recording() if mode == "on"
                      else contextlib.nullcontext()) as rec:
                    t0 = time.perf_counter()
                    program.run(j)
                    torch.cuda.synchronize(device)
                    times[mode].append(time.perf_counter() - t0)
                graphs[mode].append(graph_times.take())
                kept[mode]["hits"] += cache.hits - before[0]
                kept[mode]["captures"] += cache.captures - before[1]
                if rec is not None:
                    records.extend(rec.drain())
                j += 1
            print(f"{name} {mode}: " + " ".join(
                f"{t:.4f}" for t in times[mode][-args.jobs:]) + " s",
                flush=True)
        rec = tracing.Recorder()
        for r in records:
            getattr(rec, r["type"] + "s").append(r)
        split = _split(records, kind)
        got = {"job_s_off": times["off"], "job_s_on": times["on"],
               "on_over_off": statistics.mean(times["on"])
               / statistics.mean(times["off"]),
               "readings": _readings(rec, kind), "split_ms": split,
               "graph_ms": {m: {k: statistics.mean(g.get(k, 0.0)
                                                   for g in graphs[m])
                                for k in graphs[m][0]} for m in graphs}}
        got["kept_graphs"] = kept
        result["cells"][name] = got
        print(f"{name}: traced / untraced job time "
              f"{got['on_over_off']:.4f}")
        print(f"{name}: readings {json.dumps(got['readings'])}")
        print(f"{name}: graph ms a job (host by pass, replays' device) "
              f"{json.dumps(got['graph_ms'])}")
        print(f"{name}: kept graphs by mode {json.dumps(kept)}")
        for row in split:
            print(f"{name}: split ms " + json.dumps(
                {k: round(v, 3) for k, v in row.items()}))
        del program
        torch.cuda.empty_cache()
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
