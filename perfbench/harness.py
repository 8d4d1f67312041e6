"""One run of one cell: set-up, the measured window, the traced jobs, the
check against the plain reference that the cell's configuration names, and
the result line (its `checked_by` and a note on stderr name that reference
and the job kind).

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

Set-up (timed as setup_s, from the process's start): torch and the card,
the program's scene on the card (on a checkout's first run also the
builds of its kernels and host library into build/), and one job of the
cell's own traffic (the warm-up: every shape the window uses). The window
is a closed loop of one client: jobs back to back, job j from its own
seed; no job starts once `seconds` have passed, and the window ends when
the last job ends, every job synchronized with the card. With --trace 1
the harness wraps the program's calls (profiling.Spans) and, after the
window, runs `profile_jobs` more jobs each under a profiler window of its
own. Only the outputs of `check_jobs` jobs drawn from the seed are kept
(a reservoir sample, so the kept outputs barely add to the peak memory);
after the window the peak memory is read and the reference recomputes
those jobs; each number compared is printed beside its limit.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import random
import subprocess
import sys
import time
import traceback
from dataclasses import dataclass, field

from . import jobs, manifest, profiling

BANNED = ("jax", "jaxlib", "flax", "hobbyraytracer_tpu")


def process_age() -> float:
    """Seconds since this process started (0 where /proc cannot say)."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(0.0, up - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


def banned_modules() -> list:
    """Loaded modules whose top-level name is one the run may not load."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


@dataclass
class Run:
    """What a run measured, for the metric readers."""
    cell: manifest.Cell
    setup_s: float
    window_s: float
    walls: list
    work: list
    spans: list = field(default_factory=list)
    traces: list = field(default_factory=list)
    lanes: set = field(default_factory=set)
    peaks: dict = field(default_factory=dict)

    @property
    def job(self) -> str:
        return self.cell.traffic["job"]


def _peaks(kind: str) -> dict:
    table = manifest.load_json(os.path.join(manifest.HERE, "peaks.json"))
    for name, peaks in table.items():
        if kind.startswith(name):
            return peaks
    return {}


def _power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"


def run_cell(cell: manifest.Cell, seed: int, seconds: float, trace: bool,
             device, t_origin: float, program_cls=None) -> dict:
    """Run the cell once on `device` -> the result line's dict (its
    "checks" last). t_origin: perf_counter() of the process's start.
    program_cls: the jobs' class (default: the traffic's kind)."""
    import torch

    cls = program_cls or jobs.kind(cell)   # a refused kind or reference
    ref = manifest.reference(cell)         # raises before set-up starts
    manifest.verify_inputs(cell)
    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    spans = profiling.Spans() if trace else None
    if spans:
        spans.install()
    program = cls(cell.path(cell.config["scene"]), cell.traffic, device, seed,
                  ref)
    program.run(-1)                                     # the warm-up job
    sync()

    # the outputs of `check_jobs` jobs drawn from the seed (a reservoir
    # sample, so that only those stay on the card)
    draw = random.Random(jobs.job_seed(seed, "check"))
    k = int(cell.traffic["check_jobs"])
    slots, walls, failed = [], [], 0
    t_start = time.perf_counter()
    setup_s = t_start - t_origin
    while time.perf_counter() - t_start < seconds:
        j = len(walls)
        t0 = time.perf_counter()
        try:
            with spans.job() if spans else contextlib.nullcontext():
                out = program.run(j)
                sync()
        except Exception:      # the program failed: the run is not correct
            traceback.print_exc()
            failed += 1
            break
        walls.append(time.perf_counter() - t0)
        if j < k:
            slots.append((j, out))
        elif (r := draw.randint(0, j)) < k:
            slots[r] = (j, out)
        del out
    window_s = time.perf_counter() - t_start
    n = len(walls)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    traces = []
    if spans:
        from hobbyraytracer_tpu_torch.kernels import build as kbuild
        window_spans = list(spans.jobs)
        for p in range(int(cell.traffic["profile_jobs"])):
            def one(j=n + p):
                with spans.job():
                    program.run(j)
                    sync()
                return spans.jobs[-1].replay_units
            traces.append(profiling.profile_job(one, list(kbuild.LIBRARIES)))
        spans.jobs = window_spans

    if cuda:
        torch.cuda.empty_cache()
    gaps = {name: [] for name in cell.limits}
    for i, out in slots:
        for name, value in program.compare(out,
                                           program.reference(i)).items():
            gaps[name].append(value)
    # an infinite or NaN gap (no reading, a NaN output) is written 1e300
    checks = {name: {"value": _finite(jobs.worst(gaps[name] or [math.inf])),
                     "limit": limit} for name, limit in cell.limits.items()}
    correct = (failed == 0 and n > 0 and bool(slots)
               and all(c["value"] <= c["limit"] for c in checks.values()))

    kind = torch.cuda.get_device_name(device) if cuda else "cpu"
    run = Run(cell, setup_s, window_s, walls,
              [program.work()] * n, spans.jobs if spans else [],
              traces, spans.lanes if spans else set(), _peaks(kind))
    checked_by = {"reference": _rel(ref.__file__, package=True),
                  "kind": cell.traffic["job"],
                  "jobs": f"{_rel(sys.modules[cls.__module__].__file__)}:"
                          f"{cls.__qualname__}"}
    metrics, notes = {}, [
        "checked by the reference {reference}; job kind {kind} ({jobs})"
        .format(**checked_by)]
    for m in (cell.per_layer if trace else cell.end_to_end):
        got = manifest.reader(m["name"])(run)
        if isinstance(got, tuple):
            got, note = got
            notes.append(f"{m['name']}: {note}")
        if got is not None:
            metrics[m["name"]] = {"value": got, "unit": m["unit"]}
    device_info = {"platform": "gpu" if cuda else "cpu", "kind": kind,
                   "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": n + failed, "failed": failed,
              "metrics": metrics, "device": device_info,
              "checked_by": checked_by}
    if trace:
        device_info["busy_s"] = sum(t.busy_s for t in traces)
        device_info["window_s"] = sum(t.window_s for t in traces)
        result["breakdown"] = _breakdown(traces)
        notes.append(f"peaks {run.peaks}; card {_power_limit()}")
    if walls:
        notes.append(f"{n} jobs in {window_s:.3f} s; a job {min(walls):.3f}"
                     f" to {max(walls):.3f} s, median "
                     f"{sorted(walls)[n // 2]:.3f} s; setup {setup_s:.3f} s")
    for note in notes:
        print(note, file=sys.stderr)
    result["checks"] = checks
    return result


def _rel(path: str, package: bool = False) -> str:
    """`path` (a package's folder where `package`) from the checkout's
    root."""
    return os.path.relpath(os.path.dirname(path) if package else path,
                           manifest.ROOT)


def _finite(x: float) -> float:
    return x if math.isfinite(x) else 1e300


def _top(sums: dict, n: int = 10) -> list:
    return [[name[:120], s] for name, s in
            sorted(sums.items(), key=lambda kv: -kv[1])[:n]]


def _breakdown(traces: list) -> dict:
    """The device operations that took most time, and the idle time by
    what the host was doing, summed over the traced jobs."""
    ops, idle = {}, {}
    for t in traces:
        for name, s in t.by_name.items():
            ops[name] = ops.get(name, 0.0) + s
        for kind, s in t.idle_by_span.items():
            idle[kind] = idle.get(kind, 0.0) + s
    return {"device_ops": _top(ops), "idle_gaps": _top(idle)}


def main(argv=None) -> int:
    t_origin = time.perf_counter() - process_age()
    p = argparse.ArgumentParser(prog="perfbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    # the program at its defaults: none of its knobs from the environment;
    # any kernel cache inside the checkout, at fixed paths
    for key in [k for k in os.environ if k.startswith("HRT_")]:
        del os.environ[key]
    cache = os.path.join(manifest.ROOT, "build", "perfbench")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["USE_FLAX"] = "0"
    import torch

    cell = manifest.load_cell(args.workload)
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell.chips):
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), t_origin)
    found = banned_modules()
    if found:
        print(f"the run loaded {found}: no result", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        ok = "ok" if c["value"] <= c["limit"] else "FAILED"
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {ok}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0
