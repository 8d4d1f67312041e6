"""Spans and the device trace of the traced run (`--trace 1`).

Spans: the harness wraps the program's calls from here (the program is
not edited): `kernels/build.py:GraphReplay.__call__` (kind "eager" for a
graph's first, eager run, "capture" for the run that captures and replays
it, "replay" after), `GraphReplay.capture` ("capture_record"),
`integrator/wavefront.py:_close_block` ("host_read"), `film_image`
("film") and `kernels/mesh_traverse.py:_traverse_cuda`, whose rays per
launch it records. Each span's host time is kept, and each is a
torch.profiler annotation named "pb.<kind>", so that a profiled job's
device activity can be split by the span that launched it. A wrapped name
that the program lacks raises (AttributeError).

The device trace: one torch.profiler window a profiled job (CPU and CUDA
activity). Its kernel, memcpy and memset records give the busy time (the
union of their intervals), the time by kernel name, the busy time of each
kind of span (a record belongs to the last launching span that started
before it: every block and every step ends in a host read, so no record
of one starts after the next has begun), and the idle gaps, each named by
the innermost span the host was in at its midpoint. The records are read
through torch.profiler's kineto results (`prof.profiler.kineto_results`,
each record's `is_user_annotation`); a torch that lacks them raises
(AttributeError), as a missing wrapped name does.
"""
from __future__ import annotations

import functools
import time
from dataclasses import dataclass, field

import numpy as np
import torch

PREFIX = "pb."
LAUNCHING = ("job", "eager", "capture", "replay", "film")


@dataclass
class JobSpans:
    """Host seconds of each kind of span in one job, and the units
    (segments of a block, or 1 a step) of its replays."""
    seconds: dict = field(default_factory=dict)
    replay_units: int = 0

    def add(self, kind: str, seconds: float) -> None:
        self.seconds[kind] = self.seconds.get(kind, 0.0) + seconds


class Spans:
    """The wrappers, installed on the program by `install`, and their
    records: `jobs`, one JobSpans a job, and `lanes`, the rays of each
    launch of K1 / K2 that went through the Python wrapper."""

    def __init__(self):
        self.jobs = []
        self.lanes = set()

    def job(self):
        """A new job's record, and its span (a context manager)."""
        self.jobs.append(JobSpans())
        return torch.profiler.record_function(PREFIX + "job")

    def _timed(self, kind: str, fn, *args, **kwargs):
        t0 = time.perf_counter()
        with torch.profiler.record_function(PREFIX + kind):
            out = fn(*args, **kwargs)
        if self.jobs:
            self.jobs[-1].add(kind, time.perf_counter() - t0)
        return out

    def install(self) -> None:
        from hobbyraytracer_tpu_torch.integrator import wavefront
        from hobbyraytracer_tpu_torch.kernels import build as kbuild
        from hobbyraytracer_tpu_torch.kernels import mesh_traverse as kmod
        spans = self
        call = kbuild.GraphReplay.__call__
        capture = kbuild.GraphReplay.capture

        @functools.wraps(call)
        def graph_call(graph, fn):
            kind = ("eager" if not graph.warm else
                    "capture" if graph.graph is None else "replay")
            out = spans._timed(kind, call, graph, fn)
            if kind == "replay" and spans.jobs:
                spans.jobs[-1].replay_units += (
                    len(out) if isinstance(out, list) else 1)
            return out

        @functools.wraps(capture)
        def graph_capture(graph, fn):
            return spans._timed("capture_record", capture, graph, fn)

        traverse = kmod._traverse_cuda

        @functools.wraps(traverse)
        def traverse_cuda(rays8, *args, **kwargs):
            spans.lanes.add(int(rays8.numel() // 8))
            return traverse(rays8, *args, **kwargs)

        kbuild.GraphReplay.__call__ = graph_call
        kbuild.GraphReplay.capture = graph_capture
        kmod._traverse_cuda = traverse_cuda
        for name, kind in (("_close_block", "host_read"),
                           ("film_image", "film")):
            fn = getattr(wavefront, name)
            setattr(wavefront, name, functools.partial(self._timed, kind, fn))


@dataclass
class DeviceTrace:
    """What one profiled job's trace shows (seconds)."""
    window_s: float
    busy_s: float
    by_name: dict
    busy_by_span: dict
    idle_by_span: dict
    launches: dict
    units: int


def read_trace(prof, launches: dict, units: int) -> DeviceTrace:
    """Reduce one job's profiler window (which holds exactly one "pb.job"
    annotation) to a DeviceTrace."""
    gpu, spans = [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if str(e.device_type()).endswith("CUDA"):
            # a kernel, memcpy or memset record, not an annotation's range
            if not (name.startswith(PREFIX) or e.is_user_annotation()):
                gpu.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                            name))
        elif name.startswith(PREFIX):
            spans.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                          name[len(PREFIX):]))
    jobs = [s for s in spans if s[2] == "job"]
    if len(jobs) != 1 or not gpu:
        raise RuntimeError(f"a profiled job's trace holds {len(jobs)} job "
                           f"spans and {len(gpu)} device records")
    w0, w1 = jobs[0][0], jobs[0][1]
    gpu.sort()
    start = np.array([g[0] for g in gpu], np.int64)
    end = np.array([g[1] for g in gpu], np.int64)
    reach = np.maximum.accumulate(end)
    prior = np.concatenate([[start[0]], reach[:-1]])
    own = np.maximum(end - np.maximum(start, prior), 0)   # union share
    by_name = {}
    for (_, _, name), dur in zip(gpu, end - start):
        by_name[name] = by_name.get(name, 0.0) + dur * 1e-9

    spans.sort(key=lambda s: (s[0], -s[1]))
    launch = [s for s in spans if s[2] in LAUNCHING]
    owner = np.searchsorted(np.array([s[0] for s in launch], np.int64),
                            start, side="right") - 1
    busy_by_span = _by_kind(owner, own, [s[2] for s in launch], "before")

    # idle gaps: before the first record, between records, after the last
    w_end = max(w1, int(reach[-1]))
    g_lo = np.concatenate([[w0], reach])
    g_hi = np.concatenate([start, [w_end]])
    keep = g_hi > g_lo
    g_lo, g_hi = g_lo[keep], g_hi[keep]
    mid = (g_lo + g_hi) // 2
    s_start = np.array([s[0] for s in spans], np.int64)
    s_end = np.array([s[1] for s in spans], np.int64)
    parent = np.full(len(spans), -1)
    open_ = []
    for i in range(len(spans)):           # innermost span holding span i
        while open_ and s_end[open_[-1]] < s_end[i]:
            open_.pop()
        parent[i] = open_[-1] if open_ else -1
        open_.append(i)
    idx = np.searchsorted(s_start, mid, side="right") - 1
    for _ in range(len(spans)):           # up to the span holding the gap
        out = (idx >= 0) & (s_end[np.maximum(idx, 0)] < mid)
        if not out.any():
            break
        idx[out] = parent[idx[out]]
    idle_by_span = _by_kind(idx, g_hi - g_lo, [s[2] for s in spans],
                            "outside")
    window = (w_end - w0) * 1e-9
    return DeviceTrace(window, float(own.sum()) * 1e-9, by_name,
                       busy_by_span, idle_by_span, launches, units)


def _by_kind(index, ns, kinds: list, none: str) -> dict:
    """{kind: seconds}: the nanoseconds `ns` summed by the kind of the
    span at each `index` (-1: `none`)."""
    sums = np.bincount(index + 1, weights=ns.astype(np.float64),
                       minlength=len(kinds) + 1)
    out = {}
    for kind, s in zip([none] + kinds, sums):
        if s:
            out[kind] = out.get(kind, 0.0) + s * 1e-9
    return out


def profile_job(run_job, libraries) -> DeviceTrace:
    """Run one job (run_job(), which opens the job's span and
    synchronizes at its end) under a profiler window of its own."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    before = {lib.name: lib.launches for lib in libraries}
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    units = run_job()
    prof.stop()
    launches = {lib.name: lib.launches - before[lib.name]
                for lib in libraries}
    return read_trace(prof, launches, units)
