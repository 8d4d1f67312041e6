"""The program's own record of a render or a fit: host spans, device phase
times and counters, kept in memory (`RECORDER`) until drained.

When. A render (integrator/wavefront.py:render_image / render_state) or a
fit (diff/fit.py:fit_materials) is traced as a whole when, at its start, a
torch.profiler session is recording or the caller is inside `recording()`.
Otherwise the program runs as it does untraced: the same kernels, the same
graphs, no extra host read; each instrumented site checks `ACTIVE` once,
and only where Python runs (the eager and capture passes, not a graph's
replays). Calls outside a render or a fit (the batch integrator's graphs,
parallel/shard.py's workers, `_segment` called directly) record nothing,
except the graph spans of `GraphReplay` under `recording()`.

Host spans: a name ("hrt.<name>"), start and end (`time.time_ns()`, the
clock of torch.profiler's kineto records), an id, the parent's id, the id
of the top-level span (the job), and attributes; every span inside a job
carries `route`: the pass under way when it closed ("eager", "capture" or
"replay", set by kernels/build.py:GraphReplay). While a profiler records,
each span is also a `torch.profiler.record_function("hrt.<name>")` range.

Device phase times (`phase`): a phase of a segment or of a fit step is
bounded by timing events recorded on the current stream; inside a CUDA
graph's capture they become event-record nodes, so every replay times
itself. A phase that directly follows another starts at that one's end
event (the program issues no device work between consecutive phases; the
lane counters and the end of a block or step break the chain): a
segment's four phases take five events. They are read after the host read
that ends each block or step (`read_phases`), per phase summed over the
block's segments, tagged with the route. On the CPU a phase records its
host time under the same name.

A phase may hold a nested one (`subphase`: the sphere find inside a
segment's find), timed by two events of its own, so that the phases
around it keep their shared boundaries.

Counters: segments (or steps) run; the nodes of each captured graph by
type, counted on the graph before it is instantiated; in a render, lane
counters on the device, allocated before any capture and added to in
every segment (lanes active at the find, lanes that hit, lanes left
deferred by the retirement cap, rows retired, and where the scene has
what they count the `LANE_KINDS`: lanes whose closest hit is a pooled
sphere, lanes the dielectric lobe scattered): one int32 count a lane (a
retirement row), so a segment adds elementwise, and summed once when the
render ends.

Records are plain dicts, `{"type": "span" | "phase" | "counter", ...}`;
`write_jsonl` writes them one a line (the CLI's `--profile DIR` writes
DIR/spans_rank{r}.jsonl).
"""
from __future__ import annotations

import contextlib
import ctypes
import itertools
import json
import time
from typing import Optional

import torch

# names of a render's lane counters, in the order count_lanes takes its
# masks
LANE_COUNTERS = ("lanes.active", "lanes.hit", "lanes.deferred",
                 "rows.retired")
# lane counters a render keeps only where its scene has what they count
# (pooled spheres; a dielectric material), each noted by its site in the
# segment (`note_lanes`)
LANE_KINDS = ("lanes.sphere_hit", "lanes.dielectric")
# CUgraphNodeType (the runtime's cudaGraphNodeType has the same values)
NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 7: "event_record"}


class Recorder:
    """The records of the traced calls, in the order they ended."""

    def __init__(self):
        self.spans = []
        self.phases = []
        self.counters = []

    def records(self) -> list:
        return self.spans + self.phases + self.counters

    def drain(self) -> list:
        """Every record so far (spans, then phases, then counters); the
        recorder is left empty."""
        out = self.records()
        self.spans, self.phases, self.counters = [], [], []
        return out


RECORDER = Recorder()
ACTIVE: Optional["Trace"] = None   # the trace under way; None: tracing off
_IDS = itertools.count(1)


def profiler_enabled() -> bool:
    """Is a torch.profiler session recording?"""
    return torch._C._autograd._profiler_enabled()


class Job:
    """One traced render or fit: its root span, the route of the pass under
    way, the phase marks of that pass and of the captured graph, and the
    lane counters of a render."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.route = "eager"
        self.marks = []        # (name, start, end): this pass's phases
        self.captured = []     # the marks recorded into the graph
        self.boundary = None   # the end event of the phase just closed
        self.units = 0         # segments (render) or steps (fit) run
        self.lanes = None      # (3, pool) and (cap,) int32 counts (render)
        self.kinds = {}        # LANE_KINDS name -> (pool,) int32 counts
        self.noted = {}        # name -> this segment's mask of the hits
        self.root = None


class Trace:
    """The state of tracing while it is on: the open spans and the job."""

    def __init__(self, profiling: bool):
        self.profiling = profiling
        self.stack = []
        self.job: Optional[Job] = None


class Span:
    """An open host span (a context manager); its record is written when
    it closes. `attrs` may be added to until then."""

    def __init__(self, trace: Trace, name: str, attrs: dict):
        self.trace, self.name, self.attrs = trace, name, attrs
        self._range = None

    def __enter__(self) -> "Span":
        tr = self.trace
        self.id = next(_IDS)
        self.parent = tr.stack[-1].id if tr.stack else None
        self.job = tr.stack[0].id if tr.stack else self.id
        tr.stack.append(self)
        self.start_ns = time.time_ns()
        if tr.profiling:
            self._range = torch.profiler.record_function("hrt." + self.name)
            self._range.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        if self._range is not None:
            self._range.__exit__(*exc)
        end = time.time_ns()
        tr = self.trace
        tr.stack.remove(self)
        if tr.job is not None:
            self.attrs.setdefault("route", tr.job.route)
        RECORDER.spans.append({
            "type": "span", "name": "hrt." + self.name,
            "start_ns": self.start_ns, "end_ns": end, "id": self.id,
            "parent": self.parent, "job": self.job, "attrs": self.attrs})


class _Phase(Span):
    """A span that also times its device work (timing events on the
    current stream, the first shared with the phase just closed where
    there is one; on the CPU its host time)."""

    def __enter__(self) -> "_Phase":
        super().__enter__()
        job = self.trace.job
        if job.device.type != "cuda":
            self._start = time.perf_counter_ns()
        elif job.boundary is not None:
            self._start = job.boundary
        else:
            self._start = _event()
        return self

    def __exit__(self, *exc) -> None:
        job = self.trace.job
        if job.device.type != "cuda":
            end = time.perf_counter_ns()
        else:
            end = job.boundary = _event()
        job.marks.append((self.name, self._start, end))
        super().__exit__(*exc)


class _SubPhase(Span):
    """A phase nested inside an open one, timed by two events of its own
    (its host time on the CPU): the phases around it keep their shared
    boundaries."""

    def __enter__(self) -> "_SubPhase":
        super().__enter__()
        self._start = _stamp(self.trace.job)
        return self

    def __exit__(self, *exc) -> None:
        job = self.trace.job
        job.marks.append((self.name, self._start, _stamp(job)))
        super().__exit__(*exc)


def _stamp(job: Job):
    """A timing event on the card, the host's ns on the CPU."""
    return _event() if job.device.type == "cuda" else time.perf_counter_ns()


def _event() -> "torch.cuda.Event":
    """A timing event recorded on the current stream (inside a capture, an
    event-record node of the graph)."""
    ev = torch.cuda.Event(enable_timing=True, external=True)
    ev.record()
    return ev


_NULL = contextlib.nullcontext()


def span(name: str, **attrs):
    """A host span "hrt.<name>" while tracing is on (else a no-op)."""
    tr = ACTIVE
    if tr is None:
        return _NULL
    return Span(tr, name, attrs)


def phase(name: str):
    """A phase "hrt.<name>" of a traced job: a host span that also times
    the device work it issues (else a no-op)."""
    tr = ACTIVE
    if tr is None or tr.job is None:
        return _NULL
    return _Phase(tr, name, {})


def subphase(name: str, inside: str):
    """A phase "hrt.<name>" of a traced job nested in the open phase
    "hrt.<inside>" (else a no-op: untraced, or called from elsewhere)."""
    tr = ACTIVE
    if (tr is None or tr.job is None or not tr.stack
            or tr.stack[-1].name != inside):
        return _NULL
    return _SubPhase(tr, name, {})


def set_route(route: str) -> None:
    """The pass that starts: "eager", "capture" (recorded into a graph and
    replayed at once) or "replay"."""
    tr = ACTIVE
    if tr is not None and tr.job is not None:
        tr.job.route = route


@contextlib.contextmanager
def recording():
    """Trace every render and fit inside (no profiler needed) -> the
    recorder."""
    global ACTIVE
    if ACTIVE is not None:
        yield RECORDER
        return
    ACTIVE = Trace(profiler_enabled())
    try:
        yield RECORDER
    finally:
        ACTIVE = None


@contextlib.contextmanager
def job(kind: str, device, **attrs):
    """A render or fit ("hrt.<kind>"), traced when a profiler records or
    inside `recording()` -> its Job (None when untraced). Inside a job
    already this adds `attrs` to its root span and yields that job."""
    global ACTIVE
    tr = ACTIVE
    if tr is not None and tr.job is not None:
        tr.job.root.attrs.update(attrs)
        yield tr.job
        return
    profiling = profiler_enabled()
    if tr is None and not profiling:
        yield None
        return
    own = tr is None
    if own:
        tr = ACTIVE = Trace(True)
    saved, tr.profiling = tr.profiling, tr.profiling or profiling
    j = tr.job = Job(device)
    try:
        with Span(tr, kind, dict(attrs)) as root:
            j.root = root
            yield j
            _counter(j, "segments" if kind == "render" else "steps",
                     j.units)
            if j.lanes is not None:
                lanes, rows = j.lanes
                sums = lanes.sum(1, dtype=torch.int64).tolist()
                sums.append(int(rows.sum(dtype=torch.int64)))
                for name, value in zip(LANE_COUNTERS, sums):
                    _counter(j, name, value)
                for name, lanes in j.kinds.items():
                    _counter(j, name, int(lanes.sum(dtype=torch.int64)))
    finally:
        tr.job = None
        tr.profiling = saved
        if own:
            ACTIVE = None


def lane_counters(device, pool: int, cap: int, kinds=()) -> None:
    """Allocate the traced render's lane counters for a pool of `pool`
    lanes retiring at most `cap` rows a segment, and one for each name of
    `kinds` (of LANE_KINDS) that the scene has (before any graph is
    captured: the graph adds to them in place)."""
    tr = ACTIVE
    if tr is not None and tr.job is not None and tr.job.lanes is None:
        tr.job.lanes = (
            torch.zeros((3, pool), dtype=torch.int32, device=device),
            torch.zeros((cap,), dtype=torch.int32, device=device))
        tr.job.kinds = {k: torch.zeros((pool,), dtype=torch.int32,
                                       device=device) for k in kinds}


def note_lanes(name: str, mask_of) -> None:
    """In a traced render that counts `name` (a LANE_KINDS counter): keep
    `mask_of`, a function of the segment's closest hits to the (pool,)
    mask of the lanes it counts, for this segment's count_lanes (no
    device work here; else a no-op)."""
    tr = ACTIVE
    if tr is not None and tr.job is not None and name in tr.job.kinds:
        tr.job.noted[name] = mask_of


def count_lanes(active: torch.Tensor, hit: torch.Tensor,
                deferred: torch.Tensor, retired: torch.Tensor,
                hits=None) -> None:
    """Count one segment on the device: the (pool,) masks of the lanes
    active at the find, that hit and left deferred, and the (cap,) mask
    of the retirement rows that retired a chunk; and of the lanes that
    hit, those each noted counter marks in `hits`, the segment's closest
    hits."""
    tr = ACTIVE
    if tr is None or tr.job is None or tr.job.lanes is None:
        return
    lanes, rows = tr.job.lanes
    lanes.add_(torch.stack([active, hit, deferred]))
    rows.add_(retired)
    for name, mask_of in tr.job.noted.items():
        tr.job.kinds[name].add_(hit & mask_of(hits))
    tr.job.noted = {}
    tr.job.boundary = None


def read_phases(units: int) -> None:
    """After the host read that ends a block (units: its segments) or a
    step (1): record each phase's milliseconds, summed over the pass, with
    the route. A replay reads the marks its graph's capture recorded."""
    tr = ACTIVE
    if tr is None or tr.job is None:
        return
    j = tr.job
    j.units += units
    j.boundary = None
    marks = j.captured if j.route == "replay" else j.marks
    if j.route == "capture":
        j.captured = marks
    j.marks = []
    ms = {}
    for name, a, b in marks:
        ms[name] = ms.get(name, 0.0) + (
            (b - a) * 1e-6 if isinstance(a, int) else a.elapsed_time(b))
    for name, v in ms.items():
        RECORDER.phases.append({"type": "phase", "job": j.root.id,
                                "name": "hrt." + name, "route": j.route,
                                "ms": v, "units": units})


def _counter(j: Optional[Job], name: str, value) -> None:
    RECORDER.counters.append({"type": "counter",
                              "job": j.root.id if j is not None else None,
                              "name": name, "value": value})


_LIBCUDA = None


def _libcuda() -> ctypes.CDLL:
    """The CUDA driver's graph queries, typed."""
    global _LIBCUDA
    if _LIBCUDA is None:
        lib = ctypes.CDLL("libcuda.so.1")
        lib.cuGraphGetNodes.argtypes = [ctypes.c_void_p,
                                        ctypes.POINTER(ctypes.c_void_p),
                                        ctypes.POINTER(ctypes.c_size_t)]
        lib.cuGraphGetNodes.restype = ctypes.c_int
        lib.cuGraphNodeGetType.argtypes = [ctypes.c_void_p,
                                           ctypes.POINTER(ctypes.c_int)]
        lib.cuGraphNodeGetType.restype = ctypes.c_int
        _LIBCUDA = lib
    return _LIBCUDA


def graph_nodes(graph: "torch.cuda.CUDAGraph") -> dict:
    """The nodes of a captured graph made with keep_graph=True, by type:
    {"kernel", "memcpy", "memset", "event_record", "other": count}. Read
    through the CUDA driver, whose CUgraph is the runtime's cudaGraph_t."""
    lib = _libcuda()
    handle = graph.raw_cuda_graph()
    n = ctypes.c_size_t(0)
    _check(lib.cuGraphGetNodes(handle, None, ctypes.byref(n)),
           "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    _check(lib.cuGraphGetNodes(handle, nodes, ctypes.byref(n)),
           "cuGraphGetNodes")
    out = dict.fromkeys([*NODE_TYPES.values(), "other"], 0)
    kind = ctypes.c_int(0)
    for node in nodes:
        _check(lib.cuGraphNodeGetType(node, ctypes.byref(kind)),
               "cuGraphNodeGetType")
        out[NODE_TYPES.get(kind.value, "other")] += 1
    return out


def _check(rc: int, call: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{call} failed with CUresult {rc}")


def count_graph_nodes(graph) -> None:
    """Record the captured graph's nodes by type ("graph.<type>")."""
    tr = ACTIVE
    if tr is None:
        return
    for kind, n in graph_nodes(graph).items():
        _counter(tr.job, "graph." + kind, n)


def write_jsonl(path: str, records: list) -> None:
    """The records, one JSON object a line."""
    with open(path, "w") as f:
        for r in records:
            f.write(json.dumps(r) + "\n")
