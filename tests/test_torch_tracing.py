"""The program's own tracing (hobbyraytracer_tpu_torch/tracing.py) on the
CPU: a traced render and fit equal the untraced ones bit for bit; untraced
calls record nothing; the span tree's parents and jobs hold together; the
render's lane counters equal a recount made by stepping the segments by
hand; the spans appear in a torch.profiler trace on the recorder's clock;
the benchmark's reduction of a profiled job ignores them; the CLI's
--profile writes them beside its trace."""
import json
import os
from collections import Counter

import pytest
import torch

from hobbyraytracer_tpu_torch import tracing
from hobbyraytracer_tpu_torch.cli import main as cli
from hobbyraytracer_tpu_torch.core.rng import Sampler
from hobbyraytracer_tpu_torch.core.types import Rays
from hobbyraytracer_tpu_torch.diff import fit as pfit
from hobbyraytracer_tpu_torch.integrator import wavefront as pwf
from hobbyraytracer_tpu_torch.scene import build_scene, load_scene_desc
from hobbyraytracer_tpu_torch.scene import ir as pir

from _torch_parity import SCENES, TEAPOT

torch.set_num_threads(2)

SHINY = f"{SCENES}/shiny_teapot.yaml"
SEGMENT_PHASES = ("hrt.segment.regenerate", "hrt.segment.find",
                  "hrt.segment.shade", "hrt.segment.retire")
FIT_PHASES = ("hrt.fit.forward", "hrt.fit.backward", "hrt.fit.adam")
# 12x12 @ 3 spp on a 40-lane pool: the retirement cap (64 lanes at least)
# never binds; at 1 spp on a pool of 400 lanes over 20x20 it does
RENDERS = {"small pool": dict(size=12, spp=3, pool=40),
           "cap binds": dict(size=20, spp=1, pool=400)}


@pytest.fixture(autouse=True)
def empty_recorder():
    tracing.RECORDER.drain()
    yield
    tracing.RECORDER.drain()


@pytest.fixture(scope="module")
def teapot():
    job = build_scene(load_scene_desc(TEAPOT))
    return job.scene, job.camera


@pytest.fixture(scope="module")
def shiny():
    job = build_scene(load_scene_desc(SHINY))
    return job.scene, job.camera


def _render(teapot, size=12, spp=3, pool=40, seed=5):
    scene, camera = teapot
    return pwf.render_image(scene, camera, size, size, spp,
                            Sampler(seed, "cpu"), max_depth=8, pool=pool)


def _fit(shiny, steps=2, size=10):
    """A 2-step fit of the perturbed materials back to the scene's own
    render (2 spp, depth 3)."""
    scene, camera = shiny
    sampler = Sampler(4, "cpu")
    with torch.no_grad():
        target = pfit.render_linear(scene, camera, size, size, sampler, 2, 3)
    m = scene.materials
    start = pir.replace(scene, materials=pir.replace(
        m, albedo=torch.clamp(m.albedo * 0.3 + 0.3, 0, 1)))
    return pfit.fit_materials(start, camera, target, size, size,
                              steps=steps, n_samples=2, max_depth=3,
                              sampler=sampler, verbose=False)


def _of(records, kind):
    return [r for r in records if r["type"] == kind]


@pytest.mark.parametrize("case", sorted(RENDERS))
def test_traced_render_equals_untraced(teapot, case):
    off = _render(teapot, **RENDERS[case])
    assert tracing.RECORDER.records() == []
    with tracing.recording() as rec:
        on = _render(teapot, **RENDERS[case])
    assert torch.equal(off, on)
    assert _of(rec.records(), "phase") and _of(rec.records(), "counter")


def test_traced_fit_equals_untraced(shiny):
    off = _fit(shiny)
    assert tracing.RECORDER.records() == []
    with tracing.recording():
        on = _fit(shiny)
    assert list(off.losses) == list(on.losses)
    for f in pfit.MAT_FIELDS:
        assert torch.equal(off.params["materials"][f],
                           on.params["materials"][f])


def test_untraced_calls_record_nothing(teapot, shiny):
    """No profiler and no recording(): renders, fits, segments stepped by
    hand and the phase helpers leave the recorder empty."""
    _render(teapot)
    _fit(shiny, steps=1)
    scene, camera = teapot
    state = pwf.init_state(8, 8, 32, "cpu")
    sampler = Sampler(1, "cpu")
    pwf._regenerate(state, camera, 8, 8, 64, sampler)
    pwf._segment(state, scene, 8, 8, sampler, 8, 1)
    with tracing.phase("segment.find"), tracing.span("block"):
        tracing.set_route("replay")
        tracing.read_phases(1)
    assert tracing.ACTIVE is None
    assert tracing.RECORDER.records() == []


def _check_tree(spans, root_name, child_name, phases):
    """One job: its root holds every span; each span's parent is open
    around it; the children of the root are `child_name` (and the named
    extras), the phases sit inside a child."""
    by_id = {s["id"]: s for s in spans}
    (root,) = [s for s in spans if s["parent"] is None]
    assert root["name"] == root_name and root["job"] == root["id"]
    for s in spans:
        assert s["job"] == root["id"]
        assert s["start_ns"] <= s["end_ns"]
        if s is root:
            continue
        p = by_id[s["parent"]]
        assert p["start_ns"] <= s["start_ns"] and s["end_ns"] <= p["end_ns"]
        if s["name"] in phases:
            assert p["name"] == child_name
        if s["name"] == child_name:
            assert p is root
            assert s["attrs"]["route"] == "eager"
    names = Counter(s["name"] for s in spans)
    assert names[child_name] > 0
    return names


def test_render_span_tree(teapot):
    with tracing.recording() as rec:
        _render(teapot)
    spans = _of(rec.records(), "span")
    names = _check_tree(spans, "hrt.render", "hrt.block", SEGMENT_PHASES)
    blocks = names["hrt.block"]
    assert names["hrt.host_read"] == blocks and names["hrt.film"] == 1
    for p in SEGMENT_PHASES:
        assert names[p] == 8 * blocks
    root = next(s for s in spans if s["name"] == "hrt.render")
    assert root["attrs"] == {"width": 12, "height": 12, "spp": 3, "pool": 40,
                             "cap": 40, "steps": 8, "route": "eager",
                             "graph": "eager"}
    phases = _of(rec.records(), "phase")
    assert Counter(p["name"] for p in phases) == {p: blocks
                                                  for p in SEGMENT_PHASES}
    assert all(p["job"] == root["id"] and p["route"] == "eager"
               and p["units"] == 8 and p["ms"] > 0 for p in phases)


def test_fit_span_tree(shiny):
    with tracing.recording() as rec:
        _fit(shiny, steps=2)
    spans = _of(rec.records(), "span")
    names = _check_tree(spans, "hrt.fit", "hrt.fit.step", FIT_PHASES)
    assert names["hrt.fit.step"] == 2
    assert all(names[p] == 2 for p in FIT_PHASES)
    steps = [s for s in spans if s["name"] == "hrt.fit.step"]
    assert [s["attrs"]["index"] for s in steps] == [0, 1]
    phases = _of(rec.records(), "phase")
    assert Counter(p["name"] for p in phases) == {p: 2 for p in FIT_PHASES}
    counters = {c["name"]: c["value"] for c in _of(rec.records(), "counter")}
    assert counters == {"steps": 2}


def test_jobs_in_one_recording_are_apart(teapot):
    with tracing.recording() as rec:
        _render(teapot, seed=1)
        _render(teapot, seed=2)
    roots = [s for s in _of(rec.records(), "span")
             if s["name"] == "hrt.render"]
    assert len(roots) == 2 and roots[0]["id"] != roots[1]["id"]
    for kind in ("span", "phase", "counter"):
        assert {r["job"] for r in _of(rec.records(), kind)} == {
            r["id"] for r in roots}


@pytest.mark.parametrize("case", sorted(RENDERS))
def test_lane_counters_equal_a_recount(teapot, case):
    """The render's counters against the segments stepped by hand on the
    same state: lanes active at the find, lanes that hit, lanes left
    deferred, rows retired (lanes whose item went back to -1), segments."""
    cfg = RENDERS[case]
    scene, camera = teapot
    size, spp = cfg["size"], cfg["spp"]
    with tracing.recording() as rec:
        _render(teapot, **cfg)
    got = {c["name"]: c["value"] for c in _of(rec.records(), "counter")}

    sampler = Sampler(5, "cpu")
    _, n_chunks, _ = pwf._chunk_geometry(spp, pwf.SAMPLE_CHUNK)
    total = size * size * n_chunks
    state = pwf.init_state(size, size, min(cfg["pool"], total), "cpu")
    want = Counter()
    while int(state.retired) < size * size * spp:
        for _ in range(8):
            pwf._regenerate(state, camera, size, size, total, sampler)
            active = pwf._active(state)
            hits = pir.intersect_scene(scene, Rays(o=state.o, d=state.d),
                                       ray_valid=active, sampler=sampler,
                                       bounce=state.it)
            held = state.item >= 0
            pwf._segment(state, scene, size, size, sampler, 8, spp)
            want["segments"] += 1
            want["lanes.active"] += int(active.sum())
            want["lanes.hit"] += int((active & hits.hit).sum())
            want["lanes.deferred"] += int(state.defer.sum())
            want["rows.retired"] += int((held & (state.item < 0)).sum())
    assert got == dict(want)
    assert want["rows.retired"] == total
    if case == "cap binds":
        assert want["lanes.deferred"] > 0
    else:
        assert want["lanes.deferred"] == 0


def test_spans_are_in_the_profiler_trace(teapot):
    """Under a CPU torch.profiler the render is traced without
    recording(); every span is a kineto range of its name, starting within
    1 ms of the recorder's stamp."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _render(teapot)
    spans = sorted(_of(tracing.RECORDER.records(), "span"),
                   key=lambda s: s["start_ns"])
    events = sorted((e for e in prof.profiler.kineto_results.events()
                     if e.name().startswith("hrt.")),
                    key=lambda e: e.start_ns())
    assert len(spans) == len(events) > 0
    for s, e in zip(spans, events):
        assert e.name() == s["name"]
        assert abs(e.start_ns() - s["start_ns"]) < 1_000_000


class _Event:
    """A kineto record as perfbench/profiling.py:read_trace reads it."""

    def __init__(self, name, device, start, dur, annotation):
        self._v = (name, device, start, dur, annotation)

    def name(self):
        return self._v[0]

    def device_type(self):
        return f"DeviceType.{self._v[1]}"

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def is_user_annotation(self):
        return self._v[4]


class _Prof:
    def __init__(self, events):
        results = type("R", (), {"events": lambda self: events})()
        self.profiler = type("P", (), {"kineto_results": results})()


def test_read_trace_ignores_program_spans(teapot):
    """A profiled job's reduction (busy, idle, by kind and by name) is the
    same with and without the program's hrt.* ranges: the CPU ranges of a
    real profiled render, and a card-side copy of each (a GPU user
    annotation, as CUPTI adds them)."""
    from torch.profiler import ProfilerActivity, profile

    from perfbench import profiling
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("pb.job"):
            _render(teapot)
    real = [e for e in prof.profiler.kineto_results.events()
            if e.name().startswith(("hrt.", "pb."))]
    program = [e for e in real if e.name().startswith("hrt.")]
    assert program
    job = next(e for e in real if e.name() == "pb.job")
    t0, t1 = job.start_ns(), job.start_ns() + job.duration_ns()
    step = (t1 - t0) // 40
    device = [_Event(f"kernel_{i % 3}", "CUDA", t0 + i * step, step // 2,
                     False) for i in range(1, 39)]
    mirrors = [_Event(e.name(), "CUDA", e.start_ns() + 5_000,
                      e.duration_ns(), True) for e in program]
    base = [job] + device
    a = profiling.read_trace(_Prof(base), {}, 1)
    b = profiling.read_trace(_Prof(base + program + mirrors), {}, 1)
    assert a == b
    assert a.busy_s > 0 and a.idle_by_span


def test_cli_profile_writes_the_spans(tmp_path):
    """The CLI's --profile DIR writes the chrome trace and
    spans_rank0.jsonl, one record a line, the render's spans among them."""
    out = tmp_path / "c.png"
    rc = cli.main(["render", f"{SCENES}/cornell_box.yaml", "-o", str(out),
                   "--spp", "2", "--width", "8", "--height", "8",
                   "--device", "cpu", "--profile", str(tmp_path / "prof")])
    assert rc == 0
    trace = json.loads((tmp_path / "prof" / "render_rank0.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"hrt.render", "hrt.block", "hrt.segment.find"} <= names
    lines = (tmp_path / "prof" / "spans_rank0.jsonl").read_text().splitlines()
    records = [json.loads(ln) for ln in lines]
    assert {r["type"] for r in records} == {"span", "phase", "counter"}
    assert "hrt.render" in {r.get("name") for r in records}
    assert tracing.RECORDER.records() == []
    assert os.path.exists(out)


def test_write_jsonl_round_trip(tmp_path, teapot):
    with tracing.recording() as rec:
        _render(teapot)
    records = rec.drain()
    assert rec.records() == []
    path = tmp_path / "spans.jsonl"
    tracing.write_jsonl(str(path), records)
    back = [json.loads(ln) for ln in path.read_text().splitlines()]
    assert back == records
