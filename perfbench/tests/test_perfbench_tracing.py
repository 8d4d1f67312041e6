"""The readers of the program's own record (program_trace.py and the
metrics of source program_span that use it), fed a hand-built recorder:
their arithmetic, the jobs and routes they keep, and nothing read where
the record is empty or the program has none."""
import json
import os
import types

import pytest

from perfbench import harness, manifest, program_trace

NEW = ["segment_phase_ms.regenerate", "segment_phase_ms.find",
       "segment_phase_ms.shade", "segment_phase_ms.retire",
       "fit_phase_ms.forward", "fit_phase_ms.backward", "fit_phase_ms.adam",
       "kernel_nodes.segment", "kernel_nodes.step", "lane_occupancy",
       "lane_occupancy.short", "deferred_lanes",
       "graph_instantiate_ms.short", "graph_instantiate_ms.fit"]


def run_of(job):
    cell = manifest.Cell("x", 1, {}, {"job": job}, {}, [], [], "")
    return harness.Run(cell, 1.0, 2.0, [1.0], [1])


class Rec:
    """A recorder as the program keeps one."""

    def __init__(self):
        self.spans, self.phases, self.counters = [], [], []
        self._id = 0

    def span(self, name, job=None, parent=None, ms=1.0, **attrs):
        self._id += 1
        sid = self._id
        self.spans.append({"type": "span", "name": name, "id": sid,
                           "parent": parent, "job": job or sid,
                           "start_ns": 1000, "end_ns": 1000 + int(ms * 1e6),
                           "attrs": attrs})
        return sid

    def phase(self, job, name, route, ms, units):
        self.phases.append({"type": "phase", "job": job, "name": name,
                            "route": route, "ms": ms, "units": units})

    def counter(self, job, name, value):
        self.counters.append({"type": "counter", "job": job, "name": name,
                              "value": value})


def render(rec, pool=100, cap=10, steps=8, segments=40, active=(2000,),
           hit=1000, deferred=400, rows=300, kernels=5200, instantiate=12.0):
    j = rec.span("hrt.render", width=8, height=8, spp=1, pool=pool, cap=cap,
                 steps=steps)
    b = rec.span("hrt.block", job=j, parent=j, route="replay")
    rec.span("hrt.graph.instantiate", job=j, parent=b, ms=instantiate)
    for route, ms in (("eager", 100.0), ("capture", 50.0), ("replay", 8.0),
                      ("replay", 12.0)):
        for k, name in enumerate(("regenerate", "find", "shade",
                                  "retire")):
            rec.phase(j, "hrt.segment." + name, route, ms * (k + 1), 8)
    for name, value in (("segments", segments), ("graph.kernel", kernels),
                        ("graph.memcpy", 80), ("graph.memset", 8),
                        ("graph.event_record", 64), ("graph.other", 0),
                        ("lanes.active", sum(active)), ("lanes.hit", hit),
                        ("lanes.deferred", deferred),
                        ("rows.retired", rows)):
        rec.counter(j, name, value)
    return j


def fit(rec, kernels=9000, instantiate=300.0):
    j = rec.span("hrt.fit", width=8, height=8, spp=4, steps=3)
    rec.span("hrt.graph.instantiate", job=j, parent=j, ms=instantiate)
    for route, ms in (("eager", 900.0), ("capture", 90.0), ("replay", 3.0),
                      ("replay", 5.0)):
        for k, name in enumerate(("forward", "backward", "adam")):
            rec.phase(j, "hrt.fit." + name, route, ms * (k + 1), 1)
    rec.counter(j, "steps", 3)
    rec.counter(j, "graph.kernel", kernels)
    rec.counter(j, "graph.event_record", 6)
    return j


def read(name, run, rec):
    got = manifest.reader(name)(run, rec)
    return got[0] if isinstance(got, tuple) else got


def test_segment_and_fit_phases_average_the_replays():
    rec = Rec()
    render(rec)
    fit(rec)
    r, f = run_of("render"), run_of("fit")
    # replays of 8 segments: (8 + 12) * (k + 1) ms over 16 segments
    for k, name in enumerate(("regenerate", "find", "shade", "retire")):
        got, note = manifest.reader("segment_phase_ms." + name)(r, rec)
        assert got == pytest.approx(20.0 * (k + 1) / 16)
        assert "16 replayed segments" in note
        assert read("segment_phase_ms." + name, f, rec) is None
    for k, name in enumerate(("forward", "backward", "adam")):
        assert read("fit_phase_ms." + name, f, rec) == pytest.approx(
            8.0 * (k + 1) / 2)
        assert read("fit_phase_ms." + name, r, rec) is None


def test_phases_of_two_jobs_pool_their_units():
    rec = Rec()
    render(rec)
    j = rec.span("hrt.render", pool=100, cap=10, steps=4)
    rec.phase(j, "hrt.segment.find", "replay", 40.0, 4)
    # (8 * 2 + 12 * 2 + 40) ms over 8 + 8 + 4 segments
    assert read("segment_phase_ms.find", run_of("render"), rec) == (
        pytest.approx(80.0 / 20))


def test_kernel_nodes_a_segment_and_a_step():
    rec = Rec()
    render(rec, steps=8, kernels=5200)
    render(rec, steps=4, kernels=2400)
    fit(rec, kernels=9000)
    fit(rec, kernels=9100)
    got, note = manifest.reader("kernel_nodes.segment")(run_of("render"),
                                                        rec)
    assert got == pytest.approx((650 + 600) / 2)
    assert "memcpy 15," in note and "event_record 12" in note
    assert read("kernel_nodes.step", run_of("fit"), rec) == 9050
    assert read("kernel_nodes.step", run_of("render"), rec) is None


def test_lane_occupancy_deferred_and_cap_fill():
    rec = Rec()
    render(rec, pool=100, cap=10, segments=40, active=(2000,), hit=1000,
           deferred=400, rows=300)
    render(rec, pool=50, cap=5, segments=20, active=(500,), hit=100,
           deferred=0, rows=100)
    r = run_of("render")
    lanes = 100 * 40 + 50 * 20
    occ, note = manifest.reader("lane_occupancy")(r, rec)
    assert occ == pytest.approx(100.0 * 2500 / lanes)
    assert "hit share 44.0000%" in note and "60 segments" in note
    assert read("lane_occupancy.short", r, rec) == occ
    deferred, note = manifest.reader("deferred_lanes")(r, rec)
    assert deferred == pytest.approx(100.0 * 400 / lanes)
    fill = 100.0 * 400 / (10 * 40 + 5 * 20)
    assert f"cap fill {fill:.4f}%" in note
    assert read("lane_occupancy", run_of("fit"), rec) is None


def test_graph_instantiate_host_ms_a_job():
    rec = Rec()
    render(rec, instantiate=12.0)
    render(rec, instantiate=18.0)
    fit(rec, instantiate=300.0)
    assert read("graph_instantiate_ms.short", run_of("render"), rec) == (
        pytest.approx(15.0))
    assert read("graph_instantiate_ms.fit", run_of("fit"), rec) == (
        pytest.approx(300.0))
    assert read("graph_instantiate_ms.fit", run_of("render"), rec) is None


def test_nothing_is_read_from_an_empty_record_or_no_program(monkeypatch):
    empty = Rec()
    for name in NEW:
        for job in ("render", "fit"):
            assert read(name, run_of(job), empty) is None, name
    # a program without tracing.py: the readers give nothing, raise nothing
    monkeypatch.setattr(program_trace, "recorder", lambda: None)
    for name in NEW:
        for job in ("render", "fit"):
            assert manifest.reader(name)(run_of(job)) is None, name


def test_spans_outside_a_job_and_other_routes_are_left_out():
    rec = Rec()
    rec.span("hrt.graph.instantiate", ms=50.0)     # no job (batch graphs)
    j = render(rec)
    rec.phase(j + 100, "hrt.segment.find", "replay", 1e6, 1)  # no such job
    assert read("graph_instantiate_ms.short", run_of("render"), rec) == (
        pytest.approx(12.0))
    assert read("segment_phase_ms.find", run_of("render"), rec) == (
        pytest.approx(40.0 / 16))


def test_the_manifest_lists_each_new_metric_with_its_cells():
    m = manifest.load_json(os.path.join(manifest.ROOT, "BENCHMARK.json"))
    per_layer = {x["name"]: x for x in m["per_layer"]}
    for name in NEW:
        x = per_layer[name]
        assert x["source"] == "program_span" and x["workloads"], name
    assert [x["name"] for x in m["per_layer"]][-len(NEW):] == NEW


def test_the_program_s_recorder_is_found():
    rec = program_trace.recorder()
    assert rec is not None
    assert isinstance(rec.spans, list) and json.dumps(rec.records()) == "[]"


def test_reader_accepts_any_record_object():
    rec = types.SimpleNamespace(spans=[], phases=[], counters=[])
    assert read("lane_occupancy", run_of("render"), rec) is None
