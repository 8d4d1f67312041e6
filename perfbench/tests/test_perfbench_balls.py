"""The scattered_balls configuration on the CPU at a tiny film: its own
reference (reference_scattered_balls) reads the program bit for bit, its
bfloat16 control and each planted render fault read not correct; the
sphere find's count (sphere_counts.py) and the readers of the sphere
find's records, fed a hand-built recorder."""
import builtins
import dataclasses
import dis
import os
import time
import types

import pytest
import torch

from perfbench import (counts, faults, harness, jobs, manifest,
                       program_trace, sphere_counts)

CELL = "scattered_balls.final1200"
TINY = dict(width=32, height=18, spp=2, pool=512)
NEW = ("segment_phase_ms.find_spheres", "sphere_find_roofline",
       "sphere_hit_lanes")
PEAKS = {"bytes_per_s": 3.35e12, "f32_flops_per_s": 67e12}


def tiny_cell():
    cell = manifest.load_cell(CELL)
    return dataclasses.replace(cell, traffic={**cell.traffic, **TINY})


def run(cell, program_cls=None, seed=2 ** 31 + 7):
    return harness.run_cell(cell, seed, 0.5, False, "cpu",
                            time.perf_counter(), program_cls)


def as_program(dtype):
    """The reference in `dtype` put in the program's place."""
    cls = jobs.kind(tiny_cell())

    class Reference(cls):
        def run(self, j):
            return cls.as_output(self.reference(j, dtype))

    return Reference


def test_the_cell_is_checked_by_its_own_reference():
    cell = tiny_cell()
    assert jobs.kind(cell) is jobs.RenderJobs
    ref = manifest.reference(cell)
    assert ref.__name__.endswith("reference_scattered_balls")
    assert {"scene", "trace", "render"} <= set(vars(ref))


def test_the_rebuilt_step_is_the_shared_one_over_this_trace():
    """The balls' Pool runs the shared iteration's code over its own
    globals: that holds only while the code has no closure and every global
    it loads is the shared module's, `tr` alone swapped for this trace."""
    from perfbench.reference import render as shared
    from perfbench.reference_scattered_balls import render as balls

    step = balls._shared_step
    assert step.__code__ is shared.Pool.step.__code__
    codes = [step.__code__]
    for code in codes:
        assert not code.co_freevars and not code.co_cellvars, code.co_name
        codes += [c for c in code.co_consts if isinstance(c, type(code))]
    loaded = {i.argval for code in codes for i in dis.get_instructions(code)
              if i.opname == "LOAD_GLOBAL"}
    assert "tr" in loaded and step.__globals__["tr"] is balls.trace
    for name in loaded - {"tr"}:
        if name in vars(shared):
            assert step.__globals__[name] is vars(shared)[name], name
        else:
            assert hasattr(builtins, name), name


def test_program_reads_as_the_reference_bit_for_bit():
    result = run(tiny_cell())
    assert result["correct"]
    assert result["checks"]["pixels_off_pct"]["value"] == 0.0
    assert result["checked_by"]["reference"] == os.path.join(
        "perfbench", "reference_scattered_balls")
    assert result["checked_by"]["kind"] == "render"


def test_reference_on_both_sides_is_correct():
    assert run(tiny_cell(), as_program(torch.float32))["correct"]


def test_bfloat16_control_is_not_correct():
    result = run(tiny_cell(), as_program(torch.bfloat16))
    assert not result["correct"]
    assert result["checks"]["pixels_off_pct"]["value"] > 10.0


@pytest.mark.parametrize("fault", ["half_the_samples", "answer_altered",
                                   "framebuffer_unchanged"])
def test_render_fault_is_not_correct(fault):
    cell = tiny_cell()
    assert not run(cell, faults.broken(cell, fault))["correct"]


def test_sphere_find_bytes_are_k1_s_for_the_same_rays():
    n_bytes, n_ops = sphere_counts.sphere_find_work(10, 1000)
    assert n_bytes == counts.k1_work(10, 1000)[0] == 10 * 1000 * 68
    assert n_ops == 10 * 1000 * sphere_counts.OPS_PER_RAY
    assert counts.least_time(n_bytes, n_ops, PEAKS)[1] == "bytes"


class Rec:
    """A recorder as the program keeps one."""

    def __init__(self):
        self.spans, self.phases, self.counters = [], [], []

    def render(self, pool=196608, replays=((8, 96.0), (8, 104.0)),
               find=(8, 110.0), counted=None, **attrs):
        j = len(self.spans) + 1
        self.spans.append({"type": "span", "name": "hrt.render", "id": j,
                           "parent": None, "job": j, "start_ns": 0,
                           "end_ns": 1, "attrs": {"pool": pool, **attrs}})
        for route, (units, ms) in [("capture", (8, 500.0))] + [
                ("replay", r) for r in replays]:
            self.phases.append({"type": "phase", "job": j, "route": route,
                                "name": "hrt.segment.find.spheres",
                                "ms": ms, "units": units})
        self.phases.append({"type": "phase", "job": j, "route": "replay",
                            "name": "hrt.segment.find", "ms": find[1],
                            "units": find[0]})
        for name, value in (counted or {}).items():
            self.counters.append({"type": "counter", "job": j,
                                  "name": name, "value": value})
        return j


def run_of(job):
    cell = manifest.Cell("x", 1, {}, {"job": job}, {}, [], [], "")
    return harness.Run(cell, 1.0, 2.0, [1.0], [1], peaks=PEAKS)


def test_the_sphere_find_phase_and_its_roofline():
    rec = Rec()
    rec.render()
    got, note = manifest.reader("segment_phase_ms.find_spheres")(
        run_of("render"), rec)
    assert got == pytest.approx(200.0 / 16)         # replays only
    assert "16 replayed segments" in note
    share, note = manifest.reader("sphere_find_roofline")(run_of("render"),
                                                          rec)
    least = 16 * 196608 * 68 / 3.35e12
    assert share == pytest.approx(100.0 * least / 0.2)
    assert "bound by bytes" in note and f"{16 * 196608 * 68} B" in note
    rec.render(pool=1000)               # the rays of a segment are unknown
    assert manifest.reader("sphere_find_roofline")(run_of("render"),
                                                   rec) is None


def test_sphere_hit_lanes_and_the_dielectric_share():
    rec = Rec()
    rec.render(counted={"lanes.active": 1000, "lanes.sphere_hit": 600,
                        "lanes.dielectric": 50}, sphere_route="dense")
    rec.render(counted={"lanes.active": 3000, "lanes.sphere_hit": 1400},
               sphere_route="dense")
    got, note = manifest.reader("sphere_hit_lanes")(run_of("render"), rec)
    assert got == pytest.approx(50.0)
    assert "dielectric 1.2500%" in note and "route dense" in note


def test_nothing_is_read_without_the_sphere_records(monkeypatch):
    teapot = Rec()
    j = teapot.render(counted={"lanes.active": 10, "lanes.hit": 5})
    teapot.phases = [p for p in teapot.phases
                     if p["name"] != "hrt.segment.find.spheres"]
    assert j
    for rec in (Rec(), teapot,
                types.SimpleNamespace(spans=[], phases=[], counters=[])):
        for name in NEW:
            for job in ("render", "fit"):
                assert manifest.reader(name)(run_of(job), rec) is None
    # a program without tracing.py: nothing read, nothing raised
    monkeypatch.setattr(program_trace, "recorder", lambda: None)
    for name in NEW:
        assert manifest.reader(name)(run_of("render")) is None


def test_the_manifest_lists_the_cell_s_metrics():
    m = manifest.load_json(os.path.join(manifest.ROOT, "BENCHMARK.json"))
    per_layer = {x["name"]: x for x in m["per_layer"]}
    for name in NEW:
        x = per_layer[name]
        assert x["workloads"] == [CELL] and x["moves"] == "rays_per_s"
    listed = {x["name"] for x in m["per_layer"] + m["end_to_end"]
              if CELL in x.get("workloads", [CELL])}
    assert "k1_roofline" not in listed
    assert {"rays_per_s", "setup_s", "segment_phase_ms.find",
            "lane_occupancy", *NEW} <= listed

