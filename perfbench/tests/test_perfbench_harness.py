"""The harness's arithmetic and layout on the CPU: the reduction of a
profiler window, the metric readers, K1's counts, the manifest's names,
data, references and job kinds found by name, and the modules a run may
not load."""
import dataclasses
import glob
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from dataclasses import dataclass

import pytest

from perfbench import counts, faults, harness, jobs, manifest, profiling

HERE = manifest.HERE


@dataclass
class FakeEvent:
    _name: str
    _device: str
    _start: int
    _dur: int
    _kind: str

    def name(self):
        return self._name

    def device_type(self):
        return f"DeviceType.{self._device}"

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._dur

    def is_user_annotation(self):
        return self._kind in ("user_annotation", "gpu_user_annotation")


class FakeProf:
    def __init__(self, events):
        results = type("R", (), {"events": lambda self: events})()
        self.profiler = type("P", (), {"kineto_results": results})()


def span(kind, start, end):
    return FakeEvent("pb." + kind, "CPU", start, end - start,
                     "user_annotation")


def kernel(name, start, end):
    return FakeEvent(name, "CUDA", start, end - start, "kernel")


def test_trace_busy_union_spans_and_gaps():
    events = [
        span("job", 0, 1000),
        span("eager", 10, 200), span("replay", 300, 320),
        span("host_read", 320, 600),
        kernel("a", 50, 150), kernel("b", 100, 180),      # overlap: 130 busy
        kernel("c", 400, 500), kernel("c", 500, 550),     # 150 busy
        FakeEvent("pb.replay", "CUDA", 300, 300, "gpu_user_annotation"),
    ]
    t = profiling.read_trace(FakeProf(events), {"k": 3}, 8)
    assert t.window_s == pytest.approx(1000e-9)
    assert t.busy_s == pytest.approx(280e-9)
    assert t.by_name["c"] == pytest.approx(150e-9)
    assert t.busy_by_span == pytest.approx({"eager": 130e-9,
                                            "replay": 150e-9})
    # gaps: 0-50 (eager holds 25), 180-400 (mid 290: job), 550-1000
    # (mid 775: job)
    assert t.idle_by_span == pytest.approx({"eager": 50e-9,
                                            "job": 670e-9})
    assert t.launches == {"k": 3} and t.units == 8


def test_trace_needs_one_job_span():
    with pytest.raises(RuntimeError):
        profiling.read_trace(FakeProf([kernel("a", 0, 1)]), {}, 0)


def fake_run(job, walls, work, **kw):
    cell = manifest.Cell("x", 1, {}, {"job": job}, {}, [], [], "")
    return harness.Run(cell, 7.5, sum(walls) + 0.25, walls, work, **kw)


def test_end_to_end_readers():
    walls = [0.5] * 9 + [1.5]
    r = fake_run("render", walls, [1000] * 10)
    assert manifest.reader("rays_per_s")(r) == pytest.approx(10000 / 6.25)
    assert manifest.reader("render_s_p90")(r) == 0.5        # rank 9 of 10
    assert manifest.reader("render_s_p90")(
        fake_run("render", walls + [2.0], [1] * 11)) == 1.5  # rank 10 of 11
    assert manifest.reader("setup_s")(r) == 7.5
    assert manifest.reader("fit_step_ms")(r) is None
    f = fake_run("fit", [4.0, 4.0], [30, 30])
    assert manifest.reader("fit_step_ms")(f) == pytest.approx(
        1e3 * 8.25 / 60)
    assert manifest.reader("rays_per_s")(f) is None
    assert manifest.reader("rays_per_s.short")(r) == manifest.reader(
        "rays_per_s")(r)


def test_layer_readers():
    trace = profiling.DeviceTrace(
        window_s=2.0, busy_s=1.5,
        by_name={"void hrt::traverse_kernel<24>": 0.01, "x": 1.0},
        busy_by_span={"replay": 1.2, "eager": 0.2}, idle_by_span={},
        launches={"mesh_traverse": 100}, units=800)
    spans = [profiling.JobSpans({"capture_record": 0.1, "eager": 0.05}),
             profiling.JobSpans({"capture_record": 0.2, "eager": 0.05})]
    peaks = {"bytes_per_s": 3.35e12, "f32_flops_per_s": 67e12}
    r = fake_run("render", [1.0], [1], spans=spans, traces=[trace],
                 lanes={196608}, peaks=peaks)
    assert manifest.reader("device_idle_share.render")(r) == pytest.approx(
        25.0)
    assert manifest.reader("device_idle_share.fit")(r) is None
    assert manifest.reader("capture_ms.render")(r) == pytest.approx(200.0)
    assert manifest.reader("segment_busy_ms")(r) == pytest.approx(1.5)
    for name in ("device_idle_share.render", "capture_ms.render",
                 "segment_busy_ms", "k1_roofline"):
        short = name.split(".")[0] + ".short"
        assert manifest.reader(short)(r) == manifest.reader(name)(r)
    share, note = manifest.reader("k1_roofline")(r)
    least = 100 * 196608 * 68 / 3.35e12
    assert share == pytest.approx(100 * least / 0.01)
    assert "bytes" in note
    assert manifest.reader("k1_roofline")(
        fake_run("render", [1.0], [1], traces=[trace], lanes={1, 2},
                 peaks=peaks)) is None            # rays a launch unknown


def test_k1_counts():
    n_bytes, n_ops = counts.k1_work(10, 1000)
    assert (n_bytes, n_ops) == (10 * 1000 * 68, 10 * 1000 * 63)
    peaks = {"bytes_per_s": 2.0, "f32_flops_per_s": 1.0}
    assert counts.least_time(4.0, 1.0, peaks) == (2.0, "bytes")
    assert counts.least_time(1.0, 4.0, peaks) == (4.0, "operations")


def test_manifest_names_units_and_files():
    m = manifest.load_json(os.path.join(manifest.ROOT, "BENCHMARK.json"))
    metrics = m["end_to_end"] + m["per_layer"]
    names = ([c["name"] for c in m["configs"]]
             + [w["name"] for w in m["workloads"]]
             + [x["name"] for x in metrics]
             + [w["config"] for w in m["workloads"]]
             + [w["traffic"] for w in m["workloads"]]
             + [k for c in m["configs"] for k in c["reduced"]])
    for name in names:
        assert manifest.NAME.fullmatch(name), name
    for x in metrics:
        assert manifest.UNIT.fullmatch(x["unit"]), x["unit"]
        assert x["better"] in ("lower", "higher")
        assert os.path.exists(os.path.join(HERE, "metrics",
                                           x["name"] + ".py"))
    for text in ([c["why"] for c in m["configs"]]
                 + [w["why"] for w in m["workloads"]]
                 + [c["source"] for c in m["configs"]]
                 + [x["layer"] for x in m["per_layer"]] + m["command"]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    for w in m["workloads"]:
        cell = manifest.load_cell(w["name"])
        manifest.verify_inputs(cell)
        assert set(cell.limits)
    assert len(json.dumps(m)) < 64 * 1024


def test_each_layer_metric_moves_a_metric_its_cells_report():
    m = manifest.load_json(os.path.join(manifest.ROOT, "BENCHMARK.json"))
    cells = [w["name"] for w in m["workloads"]]

    def reported(metric):
        return set(metric.get("workloads", cells))

    e2e = {x["name"]: reported(x) for x in m["end_to_end"]}
    for x in m["per_layer"]:
        assert x["moves"] in e2e, x["name"]
        assert reported(x) <= e2e[x["moves"]], x["name"]
    for cell in cells:
        assert cell in e2e["setup_s"]
        assert any(cell in r for n, r in e2e.items() if n != "setup_s")
        assert any(cell in reported(x) for x in m["per_layer"])


def copy_bench(tmp_path):
    """The manifest and a copy of the benchmark's folder in tmp_path, for a
    later change's files and entries."""
    bench = tmp_path / "perfbench"
    shutil.copytree(HERE, bench, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    return manifest.load_json(os.path.join(manifest.ROOT,
                                           "BENCHMARK.json")), bench


def add_cell(m, bench, config: dict, traffic: str, mix: dict, limits: dict):
    """A configuration (`config`, written as configs/<name>.json), a mix
    and their cell, as files and manifest entries -> the cell's name."""
    name = f"{config['name']}.{traffic}"
    (bench / "configs" / f"{config['name']}.json").write_text(
        json.dumps(config))
    (bench / "traffic" / f"{traffic}.json").write_text(json.dumps(mix))
    (bench / "cells" / f"{name}.json").write_text(json.dumps(
        {"limits": limits}))
    m["configs"].append({"name": config["name"], "source": "x",
                         "file": f"perfbench/configs/{config['name']}.json",
                         "reduced": [], "why": "x"})
    m["workloads"].append({"name": name, "config": config["name"],
                           "traffic": traffic, "chips": 1, "why": "x"})
    return name


def teapot_config(bench, **changes) -> dict:
    return {**json.loads((bench / "configs" / "teapot.json").read_text()),
            **changes}


def test_a_new_config_mix_metric_and_cell_are_found_by_name(tmp_path):
    """A later change adds files and manifest entries only."""
    m, bench = copy_bench(tmp_path)
    add_cell(m, bench, teapot_config(bench, name="teapot_copy"), "tiny",
             {"job": "render", "width": 8, "height": 8, "spp": 1,
              "max_depth": 4, "pool": 64, "rr": True, "profile_jobs": 1,
              "check_jobs": 1}, {"pixels_off_pct": 0.1})
    (bench / "metrics" / "jobs_done.py").write_text(
        "def read(run):\n    return len(run.walls)\n")
    m["per_layer"].append({"name": "jobs_done", "unit": "jobs",
                           "better": "higher", "source": "host_clock",
                           "layer": "render loop", "moves": "rays_per_s",
                           "workloads": ["teapot_copy.tiny"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    cell = manifest.load_cell("teapot_copy.tiny", str(tmp_path), str(bench))
    assert cell.config["name"] == "teapot_copy"
    assert cell.traffic["width"] == 8
    assert [x["name"] for x in cell.per_layer][-1] == "jobs_done"
    read = manifest.reader("jobs_done", str(bench))
    assert read(harness.Run(cell, 0.0, 1.0, [0.5, 0.5], [1, 1])) == 2


KIND_FILE = '''"""Renders as a job kind of its own, with a fault of its own."""
from perfbench import faults, jobs


class JOBS(jobs.RenderJobs):
    kind = "render_copy"


def _corner_altered(p, j):
    img = JOBS.run(p, j).clone()
    img[:2, :2] += 0.05
    return img


FAULTS = {"corner_altered": _corner_altered,
          "half_the_samples": faults.FAULTS["render"]["half_the_samples"]}
'''


@pytest.fixture
def own_cell(tmp_path):
    """A cell whose configuration names its own reference package (a copy
    of the shared one) and whose mix names its own job kind, a file: both
    new files and manifest entries only."""
    m, bench = copy_bench(tmp_path)
    shutil.copytree(bench / "reference", bench / "reference_copy")
    (bench / "kinds").mkdir()
    (bench / "kinds" / "render_copy.py").write_text(KIND_FILE)
    name = add_cell(
        m, bench, teapot_config(bench, name="teapot_own",
                                reference="reference_copy"), "tiny_own",
        {"job": "render_copy", "width": 24, "height": 20, "spp": 4,
         "max_depth": 50, "pool": 512, "rr": True, "profile_jobs": 1,
         "check_jobs": 1}, {"pixels_off_pct": 0.01})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    return manifest.load_cell(name, str(tmp_path), str(bench))


def run_tiny(cell, program_cls=None):
    return harness.run_cell(cell, 2 ** 31 + 7, 0.5, False, "cpu",
                            time.perf_counter(), program_cls)


def test_a_config_s_own_reference_and_a_mix_s_own_kind_run(own_cell,
                                                            capsys):
    folder = os.path.join(own_cell.bench, "reference_copy")
    ref = manifest.reference(own_cell)
    for module in (ref, ref.scene, ref.trace, ref.render, ref.fit):
        assert os.path.dirname(module.__file__) == folder
    cls = jobs.kind(own_cell)
    assert cls.kind == "render_copy" and issubclass(cls, jobs.RenderJobs)
    assert cls is not jobs.RenderJobs
    result = run_tiny(own_cell)
    assert result["correct"], result["checks"]
    assert [c["value"] for c in result["checks"].values()] == [0.0]
    assert result["checked_by"]["reference"].endswith("reference_copy")
    assert result["checked_by"]["kind"] == "render_copy"
    assert list(result)[-1] == "checks"
    err = capsys.readouterr().err
    assert "reference_copy" in err and "job kind render_copy" in err


@pytest.mark.parametrize("fault", ["corner_altered", "half_the_samples"])
def test_a_kind_file_s_own_faults_are_not_correct(own_cell, fault):
    assert set(faults.planted(own_cell)) == {"corner_altered",
                                             "half_the_samples"}
    assert not run_tiny(own_cell, faults.broken(own_cell, fault))["correct"]


CELLS = ("teapot.final640", "shiny_teapot.fit", "teapot.film256",
         "shiny_teapot.film1080")


@pytest.mark.parametrize("name", CELLS)
def test_the_cells_resolve_to_the_built_in_kinds_and_shared_reference(name):
    import perfbench.reference as shared
    from perfbench.reference import fit, render, scene, trace
    cell = manifest.load_cell(name)
    job = cell.traffic["job"]
    assert jobs.kind(cell) is {"render": jobs.RenderJobs,
                               "fit": jobs.FitJobs}[job]
    assert faults.planted(cell) is faults.FAULTS[job]
    ref = manifest.reference(cell)
    assert ref is shared
    assert (ref.scene, ref.trace, ref.render, ref.fit) == (scene, trace,
                                                           render, fit)


def _no_set_up(monkeypatch):
    def built(*args, **kwargs):
        raise AssertionError("set-up started")
    monkeypatch.setattr(jobs.RenderJobs, "__init__", built)


@pytest.mark.parametrize("name, says", [
    ("../x", "not a valid name"), ("scene", "starts with 'reference'"),
    ("reference.x", "without '.'"), ("reference_none", "no package")])
def test_a_refused_reference_raises_before_set_up(monkeypatch, name, says):
    _no_set_up(monkeypatch)
    cell = manifest.load_cell("teapot.film256")
    cell = dataclasses.replace(cell, config={**cell.config,
                                             "reference": name})
    with pytest.raises(ValueError, match=re.escape(says)):
        run_tiny(cell)


@pytest.mark.parametrize("text, says", [
    (None, "has no file"),
    ("FAULTS = {'x': print}\n", "no class JOBS"),
    ("from perfbench import jobs\nJOBS = jobs.RenderJobs\n", "no FAULTS"),
    ("from perfbench import jobs\nJOBS = jobs.RenderJobs\nFAULTS = {}\n",
     "no FAULTS")])
def test_a_refused_kind_file_raises_before_set_up(tmp_path, monkeypatch,
                                                  text, says):
    _no_set_up(monkeypatch)
    (tmp_path / "kinds").mkdir()
    if text is not None:
        (tmp_path / "kinds" / "bad.py").write_text(text)
    cell = manifest.load_cell("teapot.film256")
    cell = dataclasses.replace(cell, traffic={**cell.traffic, "job": "bad"},
                               bench=str(tmp_path))
    with pytest.raises(ValueError, match=re.escape(says)):
        run_tiny(cell)
    with pytest.raises(ValueError, match=re.escape(says)):
        faults.planted(cell)


def test_importing_the_benchmark_loads_no_jax():
    code = (
        "import glob, importlib, importlib.util, os, sys\n"
        f"sys.path.insert(0, {manifest.ROOT!r})\n"
        "import perfbench.run\n"
        "for mod in ('harness', 'jobs', 'manifest', 'profiling', 'counts',"
        " 'calibrate', 'reference.rng', 'reference.scene',"
        " 'reference.trace', 'reference.render', 'reference.fit'):\n"
        "    importlib.import_module('perfbench.' + mod)\n"
        "from perfbench import manifest\n"
        f"for f in glob.glob(os.path.join({HERE!r}, 'metrics', '*.py')):\n"
        "    manifest.reader(os.path.basename(f)[:-3])\n"
        f"for f in glob.glob(os.path.join({HERE!r}, 'reference*',"
        " '__init__.py')):\n"
        "    manifest.reference_package("
        "os.path.basename(os.path.dirname(f)))\n"
        f"for f in glob.glob(os.path.join({HERE!r}, 'kinds', '*.py')):\n"
        "    manifest.kind(os.path.basename(f)[:-3])\n"
        "bad = {m.split('.')[0] for m in sys.modules} & "
        "{'jax', 'jaxlib', 'flax', 'hobbyraytracer_tpu'}\n"
        "print(sorted(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_reference_imports_nothing_of_the_program():
    """Nor anything of JAX: every reference package of the benchmark."""
    files = glob.glob(os.path.join(HERE, "reference*", "**", "*.py"),
                      recursive=True)
    assert os.path.join(HERE, "reference", "scene.py") in files
    jax = re.compile(r"^\s*(from|import)\s+(jax|jaxlib|flax)\b", re.M)
    for f in files:
        text = open(f).read()
        assert "hobbyraytracer_tpu" not in text, f
        assert not jax.search(text), f


def test_run_refuses_without_a_card(monkeypatch):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is here")
    assert harness.main(["--workload", "teapot.final640", "--seed", "1",
                         "--seconds", "1"]) == 3


def test_the_check_writes_no_infinity():
    assert harness._finite(math.inf) == 1e300
    assert harness._finite(math.nan) == 1e300
    assert harness._finite(0.5) == 0.5
