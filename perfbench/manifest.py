"""The benchmark's data, found by name: the manifest (BENCHMARK.json at the
checkout's root), and for one cell its configuration (`configs/<name>.json`,
its scene files checked by sha256), its traffic mix
(`traffic/<name>.json`), its limits (`cells/<cell>.json`), the readers of
its metrics (`metrics/<metric>.py`), the plain reference that checks it
and the kind of job its mix runs. A new cell, mix, configuration or metric
is new files and manifest entries; nothing here changes:

- a configuration whose scene the shared reference (`reference/`) cannot
  read brings its own package `<package>/` (a name that starts with
  `reference`, without a `.`) and names it in its file,
  `"reference": "<package>"`. The package holds the modules that its job
  kinds read (`scene`, `trace`, `render`, `fit` for the built-in ones); it
  may import `perfbench.reference.*` and imports nothing of the program or
  of JAX;
- a mix whose `"job"` is not one of the built-in kinds (`jobs.KINDS`)
  names a file `kinds/<job>.py`, which defines `JOBS`, a class with the
  interface of `jobs.RenderJobs`, and `FAULTS`, its planted faults (name
  -> fn(program, j) -> the output of job j with the fault in it; one at
  least). The metric readers see the job's name as `run.job`.
"""
from __future__ import annotations

import hashlib
import importlib.util
import json
import os
import re
import sys
from dataclasses import dataclass

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def check_name(name: str) -> str:
    """A name of the manifest: at most 64 letters, digits, `_`, `.`, `-`,
    not starting with `.` or `-`."""
    if not isinstance(name, str) or not NAME.fullmatch(name):
        raise ValueError(f"not a valid name: {name!r}")
    return name


def sha256(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


@dataclass
class Cell:
    """One workload: its names and the data files that define it."""
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list
    base: str
    bench: str = HERE      # the folder its configuration and mix came from

    def path(self, rel: str) -> str:
        """A path of the benchmark's files, relative to the checkout."""
        return os.path.join(self.base, rel)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, base: str = ROOT, bench: str = HERE) -> Cell:
    """The cell `name` of `base`/BENCHMARK.json, its files read from
    `bench` (this folder, or another that holds the same layout)."""
    manifest = load_json(os.path.join(base, "BENCHMARK.json"))
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    config = load_json(os.path.join(bench, "configs",
                                    check_name(w["config"]) + ".json"))
    traffic = load_json(os.path.join(bench, "traffic",
                                     check_name(w["traffic"]) + ".json"))
    limits = load_json(os.path.join(bench, "cells",
                                    check_name(name) + ".json"))["limits"]
    return Cell(name, int(w["chips"]), config, traffic, limits,
                [m for m in manifest["end_to_end"] if _applies(m, name)],
                [m for m in manifest["per_layer"] if _applies(m, name)],
                base, bench)


def verify_inputs(cell: Cell) -> None:
    """Refuse to run when a frozen input differs from its recorded sha256."""
    for rel, digest in cell.config["inputs"].items():
        got = sha256(cell.path(rel))
        if got != digest:
            raise RuntimeError(f"{rel}: sha256 {got}, expected {digest}")


def _module(name: str, path: str, package: bool = False):
    """The module of the file `path` (a package's `__init__.py` where
    `package`) under the name `name`, made once a process."""
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            name, path, submodule_search_locations=(
                [os.path.dirname(path)] if package else None))
        module = importlib.util.module_from_spec(spec)
        sys.modules[name] = module
        try:
            spec.loader.exec_module(module)
        except BaseException:
            del sys.modules[name]
            raise
    return sys.modules[name]


def _tag(path: str) -> str:
    return hashlib.sha256(os.path.realpath(path).encode()).hexdigest()[:12]


def reference(cell: Cell):
    """The plain reference package that checks `cell`: the one its
    configuration names, from the cell's bench folder."""
    return reference_package(cell.config.get("reference", "reference"),
                             cell.bench)


def reference_package(name: str = "reference", bench: str = HERE):
    """The package `<bench>/<name>/`, with every module of it imported (this
    folder's packages are `perfbench.<name>`)."""
    if "." in check_name(name) or not name.startswith("reference"):
        raise ValueError(f"the reference {name!r} is refused: a reference is "
                         "a package whose name starts with 'reference', "
                         "without '.'")
    folder = os.path.join(bench, name)
    if not os.path.isfile(os.path.join(folder, "__init__.py")):
        raise ValueError(f"the reference {name!r} is refused: no package "
                         f"{folder}")
    if os.path.realpath(bench) == os.path.realpath(HERE):
        package = importlib.import_module(f"{__package__}.{name}")
    else:
        package = _module(f"perfbench_{name}_{_tag(folder)}",
                          os.path.join(folder, "__init__.py"), package=True)
    for f in sorted(os.listdir(folder)):
        if f.endswith(".py") and f != "__init__.py":
            importlib.import_module(f"{package.__name__}.{f[:-3]}")
    return package


def kind(name: str, bench: str = HERE):
    """The module of kinds/<name>.py: its job kind `JOBS` and the kind's
    planted faults `FAULTS`."""
    path = os.path.join(bench, "kinds", check_name(name) + ".py")
    if not os.path.isfile(path):
        raise ValueError(f"the job {name!r} is not built in and has no "
                         f"file {path}")
    module = _module(f"perfbench_kind_{_tag(path)}", path)
    if not isinstance(getattr(module, "JOBS", None), type):
        raise ValueError(f"{path} defines no class JOBS")
    faults = getattr(module, "FAULTS", None)
    if not isinstance(faults, dict) or not faults:
        raise ValueError(f"{path} defines no FAULTS: a dict of one planted "
                         "fault or more")
    return module


def reader(name: str, bench: str = HERE):
    """The `read(run)` function of metrics/<name>.py."""
    path = os.path.join(bench, "metrics", check_name(name) + ".py")
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
