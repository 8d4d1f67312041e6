"""The benchmark's data, found by name: the manifest (BENCHMARK.json at the
checkout's root), and for one cell its configuration (`configs/<name>.json`,
its scene files checked by sha256), its traffic mix
(`traffic/<name>.json`), its limits (`cells/<cell>.json`) and the readers
of its metrics (`metrics/<metric>.py`). A new cell, mix, configuration or
metric is new files and manifest entries; nothing here changes.
"""
from __future__ import annotations

import hashlib
import importlib.util
import json
import os
import re
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
                base)


def verify_inputs(cell: Cell) -> None:
    """Refuse to run when a frozen input differs from its recorded sha256."""
    for rel, digest in cell.config["inputs"].items():
        got = sha256(cell.path(rel))
        if got != digest:
            raise RuntimeError(f"{rel}: sha256 {got}, expected {digest}")


def reader(name: str, bench: str = HERE):
    """The `read(run)` function of metrics/<name>.py."""
    path = os.path.join(bench, "metrics", check_name(name) + ".py")
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
