"""The port's benchmark (hobbyraytracer_tpu_torch/bench.py, the CLI's
`bench`), the counterpart of the repository's bench.py, at a tiny size on
the CPU: its JSON line has bench.py's keys and meaning, each BENCH_*
variable is read, the assets are made first (and the repository's assets/
left as they are), and a device that is not there is refused, never
replaced by the CPU (tests/test_torch_no_jax.py)."""
import importlib.util
import json
import os

import pytest
import torch

from hobbyraytracer_tpu_torch import bench
from hobbyraytracer_tpu_torch.cli import main as cli

from _torch_parity import ROOT

torch.set_num_threads(2)

KEYS = ["metric", "value", "unit", "vs_baseline", "repeats", "min", "max"]


def _tiny(monkeypatch, **env):
    for k, v in {"BENCH_SIZE": "8", "BENCH_SPP": "1", "BENCH_REPEATS": "2",
                 "BENCH_POOL": "64", **env}.items():
        monkeypatch.setenv(k, v)


def _last_json(out):
    lines = out.strip().splitlines()
    return lines, json.loads(lines[-1])


def test_cli_bench_on_cpu(monkeypatch, capsys):
    """`bench --device cpu` at 8x8, 1 spp, two repeats, pool 64 (the
    wavefront teapot, through K1's plain version): rc 0, the device named
    on an earlier line, and the last line bench.py's JSON; assets/ not
    written."""
    _tiny(monkeypatch)
    assets = os.path.join(ROOT, "assets")
    stamps = {n: os.stat(os.path.join(assets, n)).st_mtime_ns
              for n in os.listdir(assets)}
    assert cli.main(["bench", "--device", "cpu"]) == 0
    lines, line = _last_json(capsys.readouterr().out)
    assert "[bench] on cpu" in lines
    assert list(line) == KEYS
    assert line["metric"] == "primary_rays_per_s_teapot_8x8@1spp"
    assert line["unit"] == "rays/s/chip" and line["repeats"] == 2
    assert 0 < line["min"] <= line["value"] <= line["max"]
    assert line["vs_baseline"] == round(
        line["value"] / bench.BASELINE_PRIMARY_RAYS_PER_S, 3)
    assert stamps == {n: os.stat(os.path.join(assets, n)).st_mtime_ns
                      for n in os.listdir(assets)}


@pytest.mark.parametrize("scene,integrator", [("cornell", "batch"),
                                              ("balls", "wavefront")])
def test_bench_reads_its_variables(monkeypatch, scene, integrator):
    """BENCH_SCENE, BENCH_INTEGRATOR and one repeat (no spread keys)."""
    _tiny(monkeypatch, BENCH_SCENE=scene, BENCH_INTEGRATOR=integrator,
          BENCH_REPEATS="1", BENCH_SIZE="6", BENCH_SPP="2")
    line = bench.run(torch.device("cpu"))
    assert list(line) == KEYS[:4]
    assert line["metric"] == f"primary_rays_per_s_{scene}_6x6@2spp"
    assert line["value"] > 0


def test_bench_takes_the_root_bench_contract(monkeypatch):
    """The same baseline, scenes and defaults as the repository's bench.py
    (read from its source, which imports JAX only inside main)."""
    spec = importlib.util.spec_from_file_location(
        "root_bench", os.path.join(ROOT, "bench.py"))
    root = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(root)
    assert root.BASELINE_PRIMARY_RAYS_PER_S == \
        bench.BASELINE_PRIMARY_RAYS_PER_S
    with open(os.path.join(ROOT, "bench.py")) as f:
        src = f.read()
    for name, path in bench.SCENE_FILES.items():
        assert f'"{name}": "{path}"' in src
    for var, default in (("BENCH_SCENE", '"teapot"'), ("BENCH_SIZE", '"640"'),
                         ("BENCH_SPP", '"100"'), ("BENCH_REPEATS", '"3"'),
                         ("BENCH_INTEGRATOR", '"wavefront"')):
        assert f'"{var}", {default}' in src
    assert "PRNGKey(100 + rep)" in src and "render(1, " in src
