"""The port's generated assets (scene/procgen.py, scene/fixtures.py)
against the JAX package's and the repository's assets/.

- Each generator gives the JAX package's arrays exactly; each OBJ it
  writes is the JAX package's file byte for byte, and teapot /
  teapot_hires are the repository's assets/teapot.obj and
  assets/teapot_hires.obj.
- ensure_assets into an empty directory (tmp_path) writes the five files
  of assets/ byte for byte, as the JAX package's writes them; on a stale
  version it rewrites the environments as the JAX package does; against
  the repository's assets/ (at FIXTURE_VERSION) it writes nothing.
"""
import filecmp
import os

import numpy as np
import pytest
import torch

from hobbyraytracer_tpu.scene import fixtures as jfix
from hobbyraytracer_tpu.scene import procgen as jgen
from hobbyraytracer_tpu_torch.scene import fixtures as pfix
from hobbyraytracer_tpu_torch.scene import procgen as pgen

from _torch_parity import ROOT

torch.set_num_threads(2)

ASSETS = os.path.join(ROOT, "assets")
FILES = ("teapot.obj", "teapot_hires.obj", "hall.hdr", "sky.hdr",
         ".fixture_version")


@pytest.mark.parametrize("name,kw", [
    ("uv_sphere", {}), ("uv_sphere", dict(radius=2.0, n_theta=5, n_phi=7,
                                          center=(1.0, -2.0, 0.5))),
    ("box_mesh", {}), ("teapot", {}), ("teapot", dict(n_seg=12,
                                                      n_profile=9,
                                                      scale=0.5)),
    ("teapot_hires", {})])
def test_generators_match_jax(name, kw):
    """The mesh dicts of every generator: the same keys, dtypes and
    bytes."""
    got, ref = getattr(pgen, name)(**kw), getattr(jgen, name)(**kw)
    assert sorted(got) == sorted(ref)
    for k in got:
        a, b = np.asarray(got[k]), np.asarray(ref[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert a.tobytes() == b.tobytes(), k


@pytest.mark.parametrize("kind", ["teapot", "teapot_hires", "sphere", "box"])
def test_ensure_asset_obj_matches_jax_and_the_repo(tmp_path, kind):
    """ensure_asset_obj writes the JAX package's OBJ byte for byte (the
    teapots: the repository's assets), and leaves an existing file alone."""
    a = str(tmp_path / "p" / f"{kind}.obj")
    b = str(tmp_path / "j" / f"{kind}.obj")
    assert pgen.ensure_asset_obj(a, kind) == a
    jgen.ensure_asset_obj(b, kind)
    assert filecmp.cmp(a, b, shallow=False)
    if kind.startswith("teapot"):
        assert filecmp.cmp(a, os.path.join(ASSETS, f"{kind}.obj"),
                           shallow=False)
    stamp = os.stat(a).st_mtime_ns
    pgen.ensure_asset_obj(a, "box")   # exists: not rewritten
    assert os.stat(a).st_mtime_ns == stamp


@pytest.mark.parametrize("name", ["hall_environment", "sky_environment"])
def test_environments_match_jax(name):
    a, b = getattr(pfix, name)(), getattr(jfix, name)()
    assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def test_ensure_assets_writes_the_repo_assets(tmp_path):
    """Into an empty directory: the five files of assets/ byte for byte,
    the same as the JAX package's ensure_assets writes, and the same
    paths returned."""
    p, j = tmp_path / "p", tmp_path / "j"
    got, ref = pfix.ensure_assets(str(p)), jfix.ensure_assets(str(j))
    assert pfix.FIXTURE_VERSION == jfix.FIXTURE_VERSION == 3
    assert {k: os.path.relpath(v, p) for k, v in got.items()} == {
        k: os.path.relpath(v, j) for k, v in ref.items()}
    assert sorted(os.listdir(p)) == sorted(os.listdir(j)) == sorted(FILES)
    for name in FILES:
        assert filecmp.cmp(p / name, j / name, shallow=False), name
        assert filecmp.cmp(p / name, os.path.join(ASSETS, name),
                           shallow=False), name


def test_stale_version_rewrites_as_jax(tmp_path):
    """A directory at an older FIXTURE_VERSION with the meshes present: the
    environments are rewritten and the version bumped, the meshes kept, as
    the JAX package does."""
    dirs = []
    for label, fix in (("p", pfix), ("j", jfix)):
        d = tmp_path / label
        d.mkdir()
        (d / ".fixture_version").write_text("2")
        for name in ("teapot.obj", "teapot_hires.obj"):
            (d / name).write_text("o kept\n")
        (d / "hall.hdr").write_bytes(b"old")
        fix.ensure_assets(str(d))
        dirs.append(d)
    for name in FILES:
        assert filecmp.cmp(dirs[0] / name, dirs[1] / name, shallow=False)
    assert (dirs[0] / "teapot.obj").read_text() == "o kept\n"
    assert filecmp.cmp(dirs[0] / "hall.hdr", os.path.join(ASSETS, "hall.hdr"),
                       shallow=False)
    assert (dirs[0] / ".fixture_version").read_text() == "3"


def test_ensure_assets_leaves_the_repo_assets_alone():
    """The default directory is the repository's assets/; at
    FIXTURE_VERSION nothing there is written."""
    assert os.path.realpath(pfix.ASSET_DIR) == os.path.realpath(ASSETS)
    before = {n: os.stat(os.path.join(ASSETS, n)).st_mtime_ns for n in FILES}
    paths = pfix.ensure_assets()
    after = {n: os.stat(os.path.join(ASSETS, n)).st_mtime_ns for n in FILES}
    assert before == after
    assert os.path.realpath(paths["hall"]) == os.path.realpath(
        os.path.join(ASSETS, "hall.hdr"))
