"""The port's host layer (numpy copies of the reference's scene schema, OBJ
parser, cluster build and HDR reader, plus its scene build and the
scene/convert.py bridge) against the JAX package's."""
import dataclasses
import glob
import os

import numpy as np
import pytest
import torch

from hobbyraytracer_tpu import native as jnative
from hobbyraytracer_tpu.io import hdr as jhdr
from hobbyraytracer_tpu.scene import build_scene as jax_build_scene
from hobbyraytracer_tpu.scene import bvh as jbvh
from hobbyraytracer_tpu.scene import objloader as jobj
from hobbyraytracer_tpu.scene import schema as jschema
from hobbyraytracer_tpu_torch.io import hdr as phdr
from hobbyraytracer_tpu_torch.scene import build as pbuild
from hobbyraytracer_tpu_torch.scene import bvh as pbvh
from hobbyraytracer_tpu_torch.scene import convert, meshload, objloader
from hobbyraytracer_tpu_torch.scene import schema as pschema

from _torch_parity import (ROOT, SCENES, TEAPOT, assert_tree_close,
                           jax_camera_arrays, jax_scene_arrays)

torch.set_num_threads(2)


@pytest.fixture
def numpy_cluster_build(monkeypatch):
    """The reference's numpy cluster build: its native C++ SAH (used when
    libhrtnative builds) picks other splits on the teapot than its own
    numpy SAH, which is what the port copies."""
    monkeypatch.setattr(jnative, "build_clusters", lambda *a, **k: None)


@pytest.mark.parametrize("path", sorted(glob.glob(f"{SCENES}/*.yaml")),
                         ids=os.path.basename)
def test_schema_matches_reference(path):
    assert (dataclasses.asdict(pschema.load_scene_desc(path))
            == dataclasses.asdict(jschema.load_scene_desc(path)))


def test_schema_errors_match(tmp_path):
    bad = tmp_path / "bad.yaml"
    bad.write_text("film: {width: 4, height: 4, samples: 1}\n")
    with pytest.raises(pschema.SceneError, match="output"):
        pschema.load_scene_desc(str(bad))
    with pytest.raises(jschema.SceneError, match="output"):
        jschema.load_scene_desc(str(bad))


def _obj_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert a[k].dtype == b[k].dtype, k


def test_obj_parse_matches_reference(tmp_path):
    path = f"{ROOT}/assets/teapot.obj"
    _obj_equal(objloader.parse_obj(path), jobj.parse_obj_python(path))
    # quads (fan triangulation), negative indices, v/vt/vn and v//vn forms
    small = tmp_path / "quad.obj"
    small.write_text("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\n"
                     "vt 0 0\nvt 1 0\nvt 1 1\nvn 0 0 1\n"
                     "f 1/1/1 2/2/1 3/3/1 4/3/1\n"
                     "f -4//1 -2//1 -1//1\n")
    _obj_equal(objloader.parse_obj(str(small)),
               jobj.parse_obj_python(str(small)))
    assert meshload.load_mesh(str(small))["indices"].shape == (3, 3)


def test_mesh_formats_not_ported_raise(tmp_path):
    with pytest.raises(NotImplementedError, match="item 16"):
        meshload.load_mesh(str(tmp_path / "m.ply"))


@pytest.mark.parametrize("sah", [True, False])
@pytest.mark.parametrize("mesh", ["teapot", "random"])
def test_build_clusters_matches_reference(monkeypatch, numpy_cluster_build,
                                          mesh, sah):
    if mesh == "teapot":
        m = objloader.parse_obj(f"{ROOT}/assets/teapot.obj")
        verts, idx, leaf = m["verts"], m["indices"], 128
    else:
        rng = np.random.default_rng(0)
        verts = rng.normal(size=(900, 3)).astype(np.float32)
        idx = rng.integers(0, 900, size=(300, 3)).astype(np.int32)
        leaf = 32
    monkeypatch.setattr(jbvh, "BVH_SAH", sah)
    ref = jbvh.build_clusters(verts, idx, leaf_size=leaf)
    got = pbvh.build_clusters(verts, idx, leaf_size=leaf, sah=sah)
    _obj_equal(got, ref)
    if mesh == "teapot" and sah:
        assert got["tri_id"].shape == (30, 128)


@pytest.mark.parametrize("name", ["hall.hdr", "sky.hdr"])
def test_read_hdr_matches_reference(name):
    path = f"{ROOT}/assets/{name}"
    a, b = phdr.read_hdr(path), jhdr.read_hdr(path)
    assert a.dtype == b.dtype == np.float32
    np.testing.assert_array_equal(a, b)


def test_build_scene_matches_reference(numpy_cluster_build):
    """The teapot scene built by both packages, leaf for leaf: ints exact,
    floats within 1e-6 (the mesh rotation goes through each framework's
    sin/cos)."""
    job_p = pbuild.build_scene(pschema.load_scene_desc(TEAPOT))
    job_j = jax_build_scene(jschema.load_scene_desc(TEAPOT))
    assert_tree_close(convert.scene_to_arrays(job_p.scene),
                      jax_scene_arrays(job_j.scene))
    assert_tree_close(convert.camera_to_arrays(job_p.camera),
                      jax_camera_arrays(job_j.camera))
    assert (job_p.width, job_p.height, job_p.samples, job_p.output) == (
        job_j.width, job_j.height, job_j.samples, job_j.output)
    mesh = job_p.scene.instances[0].mesh
    assert tuple(mesh.tri_soa.shape) == (30, 24, 128)   # resident layout


def test_convert_carries_jax_scene_exactly():
    job_j = jax_build_scene(jschema.load_scene_desc(TEAPOT))
    arrays = jax_scene_arrays(job_j.scene)
    scene = convert.scene_from_arrays(arrays)
    assert_tree_close(convert.scene_to_arrays(scene), arrays, atol=0.0)
    cam = jax_camera_arrays(job_j.camera)
    assert_tree_close(convert.camera_to_arrays(
        convert.camera_from_arrays(cam)), cam, atol=0.0)
    # the tables move with the module
    assert scene.to("meta").instances[0].mesh.tri_soa.device.type == "meta"


def test_convert_refuses_unported_parts():
    job_j = jax_build_scene(jschema.load_scene_desc(TEAPOT))
    arrays = jax_scene_arrays(job_j.scene)
    with_spheres = dict(arrays, spheres={
        "center": np.zeros((1, 3), np.float32),
        "radius": np.ones((1,), np.float32),
        "mat_id": np.zeros((1,), np.int32)})
    with pytest.raises(NotImplementedError, match="spheres"):
        convert.scene_from_arrays(with_spheres)
    with pytest.raises(NotImplementedError, match="media"):
        convert.scene_from_arrays(dict(arrays, media=[object()]))


@pytest.mark.parametrize("scene,match", [
    ("cornell_box.yaml", "box"), ("scattered_balls.yaml", "sphere"),
    ("cornell_smoke.yaml", "box|constant_medium")])
def test_unported_objects_raise(scene, match):
    with pytest.raises(NotImplementedError, match=match):
        pbuild.build_scene(pschema.load_scene_desc(f"{SCENES}/{scene}"))


def test_unported_materials_raise(tmp_path):
    text = open(TEAPOT).read().replace("type: lambertian", "type: metal\n"
                                       "    roughness: 0.1", 1)
    path = tmp_path / "metal.yaml"
    path.write_text(text.replace("../assets/", f"{ROOT}/assets/"))
    with pytest.raises(NotImplementedError, match="item 7"):
        pbuild.build_scene(pschema.load_scene_desc(str(path)))


def test_tpu_table_rule_matches_reference():
    from hobbyraytracer_tpu.kernels.mesh_traverse import mesh_fits_vmem
    for k in (1, 30, 64, 500, 731, 732, 822, 2000):
        assert pbuild.tpu_mesh_fits_vmem(k, 128) == mesh_fits_vmem(k, 128), k
