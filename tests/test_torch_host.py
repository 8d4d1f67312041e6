"""The port's host layer (copies of the reference's scene schema, native
and Python OBJ parsers, native and numpy cluster builds and HDR reader,
plus its scene build and the scene/convert.py bridge) against the JAX
package's. Ints and the cluster tables equal; other floats within 1e-6."""
import dataclasses
import glob
import importlib.util
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
from hobbyraytracer_tpu_torch import native as pnative
from hobbyraytracer_tpu_torch.io import hdr as phdr
from hobbyraytracer_tpu_torch.scene import build as pbuild
from hobbyraytracer_tpu_torch.scene import bvh as pbvh
from hobbyraytracer_tpu_torch.scene import convert, meshload, objloader
from hobbyraytracer_tpu_torch.scene import schema as pschema

from _torch_parity import (HIRES, ROOT, SCENES, TEAPOT, assert_tree_close,
                           jax_camera_arrays, jax_scene_arrays)

torch.set_num_threads(2)


@pytest.fixture
def numpy_cluster_build(monkeypatch):
    """Both packages on their numpy cluster build (the native C++ SAH,
    which each uses when its library builds, picks other splits on the
    teapot than the numpy SAH)."""
    monkeypatch.setattr(jnative, "build_clusters", lambda *a, **k: None)
    monkeypatch.setattr(pnative, "build_clusters", lambda *a, **k: None)


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


@pytest.mark.parametrize("name", ["teapot.obj", "teapot_hires.obj"])
def test_native_obj_parse_matches_reference(name):
    """The port's native parser (its own build of objbvh.cpp) against the
    JAX package's native parser and the Python parser: arrays equal."""
    path = f"{ROOT}/assets/{name}"
    assert pnative.lib() is not None and jnative.lib() is not None
    got = pnative.parse_obj(path)
    _obj_equal(got, jnative.parse_obj(path))
    _obj_equal(objloader.parse_obj(path), got)
    if name == "teapot.obj":
        _obj_equal(got, objloader.parse_obj_python(path))
    else:
        assert got["indices"].shape == (105_208, 3)


@pytest.mark.parametrize("sah", [True, False])
@pytest.mark.parametrize("name", ["teapot.obj", "teapot_hires.obj"])
def test_native_clusters_match_reference(name, sah):
    """The port's build_clusters takes its native builder, as the JAX
    package's does: tables equal, K = 30 (teapot) and 822 (teapot_hires)
    with the SAH."""
    m = pnative.parse_obj(f"{ROOT}/assets/{name}")
    got = pbvh.build_clusters(m["verts"], m["indices"], leaf_size=128,
                              sah=sah)
    _obj_equal(got, jnative.build_clusters(m["verts"], m["indices"], 128,
                                           sah=sah))
    if sah:
        assert got["tri_id"].shape == ((30, 128) if name == "teapot.obj"
                                       else (822, 128))


def test_native_choice_follows_reference(monkeypatch, tmp_path, capsys):
    """HRT_NO_NATIVE=1 and a failed build both give the numpy builder (a
    failed build says so); the numpy SAH differs from the native one on
    the teapot, and equals the reference's numpy SAH."""
    m = objloader.parse_obj_python(f"{ROOT}/assets/teapot.obj")
    native_cl = pbvh.build_clusters(m["verts"], m["indices"], leaf_size=128)
    monkeypatch.setattr(jnative, "build_clusters", lambda *a, **k: None)
    numpy_ref = jbvh.build_clusters(m["verts"], m["indices"], leaf_size=128)
    for how in ("env", "failed build"):
        monkeypatch.setattr(pnative, "_TRIED", False)
        monkeypatch.setattr(pnative, "_LIB", None)
        if how == "env":
            monkeypatch.setenv("HRT_NO_NATIVE", "1")
        else:
            monkeypatch.delenv("HRT_NO_NATIVE", raising=False)
            monkeypatch.setattr(pnative, "BUILD_DIR", str(tmp_path))
            monkeypatch.setenv("CXX", "false")
        assert pnative.lib() is None
        assert pnative.parse_obj(f"{ROOT}/assets/teapot.obj") is None
        got = pbvh.build_clusters(m["verts"], m["indices"], leaf_size=128)
        _obj_equal(got, numpy_ref)
        assert not np.array_equal(got["tri_id"], native_cl["tri_id"])
    assert "[native] build skipped" in capsys.readouterr().out
    assert not list(tmp_path.iterdir())        # no half-built library


@pytest.mark.parametrize("scene", [TEAPOT, HIRES], ids=os.path.basename)
def test_build_scene_native_matches_reference(scene):
    """build_scene of both packages with their native builders: the mesh
    tables (cluster ids and bounds, tri_soa in either layout, bounds8)
    byte-identical, and equal to the digests chip_smoke.py holds the card's
    host build to; the rest leaf for leaf as in
    test_build_scene_matches_reference."""
    job_p = pbuild.build_scene(pschema.load_scene_desc(scene))
    job_j = jax_build_scene(jschema.load_scene_desc(scene))
    arr_p = convert.scene_to_arrays(job_p.scene)
    arr_j = jax_scene_arrays(job_j.scene)
    assert_tree_close(arr_p, arr_j)
    mesh_p, mesh_j = arr_p["instances"][0]["mesh"], arr_j["instances"][0][
        "mesh"]
    for f in convert.MESH_FIELDS:
        assert mesh_p[f].dtype == mesh_j[f].dtype, f
        assert mesh_p[f].tobytes() == mesh_j[f].tobytes(), f
    rows = 24 if scene == TEAPOT else 32
    k = 30 if scene == TEAPOT else 822
    assert mesh_p["tri_soa"].shape == (k, rows, 128)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", f"{ROOT}/chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    mesh = next(i for i in job_p.scene.instances if i.kind == "mesh").mesh
    key = os.path.relpath(scene, ROOT)
    assert smoke.table_digest(mesh) == smoke.TABLE_SHA256[key]


def test_mesh_formats_not_ported_raise(tmp_path):
    """Every mesh format of the JAX package is ported: a missing file of
    each extension raises the JAX package's OSError (the file is opened,
    not refused), and .blend / .x3d are refused with its ValueError
    (tests/test_torch_meshload.py parses each format)."""
    from hobbyraytracer_tpu.scene import meshload as jmeshload
    for ext in (".ply", ".stl", ".gltf", ".glb", ".dae", ".3ds", ".fbx"):
        path = str(tmp_path / f"m{ext}")
        with pytest.raises(OSError) as got:
            meshload.load_mesh(path)
        with pytest.raises(OSError) as ref:
            jmeshload.load_mesh(path)
        assert (type(got.value), str(got.value)) == (type(ref.value),
                                                     str(ref.value))
    (tmp_path / "m.blend").write_bytes(b"BLENDER")
    with pytest.raises(ValueError, match="unsupported mesh format .blend"):
        meshload.load_mesh(str(tmp_path / "m.blend"))


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
    """Nothing is refused any more: spheres come across (a table without
    the kernel tables reads them as None), and so do media (held against
    the JAX build in test_media_triangles_and_small_meshes_build), the
    fit's bilinear texture filtering and the lens (use_lens both ways; a
    dict without it reads as False)."""
    job_j = jax_build_scene(jschema.load_scene_desc(TEAPOT))
    arrays = jax_scene_arrays(job_j.scene)
    with_spheres = dict(arrays, spheres={
        "center": np.zeros((1, 3), np.float32),
        "radius": np.ones((1,), np.float32),
        "mat_id": np.zeros((1,), np.int32)})
    scene = convert.scene_from_arrays(with_spheres)
    assert scene.spheres.center.shape == (1, 3)
    assert scene.spheres.kernel_table is None
    with_medium = convert.scene_from_arrays(dict(arrays, media=[{
        "btype": "sphere", "center": np.zeros((3,), np.float32),
        "radius": np.float32(2.0), "neg_inv_density": np.float32(-4.0),
        "mat_id": np.int32(1)}]))
    assert with_medium.media[0].btype == "sphere"
    assert with_medium.media[0].bmin is None
    bilinear = convert.scene_from_arrays(dict(arrays, textures=dict(
        arrays["textures"], bilinear=True)))
    assert bilinear.textures.bilinear and not scene.textures.bilinear
    assert convert.scene_to_arrays(bilinear)["textures"]["bilinear"] is True
    cam = jax_camera_arrays(job_j.camera)
    lens = convert.camera_from_arrays(dict(cam, use_lens=True))
    assert lens.use_lens
    assert_tree_close(convert.camera_to_arrays(lens),
                      dict(cam, use_lens=True), atol=0.0)
    del cam["use_lens"]
    assert not convert.camera_from_arrays(cam).use_lens


@pytest.mark.parametrize("scene", ["scattered_balls", "cornell_box",
                                   "shiny_teapot", "awesome_reflections",
                                   "two_teapots"])
def test_build_scene_new_scenes_match_reference(scene):
    """build_scene of the scenes this slice unlocks (spheres with their
    cluster tables, boxes as six rects, metal and dielectric materials)
    against the JAX build, leaf for leaf (ints, statics and the cluster
    tables exact, other floats within 1e-6), and the camera; then the JAX
    scene carried across by convert gives the same tensors exactly."""
    path = f"{SCENES}/{scene}.yaml"
    job_p = pbuild.build_scene(pschema.load_scene_desc(path))
    job_j = jax_build_scene(jschema.load_scene_desc(path))
    arr_p = convert.scene_to_arrays(job_p.scene)
    arr_j = jax_scene_arrays(job_j.scene)
    assert_tree_close(arr_p, arr_j)
    assert_tree_close(convert.camera_to_arrays(job_p.camera),
                      jax_camera_arrays(job_j.camera))
    assert not job_j.camera.use_lens
    assert (job_p.width, job_p.height, job_p.samples, job_p.output) == (
        job_j.width, job_j.height, job_j.samples, job_j.output)
    carried = convert.scene_from_arrays(arr_j)
    assert_tree_close(convert.scene_to_arrays(carried), arr_j, atol=0.0)
    if scene == "scattered_balls":
        sp = arr_p["spheres"]
        assert sp["center"].shape == (485, 3)
        assert sp["kernel_table"].shape == (4, 8, 128)
        for f in ("center", "radius", "mat_id", "kernel_table",
                  "kernel_bounds", "kernel_ids"):
            assert sp[f].tobytes() == arr_j["spheres"][f].tobytes(), f
        assert set(job_p.scene.materials.present) == {0, 1, 2}
        assert carried.to("meta").spheres.kernel_ids.device.type == "meta"
        spec = importlib.util.spec_from_file_location(
            "chip_smoke", f"{ROOT}/chip_smoke.py")
        smoke = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(smoke)
        assert (smoke.table_digest(job_p.scene.spheres)
                == smoke.TABLE_SHA256[smoke.BALLS])
    elif scene == "two_teapots":
        assert [i.kind for i in job_p.scene.instances] == ["mesh", "mesh"]
        assert [int(i.mesh.mat_id) for i in job_p.scene.instances] == [1, 2]
    elif scene == "cornell_box":
        # two transformed boxes of six rects each beside the pooled walls
        assert [i.kind for i in job_p.scene.instances] == ["rect", "rect"]
        assert all(i.rects.axis.shape == (6,) for i in job_p.scene.instances)
        assert arr_p["spheres"]["kernel_table"] is None
    else:
        assert 1 in job_p.scene.materials.present      # metal


_TRIANGLE = ("  - type: triangle\n    v0: [0, 0, 0]\n    v1: [1, 0, 0]\n"
             "    v2: [0, 1, 0]\n    material: white\n")


@pytest.mark.parametrize("scene", ["cornell_smoke.yaml", "triangle",
                                   "tiny-mesh"])
def test_media_triangles_and_small_meshes_build(scene, tmp_path):
    """What the port used to refuse now builds, and matches the JAX build
    leaf for leaf (ints exact, floats within 1e-6), carried across by
    convert exactly: cornell_smoke's two box media with their phase
    materials after the named ones, a standalone `type: triangle` (a dense
    mesh of one with its face normal), and a one-triangle OBJ (under
    BVH_MIN_TRIS, so a dense mesh without cluster tables)."""
    path = f"{SCENES}/{scene}"
    if scene != "cornell_smoke.yaml":
        text = open(f"{SCENES}/cornell_box.yaml").read()
        if scene == "triangle":
            text += _TRIANGLE
        else:
            (tmp_path / "one.obj").write_text(
                "v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n")
            text += ("  - type: mesh\n    path: one.obj\n"
                     "    material: white\n")
        path = tmp_path / "scene.yaml"
        path.write_text(text)
    job_p = pbuild.build_scene(pschema.load_scene_desc(str(path)))
    job_j = jax_build_scene(jschema.load_scene_desc(str(path)))
    arr_p = convert.scene_to_arrays(job_p.scene)
    arr_j = jax_scene_arrays(job_j.scene)
    assert_tree_close(arr_p, arr_j)
    carried = convert.scene_from_arrays(arr_j)
    assert_tree_close(convert.scene_to_arrays(carried), arr_j, atol=0.0)
    if scene == "cornell_smoke.yaml":
        assert [m["btype"] for m in arr_p["media"]] == ["box", "box"]
        assert [int(m["mat_id"]) for m in arr_p["media"]] == [6, 7]
        assert list(arr_p["materials"]["mtype"][6:8]) == [4, 4]  # isotropic
        assert 4 in job_p.scene.materials.present
        assert arr_p["spheres"]["center"].shape == (1, 3)     # the glass
        assert arr_p["spheres"]["kernel_table"] is None
        assert carried.to("meta").media[1].bmax.device.type == "meta"
    else:
        mesh = arr_p["instances"][-1]["mesh"]
        assert mesh["use_bvh"] is False and mesh["tri_soa"] is None
        assert mesh["indices"].shape == (1, 3)
        assert not job_p.scene.instances[-1].mesh.use_bvh
        if scene == "triangle":
            np.testing.assert_array_equal(mesh["normals"],
                                          [[0.0, 0.0, 1.0]] * 3)


def test_mesh_tables_come_all_or_none():
    from hobbyraytracer_tpu_torch.scene import ir as pir
    v = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError, match="all five"):
        pir.MeshGeom(v, v, np.zeros((3, 2), np.float32),
                     np.asarray([[0, 1, 2]], np.int32), 0,
                     cluster_id=np.zeros((1, 1), np.int32))


def test_unported_materials_raise(tmp_path):
    """No material type is refused any more: a metal teapot scene builds
    with the metal lobe present. An unknown type is skipped with a message,
    as in the reference, and its objects with it."""
    text = open(TEAPOT).read().replace("type: lambertian", "type: metal\n"
                                       "    roughness: 0.1", 1)
    path = tmp_path / "metal.yaml"
    path.write_text(text.replace("../assets/", f"{ROOT}/assets/"))
    job = pbuild.build_scene(pschema.load_scene_desc(str(path)))
    assert 1 in job.scene.materials.present
    n_rects = job.scene.rects.axis.shape[0]
    path.write_text(text.replace("type: metal", "type: velvet").replace(
        "../assets/", f"{ROOT}/assets/"))
    job = pbuild.build_scene(pschema.load_scene_desc(str(path)))
    assert 1 not in job.scene.materials.present
    assert (job.scene.rects.axis.shape[0] + len(job.scene.instances)
            < n_rects + 1)


def test_tpu_table_rule_matches_reference():
    from hobbyraytracer_tpu.kernels.mesh_traverse import mesh_fits_vmem
    for k in (1, 30, 64, 500, 731, 732, 822, 2000):
        assert pbuild.tpu_mesh_fits_vmem(k, 128) == mesh_fits_vmem(k, 128), k
