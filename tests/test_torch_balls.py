"""The final scene of Ray Tracing in One Weekend (scenes/scattered_balls.yaml:
485 pooled spheres, lambertian, metal and dielectric materials, a solid
sky) rendered by the port on the CPU against the benchmark's own plain
reference of it (perfbench/reference_scattered_balls: the dense sphere
find and the dielectric lobe in plain PyTorch), pixel for pixel; and the
port's record of the sphere find when the render is traced (the nested
phase hrt.segment.find.spheres, the render's `spheres` and
`sphere_route`, the lane counters lanes.sphere_hit and lanes.dielectric)
against a recount made by stepping the segments by hand."""
from collections import Counter

import pytest
import torch

from hobbyraytracer_tpu_torch import tracing
from hobbyraytracer_tpu_torch.core.rng import Sampler
from hobbyraytracer_tpu_torch.core.types import Rays
from hobbyraytracer_tpu_torch.integrator import wavefront as pwf
from hobbyraytracer_tpu_torch.kernels import sphere_scan as scmod
from hobbyraytracer_tpu_torch.ops import intersect as pisect
from hobbyraytracer_tpu_torch.ops import shade as pshade
from hobbyraytracer_tpu_torch.scene import build_scene, load_scene_desc
from hobbyraytracer_tpu_torch.scene import ir as pir
from perfbench import manifest

from _torch_parity import SCENES

torch.set_num_threads(2)

BALLS = f"{SCENES}/scattered_balls.yaml"
# a glass sphere in front of the camera holding a fuzzy metal sphere off its
# centre: rays the metal sends back at the glass from inside meet it past
# the critical angle (total internal reflection), the rest refract
GLASS_CUT = """
film: {width: 32, height: 18, samples: 4, output: cut.png}
camera:
    position: [13, 2, 3]
    look_at: [0, 0, 0]
    up: [0, 1, 0]
    fov: 20
    aperture: 0.1
    focal_distance: 10
    background: [0.70, 0.80, 1.00]
materials:
  - {name: ground, type: lambertian, albedo: [0.5, 0.5, 0.5]}
  - {name: glass, type: dielectric, ior: 1.5}
  - {name: brown, type: lambertian, albedo: [0.4, 0.2, 0.1]}
  - {name: steel, type: metal, albedo: [0.7, 0.6, 0.5], roughness: 0.0}
  - {name: fuzz, type: metal, albedo: [0.8, 0.8, 0.9], roughness: 0.3}
objects:
  - {type: sphere, center: [0, -1000, 0], radius: 1000, material: ground}
  - {type: sphere, center: [0, 1, 0], radius: 1.0, material: glass}
  - {type: sphere, center: [8.2, 1.3, 1.9], radius: 0.7, material: glass}
  - {type: sphere, center: [8.2, 1.65, 1.9], radius: 0.25, material: fuzz}
  - {type: sphere, center: [-4, 1, 0], radius: 1.0, material: brown}
  - {type: sphere, center: [4, 1, 0], radius: 1.0, material: steel}
"""
# (scene, width, height, spp, pool): pools under the work items, so lanes
# take new items as they finish, and the retirement cap (64) binds
CASES = {"485 spheres": ("balls", 32, 18, 2, 512),
         "glass cut": ("cut", 32, 18, 4, 256)}
SEED = 2 ** 31 + 11


@pytest.fixture(scope="module")
def ref():
    return manifest.reference_package("reference_scattered_balls")


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    cut = tmp_path_factory.mktemp("balls") / "glass_cut.yaml"
    cut.write_text(GLASS_CUT)
    return {"balls": BALLS, "cut": str(cut)}


@pytest.fixture(autouse=True)
def empty_recorder():
    tracing.RECORDER.drain()
    yield
    tracing.RECORDER.drain()


def _program(path, width, height, spp, pool):
    job = build_scene(load_scene_desc(path))
    return job.scene, job.camera, pwf.render_image(
        job.scene, job.camera, width, height, spp, Sampler(SEED, "cpu"),
        max_depth=50, pool=pool)


@pytest.mark.parametrize("case", sorted(CASES))
def test_render_equals_the_reference_pixel_for_pixel(monkeypatch, ref,
                                                     paths, case):
    """The port's image is the reference's exactly (pixels_off_pct 0), the
    lobes met on the way counted by the reference: in the glass cut some
    dielectric lanes refract and some meet total internal reflection."""
    name, width, height, spp, pool = CASES[case]
    _, _, img = _program(paths[name], width, height, spp, pool)
    met = Counter()
    lobe = ref.trace.dielectric

    def counted(*args):
        out = lobe(*args)
        met["dielectric"] += int(out[0].sum())
        met["refracted"] += int(out[2].sum())
        met["total internal reflection"] += int(out[3].sum())
        return out

    monkeypatch.setattr(ref.trace, "dielectric", counted)
    sc = ref.trace.DeviceScene(ref.scene.load(paths[name]), "cpu")
    want = ref.render.render(sc, width, height, spp, SEED, 50, pool, True)
    assert img.shape == want.shape == (height, width, 3)
    off = ~((img - want).abs() <= 1.0 / 256.0)
    assert 100.0 * off.float().mean().item() == 0.0
    assert torch.equal(img, want)
    assert met["dielectric"] > 0 and met["refracted"] > 0
    if name == "cut":
        assert met["total internal reflection"] > 0


def test_traced_balls_render_records_the_sphere_find():
    """Traced, the render is the untraced one bit for bit; it records the
    sphere find as a phase nested in each segment's find, the pool's 485
    spheres on the dense route, and lane counters that equal a recount of
    the segments stepped by hand: active lanes whose closest hit is a
    sphere (every hit here), lanes the dielectric lobe scattered; and no
    launch of the sphere_scan kernel (the CPU runs its plain version)."""
    width, height, spp, pool = 16, 9, 2, 128
    scene, camera, off = _program(BALLS, width, height, spp, pool)
    scans = scmod.SCAN_KERNEL.launches
    with tracing.recording() as rec:
        on = pwf.render_image(scene, camera, width, height, spp,
                              Sampler(SEED, "cpu"), max_depth=50, pool=pool)
    assert torch.equal(off, on)
    records = rec.records()
    spans = [r for r in records if r["type"] == "span"]
    by_id = {s["id"]: s for s in spans}
    (root,) = [s for s in spans if s["name"] == "hrt.render"]
    assert root["attrs"]["spheres"] == 485
    assert root["attrs"]["sphere_route"] == "dense"
    finds = [s for s in spans if s["name"] == "hrt.segment.find.spheres"]
    assert finds and len(finds) == sum(
        s["name"] == "hrt.segment.find" for s in spans)
    for s in finds:
        parent = by_id[s["parent"]]
        assert parent["name"] == "hrt.segment.find"
        assert parent["start_ns"] <= s["start_ns"] <= s["end_ns"] \
            <= parent["end_ns"]
    phases = {}
    for p in records:
        if p["type"] == "phase":
            phases[p["name"]] = phases.get(p["name"], 0.0) + p["ms"]
    assert 0 < phases["hrt.segment.find.spheres"] <= phases[
        "hrt.segment.find"]
    got = {c["name"]: c["value"] for c in records if c["type"] == "counter"}

    sampler = Sampler(SEED, "cpu")
    total = width * height          # one chunk of `spp` samples a pixel
    state = pwf.init_state(width, height, pool, "cpu")
    want = Counter()
    while int(state.retired) < total * spp:
        for _ in range(8):
            pwf._regenerate(state, camera, width, height, total, sampler)
            active = pwf._active(state)
            hits = pir.intersect_scene(scene, Rays(o=state.o, d=state.d),
                                       ray_valid=active)
            mtype = scene.materials.mtype[torch.clamp(hits.mat_id, min=0)]
            pwf._segment(state, scene, width, height, sampler, 50, spp)
            want["lanes.active"] += int(active.sum())
            want["lanes.sphere_hit"] += int((active & hits.hit).sum())
            want["lanes.dielectric"] += int(
                (active & hits.hit & (mtype == pshade.MAT_DIELECTRIC)).sum())
    for name in ("lanes.active", "lanes.sphere_hit", "lanes.dielectric"):
        assert got[name] == want[name], name
    assert 0 < got["lanes.sphere_hit"] <= got["lanes.active"]
    assert 0 < got["lanes.dielectric"] < got["lanes.sphere_hit"]
    assert scmod.SCAN_KERNEL.launches == scans


def test_the_sphere_route_is_dense_unless_the_kernel_is_asked_for(
        monkeypatch):
    """`sphere_route` names the find intersect_scene takes: the dense scan
    by default, K4's clustered find when HRT_SPHERE_KERNEL's switch is on
    and the pool carries cluster tables, none without pooled spheres."""
    balls = build_scene(load_scene_desc(BALLS)).scene
    teapot = build_scene(load_scene_desc(
        f"{SCENES}/teapot_scene.yaml")).scene
    assert pir.sphere_route(balls) == "dense"
    assert pir.sphere_route(teapot) is None
    monkeypatch.setattr(pisect, "SPHERE_KERNEL", True)
    assert pir.sphere_route(balls) == "clustered"
    assert pir.sphere_route(balls, mesh_backend="lockstep") == "dense"
    assert pwf._sphere_attrs(balls) == {"spheres": 485,
                                        "sphere_route": "clustered"}
    assert pwf._sphere_attrs(teapot) == {}
    assert pwf._lane_kinds(balls) == ("lanes.sphere_hit",
                                      "lanes.dielectric")
    assert pwf._lane_kinds(teapot) == ()
