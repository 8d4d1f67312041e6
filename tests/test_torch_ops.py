"""The port's tensor ops against the JAX package's functions on the same
numpy inputs: camera rays, film tonemap, texture lookups, emission and
scatter (with injected noise), rect intersection, the coherence key,
instance transforms, quaternions, the background lookup and the Sampler."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hobbyraytracer_tpu.core import quat as jquat
from hobbyraytracer_tpu.core.types import Hits as JHits
from hobbyraytracer_tpu.core.types import Rays as JRays
from hobbyraytracer_tpu.integrator import path as jpath
from hobbyraytracer_tpu.io import images as jimages
from hobbyraytracer_tpu.ops import camera as jcam
from hobbyraytracer_tpu.ops import film as jfilm
from hobbyraytracer_tpu.ops import intersect as jisect
from hobbyraytracer_tpu.ops import shade as jshade
from hobbyraytracer_tpu.ops import texture as jtex
from hobbyraytracer_tpu.scene import build_scene as jax_build_scene
from hobbyraytracer_tpu.scene import ir as jir
from hobbyraytracer_tpu.scene import load_scene_desc as jax_load_scene_desc
from hobbyraytracer_tpu_torch.core import quat as pquat
from hobbyraytracer_tpu_torch.core import rng as prng
from hobbyraytracer_tpu_torch.core.types import Hits, Rays
from hobbyraytracer_tpu_torch.integrator import path as ppath
from hobbyraytracer_tpu_torch.ops import camera as pcam
from hobbyraytracer_tpu_torch.ops import film as pfilm
from hobbyraytracer_tpu_torch.ops import intersect as pisect
from hobbyraytracer_tpu_torch.ops import shade as pshade
from hobbyraytracer_tpu_torch.ops import texture as ptex
from hobbyraytracer_tpu_torch.scene import convert, ir as pir

from _torch_parity import (TEAPOT, Noise, NoiseSampler, jax_camera_arrays,
                           jax_scene_arrays, patch_jax_rng)

torch.set_num_threads(2)

T = torch.from_numpy


def _close(p, j, rtol=1e-6, atol=1e-6):
    np.testing.assert_allclose(p.numpy(), np.asarray(j), rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def teapot():
    job = jax_build_scene(jax_load_scene_desc(TEAPOT))
    return (job, convert.scene_from_arrays(jax_scene_arrays(job.scene)),
            convert.camera_from_arrays(jax_camera_arrays(job.camera)))


def test_get_rays(teapot):
    job, _, cam = teapot
    rng = np.random.default_rng(0)
    s, t = (rng.uniform(-0.1, 1.1, 500).astype(np.float32) for _ in "st")
    rj = jcam.get_rays(job.camera, jnp.asarray(s), jnp.asarray(t))
    rp = pcam.get_rays(cam, T(s), T(t))
    _close(rp.o, rj.o, 0, 0)
    _close(rp.d, rj.d, 1e-6, 1e-6)
    # make_camera from the scene's own numbers builds the same basis
    c2 = pcam.make_camera((0, 2.5, 8.5), (0, 2.5, 0), (0, 1, 0), 45, 1.0,
                          0.001, 8.5)
    for f in ("origin", "lower_left_corner", "horizontal", "vertical", "u",
              "v", "w", "lens_radius"):
        _close(getattr(c2, f), getattr(job.camera, f), 0, 0)


def test_tonemap_and_quantize():
    rng = np.random.default_rng(1)
    c = rng.uniform(0, 4, (64, 3)).astype(np.float32)
    c[0, 0], c[1, 1], c[2, 2], c[3, 0] = np.nan, np.inf, -np.inf, -1.0
    tp = pfilm.tonemap(T(c))
    _close(tp, jfilm.tonemap(jnp.asarray(c)), 1e-6, 1e-7)
    assert torch.isfinite(tp).all()
    np.testing.assert_array_equal(pfilm.quantize(tp.numpy()),
                                  jfilm.quantize(np.asarray(tp.numpy())))


def test_output_film_png_roundtrip(tmp_path):
    img = np.random.default_rng(2).integers(0, 256, (5, 7, 3), np.uint8)
    assert pfilm.output_film(img, str(tmp_path / "a.png"))
    np.testing.assert_array_equal(jimages.read_png(str(tmp_path / "a.png")),
                                  img)
    with pytest.raises(NotImplementedError, match="item 16"):
        pfilm.output_film(img, str(tmp_path / "a.bmp"))


def _tex_specs():
    rng = np.random.default_rng(3)
    return [
        {"type": jtex.TEX_SOLID, "solid": (1.0, 1.0, 1.0)},
        {"type": jtex.TEX_SOLID, "solid": (0.2, 0.3, 0.4)},
        {"type": jtex.TEX_CHECKERED, "solid": (0.9, 0.1, 0.1),
         "solid2": (0.1, 0.1, 0.9)},
        {"type": jtex.TEX_IMAGE,
         "image": rng.uniform(0, 1, (5, 7, 3)).astype(np.float32)},
        {"type": jtex.TEX_ENVIRONMENT,
         "image": rng.uniform(0, 3, (6, 9, 3)).astype(np.float32)},
        {"type": jtex.TEX_IMAGE, "image": None},        # no data: cyan
        {"type": jtex.TEX_ENVIRONMENT, "image": None},
    ]


@pytest.mark.parametrize("types", [None, (2, 3)])
def test_colour_value(types):
    specs = _tex_specs()
    tj, tp = jtex.build_table(specs), ptex.build_table(specs)
    for f in ("ttype", "solid", "solid2", "atlas", "offset", "width",
              "height"):
        _close(getattr(tp, f), getattr(tj, f), 0, 0)
    rng = np.random.default_rng(4)
    n = 2000
    tid = rng.integers(-1, len(specs), n).astype(np.int32)
    u, v = (rng.uniform(-0.2, 1.2, n).astype(np.float32) for _ in "uv")
    p = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    if types is not None:   # only ids of the named types (and solid)
        tid = np.where(np.isin(np.asarray(tj.ttype)[np.maximum(tid, 0)],
                               list(types) + [0]), tid, 0).astype(np.int32)
    cj = jtex.colour_value(tj, jnp.asarray(tid), jnp.asarray(u),
                           jnp.asarray(v), jnp.asarray(p), types)
    cp = ptex.colour_value(tp, T(tid), T(u), T(v), T(p), types)
    _close(cp, cj, 0, 0)
    sj = jtex.scalar_value(tj, jnp.asarray(tid), jnp.asarray(u),
                           jnp.asarray(v), jnp.asarray(p))
    _close(ptex.scalar_value(tp, T(tid), T(u), T(v), T(p)), sj)


def _mat_specs(textured):
    return [{"mtype": jshade.MAT_LAMBERTIAN},
            {"mtype": jshade.MAT_LAMBERTIAN, "albedo": (0.7, 0.2, 0.1),
             "albedo_tex": 2 if textured else -1},
            {"mtype": jshade.MAT_DIFFUSE_LIGHT, "albedo": (0.9, 0.8, 0.4),
             "strength": 4.5, "strength_tex": 1 if textured else -1},
            {"mtype": jshade.MAT_LAMBERTIAN, "albedo": (0.1, 0.5, 0.2)}]


def _hits(n, n_mats, seed):
    rng = np.random.default_rng(seed)
    hit = rng.uniform(size=n) < 0.8
    mat = np.where(hit, rng.integers(0, n_mats, n), -1).astype(np.int32)
    normal = rng.normal(size=(n, 3)).astype(np.float32)
    normal[:5] = [[0.0, 0.0, 1e-9]] * 5     # lam_dir near zero below
    return dict(hit=hit, t=np.where(hit, 1.0, 1e30).astype(np.float32),
                p=rng.uniform(-2, 2, (n, 3)).astype(np.float32),
                normal=normal,
                uv=rng.uniform(0, 1, (n, 2)).astype(np.float32),
                front_face=rng.uniform(size=n) < 0.5, mat_id=mat)


@pytest.mark.parametrize("textured", [False, True])
def test_emitted_and_scatter(monkeypatch, textured):
    specs, tex_specs = _mat_specs(textured), _tex_specs()
    ttypes = [s["type"] for s in tex_specs]
    mj = jshade.build_table(specs, tex_ttypes=ttypes)
    mp = pshade.build_table(specs, tex_ttypes=ttypes)
    assert (mp.present, mp.textured, mp.tex_types) == (
        mj.present, mj.textured, mj.tex_types)
    tj, tp = jtex.build_table(tex_specs), ptex.build_table(tex_specs)
    n = 1000
    h = _hits(n, len(specs), 5)
    hj = JHits(**{k: jnp.asarray(v) for k, v in h.items()})
    hp = Hits(**{k: T(v) for k, v in h.items()})
    _close(pshade.emitted(mp, tp, hp), jshade.emitted(mj, tj, hj), 1e-6, 0)

    noise = Noise(6)
    sph = noise.unit_sphere(prng.SCATTER_SPHERE, 3, (n,))
    sph[:5] = [[0.0, 0.0, -1e-9]] * 5       # normal + sphere ~ 0
    noise.unit_sphere = lambda purpose, it, shape: sph
    patch_jax_rng(monkeypatch, noise)
    d = np.random.default_rng(7).normal(size=(n, 3)).astype(np.float32)
    ok_j, at_j, nd_j = jshade.scatter(
        mj, tj, JRays(o=hj.p, d=jnp.asarray(d)), hj, jax.random.PRNGKey(0), 3)
    ok_p, at_p, nd_p = pshade.scatter(mp, tp, Rays(o=hp.p, d=T(d)), hp,
                                      NoiseSampler(noise), 3)
    np.testing.assert_array_equal(ok_p.numpy(), np.asarray(ok_j))
    _close(at_p, at_j, 0, 0)
    _close(nd_p, nd_j, 0, 0)
    np.testing.assert_array_equal(nd_p.numpy()[:5], h["normal"][:5])


def test_unported_material_types_raise():
    with pytest.raises(NotImplementedError, match="item 7"):
        pshade.build_table([{"mtype": pshade.MAT_LAMBERTIAN},
                            {"mtype": pshade.MAT_METAL}])


def _world_rays(n, seed, spread=3.0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    o[:, 1] += 2.5
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:7, 0] = 0.0                                  # axis-parallel rays
    return o, d


def test_intersect_rects(teapot):
    job, scene, _ = teapot
    o, d = _world_rays(3000, 8)
    for t_min in (1e-3, 0.5):
        rj, rp = job.scene.rects, scene.rects
        hj = jisect.intersect_rects(
            JRays(o=jnp.asarray(o), d=jnp.asarray(d)), rj.axis, rj.a0,
            rj.a1, rj.b0, rj.b1, rj.k, rj.mat_id, t_min, 1e30)
        hp = pisect.intersect_rects(
            Rays(o=T(o), d=T(d)), rp.axis, rp.a0, rp.a1, rp.b0, rp.b1, rp.k,
            rp.mat_id, t_min, 1e30, chunk=4)   # two chunks of the 6 rects
        for f in ("hit", "mat_id", "front_face"):
            np.testing.assert_array_equal(getattr(hp, f).numpy(),
                                          np.asarray(getattr(hj, f)))
        for f in ("t", "p", "normal", "uv"):
            _close(getattr(hp, f), getattr(hj, f), 1e-5, 1e-5)


def test_intersect_scene_rects_and_transformed_rects(teapot):
    """Whole-scene closest hit with the mesh left out (its find is held
    against the Pallas kernel in test_torch_mesh_traverse.py), plus a
    transformed rect instance."""
    job, scene, _ = teapot
    rot = np.asarray(jquat.from_euler(jnp.radians(jnp.asarray(
        [10.0, 30.0, -20.0]))))
    tr = dict(translate=np.asarray([0.3, 1.0, -0.2], np.float32),
              scale=np.asarray([1.5, 1.5, 1.5], np.float32), quat=rot)
    jrt = jir.RectTable(**{f: getattr(job.scene.rects, f)[:2] for f in (
        "axis", "a0", "a1", "b0", "b1", "k", "mat_id")})
    jinst = jir.Instance(kind="rect", rects=jrt, transform=jir.Transform(
        translate=jnp.asarray(tr["translate"]),
        scale=jnp.asarray(tr["scale"]), quat=jnp.asarray(rot)))
    jscene = job.scene.replace(instances=(jinst,))
    pinst = pir.Instance("rect", rects=pir.RectTable(
        **{f: getattr(scene.rects, f)[:2] for f in (
            "axis", "a0", "a1", "b0", "b1", "k", "mat_id")}),
        transform=pir.Transform(tr["translate"], tr["scale"], rot))
    pscene = pir.SceneIR(scene.rects, [pinst], scene.materials,
                         scene.textures, int(scene.background_tex))
    o, d = _world_rays(2000, 9)
    hj = jir.intersect_scene(jscene, JRays(o=jnp.asarray(o),
                                           d=jnp.asarray(d)), None, 0)
    hp = pir.intersect_scene(pscene, Rays(o=T(o), d=T(d)))
    for f in ("hit", "mat_id", "front_face"):
        np.testing.assert_array_equal(getattr(hp, f).numpy(),
                                      np.asarray(getattr(hj, f)))
    for f in ("t", "p", "normal", "uv"):
        _close(getattr(hp, f), getattr(hj, f), 1e-5, 1e-5)
    assert hp.hit.float().mean() > 0.3


def test_cheap_key_from_box():
    o, d = _world_rays(4000, 10)
    valid = np.random.default_rng(11).uniform(size=4000) < 0.9
    bmin = np.asarray([-1.0, 0.5, -1.5], np.float32)
    bmax = np.asarray([1.2, 2.0, 0.5], np.float32)
    kj = jisect.cheap_key_from_box(jnp.asarray(o), jnp.asarray(d),
                                   jnp.asarray(valid), jnp.asarray(bmin),
                                   jnp.asarray(bmax), 1e30)
    kp = pisect.cheap_key_from_box(T(o), T(d), T(valid), T(bmin), T(bmax),
                                   1e30)
    assert kp.dtype == torch.int32
    np.testing.assert_array_equal(kp.numpy(), np.asarray(kj))
    assert len(np.unique(kp.numpy())) > 20


def test_transform(teapot):
    job, scene, _ = teapot
    jt, pt = job.scene.instances[0].transform, scene.instances[0].transform
    o, d = _world_rays(1000, 12)
    rj = jt.ray_to_object(JRays(o=jnp.asarray(o), d=jnp.asarray(d)))
    rp = pt.ray_to_object(Rays(o=T(o), d=T(d)))
    _close(rp.o, rj.o, 1e-6, 1e-6)
    _close(rp.d, rj.d, 1e-6, 1e-6)
    _close(pt.point_to_world(T(o)), jt.point_to_world(jnp.asarray(o)))
    _close(pt.normal_to_world(T(d)), jt.normal_to_world(jnp.asarray(d)))


def test_quat():
    rng = np.random.default_rng(13)
    eul = rng.uniform(-math.pi, math.pi, (50, 3)).astype(np.float32)
    qj = jquat.from_euler(jnp.asarray(eul))
    qp = pquat.from_euler(T(eul))
    _close(qp, qj, 1e-6, 1e-6)
    v = rng.normal(size=(50, 3)).astype(np.float32)
    q = np.array(qj)
    _close(pquat.rotate(T(q), T(v)), jquat.rotate(jnp.asarray(q),
                                                  jnp.asarray(v)))
    _close(pquat.inverse_rotate(T(q), T(v)),
           jquat.inverse_rotate(jnp.asarray(q), jnp.asarray(v)))
    back = pquat.rotate(T(q), pquat.inverse_rotate(T(q), T(v)))
    _close(back, v, 1e-5, 1e-5)


def test_background_colour(teapot):
    job, scene, _ = teapot
    d = np.random.default_rng(14).normal(size=(3000, 3)).astype(np.float32)
    _close(ppath.background_colour(scene, T(d)),
           jpath.background_colour(job.scene, jnp.asarray(d)), 1e-5, 1e-5)


def test_sampler_streams():
    s = prng.Sampler(5, "cpu")
    a = s.uniform(prng.PIXEL_JITTER_U, 3, (1000,))
    assert torch.equal(a, prng.Sampler(5, "cpu").uniform(
        prng.PIXEL_JITTER_U, 3, (1000,)))
    assert not torch.equal(a, s.uniform(prng.PIXEL_JITTER_V, 3, (1000,)))
    assert not torch.equal(a, s.uniform(prng.PIXEL_JITTER_U, 4, (1000,)))
    assert not torch.equal(a, prng.Sampler(6, "cpu").uniform(
        prng.PIXEL_JITTER_U, 3, (1000,)))
    assert a.dtype == torch.float32 and 0 <= a.min() and a.max() < 1
    assert abs(a.mean().item() - 0.5) < 0.05
    sph = s.unit_sphere(prng.SCATTER_SPHERE, 0, (20000,))
    assert sph.shape == (20000, 3)
    _close(sph.norm(dim=1), np.ones(20000, np.float32), 1e-5, 1e-5)
    assert sph.mean(dim=0).abs().max() < 0.03
