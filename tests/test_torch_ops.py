"""The port's tensor ops against the JAX package's functions on the same
numpy inputs: camera rays, film tonemap, texture lookups, emission and
scatter (with injected noise), rect intersection, the coherence keys
(both forms, cluster entries, the packed key and every HRT_KEY_MODE),
instance transforms, quaternions, the background lookup and the Sampler."""
import math
import os

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
    """PNG, and since the codecs are ported TGA and BMP too, read back by
    the JAX package's readers (tests/test_torch_io.py compares the bytes
    and the unknown-extension path)."""
    img = np.random.default_rng(2).integers(0, 256, (5, 7, 3), np.uint8)
    assert pfilm.output_film(img, str(tmp_path / "a.png"))
    np.testing.assert_array_equal(jimages.read_png(str(tmp_path / "a.png")),
                                  img)
    for ext in ("tga", "bmp"):
        assert pfilm.output_film(img, str(tmp_path / f"a.{ext}"))
        np.testing.assert_array_equal(
            jimages.read_image(str(tmp_path / f"a.{ext}")), img)


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
    """Every material type of the reference builds now (none is refused);
    media, whose isotropic phase material is one of them, no longer raise
    either, nor does the fit's bilinear texture filtering, nor the
    thin-lens camera (its use_lens comes across)."""
    tab = pshade.build_table([{"mtype": t} for t in range(7)])
    assert tab.present == tuple(range(7))
    cam = {f: np.zeros((3,), np.float32) for f in convert.CAMERA_FIELDS}
    assert convert.camera_from_arrays(dict(cam, use_lens=True)).use_lens


_LOBES = {
    "metal": [{"mtype": jshade.MAT_METAL, "albedo": (0.7, 0.6, 0.5),
               "roughness": 0.0},
              {"mtype": jshade.MAT_METAL, "albedo": (0.2, 0.9, 0.5),
               "roughness": 0.35},
              {"mtype": jshade.MAT_METAL, "roughness": -3.0,
               "roughness_tex": 1}],
    "dielectric": [{"mtype": jshade.MAT_DIELECTRIC, "ior": 1.5},
                   {"mtype": jshade.MAT_DIELECTRIC, "ior": 2.4,
                    "roughness": 0.1}],
    "isotropic": [{"mtype": jshade.MAT_ISOTROPIC, "albedo": (0.3, 0.4, 0.5)}],
    "pbr": [{"mtype": jshade.MAT_PBR, "metallness": 0.9, "roughness": 0.2},
            {"mtype": jshade.MAT_PBR, "metallness": 0.1},
            {"mtype": jshade.MAT_PBR, "metallness_tex": 2,
             "albedo_tex": 3}],
    "uvtest": [{"mtype": jshade.MAT_UVTEST}],
}
_LOBES["all"] = [m for specs in _LOBES.values() for m in specs] + [
    {"mtype": jshade.MAT_DIFFUSE_LIGHT, "strength": 3.0}]


@pytest.mark.parametrize("lobe", sorted(_LOBES))
def test_scatter_lobes_match_jax(monkeypatch, lobe):
    """Each lobe of scatter (and all of them in one table) against JAX's
    under the same injected noise, beside a lambertian: did_scatter equal
    but for lanes whose deciding quantity (the metal lobe's dot with the
    normal, Schlick against the uniform draw) sits within rounding of its
    threshold (<= 0.2% of lanes, left out of the rest); attenuation equal;
    new_d within atol 2e-6 (the frameworks' rsqrt and sqrt round
    differently). A lobe absent from `present` draws nothing: the streams
    drawn are the same in both packages."""
    specs = [{"mtype": jshade.MAT_LAMBERTIAN, "albedo": (0.5, 0.4, 0.3)}]
    specs += _LOBES[lobe]
    tex_specs = _tex_specs()
    ttypes = [s["type"] for s in tex_specs]
    mj = jshade.build_table(specs, tex_ttypes=ttypes)
    mp = pshade.build_table(specs, tex_ttypes=ttypes)
    assert (mp.present, mp.textured, mp.tex_types) == (
        mj.present, mj.textured, mj.tex_types)
    tj, tp = jtex.build_table(tex_specs), ptex.build_table(tex_specs)
    n = 4000
    h = _hits(n, len(specs), 20)
    rng = np.random.default_rng(21)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    # half the normals unit and facing the ray (as a sphere hit gives them),
    # the rest raw, as a mesh gives them
    unit = h["normal"] / np.linalg.norm(h["normal"], axis=1, keepdims=True)
    facing = np.where((unit * d).sum(1, keepdims=True) < 0, unit, -unit)
    h["normal"][n // 2:] = facing[n // 2:].astype(np.float32)
    hj = JHits(**{k: jnp.asarray(v) for k, v in h.items()})
    hp = Hits(**{k: T(v) for k, v in h.items()})

    class Counting(Noise):
        def __init__(self, seed):
            super().__init__(seed)
            self.drawn = []

        def _rng(self, purpose, iteration, shape, kind):
            self.drawn.append((int(purpose), kind))
            return super()._rng(purpose, iteration, shape, kind)

    noise_j, noise_p = Counting(22), Counting(22)
    patch_jax_rng(monkeypatch, noise_j)
    ok_j, at_j, nd_j = jshade.scatter(
        mj, tj, JRays(o=hj.p, d=jnp.asarray(d)), hj, jax.random.PRNGKey(0), 5)
    ok_p, at_p, nd_p = pshade.scatter(mp, tp, Rays(o=hp.p, d=T(d)), hp,
                                      NoiseSampler(noise_p), 5)
    assert noise_p.drawn == noise_j.drawn
    want = {(prng.SCATTER_SPHERE, "s")}
    if lobe in ("dielectric", "all"):
        want.add((prng.DIELECTRIC_CHOICE, "u"))
    if lobe in ("isotropic", "all"):
        want.add((prng.SCATTER_BALL, "b"))
    assert set(noise_p.drawn) == want
    ok_j, ok_p = np.asarray(ok_j), ok_p.numpy()
    nd_j, nd_p = np.asarray(nd_j), nd_p.numpy()
    edge = (ok_j != ok_p) | (np.abs(nd_j - nd_p).max(axis=1) > 1e-3)
    assert edge.mean() <= 0.002, edge.sum()
    _close(at_p, at_j, 0, 0)
    np.testing.assert_allclose(nd_p[~edge], nd_j[~edge], rtol=0, atol=2e-6)
    mt = np.asarray(mj.mtype)[np.maximum(h["mat_id"], 0)]
    for t in mj.present:        # every lobe of the table was exercised
        assert ((mt == t) & h["hit"]).sum() > 50, t
    if lobe == "dielectric":
        assert (at_p.numpy()[(mt == jshade.MAT_DIELECTRIC)] == 1.0).all()
    if lobe == "metal":
        absorbed = (mt == jshade.MAT_METAL) & h["hit"] & ~ok_p
        assert absorbed.any()


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


@pytest.mark.parametrize("corridor", [False, True])
def test_cheap_key_from_box_forms(corridor):
    """Both forms of the key (octant: misses 1 << 20; corridor: 30 bits,
    misses 1 << 30) against the JAX function: int keys equal."""
    o, d = _world_rays(4000, 13)
    valid = np.random.default_rng(14).uniform(size=4000) < 0.9
    bmin = np.asarray([-1.0, 0.5, -1.5], np.float32)
    bmax = np.asarray([1.2, 2.0, 0.5], np.float32)
    kj = jisect.cheap_key_from_box(jnp.asarray(o), jnp.asarray(d),
                                   jnp.asarray(valid), jnp.asarray(bmin),
                                   jnp.asarray(bmax), 1e30, corridor=corridor)
    kp = pisect.cheap_key_from_box(T(o), T(d), T(valid), T(bmin), T(bmax),
                                   1e30, corridor=corridor)
    assert kp.dtype == torch.int32
    np.testing.assert_array_equal(kp.numpy(), np.asarray(kj))
    miss = 1 << 30 if corridor else 1 << 20
    assert (kp.numpy()[~valid] == miss).all()
    assert len(np.unique(kp.numpy())) > 20


def _key_inputs(n_clusters, seed):
    """Random cluster boxes (8, K) and rays around them, a tenth invalid."""
    rng = np.random.default_rng(seed)
    lo = rng.uniform(-2.0, 2.0, (n_clusters, 3)).astype(np.float32)
    hi = lo + rng.uniform(0.05, 0.6, (n_clusters, 3)).astype(np.float32)
    bounds8 = np.concatenate([lo.T, hi.T, np.zeros((2, n_clusters),
                                                   np.float32)])
    o = rng.uniform(-4.0, 4.0, (1500, 3)).astype(np.float32)
    d = rng.normal(size=(1500, 3)).astype(np.float32)
    valid = rng.uniform(size=1500) < 0.9
    return bounds8, o, d, valid


def test_cluster_entries_and_pack_coherence_key():
    """cluster_entries (R, K) and pack_coherence_key against the JAX
    functions: entries equal (both +inf where missed), int keys equal, at
    K = 40 (20 entry bits) and K = 300."""
    for k_clusters, seed in ((40, 15), (300, 16)):
        bounds8, o, d, _ = _key_inputs(k_clusters, seed)
        bmin, bmax = bounds8[:3].T.copy(), bounds8[3:6].T.copy()
        ej = np.asarray(jisect.cluster_entries(
            JRays(o=jnp.asarray(o), d=jnp.asarray(d)), jnp.asarray(bmin),
            jnp.asarray(bmax), 1e30))
        ep = pisect.cluster_entries(Rays(o=T(o), d=T(d)), T(bmin), T(bmax),
                                    1e30)
        np.testing.assert_array_equal(ep.numpy(), ej)
        e_min = ej.min(axis=1)
        first = np.where(np.isfinite(e_min), ej.argmin(axis=1), 0).astype(
            np.int32)
        kj = jisect.pack_coherence_key(jnp.asarray(e_min),
                                       jnp.asarray(first), k_clusters)
        kp = pisect.pack_coherence_key(T(e_min), T(first), k_clusters)
        assert kp.dtype == torch.int32
        np.testing.assert_array_equal(kp.numpy(), np.asarray(kj))
        assert np.isfinite(e_min).any() and not np.isfinite(e_min).all()
    assert pisect.pack_coherence_key(torch.zeros(0), torch.zeros(
        0, dtype=torch.int32), 5).shape == (0,)


@pytest.mark.parametrize("mode", ["auto", "cheap", "corridor", "pallas"])
def test_coherence_key_modes(monkeypatch, mode):
    """coherence_key in each HRT_KEY_MODE against the JAX function with the
    same mode (the JAX "pallas" mode runs coherence_keys_pallas in
    interpret mode), below and above CORRIDOR_MIN_K: int keys equal."""
    monkeypatch.setattr(jisect, "KEY_MODE", mode)
    monkeypatch.setattr(pisect, "KEY_MODE", mode)
    for k_clusters, seed in ((40, 17), (300, 18)):
        bounds8, o, d, valid = _key_inputs(k_clusters, seed)
        kj = jisect.coherence_key(jnp.asarray(o), jnp.asarray(d),
                                  jnp.asarray(valid), jnp.asarray(bounds8),
                                  1e30, interpret=True)
        kp = pisect.coherence_key(T(o), T(d), T(valid), T(bounds8), 1e30)
        assert kp.dtype == torch.int32
        np.testing.assert_array_equal(kp.numpy(), np.asarray(kj))
        assert len(np.unique(kp.numpy())) > 20


def test_key_mode_is_read_at_call_time(monkeypatch):
    """KEY_MODE switches in-process; an unknown value raises, and so does
    an unknown HRT_KEY_MODE at import (as in the reference)."""
    bounds8, o, d, valid = _key_inputs(300, 19)
    keys = {}
    for mode in ("cheap", "corridor", "auto"):
        monkeypatch.setattr(pisect, "KEY_MODE", mode)
        keys[mode] = pisect.coherence_key(T(o), T(d), T(valid), T(bounds8),
                                          1e30)
    assert not torch.equal(keys["cheap"], keys["corridor"])
    assert torch.equal(keys["auto"], keys["corridor"])   # K >= 256
    monkeypatch.setattr(pisect, "CORRIDOR_MIN_K", 301)
    assert torch.equal(pisect.coherence_key(T(o), T(d), T(valid),
                                            T(bounds8), 1e30), keys["cheap"])
    monkeypatch.setattr(pisect, "KEY_MODE", "exact")
    with pytest.raises(ValueError, match="KEY_MODE"):
        pisect.coherence_key(T(o), T(d), T(valid), T(bounds8), 1e30)
    import subprocess
    import sys
    proc = subprocess.run(
        [sys.executable, "-c",
         "import hobbyraytracer_tpu_torch.ops.intersect"],
        env=dict(os.environ, HRT_KEY_MODE="exact"), capture_output=True,
        text=True, timeout=120)
    assert proc.returncode != 0 and "HRT_KEY_MODE" in proc.stderr


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
