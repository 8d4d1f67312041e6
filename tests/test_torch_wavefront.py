"""The port's wavefront main path against the JAX package's, on the teapot
scene and the scattered-balls scene (spheres, metal, dielectric) carried
across from the JAX build (scene/convert.py):

(a) segment for segment, with identical injected noise and the JAX mesh
    find running the Pallas kernel in interpret mode;
(b) statistically, a full render against JAX's wavefront.render_image;
(c) the pool drains exactly, including a partial last sample chunk;
(d) the same two comparisons on the balls scene, by the dense sphere scan
    and by the clustered find (JAX: the Pallas sphere kernel in interpret
    mode; the port: the plain version of kernel K4);
(e) the graph route's preconditions on the CPU: a block with the
    iteration a 0-d tensor reads no host value and equals the host-int
    block bit for bit; the state's tensors serve as static buffers across
    blocks; the route is chosen by rule.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from hobbyraytracer_tpu.core.types import Rays as JRays
from hobbyraytracer_tpu.integrator import wavefront as jwf
from hobbyraytracer_tpu.ops import intersect as jisect
from hobbyraytracer_tpu.scene import ir as jir
from hobbyraytracer_tpu.scene import build_scene as jax_build_scene
from hobbyraytracer_tpu.scene import load_scene_desc as jax_load_scene_desc
from hobbyraytracer_tpu_torch.core.rng import Sampler
from hobbyraytracer_tpu_torch.core.types import Rays
from hobbyraytracer_tpu_torch.integrator import wavefront as pwf
from hobbyraytracer_tpu_torch.kernels import build as kbuild
from hobbyraytracer_tpu_torch.ops import intersect as pisect
from hobbyraytracer_tpu_torch.scene import convert
from hobbyraytracer_tpu_torch.scene import ir as pir

from _torch_parity import (BALLS, FOG_YAML, TEAPOT, Noise, NoiseSampler,
                           jax_camera_arrays, jax_scene_arrays, no_host_reads,
                           patch_jax_rng)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def teapot():
    job = jax_build_scene(jax_load_scene_desc(TEAPOT))
    scene = convert.scene_from_arrays(jax_scene_arrays(job.scene))
    camera = convert.camera_from_arrays(jax_camera_arrays(job.camera))
    return job, scene, camera


_INT_FIELDS = ("item", "depth", "sub", "defer")
_FLOAT_FIELDS = ("o", "d", "thr", "rad")


@pytest.mark.parametrize("seed,spp", [(7, 3), (11, 1)])
def test_segments_match_jax(monkeypatch, teapot, seed, spp):
    """6 segments of a 16x16 render on a 256-lane pool, at 3 spp and at
    1 spp (where more than the retirement cap of 64 lanes finish in one
    segment, so `defer` and the stable retirement order are exercised):
    int fields (item, depth, sub, defer, counter,
    retired) equal on >= 99% of lanes; float fields allclose (rtol 1e-4)
    on those lanes and fb allclose, both apart from self-hit lanes.

    A self-hit lane is one whose bounce ray re-hit its own triangle at
    t ~ 0 on one side only: the mesh test has no t_min (t > 0,
    reference kernels/mesh_traverse.py:227), and XLA's CPU build contracts
    a*b+c into FMAs where PyTorch rounds each op, so the sign of such a t
    is rounding. Those lanes follow different paths from then on; they
    are counted (<= 3% of lanes), and their pixels are left out of the fb
    comparison."""
    monkeypatch.setenv("HRT_PALLAS_INTERPRET", "1")
    noise = Noise(seed)
    patch_jax_rng(monkeypatch, noise)
    _segments_vs_jax(teapot, spp, NoiseSampler(noise),
                     jax.random.PRNGKey(0))


@pytest.mark.parametrize("seed,spp", [(7, 3), (11, 1)])
def test_segments_match_jax_with_real_samplers(monkeypatch, teapot, seed,
                                               spp):
    """6 segments of a 16x16 teapot render on a 256-lane pool, at 3 spp and
    at 1 spp, with no injected noise: the port's Sampler(seed) against
    jax.random.PRNGKey(seed), whose uniforms are the same bits
    (core/rng.py), state for state.

    Self-hit lanes are counted as test_two_teapots_segments_match_jax
    counts them: before each segment both packages find the active rays'
    nearest hits, and a lane whose t is below 1e-4 in one package only (it
    re-hits the triangle it stands on: the mesh test has no t_min, and
    XLA's FMAs round where PyTorch does not) is a self-hit lane from then
    on (<= 5% of the lanes after 6 segments: 11 and 8 of 256 at these
    seeds; this test flags every lane that re-hits in one package, where
    the origin test of test_segments_match_jax, bound at 3%, flags those
    whose origins then part). Every other lane agrees: int fields equal,
    floats allclose (rtol 1e-4), fb allclose on the pixels no self-hit
    lane retires into; counter equal, retired within the self-hit lanes'
    samples."""
    monkeypatch.setenv("HRT_PALLAS_INTERPRET", "1")
    job, scene, camera = teapot
    w = h = 16
    pool, max_depth = 256, 50
    _, n_chunks, _ = jwf._chunk_geometry(spp, jwf.SAMPLE_CHUNK)
    total = w * h * n_chunks
    key, sampler = jax.random.PRNGKey(seed), Sampler(seed, "cpu")
    js = jwf.init_state(w, h, pool)
    ps = pwf.init_state(w, h, pool, "cpu")
    self_hit = np.zeros((pool,), bool)
    bad_px = np.zeros((w * h,), bool)
    for seg in range(6):
        js = jwf._regenerate(js, job.camera, w, h, total, key)
        pwf._regenerate(ps, camera, w, h, total, sampler)
        np.testing.assert_array_equal(ps.item.numpy()[~self_hit],
                                      np.asarray(js.item)[~self_hit])
        t_j = np.asarray(jir.intersect_scene(
            job.scene, JRays(o=js.o, d=js.d), key, js.it,
            mesh_backend="auto").t)
        t_p = pir.intersect_scene(scene, Rays(o=ps.o, d=ps.d)).t.numpy()
        self_hit |= pwf._active(ps).numpy() & ((t_j < 1e-4) != (t_p < 1e-4))
        item_j, item_p = np.asarray(js.item), ps.item.numpy().copy()
        js = jwf._segment(js, job.scene, w, h, key, max_depth, spp)
        pwf._segment(ps, scene, w, h, sampler, max_depth, spp)
        assert ps.it == int(js.it) == seg + 1
        assert int(ps.counter) == int(js.counter), seg
        assert self_hit.mean() <= 0.05, (seg, self_hit.sum())
        for f in _INT_FIELDS:
            np.testing.assert_array_equal(
                getattr(ps, f).numpy()[~self_hit],
                np.asarray(getattr(js, f))[~self_hit], err_msg=f"{f} {seg}")
        for f in _FLOAT_FIELDS:
            np.testing.assert_allclose(
                getattr(ps, f).numpy()[~self_hit],
                np.asarray(getattr(js, f))[~self_hit], rtol=1e-4, atol=1e-5,
                err_msg=f"{f} after segment {seg}")
        assert abs(int(ps.retired) - int(js.retired)) <= (
            self_hit.sum() * jwf.SAMPLE_CHUNK), seg
        bad_px[item_j[self_hit & (item_j >= 0)] % (w * h)] = True
        bad_px[item_p[self_hit & (item_p >= 0)] % (w * h)] = True
        np.testing.assert_allclose(ps.fb.numpy()[:, ~bad_px],
                                   np.asarray(js.fb)[:, ~bad_px],
                                   rtol=1e-4, atol=1e-5)
    assert int(ps.retired) > 0


def _segments_vs_jax(teapot, spp, sampler, key):
    """6 segments of both packages from an empty 256-lane pool (the body
    of test_segments_match_jax)."""
    job, scene, camera = teapot
    w = h = 16
    pool, max_depth = 256, 50
    _, n_chunks, _ = jwf._chunk_geometry(spp, jwf.SAMPLE_CHUNK)
    total = w * h * n_chunks
    js = jwf.init_state(w, h, pool)
    ps = pwf.init_state(w, h, pool, "cpu")
    saw_defer = False
    self_hit = np.zeros((pool,), bool)
    bad_px = np.zeros((w * h,), bool)
    for seg in range(6):
        js = jwf._regenerate(js, job.camera, w, h, total, key)
        pwf._regenerate(ps, camera, w, h, total, sampler)
        o_j, o_p = np.asarray(js.o), ps.o.numpy().copy()
        item_j, item_p = np.asarray(js.item), ps.item.numpy().copy()
        active = (item_j >= 0) & (np.asarray(js.depth) >= 0) & ~np.asarray(
            js.defer)
        js = jwf._segment(js, job.scene, w, h, key, max_depth, spp)
        pwf._segment(ps, scene, w, h, sampler, max_depth, spp)
        assert ps.it == int(js.it) == seg + 1
        assert int(ps.counter) == int(js.counter), seg
        assert int(ps.retired) == int(js.retired), seg
        stay_j = np.abs(np.asarray(js.o) - o_j).max(axis=1) < 1e-4
        stay_p = np.abs(ps.o.numpy() - o_p).max(axis=1) < 1e-4
        cont_j = np.asarray(js.depth) > 0
        self_hit |= active & cont_j & (stay_j != stay_p)
        assert self_hit.mean() <= 0.03, (seg, self_hit.sum())
        agree = np.ones((pool,), bool)
        for f in _INT_FIELDS:
            agree &= np.asarray(getattr(js, f)) == getattr(ps, f).numpy()
        assert agree.mean() >= 0.99, (seg, agree.mean())
        same = agree & ~self_hit
        for f in _FLOAT_FIELDS:
            np.testing.assert_allclose(
                getattr(ps, f).numpy()[same],
                np.asarray(getattr(js, f))[same], rtol=1e-4, atol=1e-5,
                err_msg=f"{f} after segment {seg}")
        off = self_hit | ~agree   # pixels these lanes retire into
        bad_px[item_j[off & (item_j >= 0)] % (w * h)] = True
        bad_px[item_p[off & (item_p >= 0)] % (w * h)] = True
        assert bad_px.mean() <= 0.05, (seg, bad_px.sum())
        np.testing.assert_allclose(ps.fb.numpy()[:, ~bad_px],
                                   np.asarray(js.fb)[:, ~bad_px],
                                   rtol=1e-4, atol=1e-5)
        saw_defer |= bool(ps.defer.any())
    if spp == 1:
        assert saw_defer  # the cap overflowed at least once
    assert int(ps.retired) > 0


def test_render_matches_jax_statistically(teapot):
    """24x24 @ 32 spp through both renderers with independent random
    streams: image means within 10%, 4x4 block means correlate > 0.85."""
    job, scene, camera = teapot
    w = h = 24
    spp = 32
    img_j = np.asarray(jwf.render_image(job.scene, job.camera, w, h, spp,
                                        jax.random.PRNGKey(0), max_depth=10,
                                        pool=2048))
    img_p = pwf.render_image(scene, camera, w, h, spp, Sampler(1, "cpu"),
                             max_depth=10, pool=2048).numpy()
    assert img_p.shape == img_j.shape == (h, w, 3)
    assert np.isfinite(img_p).all()
    mj, mp = img_j.mean(), img_p.mean()
    assert abs(mp - mj) / mj < 0.10, (mp, mj)
    bj = img_j.reshape(6, 4, 6, 4, 3).mean(axis=(1, 3, 4))
    bp = img_p.reshape(6, 4, 6, 4, 3).mean(axis=(1, 3, 4))
    corr = np.corrcoef(bj.ravel(), bp.ravel())[0, 1]
    assert corr > 0.85, corr


@pytest.mark.parametrize("spp,chunk", [(3, 4), (7, 4), (6, 4)])
def test_pool_drains_exactly(teapot, spp, chunk):
    """Every sample retires exactly once, including a partial last chunk
    (7 = 4 + 3) and a pool smaller than the work queue."""
    _, scene, camera = teapot
    w = h = 8
    state = pwf.render_state(scene, camera, w, h, spp, Sampler(0, "cpu"),
                             max_depth=6, pool=96, sample_chunk=chunk,
                             steps_per_call=3)
    _, n_chunks, _ = pwf._chunk_geometry(spp, chunk)
    assert int(state.retired) == w * h * spp
    assert int(state.counter) == w * h * n_chunks
    assert not bool((state.item >= 0).any())
    assert not bool(state.defer.any())
    assert torch.isfinite(state.fb).all()


def test_render_state_stops_where_jax_stops(monkeypatch, teapot):
    """render_state on a 16x16 teapot render (4 spp, max depth 2, pool 256)
    with the same injected noise as JAX's render_state (run eagerly): the
    final `it` is the reference's, the iteration at which its loop found
    the pool dry, whatever the host-read period (steps_per_call 8 and 3);
    the framebuffers agree (rtol 1e-4) but on the pixels of lanes whose
    bounce ray re-hit its own triangle on one side only (XLA's CPU FMAs,
    see test_segments_match_jax), counted (<= 5%). At depth 2 such a lane's
    sample still ends after its second segment in both, so `it` is exact."""
    monkeypatch.setenv("HRT_PALLAS_INTERPRET", "1")
    noise = Noise(17)
    patch_jax_rng(monkeypatch, noise)
    job, scene, camera = teapot
    w = h = 16
    with jax.disable_jit():
        js = jwf.render_state(job.scene, job.camera, w, h, 4,
                              jax.random.PRNGKey(0), max_depth=2, pool=256)
    fb_j = np.asarray(js.fb)
    for steps in (8, 3):
        ps = pwf.render_state(scene, camera, w, h, 4, NoiseSampler(noise),
                              max_depth=2, pool=256, steps_per_call=steps)
        assert ps.it == int(js.it), (steps, ps.it, int(js.it))
        assert int(ps.retired) == int(js.retired) == w * h * 4
        fb_p = ps.fb.numpy()
        close = np.isclose(fb_p, fb_j, rtol=1e-4, atol=1e-5).all(axis=0)
        assert close.mean() >= 0.95, (~close).sum()
    # the pool does not run dry on a multiple of both periods: a state that
    # kept the trailing no-op iterations would fail above
    assert int(js.it) % 8 or int(js.it) % 3


def test_trailing_iterations_are_noops(teapot):
    """Iterations after completion issue nothing and change no lane's
    work (idle lanes' `depth` counts on, as in the reference; it is reset
    when a lane is issued and never read before)."""
    _, scene, camera = teapot
    w = h = 4
    sampler = Sampler(0, "cpu")
    state = pwf.render_state(scene, camera, w, h, 2, sampler, max_depth=4,
                             pool=16)
    before = {f: getattr(state, f).clone() for f in
              ("fb", "o", "d", "thr", "rad", "item", "sub", "defer",
               "counter", "retired")}
    _, n_chunks, _ = pwf._chunk_geometry(2, pwf.SAMPLE_CHUNK)
    for _ in range(3):
        pwf._regenerate(state, camera, w, h, w * h * n_chunks, sampler)
        pwf._segment(state, scene, w, h, sampler, 4, 2)
    for f, v in before.items():
        assert torch.equal(getattr(state, f), v), f


@pytest.fixture(scope="module")
def balls():
    job = jax_build_scene(jax_load_scene_desc(BALLS))
    scene = convert.scene_from_arrays(jax_scene_arrays(job.scene))
    camera = convert.camera_from_arrays(jax_camera_arrays(job.camera))
    return job, scene, camera


def _sphere_route(monkeypatch, clustered):
    """Both packages on the dense scan, or on the clustered find (JAX's
    Pallas kernel in interpret mode)."""
    monkeypatch.setattr(jisect, "SPHERE_KERNEL", clustered)
    monkeypatch.setattr(pisect, "SPHERE_KERNEL", clustered)
    if clustered:
        monkeypatch.setenv("HRT_PALLAS_INTERPRET", "1")


@pytest.mark.parametrize("clustered", [False, True],
                         ids=["dense", "clustered"])
def test_balls_segments_match_jax(monkeypatch, balls, clustered):
    """3 segments of a 16x12 balls render on a 192-lane pool at 2 spp with
    identical injected noise, by either sphere route. Dielectric and metal
    paths re-hit the sphere they leave at t_min, and the ground sphere's
    quadratic cancels, so a lane whose nearest sphere differs between the
    packages (rounding at a grazing or re-hit ray) is marked from the hits
    before the segment and left out from then on, and so is a lane whose
    int fields differ or whose floats (o, d, thr, rad) drift past
    2e-3 + 1e-3 * |x|: t's relative error under XLA's FMAs reaches 5e-4 at
    t ~ 10, and the normal of a ball of radius 0.2 is that error in p times
    5, so a few lanes drift by rounding alone and stay apart. After each of
    the 3 segments at least 94% of the lanes agree state for state, and
    counter is equal."""
    _sphere_route(monkeypatch, clustered)
    noise = Noise(13)
    patch_jax_rng(monkeypatch, noise)
    job, scene, camera = balls
    assert scene.spheres.kernel_table.shape == (4, 8, 128)
    w, h, spp = 16, 12, 2
    pool, max_depth = 192, 50
    _, n_chunks, _ = jwf._chunk_geometry(spp, jwf.SAMPLE_CHUNK)
    total = w * h * n_chunks
    key = jax.random.PRNGKey(0)
    js = jwf.init_state(w, h, pool)
    ps = pwf.init_state(w, h, pool, "cpu")
    sampler = NoiseSampler(noise)
    off = np.zeros((pool,), bool)
    for seg in range(3):
        js = jwf._regenerate(js, job.camera, w, h, total, key)
        pwf._regenerate(ps, camera, w, h, total, sampler)
        hj = jir.intersect_scene(job.scene, JRays(o=js.o, d=js.d), key,
                                 js.it, mesh_backend="auto")
        hp = pir.intersect_scene(scene, Rays(o=ps.o, d=ps.d))
        off |= np.asarray(hj.mat_id) != hp.mat_id.numpy()
        js = jwf._segment(js, job.scene, w, h, key, max_depth, spp)
        pwf._segment(ps, scene, w, h, sampler, max_depth, spp)
        assert ps.it == int(js.it) == seg + 1
        assert int(ps.counter) == int(js.counter), seg
        for f in _INT_FIELDS:
            off |= np.asarray(getattr(js, f)) != getattr(ps, f).numpy()
        for f in _FLOAT_FIELDS:
            a, b = getattr(ps, f).numpy(), np.asarray(getattr(js, f))
            off |= (np.abs(a - b) > 2e-3 + 1e-3 * np.abs(b)).any(axis=1)
        assert off.mean() <= 0.06, (seg, off.sum())
    if not off.any():
        assert int(ps.retired) == int(js.retired)
    assert int(ps.retired) > 0
    # the materials of the scene were all met
    mats = set(np.asarray(job.scene.materials.mtype)[
        np.maximum(np.asarray(hj.mat_id), 0)].tolist())
    assert mats >= {0, 1}


def test_balls_render_matches_jax_statistically(monkeypatch, balls):
    """32x18 @ 16 spp through both renderers with independent random
    streams (the port by both sphere routes): image means within 5%, 2x2
    block means correlate > 0.9; the port's two routes agree closely (same
    seed: only grazing rays differ)."""
    job, scene, camera = balls
    w, h, spp = 32, 18, 16
    img_j = np.asarray(jwf.render_image(job.scene, job.camera, w, h, spp,
                                        jax.random.PRNGKey(0), max_depth=12,
                                        pool=1024))
    imgs = {}
    for clustered in (False, True):
        monkeypatch.setattr(pisect, "SPHERE_KERNEL", clustered)
        imgs[clustered] = pwf.render_image(
            scene, camera, w, h, spp, Sampler(1, "cpu"), max_depth=12,
            pool=1024).numpy()
    bj = img_j.reshape(9, 2, 16, 2, 3).mean(axis=(1, 3, 4))
    for img_p in imgs.values():
        assert img_p.shape == img_j.shape == (h, w, 3)
        assert np.isfinite(img_p).all()
        mj, mp = img_j.mean(), img_p.mean()
        assert abs(mp - mj) / mj < 0.05, (mp, mj)
        bp = img_p.reshape(9, 2, 16, 2, 3).mean(axis=(1, 3, 4))
        assert np.corrcoef(bj.ravel(), bp.ravel())[0, 1] > 0.9
    near = np.abs(imgs[False] - imgs[True]).max(axis=2) < 1e-3
    assert near.mean() >= 0.95, near.mean()


# --- two_teapots and cornell_smoke, with and without the pool sort ---------

TWO_TEAPOTS = TEAPOT.replace("teapot_scene", "two_teapots")
SMOKE = TEAPOT.replace("teapot_scene", "cornell_smoke")


def _carried(path):
    job = jax_build_scene(jax_load_scene_desc(path))
    scene = convert.scene_from_arrays(jax_scene_arrays(job.scene))
    camera = convert.camera_from_arrays(jax_camera_arrays(job.camera))
    return job, scene, camera


@pytest.fixture(scope="module")
def two_teapots():
    return _carried(TWO_TEAPOTS)


@pytest.fixture(scope="module")
def smoke():
    return _carried(SMOKE)


class LaneBlindNoise(Noise):
    """Noise that gives every lane of a draw the same value: one scalar or
    vector per (purpose, iteration), broadcast over the shape. A path then
    depends on its work item and on nothing the lane order could change, so
    two pools that were permuted differently can be compared item by
    item."""

    def uniform(self, purpose, iteration, shape):
        return np.broadcast_to(super().uniform(purpose, iteration, ()),
                               tuple(shape)).copy()

    def unit_sphere(self, purpose, iteration, shape):
        return np.broadcast_to(super().unit_sphere(purpose, iteration, ()),
                               tuple(shape) + (3,)).copy()

    def in_ball(self, purpose, iteration, shape):
        return np.broadcast_to(super().in_ball(purpose, iteration, ()),
                               tuple(shape) + (3,)).copy()


def _by_item(state, get):
    """The pool's live lanes as {field: array} in work-item order."""
    item = get(state.item)
    order = np.argsort(item, kind="stable")
    order = order[item[order] >= 0]
    return {f: get(getattr(state, f))[order]
            for f in _INT_FIELDS + _FLOAT_FIELDS}


def test_two_teapots_builds_as_the_reference(two_teapots):
    """scenes/two_teapots.yaml built by the port against the JAX build,
    leaf for leaf (ints and the native cluster tables exact, floats within
    1e-6): two transformed instances of the 30-cluster teapot."""
    from hobbyraytracer_tpu_torch.scene import build_scene, load_scene_desc
    from _torch_parity import assert_tree_close
    job, _, _ = two_teapots
    arr_j = jax_scene_arrays(job.scene)
    arr_p = convert.scene_to_arrays(
        build_scene(load_scene_desc(TWO_TEAPOTS)).scene)
    assert_tree_close(arr_p, arr_j)
    meshes = [i["mesh"] for i in arr_p["instances"]]
    assert [m["tri_soa"].shape for m in meshes] == [(30, 24, 128)] * 2
    assert all(i["transform"] is not None for i in arr_p["instances"])
    assert [int(m["mat_id"]) for m in meshes] == [1, 2]


@pytest.mark.parametrize("pool_sort", [0, 1, 2])
def test_two_teapots_segments_match_jax(monkeypatch, two_teapots, pool_sort):
    """6 segments of a 16x16 two_teapots render at 3 spp on a 256-lane
    pool (two K1-routed meshes a segment; the JAX side runs its Pallas
    kernel in interpret mode), by the per-mesh sort (pool_sort 0) and with
    the whole pool permuted every segment (1) and every second segment
    (2).

    pool_sort 0 compares lane for lane under per-lane noise, as
    test_segments_match_jax does for one teapot. A lane is a self-hit lane
    from the segment on in which its ray met its own triangle again at
    t < 1e-4 in one package only; with two meshes they are at most 6% of
    the lanes after 6 segments (3% with one). Every other lane agrees:
    int fields equal, floats allclose (rtol 1e-4); counter equal, retired
    within the self-hit lanes' samples.

    With the pool sort on, a lane comparison holds only while both
    packages compute the same permutation, and they do not: a camera ray
    enters the meshes' box through its max-z face, where XLA's FMAs and
    PyTorch's separate roundings put ~5% of the keys one Morton level apart
    (tests/test_torch_media.py::test_wavefront_sort_key_matches_jax). So
    the keys are compared first on each segment's common state (equal on
    >= 90% of lanes where both pools hold the same item), the noise is
    made blind to the lane (LaneBlindNoise), and the pools are compared
    item by item: the same items live (>= 97% in common), and the
    items that differ in an int field or a float (rtol 1e-4), the
    self-hit items and those that depend on them, stay under 6% of all
    items; counter equal, retired within those items' samples. At the
    end one permuting segment is held against an unpermuted one from the
    same state: every per-lane field moved alike."""
    monkeypatch.setenv("HRT_PALLAS_INTERPRET", "1")
    noise = (LaneBlindNoise if pool_sort else Noise)(17)
    patch_jax_rng(monkeypatch, noise)
    job, scene, camera = two_teapots
    w = h = 16
    spp, pool, max_depth = 3, 256, 50
    _, n_chunks, _ = jwf._chunk_geometry(spp, jwf.SAMPLE_CHUNK)
    total = w * h * n_chunks
    key = jax.random.PRNGKey(0)
    js = jwf.init_state(w, h, pool)
    ps = pwf.init_state(w, h, pool, "cpu")
    sampler = NoiseSampler(noise)
    jget, pget = np.asarray, lambda t: t.numpy()
    bad_items = set()
    self_hit = np.zeros((pool,), bool)
    for seg in range(6):
        js = jwf._regenerate(js, job.camera, w, h, total, key)
        pwf._regenerate(ps, camera, w, h, total, sampler)
        if pool_sort:
            # the keys, on the lanes where both pools hold the same item
            # with the same ray
            same_lane = (jget(js.item) == pget(ps.item)) & np.isclose(
                jget(js.d), pget(ps.d), rtol=1e-4, atol=1e-5).all(axis=1)
            k_j = jget(jir.wavefront_sort_key(
                job.scene, JRays(o=js.o, d=js.d),
                (js.item >= 0) & (js.depth >= 0) & ~js.defer))
            k_p = pget(pir.wavefront_sort_key(
                scene, Rays(o=ps.o, d=ps.d), pwf._active(ps)))
            if seg == 0:
                assert same_lane.all()
            if same_lane.sum() >= 32:
                assert (k_j == k_p)[same_lane].mean() >= 0.90, seg
        if not pool_sort:
            # a self-hit: the bounce ray meets its own triangle again at
            # t ~ 1e-6 in one package only (the sign of such a t is
            # rounding, see test_segments_match_jax)
            t_j = jget(jir.intersect_scene(
                job.scene, JRays(o=js.o, d=js.d), key, js.it,
                mesh_backend="auto").t)
            t_p = pget(pir.intersect_scene(scene, Rays(o=ps.o, d=ps.d)).t)
            self_hit |= pget(pwf._active(ps)) & ((t_j < 1e-4) != (t_p < 1e-4))
        js = jwf._segment(js, job.scene, w, h, key, max_depth, spp,
                          pool_sort=pool_sort)
        pwf._segment(ps, scene, w, h, sampler, max_depth, spp,
                     pool_sort=pool_sort)
        assert ps.it == int(js.it) == seg + 1
        assert int(ps.counter) == int(js.counter), seg
        if not pool_sort:
            # lane for lane (the pools were never permuted)
            assert self_hit.mean() <= 0.06, (seg, self_hit.sum())
            for f in _INT_FIELDS:
                np.testing.assert_array_equal(
                    pget(getattr(ps, f))[~self_hit],
                    jget(getattr(js, f))[~self_hit], err_msg=f"{f} {seg}")
            for f in _FLOAT_FIELDS:
                np.testing.assert_allclose(
                    pget(getattr(ps, f))[~self_hit],
                    jget(getattr(js, f))[~self_hit], rtol=1e-4, atol=1e-5,
                    err_msg=f"{f} after segment {seg}")
            assert abs(int(ps.retired) - int(js.retired)) <= (
                self_hit.sum() * jwf.SAMPLE_CHUNK), seg
            continue
        live_j, live_p = _by_item(js, jget), _by_item(ps, pget)
        common, ij, ip = np.intersect1d(live_j["item"], live_p["item"],
                                        return_indices=True)
        n_live = max(len(live_j["item"]), len(live_p["item"]), 1)
        assert len(common) >= 0.97 * n_live, (seg, len(common), n_live)
        ints_ok = np.ones((len(common),), bool)
        for f in _INT_FIELDS:
            ints_ok &= live_j[f][ij] == live_p[f][ip]
        close = np.ones((len(common),), bool)
        for f in _FLOAT_FIELDS:
            close &= np.isclose(live_p[f][ip], live_j[f][ij], rtol=1e-4,
                                atol=1e-5).all(axis=1)
        bad_items |= set(common[~(ints_ok & close)].tolist())
        bad_items |= set(np.setxor1d(live_j["item"],
                                     live_p["item"]).tolist())
        assert len(bad_items) <= 0.06 * total, (seg, len(bad_items))
        assert abs(int(ps.retired) - int(js.retired)) <= (
            len(bad_items) * jwf.SAMPLE_CHUNK), seg
    assert int(ps.retired) > 0
    if pool_sort:
        # a permuting segment leaves every per-lane field permuted alike:
        # replay one on a copy and compare it, by item, with an unpermuted
        # segment from the same state
        import copy
        a, b = copy.deepcopy(ps), copy.deepcopy(ps)
        a.it = b.it = 6     # a multiple of both periods
        pwf._segment(a, scene, w, h, sampler, max_depth, spp, pool_sort=1)
        pwf._segment(b, scene, w, h, sampler, max_depth, spp, pool_sort=0)
        assert not torch.equal(a.item, b.item)        # it did permute
        la, lb = _by_item(a, pget), _by_item(b, pget)
        for f in _INT_FIELDS + _FLOAT_FIELDS:
            np.testing.assert_array_equal(la[f], lb[f], err_msg=f)
        assert torch.equal(a.fb, b.fb) and int(a.retired) == int(b.retired)


@pytest.mark.parametrize("pool_sort", [0, 1, 2])
def test_smoke_segments_match_jax(monkeypatch, smoke, pool_sort):
    """4 segments of a 16x16 cornell_smoke render at 2 spp on a 192-lane
    pool with identical injected noise (free flights among it). The scene
    has no kernel mesh, so the pool sort does nothing in either package
    and all three periods compare lane for lane. A lane is left out from
    the segment on where its material differs between the packages before
    it (a free flight that ends within rounding of a wall, a ray grazing
    the glass sphere), where its int fields differ, or where its floats
    drift past 2e-3 + 1e-3 |x| (the box is 555 units wide, so t's
    rounding under XLA's FMAs is of that order): at most 6% of the lanes
    after each segment; counter equal; media were met."""
    noise = Noise(19)
    patch_jax_rng(monkeypatch, noise)
    job, scene, camera = smoke
    assert len(scene.media) == 2 and not pir.has_wavefront_sort_key(scene)
    w, h, spp = 16, 16, 2
    pool, max_depth = 192, 50
    _, n_chunks, _ = jwf._chunk_geometry(spp, jwf.SAMPLE_CHUNK)
    total = w * h * n_chunks
    key = jax.random.PRNGKey(0)
    js = jwf.init_state(w, h, pool)
    ps = pwf.init_state(w, h, pool, "cpu")
    sampler = NoiseSampler(noise)
    off = np.zeros((pool,), bool)
    met = set()
    for seg in range(4):
        js = jwf._regenerate(js, job.camera, w, h, total, key)
        pwf._regenerate(ps, camera, w, h, total, sampler)
        hj = jir.intersect_scene(job.scene, JRays(o=js.o, d=js.d), key,
                                 js.it, mesh_backend="auto")
        hp = pir.intersect_scene(scene, Rays(o=ps.o, d=ps.d),
                                 sampler=sampler, bounce=ps.it)
        off |= np.asarray(hj.mat_id) != hp.mat_id.numpy()
        met |= set(hp.mat_id.numpy()[pwf._active(ps).numpy()].tolist())
        js = jwf._segment(js, job.scene, w, h, key, max_depth, spp,
                          pool_sort=pool_sort)
        pwf._segment(ps, scene, w, h, sampler, max_depth, spp,
                     pool_sort=pool_sort)
        assert ps.it == int(js.it) == seg + 1
        assert int(ps.counter) == int(js.counter), seg
        for f in _INT_FIELDS:
            off |= np.asarray(getattr(js, f)) != getattr(ps, f).numpy()
        for f in _FLOAT_FIELDS:
            a, b = getattr(ps, f).numpy(), np.asarray(getattr(js, f))
            off |= (np.abs(a - b) > 2e-3 + 1e-3 * np.abs(b)).any(axis=1)
        assert off.mean() <= 0.06, (seg, off.sum())
    if not off.any():
        assert int(ps.retired) == int(js.retired)
    assert met & {6, 7}, met        # a phase material was met


def test_pool_sort_env_is_read_at_import():
    """HRT_POOL_SORT is read once at import in both packages (0 when unset
    or empty); render calls read the module attribute at call time."""
    import os
    import subprocess
    import sys
    code = ("import jax; jax.config.update('jax_platforms', 'cpu')\n"
            "from hobbyraytracer_tpu.integrator import wavefront as j\n"
            "from hobbyraytracer_tpu_torch.integrator import wavefront as p\n"
            "print('POOL_SORT', j.POOL_SORT, p.POOL_SORT)\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for value, want in (("3", "3 3"), ("", "0 0")):
        env = dict(os.environ, HRT_POOL_SORT=value, PYTHONPATH=root)
        out = subprocess.run([sys.executable, "-c", code], env=env,
                             capture_output=True, text=True, timeout=300)
        assert f"POOL_SORT {want}" in out.stdout, out.stdout + out.stderr


def test_pool_sort_attribute_is_read_at_call_time(monkeypatch, two_teapots):
    """pool_sort=None reads wavefront.POOL_SORT when the segment runs: with
    it set to 1 the pool is permuted and the mesh finds skip their sort
    (coherence_key is never called); an explicit 0 overrides it."""
    _, scene, camera = two_teapots
    calls = []
    real = pisect.coherence_key
    monkeypatch.setattr(pisect, "coherence_key", lambda *a, **k: (
        calls.append(1), real(*a, **k))[1])
    sampler = Sampler(3, "cpu")
    w = h = 8

    def one_segment(**kw):
        st = pwf.init_state(w, h, 64, "cpu")
        pwf._regenerate(st, camera, w, h, w * h, sampler)
        pwf._segment(st, scene, w, h, sampler, 50, 1, **kw)
        return st

    plain_order = one_segment().item.clone()
    assert len(calls) == 2                     # one per mesh instance
    monkeypatch.setattr(pwf, "POOL_SORT", 1)
    sorted_order = one_segment().item
    assert len(calls) == 2                     # none added
    assert not torch.equal(sorted_order, plain_order)
    assert torch.equal(one_segment(pool_sort=0).item, plain_order)
    assert len(calls) == 4


@pytest.mark.parametrize("scene_name,pool_sort", [
    ("two_teapots", 0), ("two_teapots", 2), ("smoke", 0)])
def test_new_scenes_render_match_jax_statistically(two_teapots, smoke,
                                                   scene_name, pool_sort):
    """20x20 @ 16 spp through both wavefront renderers with independent
    random streams: image means within 10%, and every sample retires with
    the pool sort on as well."""
    job, scene, camera = two_teapots if scene_name == "two_teapots" else smoke
    w = h = 20
    spp = 16
    img_j = np.asarray(jwf.render_image(job.scene, job.camera, w, h, spp,
                                        jax.random.PRNGKey(0), max_depth=10,
                                        pool=1024))
    seen = []
    img_p = pwf.render_image(scene, camera, w, h, spp, Sampler(1, "cpu"),
                             max_depth=10, pool=1024, pool_sort=pool_sort,
                             progress_cb=lambda r, t: seen.append((r, t))
                             ).numpy()
    assert seen[-1] == (w * h * spp, w * h * spp)
    assert img_p.shape == img_j.shape == (h, w, 3)
    assert np.isfinite(img_p).all()
    mj, mp = img_j.mean(), img_p.mean()
    assert abs(mp - mj) / mj < 0.10, (mp, mj)


# --- the graph route (integrator/wavefront.py:_pool_run) --------------------

_STATE_FIELDS = ("fb", "o", "d", "thr", "rad", "item", "depth", "sub",
                 "defer", "counter", "retired")


def _clone(state, it):
    return dataclasses.replace(
        state, it=it, **{f: getattr(state, f).clone() for f in _STATE_FIELDS})


def _block_args(scene, camera, spp, steps, pool_sort=0):
    w = h = 16
    _, n_chunks, _ = pwf._chunk_geometry(spp, pwf.SAMPLE_CHUNK)
    return (scene, camera, w, h, spp, Sampler(3, "cpu"),
            range(w * h * n_chunks), steps, 50, pwf.SAMPLE_CHUNK, True,
            pool_sort)


@pytest.mark.parametrize("name", ["teapot", "two_teapots"])
def test_block_with_device_iteration_reads_no_host(monkeypatch, request,
                                                   name):
    """One _issue_block of 4 iterations (16x16 at 2 spp, a 192-lane pool
    two blocks into the render; two_teapots with pool_sort=0) with `it` a
    0-d int32 tensor, as a captured block runs it: no host read outside the
    kernel wrappers, and the state bit for bit the host-int block's, `it`
    advanced in place to the same value."""
    _, scene, camera = request.getfixturevalue(name)
    ref = pwf.init_state(16, 16, 192, "cpu")
    for _ in range(2):
        pwf._issue_block(ref, *_block_args(scene, camera, 2, 3))
    it = torch.tensor(ref.it, dtype=torch.int32)
    dev = _clone(ref, it)
    with no_host_reads(monkeypatch):
        counts_d = pwf._issue_block(dev, *_block_args(scene, camera, 2, 4))
    counts_h = pwf._issue_block(ref, *_block_args(scene, camera, 2, 4))
    assert dev.it is it and int(it) == ref.it
    assert [int(c) for c in counts_d] == [int(c) for c in counts_h]
    for f in _STATE_FIELDS:
        assert torch.equal(getattr(dev, f), getattr(ref, f)), f
    assert int(ref.retired) > 0


def test_static_block_keeps_the_state_s_buffers(teapot):
    """_static_block (what a graph captures) run block after block, the
    iteration tensor set from the host int before each as a replay sets
    it: the state's tensors stay the same objects and equal the eager
    blocks' bit for bit."""
    _, scene, camera = teapot
    eager = pwf.init_state(16, 16, 192, "cpu")
    pwf._issue_block(eager, *_block_args(scene, camera, 2, 3))
    static = _clone(eager, eager.it)
    buffers = {f: getattr(static, f) for f in _STATE_FIELDS}
    it = torch.zeros((), dtype=torch.int32)
    for _ in range(3):
        counts_e = pwf._issue_block(eager, *_block_args(scene, camera, 2, 3))
        it.fill_(static.it)
        counts_s = pwf._static_block(static, it, lambda st: pwf._issue_block(
            st, *_block_args(scene, camera, 2, 3)))
        static.it += len(counts_s)
        assert [int(c) for c in counts_s] == [int(c) for c in counts_e]
    assert static.it == eager.it == int(it)
    for f in _STATE_FIELDS:
        assert getattr(static, f) is buffers[f], f
        assert torch.equal(getattr(static, f), getattr(eager, f)), f


def test_graph_route_is_chosen_by_rule(monkeypatch, tmp_path, teapot,
                                       two_teapots, balls, smoke):
    """graph_route: a CUDA device and a segment that reads no host value.
    The CPU, either comparison switch (kernels/build.py:plain_versions,
    eager), a pool sort on a scene with a kernel mesh (by the argument or
    POOL_SORT) and a medium bounded by a clustered mesh (the lockstep
    find) run eagerly; a period on a scene without a kernel mesh sorts
    nothing and keeps the graph. On the CPU render_state never captures,
    under eager() or not."""
    from hobbyraytracer_tpu_torch.scene import build_scene, load_scene_desc
    cuda = torch.device("cuda")
    for job in (teapot, two_teapots, balls, smoke):
        assert pwf.graph_route(job[1], cuda)
        assert not pwf.graph_route(job[1], "cpu")
        for switch in (kbuild.plain_versions, kbuild.eager):
            with switch():
                assert not pwf.graph_route(job[1], cuda)
        assert pwf.graph_route(job[1], cuda)
    assert not pwf.graph_route(two_teapots[1], cuda, pool_sort=2)
    assert pwf.graph_route(two_teapots[1], cuda, pool_sort=0)
    assert pwf.graph_route(balls[1], cuda, pool_sort=2)
    monkeypatch.setattr(pwf, "POOL_SORT", 3)
    assert not pwf.graph_route(teapot[1], cuda)
    assert pwf.graph_route(teapot[1], cuda, pool_sort=0)
    monkeypatch.setattr(pwf, "POOL_SORT", 0)
    path = tmp_path / "fog.yaml"
    path.write_text(FOG_YAML % TEAPOT.replace(
        "scenes/teapot_scene.yaml", "assets/teapot.obj"))
    fog = build_scene(load_scene_desc(str(path))).scene
    assert pir.finds_read_host(fog) and not pwf.graph_route(fog, cuda)
    assert not any(pir.finds_read_host(j[1])
                   for j in (teapot, two_teapots, balls, smoke))

    def no_graph(*args, **kwargs):
        raise AssertionError("captured a graph on the CPU")

    monkeypatch.setattr(pwf, "_BlockGraph", no_graph)
    _, scene, camera = teapot

    def render():
        return pwf.render_state(scene, camera, 8, 8, 2, Sampler(0, "cpu"),
                                max_depth=4, pool=64, steps_per_call=2)

    states = [render()]
    with kbuild.eager():
        states.append(render())
    for f in _STATE_FIELDS:
        assert torch.equal(getattr(states[0], f), getattr(states[1], f))
