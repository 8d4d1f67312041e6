"""The port's wavefront main path against the JAX package's, on the teapot
scene carried across from the JAX build (scene/convert.py):

(a) segment for segment, with identical injected noise and the JAX mesh
    find running the Pallas kernel in interpret mode;
(b) statistically, a full render against JAX's wavefront.render_image;
(c) the pool drains exactly, including a partial last sample chunk.
"""
import jax
import numpy as np
import pytest
import torch

from hobbyraytracer_tpu.integrator import wavefront as jwf
from hobbyraytracer_tpu.scene import build_scene as jax_build_scene
from hobbyraytracer_tpu.scene import load_scene_desc as jax_load_scene_desc
from hobbyraytracer_tpu_torch.core.rng import Sampler
from hobbyraytracer_tpu_torch.integrator import wavefront as pwf
from hobbyraytracer_tpu_torch.scene import convert

from _torch_parity import (TEAPOT, Noise, NoiseSampler, jax_camera_arrays,
                           jax_scene_arrays, patch_jax_rng)

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
    job, scene, camera = teapot
    w = h = 16
    pool, max_depth = 256, 50
    _, n_chunks, _ = jwf._chunk_geometry(spp, jwf.SAMPLE_CHUNK)
    total = w * h * n_chunks
    key = jax.random.PRNGKey(0)
    js = jwf.init_state(w, h, pool)
    ps = pwf.init_state(w, h, pool, "cpu")
    sampler = NoiseSampler(noise)
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
