"""The port's thin lens (core/rng.py:Sampler.in_disk, ops/camera.py
use_lens and get_rays(sampler, iteration, span), the lens draw of
integrator/wavefront.py:_regenerate, integrator/path.py:sample_radiance and
diff/fit.py:render_linear_slice) against the JAX package's.

The draws are injected into both packages (tests/_torch_parity.py: the
port's NoiseSampler.in_disk, the JAX package's rng.in_disk routed to the
same noise, the already streamed (LENS, it) key of the wavefront kept):

- get_rays with the lens on: origins and directions allclose (rtol and
  atol 1e-6) to JAX's, with and without a span; with the lens off, or no
  sampler, the pinhole rays exactly;
- wavefront segments of a lens camera state for state against JAX, with
  the tolerances of tests/test_torch_wavefront.py;
- render_linear_slice with the lens: bitwise the rows of render_linear,
  and allclose to JAX's (rtol 1e-4, atol 1e-6, the fit tests' render
  tolerance); the batch integrator's pixel slice bitwise the rows of its
  whole image.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hobbyraytracer_tpu.core import rng as jrng
from hobbyraytracer_tpu.diff import fit as jfit
from hobbyraytracer_tpu.integrator import wavefront as jwf
from hobbyraytracer_tpu.ops import camera as jcam
from hobbyraytracer_tpu.scene import build_scene as jax_build_scene
from hobbyraytracer_tpu.scene import load_scene_desc as jax_load_scene_desc
from hobbyraytracer_tpu_torch.core import rng as prng
from hobbyraytracer_tpu_torch.core.rng import Sampler
from hobbyraytracer_tpu_torch.diff import fit as pfit
from hobbyraytracer_tpu_torch.integrator import path as ppath
from hobbyraytracer_tpu_torch.integrator import wavefront as pwf
from hobbyraytracer_tpu_torch.ops import camera as pcam
from hobbyraytracer_tpu_torch.scene import convert

from _torch_parity import (SCENES, TEAPOT, Noise, NoiseSampler,
                           jax_camera_arrays, jax_scene_arrays,
                           patch_jax_fit_rng, patch_jax_rng)

torch.set_num_threads(2)

CORNELL = f"{SCENES}/cornell_box.yaml"
LENS_RADIUS = 0.1


def _lens_job(path):
    """The JAX build of a scene with the lens on at LENS_RADIUS, and the
    port's scene and camera carried across."""
    job = jax_build_scene(jax_load_scene_desc(path))
    jcamera = job.camera.replace(use_lens=True,
                                 lens_radius=jnp.float32(LENS_RADIUS))
    camera = convert.camera_from_arrays(jax_camera_arrays(jcamera))
    assert camera.use_lens
    return job, jcamera, convert.scene_from_arrays(
        jax_scene_arrays(job.scene)), camera


@pytest.fixture(scope="module")
def teapot_lens():
    return _lens_job(TEAPOT)


@pytest.fixture(scope="module")
def cornell_lens():
    return _lens_job(CORNELL)


def test_in_disk_draw():
    """A (2,) + shape draw: points inside the unit disk, spread over it, a
    span the rows of the whole draw bit for bit, one stream a (purpose,
    iteration)."""
    s = Sampler(3, "cpu")
    full = s.in_disk(prng.LENS, 5, (4096,))
    assert full.shape == (4096, 2) and full.dtype == torch.float32
    r = full.norm(dim=-1)
    assert bool((r <= 1.0).all()) and float(r.max()) > 0.99
    assert abs(float((r < 2 ** -0.5).float().mean()) - 0.5) < 0.03
    assert torch.equal(s.in_disk(prng.LENS, 5, (100,), span=(17, 4096)),
                       full[17:117])
    assert torch.equal(Sampler(3, "cpu").in_disk(prng.LENS, 5, (4096,)),
                       full)
    assert not torch.equal(s.in_disk(prng.LENS, 6, (4096,)), full)


@pytest.mark.parametrize("span", [None, (30, 500)])
def test_get_rays_lens_matches_jax(monkeypatch, teapot_lens, span):
    """The lens's origins and directions against JAX's get_rays under the
    same in_disk noise, at iteration 4; the pinhole rays when the lens is
    off or no sampler is given."""
    job, jcamera, _, camera = teapot_lens
    noise = Noise(12)
    patch_jax_rng(monkeypatch, noise)
    n = 500 if span is None else 200
    rng = np.random.default_rng(0)
    s, t = (rng.uniform(-0.1, 1.1, n).astype(np.float32) for _ in "st")
    key = jrng.stream(jax.random.PRNGKey(0), jrng.LENS, 4)
    rj = jcam.get_rays(jcamera, jnp.asarray(s), jnp.asarray(t), key=key,
                       span=span)
    sampler = NoiseSampler(noise)
    rp = pcam.get_rays(camera, torch.from_numpy(s), torch.from_numpy(t),
                       sampler, 4, span)
    np.testing.assert_allclose(rp.o.numpy(), np.asarray(rj.o), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(rp.d.numpy(), np.asarray(rj.d), rtol=1e-6,
                               atol=1e-6)
    off = np.linalg.norm(rp.o.numpy() - camera.origin.numpy(), axis=1)
    assert off.max() <= LENS_RADIUS * (1 + 1e-5) and off.mean() > 0.03
    pinhole = pcam.get_rays(camera, torch.from_numpy(s),
                            torch.from_numpy(t))
    camera.use_lens = False
    try:
        no_lens = pcam.get_rays(camera, torch.from_numpy(s),
                                torch.from_numpy(t), sampler, 4, span)
    finally:
        camera.use_lens = True
    for r in (pinhole, no_lens):
        rj0 = jcam.get_rays(job.camera, jnp.asarray(s), jnp.asarray(t))
        np.testing.assert_array_equal(r.o.numpy(), np.asarray(rj0.o))
        np.testing.assert_allclose(r.d.numpy(), np.asarray(rj0.d),
                                   rtol=1e-6, atol=1e-6)


def test_make_camera_takes_use_lens():
    """make_camera(..., use_lens=True) against the JAX package's: the same
    basis and lens radius, the flag carried through convert both ways."""
    args = ((0, 2.5, 8.5), (0, 2.5, 0), (0, 1, 0), 45, 1.0, 0.2, 8.5)
    cp = pcam.make_camera(*args, use_lens=True)
    cj = jcam.make_camera(*args, use_lens=True)
    assert cp.use_lens and not pcam.make_camera(*args).use_lens
    arr = convert.camera_to_arrays(cp)
    ref = jax_camera_arrays(cj)
    assert arr["use_lens"] is True and ref["use_lens"] is True
    for f in convert.CAMERA_FIELDS:
        np.testing.assert_array_equal(arr[f], ref[f])
    assert convert.camera_from_arrays(arr).use_lens


_INT_FIELDS = ("item", "depth", "sub", "defer")
_FLOAT_FIELDS = ("o", "d", "thr", "rad")


def test_lens_segments_match_jax(monkeypatch, teapot_lens):
    """4 segments of a 16x16 render at 2 spp on a 256-lane pool with the
    lens on: after each _regenerate the fresh lanes' camera rays allclose
    (rtol 1e-5, atol 1e-6), the lens draw of iteration `it` being the
    port's (LENS, it); after each segment the state as
    tests/test_torch_wavefront.py::test_segments_match_jax holds it (int
    fields equal on >= 99% of lanes, floats allclose rtol 1e-4 on those
    lanes apart from self-hits, fb allclose apart from their pixels)."""
    monkeypatch.setenv("HRT_PALLAS_INTERPRET", "1")
    noise = Noise(21)
    patch_jax_rng(monkeypatch, noise)
    job, jcamera, scene, camera = teapot_lens
    w = h = 16
    pool, max_depth, spp = 256, 50, 2
    _, n_chunks, _ = jwf._chunk_geometry(spp, jwf.SAMPLE_CHUNK)
    total = w * h * n_chunks
    key = jax.random.PRNGKey(0)
    js = jwf.init_state(w, h, pool)
    ps = pwf.init_state(w, h, pool, "cpu")
    sampler = NoiseSampler(noise)
    self_hit = np.zeros((pool,), bool)
    bad_px = np.zeros((w * h,), bool)
    moved = 0
    for seg in range(4):
        # lanes taking a camera ray in both packages (not a lane that a
        # self-hit sent another way)
        fresh = ((np.asarray(js.item) < 0) | (np.asarray(js.depth) < 0)) & (
            (ps.item.numpy() < 0) | (ps.depth.numpy() < 0)) & ~self_hit
        js = jwf._regenerate(js, jcamera, w, h, total, key)
        pwf._regenerate(ps, camera, w, h, total, sampler)
        fresh &= (np.asarray(js.item) >= 0) & (np.asarray(js.item)
                                               == ps.item.numpy())
        for f in ("o", "d"):
            np.testing.assert_allclose(
                getattr(ps, f).numpy()[fresh],
                np.asarray(getattr(js, f))[fresh], rtol=1e-5, atol=1e-6,
                err_msg=f"camera rays' {f}, segment {seg}")
        moved += int((np.abs(ps.o.numpy()[fresh] - camera.origin.numpy())
                      .max(axis=1) > 1e-3).sum())
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
        self_hit |= active & (np.asarray(js.depth) > 0) & (stay_j != stay_p)
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
        off = self_hit | ~agree
        bad_px[item_j[off & (item_j >= 0)] % (w * h)] = True
        bad_px[item_p[off & (item_p >= 0)] % (w * h)] = True
        assert bad_px.mean() <= 0.05, (seg, bad_px.sum())
        np.testing.assert_allclose(ps.fb.numpy()[:, ~bad_px],
                                   np.asarray(js.fb)[:, ~bad_px],
                                   rtol=1e-4, atol=1e-5)
    assert moved > pool   # the lens moved the camera rays' origins
    assert int(ps.retired) > 0


@pytest.mark.parametrize("pix0,n_pix", [(64, 32), (160, 96)])
def test_lens_render_linear_slice_is_rows(cornell_lens, pix0, n_pix):
    """16x16, 2 spp, depth 3, the lens on: the slice equals those rows of
    render_linear bit for bit (slices of whole 32-element vectors, as in
    tests/test_torch_shard.py), and the lens changed the image."""
    _, _, scene, camera = cornell_lens
    s = Sampler(5, "cpu")
    with torch.no_grad():
        full = pfit.render_linear(scene, camera, 16, 16, s, 2, 3)
        part = pfit.render_linear_slice(scene, camera, 16, 16, s, 2, pix0,
                                        n_pix, 3)
        camera.use_lens = False
        try:
            pinhole = pfit.render_linear(scene, camera, 16, 16, s, 2, 3)
        finally:
            camera.use_lens = True
    assert torch.equal(part, full[pix0:pix0 + n_pix])
    assert not torch.equal(full, pinhole)


def test_lens_render_linear_slice_matches_jax(monkeypatch, cornell_lens):
    """cornell_box 16x16, 1 spp, depth 3, pixels 96..191, the lens on: the
    port's render_linear_slice against JAX's (eager) under the same
    injected draws, the lens's in_disk(stream(kt, LENS)) among them."""
    job, jcamera, scene, camera = cornell_lens
    key = jax.random.PRNGKey(0)
    noise = Noise(33)
    patch_jax_fit_rng(monkeypatch, noise, key, 1)
    with jax.disable_jit():
        img_j = jfit.render_linear_slice(job.scene, jcamera, 16, 16, key, 1,
                                         96, 96, 3)
    with torch.no_grad():
        img_p = pfit.render_linear_slice(scene, camera, 16, 16,
                                         NoiseSampler(noise), 1, 96, 96, 3)
    np.testing.assert_allclose(img_p.numpy(), np.asarray(img_j), rtol=1e-4,
                               atol=1e-6)
    assert img_p.max() > 0


def test_lens_batch_slice_is_rows(cornell_lens):
    """The batch integrator with the lens: a pixel slice of radiance_sum
    equals those rows of the whole image's bit for bit."""
    _, _, scene, camera = cornell_lens
    s = Sampler(8, "cpu")
    with torch.no_grad():
        full = ppath.radiance_sum(scene, camera, 16, 16, 2, s, max_depth=3)
        part = ppath.radiance_sum(scene, camera, 16, 16, 2, s, max_depth=3,
                                  pix0=128, n_pix=64)
    assert torch.equal(part, full[128:192])
