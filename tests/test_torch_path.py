"""The port's batch integrator (integrator/path.py: trace, pixel_grid,
sample_radiance, render_image) against the JAX package's under identical
injected noise, its radiometry against the port's wavefront integrator,
and the CLI's --integrator batch."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hobbyraytracer_tpu.core.types import Rays as JRays
from hobbyraytracer_tpu.integrator import path as jpath
from hobbyraytracer_tpu.ops.camera import get_rays as jax_get_rays
from hobbyraytracer_tpu.scene import build_scene as jax_build_scene
from hobbyraytracer_tpu.scene import load_scene_desc as jax_load_scene_desc
from hobbyraytracer_tpu_torch.core.rng import Sampler
from hobbyraytracer_tpu_torch.core.types import Rays
from hobbyraytracer_tpu_torch.integrator import path as ppath
from hobbyraytracer_tpu_torch.integrator import wavefront as pwf
from hobbyraytracer_tpu_torch.ops.camera import get_rays
from hobbyraytracer_tpu_torch.scene import convert

from _torch_parity import (SCENES, TEAPOT, Noise, NoiseSampler,
                           jax_camera_arrays, jax_scene_arrays, patch_jax_rng)

torch.set_num_threads(2)


def _carried(name):
    job = jax_build_scene(jax_load_scene_desc(f"{SCENES}/{name}.yaml"))
    return (job, convert.scene_from_arrays(jax_scene_arrays(job.scene)),
            convert.camera_from_arrays(jax_camera_arrays(job.camera)))


@pytest.fixture(scope="module")
def teapot():
    return _carried("teapot_scene")


@pytest.fixture(scope="module")
def smoke():
    return _carried("cornell_smoke")


def test_pixel_grid_matches_jax():
    x_p, y_p = ppath.pixel_grid(7, 5, "cpu")
    x_j, y_j = jpath.pixel_grid(7, 5)
    np.testing.assert_array_equal(x_p.numpy(), np.asarray(x_j))
    np.testing.assert_array_equal(y_p.numpy(), np.asarray(y_j))
    assert y_p.max() == 5 and y_p.min() == 1      # the reference's quirk
    assert x_p.dtype == y_p.dtype == torch.float32


@pytest.mark.parametrize("scene_name,backends", [
    ("smoke", ("kernel", "auto")), ("teapot", ("kernel", "auto")),
    ("teapot", ("lockstep", "xla"))])
def test_trace_matches_jax_under_noise(monkeypatch, request, scene_name,
                                       backends):
    """`trace` on a 12x12 wavefront of camera rays, max depth 6, with the
    same injected draws (the stream index is the bounce in both), the JAX
    loop run eagerly: on cornell_smoke (media, the glass sphere), and on
    the teapot by the kernel route (JAX: the Pallas kernel in interpret
    mode) and by the lockstep route (JAX: "xla"). Radiance within 2e-3 +
    1e-3 |x| on >= 92% of the rays: a ray whose path forks by rounding (a
    self-hit on the mesh, a free flight ending at a wall, a graze of the
    sphere) follows another path from there on. The image means agree
    within 5%."""
    monkeypatch.setenv("HRT_PALLAS_INTERPRET", "1")
    noise = Noise(23)
    patch_jax_rng(monkeypatch, noise)
    job, scene, camera = request.getfixturevalue(scene_name)
    w = h = 12
    x, y = ppath.pixel_grid(w, h, "cpu")
    s, t = (x + 0.5) / (w - 1), (y + 0.5) / (h - 1)
    rp = get_rays(camera, s, t)
    rj = jax_get_rays(job.camera, jnp.asarray(s.numpy()),
                      jnp.asarray(t.numpy()))
    np.testing.assert_allclose(rp.d.numpy(), np.asarray(rj.d), rtol=1e-5,
                               atol=1e-6)
    rad_p = ppath.trace(scene, rp, NoiseSampler(noise), max_depth=6,
                        mesh_backend=backends[0]).numpy()
    with jax.disable_jit():
        rad_j = np.asarray(jpath.trace(job.scene, JRays(o=rj.o, d=rj.d),
                                       jax.random.PRNGKey(0), max_depth=6,
                                       mesh_backend=backends[1]))
    assert rad_p.shape == rad_j.shape == (w * h, 3)
    assert np.isfinite(rad_p).all() and rad_p.max() > 0
    close = (np.abs(rad_p - rad_j) <= 2e-3 + 1e-3 * np.abs(rad_j)).all(axis=1)
    assert close.mean() >= 0.92, close.mean()
    assert abs(rad_p.mean() - rad_j.mean()) <= 0.05 * rad_j.mean()


def test_trace_stops_when_no_ray_is_active(monkeypatch, teapot):
    """The bounce loop ends at the first bounce that finds no active ray:
    rays that all miss take one intersect_scene call, not max_depth."""
    from hobbyraytracer_tpu_torch.scene import ir as pir
    _, scene, _ = teapot
    calls = []
    real = pir.intersect_scene
    monkeypatch.setattr(pir, "intersect_scene", lambda *a, **k: (
        calls.append(k["bounce"]), real(*a, **k))[1])
    up = Rays(o=torch.tensor([[0.0, 100.0, 0.0]] * 4),
              d=torch.tensor([[0.0, 1.0, 0.0]] * 4))
    rad = ppath.trace(scene, up, Sampler(0, "cpu"), max_depth=50)
    assert calls == [0]
    assert (rad > 0).all()              # the environment's radiance
    calls.clear()
    ppath.trace(scene, up, Sampler(0, "cpu"), max_depth=0)
    assert calls == []


@pytest.mark.parametrize("scene_name", ["teapot", "smoke"])
def test_batch_matches_wavefront_radiometry(request, scene_name):
    """The reference's radiometry check (tests/test_wavefront.py) on the
    port: the batch integrator and the wavefront integrator without
    Russian roulette estimate the same image, so their means agree within
    10% at 24x24 @ 16 spp, max depth 8."""
    _, scene, camera = request.getfixturevalue(scene_name)
    w = h = 24
    spp = 16
    a = ppath.render_image(scene, camera, w, h, spp, Sampler(0, "cpu"),
                           max_depth=8).numpy()
    b = pwf.render_image(scene, camera, w, h, spp, Sampler(1, "cpu"),
                         max_depth=8, pool=2048, rr=False).numpy()
    assert a.shape == b.shape == (h, w, 3)
    assert np.isfinite(a).all() and 0.0 <= a.min() and a.max() <= 1.0
    assert abs(a.mean() - b.mean()) / b.mean() < 0.10, (a.mean(), b.mean())


def test_render_matches_jax_statistically(teapot):
    """24x24 @ 16 spp through both batch integrators with independent
    streams: image means within 10%."""
    job, scene, camera = teapot
    w = h = 24
    img_j = np.asarray(jpath.render_image(job.scene, job.camera, w, h, 16,
                                          jax.random.PRNGKey(0), max_depth=8))
    img_p = ppath.render_image(scene, camera, w, h, 16, Sampler(2, "cpu"),
                               max_depth=8).numpy()
    assert abs(img_p.mean() - img_j.mean()) / img_j.mean() < 0.10


def test_sample_chunks_and_progress(teapot):
    """sample_chunk splits the samples (7 = 3 + 3 + 1), progress_cb fires
    once a chunk with the samples done so far, one chunk reports its
    completion only; the chunks draw from streams of their own, and the
    same seed gives the same image."""
    _, scene, camera = teapot
    w = h = 8
    seen = []
    img = ppath.render_image(scene, camera, w, h, 7, Sampler(5, "cpu"),
                             max_depth=4, sample_chunk=3,
                             progress_cb=lambda d, t: seen.append((d, t)))
    assert seen == [(64 * 3, 64 * 7), (64 * 6, 64 * 7), (64 * 7, 64 * 7)]
    again = ppath.render_image(scene, camera, w, h, 7, Sampler(5, "cpu"),
                               max_depth=4, sample_chunk=3)
    assert torch.equal(img, again)
    seen.clear()
    whole = ppath.render_image(scene, camera, w, h, 7, Sampler(5, "cpu"),
                               max_depth=4,
                               progress_cb=lambda d, t: seen.append((d, t)))
    assert seen == [(64 * 7, 64 * 7)]
    assert not torch.equal(img, whole)
    # samples of one chunk differ from one another
    one = ppath.sample_radiance(scene, camera, w, h, Sampler(5, "cpu"), 1,
                                max_depth=4)
    two = ppath.sample_radiance(scene, camera, w, h, Sampler(5, "cpu"), 2,
                                max_depth=4)
    assert not torch.allclose(two, 2.0 * one)


def test_sampler_fold_in():
    s = Sampler(9, "cpu")
    a, b = s.fold_in(0), s.fold_in(1)
    assert a.key != b.key != s.key and a.device == s.device
    assert a.key == Sampler(9, "cpu").fold_in(0).key
    assert not torch.equal(a.uniform(0, 0, (8,)), b.uniform(0, 0, (8,)))
    assert not torch.equal(a.uniform(0, 0, (8,)), s.uniform(0, 0, (8,)))


@pytest.mark.parametrize("scene", ["teapot_scene", "cornell_smoke"])
def test_cli_batch_integrator_on_cpu(tmp_path, capsys, scene):
    """`render --integrator batch --device cpu` writes the image and
    prints the rays/s line; --chunk splits the samples."""
    from hobbyraytracer_tpu.io.images import read_png
    from hobbyraytracer_tpu_torch.cli.main import main
    out = tmp_path / "batch.png"
    rc = main(["render", f"{SCENES}/{scene}.yaml", "-o", str(out), "--spp",
               "3", "--width", "10", "--height", "8", "--max-depth", "4",
               "--integrator", "batch", "--chunk", "2", "--device", "cpu"])
    assert rc == 0
    text = capsys.readouterr().out
    assert "primary rays/s on cpu" in text
    assert "Pixels rendered: 80/80" in text
    img = read_png(str(out))
    assert img.shape == (8, 10, 3) and img.max() > 0


def test_cli_rejects_unknown_integrator():
    from hobbyraytracer_tpu_torch.cli.main import main
    with pytest.raises(SystemExit):
        main(["render", TEAPOT, "--integrator", "bidirectional"])
