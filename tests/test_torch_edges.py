"""The port's edge-sampled boundary gradients (diff/edges.py) against the
JAX package's, with the same edge picks and positions (jax.random.randint
and jax.random.uniform monkeypatched on the JAX side, a NoiseSampler on the
port's), and the port's primary term against finite differences, on the
scenes of tests/test_edges.py."""
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from hobbyraytracer_tpu.core.types import Rays as JRays
from hobbyraytracer_tpu.diff import edges as jedges
from hobbyraytracer_tpu.integrator import path as jpath
from hobbyraytracer_tpu.scene import build_scene as jax_build_scene
from hobbyraytracer_tpu.scene import ir as jir
from hobbyraytracer_tpu.scene import load_scene_desc as jax_load_scene_desc
from hobbyraytracer_tpu_torch.core import rng as prng
from hobbyraytracer_tpu_torch.core.rng import Sampler
from hobbyraytracer_tpu_torch.core.types import Rays
from hobbyraytracer_tpu_torch.diff import edges as pedges
from hobbyraytracer_tpu_torch.integrator import path as ppath
from hobbyraytracer_tpu_torch.ops.camera import get_rays
from hobbyraytracer_tpu_torch.scene import convert
from hobbyraytracer_tpu_torch.scene import ir as pir

from _torch_parity import (TEAPOT, Noise, NoiseSampler, jax_camera_arrays,
                           jax_scene_arrays, patch_jax_rng)

torch.set_num_threads(2)

W = H = 32
KEY = jax.random.PRNGKey(0)

# tests/test_edges.py:26 (one constant-emissive triangle: the image's
# vertex gradient is all boundary term) and :175 (a blocker outside the
# frame whose shadow falls on the visible floor)
TRIANGLE_YAML = """
film: {width: 32, height: 32, samples: 8, output: tri.png}
camera:
  position: [0, 0, -3]
  look_at: [0, 0, 0]
  up: [0, 1, 0]
  fov: 45
  aperture: 0.0
  focal_distance: 3
  background: [0.05, 0.1, 0.2]
materials:
  - {name: glow, type: diffuse_light, albedo: [1.0, 0.8, 0.5], strength: 2.0}
objects:
  - type: triangle
    v0: [-0.8, -0.6, 0]
    v1: [0.9, -0.5, 0]
    v2: [0.0, 0.9, 0]
    material: glow
"""
SHADOW_YAML = """
film: {width: 32, height: 32, samples: 8, output: sh.png}
camera:
  position: [0, 4, 0.001]
  look_at: [0, 0, 0]
  up: [0, 0, 1]
  fov: 40
  aperture: 0.0
  focal_distance: 4
  background: [0.0, 0.0, 0.0]
materials:
  - {name: ground, type: lambertian, albedo: [0.8, 0.8, 0.8]}
  - {name: lamp, type: diffuse_light, albedo: [1.0, 1.0, 1.0], strength: 25}
objects:
  - {type: xz_rect, x: [-3, 3], z: [-3, 3], k: 0, material: ground}
  - {type: xz_rect, x: [1.7, 2.3], z: [-0.3, 0.3], k: 3, material: lamp}
  - type: triangle
    v0: [1.05, 1.5, -0.5]
    v1: [1.6, 1.5, 0.0]
    v2: [1.05, 1.5, 0.5]
    material: ground
"""
LIGHT = (2.0, 3.0, 0.0)


def _both(yaml_text):
    with tempfile.NamedTemporaryFile("w", suffix=".yaml",
                                     delete=False) as f:
        f.write(yaml_text)
        path = f.name
    try:
        job = jax_build_scene(jax_load_scene_desc(path))
    finally:
        os.unlink(path)
    return (job, convert.scene_from_arrays(jax_scene_arrays(job.scene)),
            convert.camera_from_arrays(jax_camera_arrays(job.camera)))


@pytest.fixture(scope="module")
def triangle():
    return _both(TRIANGLE_YAML)


@pytest.fixture(scope="module")
def shadow():
    return _both(SHADOW_YAML)


def _mesh(scene):
    return next(i for i in scene.instances if i.kind == "mesh").mesh


def test_edge_table_project_and_silhouettes_match_jax():
    """build_edge_table, project and silhouette_mask on the teapot mesh
    seen from the teapot scene's camera (and from a point light)."""
    job = jax_build_scene(jax_load_scene_desc(TEAPOT))
    mj = _mesh(job.scene)
    idx = np.array(mj.indices)
    e_p, f_p = pedges.build_edge_table(idx)
    e_j, f_j = jedges.build_edge_table(idx)
    np.testing.assert_array_equal(e_p, e_j)
    np.testing.assert_array_equal(f_p, f_j)
    assert e_p.dtype == f_p.dtype == np.int32 and (f_p[:, 1] >= -1).all()
    cam = convert.camera_from_arrays(jax_camera_arrays(job.camera))
    verts = np.array(mj.verts)
    np.testing.assert_allclose(
        pedges.project(cam, torch.from_numpy(verts)).numpy(),
        np.asarray(jedges.project(job.camera, mj.verts)), rtol=1e-5,
        atol=1e-6)
    for origin in (np.array(job.camera.origin), np.float32([2, 3, 0])):
        sil_p = pedges.silhouette_mask(
            torch.from_numpy(verts), torch.from_numpy(idx),
            torch.from_numpy(e_p), torch.from_numpy(f_p),
            torch.from_numpy(origin))
        sil_j = jedges.silhouette_mask(mj.verts, mj.indices,
                                       jnp.asarray(e_j), jnp.asarray(f_j),
                                       jnp.asarray(origin))
        np.testing.assert_array_equal(sil_p.numpy(), np.asarray(sil_j))
        assert 0 < sil_p.sum() < len(sil_p)


def _inject_edge_draws(monkeypatch, noise, key):
    """jax.random.randint / uniform on fold_in(key, tag) for the four
    edge-sampling tags draw `noise`'s (tag, 0) streams, as the port's
    NoiseSampler does; every other key draws as before."""
    tags = {np.asarray(jax.random.fold_in(key, t)).tobytes(): t
            for t in (prng.EDGE_PICK, prng.EDGE_S, prng.EDGE_PICK_SH,
                      prng.EDGE_S_SH)}
    real_randint, real_uniform = jax.random.randint, jax.random.uniform

    def randint(k, shape, minval, maxval, *a, **kw):
        tag = tags.get(np.asarray(k).tobytes())
        if tag is None:
            return real_randint(k, shape, minval, maxval, *a, **kw)
        return jnp.asarray(minval + noise.randint(tag, 0, shape,
                                                  maxval - minval))

    def uniform(k, shape=(), *a, **kw):
        tag = tags.get(np.asarray(k).tobytes())
        if tag is None:
            return real_uniform(k, shape, *a, **kw)
        return jnp.asarray(noise.uniform(tag, 0, shape))

    monkeypatch.setattr(jax.random, "randint", randint)
    monkeypatch.setattr(jax.random, "uniform", uniform)


def _weight(seed):
    return np.random.default_rng(seed).uniform(0.2, 1.0, (H, W, 3)).astype(
        np.float32)


def test_boundary_grad_matches_jax(monkeypatch, triangle):
    """boundary_grad on the emissive triangle, 4096 samples, radiance by
    the forward integrator at depth 2 (noise injected in both): the
    vertex gradients within rtol 1e-3."""
    job, scene, cam = triangle
    noise = Noise(21)
    patch_jax_rng(monkeypatch, noise)
    _inject_edge_draws(monkeypatch, noise, KEY)
    mj = _mesh(job.scene)
    e, f = jedges.build_edge_table(np.asarray(mj.indices))
    weight = _weight(0)
    sampler = NoiseSampler(noise)
    g_p = pedges.boundary_grad(
        _mesh(scene).verts, torch.from_numpy(e), torch.from_numpy(f),
        _mesh(scene).indices, cam, torch.from_numpy(weight), W, H,
        lambda r: ppath.trace(scene, r, sampler, max_depth=2), sampler,
        n_samples=4096)
    with jax.disable_jit():
        g_j = jedges.boundary_grad(
            mj.verts, jnp.asarray(e), jnp.asarray(f), mj.indices,
            job.camera, jnp.asarray(weight), W, H,
            lambda r: jpath.trace(job.scene, r, KEY, max_depth=2), KEY,
            n_samples=4096)
    assert np.abs(g_p.numpy()).max() > 1.0
    np.testing.assert_allclose(g_p.numpy(), np.asarray(g_j), rtol=1e-3,
                               atol=1e-3)


def test_shadow_boundary_grad_matches_jax(monkeypatch, shadow):
    """shadow_boundary_grad of the off-screen blocker, 4096 samples,
    eps_px 4, the receiver found by each package's scene find and the
    radiance by its forward integrator at depth 2 with the same injected
    noise: the vertex gradients within rtol 1e-3 of their largest."""
    job, scene, cam = shadow
    noise = Noise(22)
    patch_jax_rng(monkeypatch, noise)
    _inject_edge_draws(monkeypatch, noise, KEY)
    mj = _mesh(job.scene)
    e, f = jedges.build_edge_table(np.asarray(mj.indices))
    weight = _weight(1)
    sampler = NoiseSampler(noise)
    g_p = pedges.shadow_boundary_grad(
        _mesh(scene).verts, torch.from_numpy(e), torch.from_numpy(f),
        _mesh(scene).indices, torch.tensor(LIGHT), cam,
        torch.from_numpy(weight), W, H,
        lambda r: ppath.trace(scene, r, sampler, max_depth=2),
        lambda r: pir.intersect_scene(scene, r, sampler=sampler, bounce=0,
                                      mesh_backend="lockstep"),
        sampler, n_samples=4096, eps_px=4.0)
    with jax.disable_jit():
        g_j = jedges.shadow_boundary_grad(
            mj.verts, jnp.asarray(e), jnp.asarray(f), mj.indices,
            jnp.asarray(LIGHT, jnp.float32), job.camera,
            jnp.asarray(weight), W, H,
            lambda r: jpath.trace(job.scene, r, KEY, max_depth=2),
            lambda r: jir.intersect_scene(job.scene, r, KEY, 0), KEY,
            n_samples=4096, eps_px=4.0)
    g_j = np.asarray(g_j)
    assert np.abs(g_j).max() > 1.0
    np.testing.assert_allclose(g_p.numpy(), g_j, rtol=1e-3,
                               atol=1e-3 * np.abs(g_j).max())


def _with_verts(scene, verts):
    return pir.replace(scene, instances=nn.ModuleList([
        pir.replace(i, mesh=pir.replace(i.mesh, verts=verts))
        if i.kind == "mesh" else i for i in scene.instances]))


def _image_loss(scene, cam, weight, spp=256):
    """sum(weight * image), the image the mean of spp jittered samples a
    pixel at depth 2, all samples traced as one batch (a fixed seed, so
    that two calls differ only by the scene)."""
    sampler = Sampler(0, "cpu")
    x, y = ppath.pixel_grid(W, H, "cpu")
    x, y = x.repeat(spp), y.repeat(spp)
    ju = sampler.uniform(prng.PIXEL_JITTER_U, 0, x.shape)
    jv = sampler.uniform(prng.PIXEL_JITTER_V, 0, y.shape)
    rays = get_rays(cam, (x + ju) / (W - 1), (y + jv) / (H - 1))
    rad = ppath.trace(scene, rays, sampler, max_depth=2)
    img = rad.reshape(spp, H * W, 3).mean(dim=0)
    return float((weight.reshape(-1, 3) * img).sum())


def test_boundary_grad_matches_fd(triangle):
    """tests/test_edges.py::test_boundary_grad_matches_fd in the port: the
    emissive triangle's image gradient is all boundary term; 8192 edge
    samples against central differences (delta 0.02, 256 spp) at x of v0
    and y of v2, within 25% and 0.05 (the reference's tolerance)."""
    _, scene, cam = triangle
    verts = _mesh(scene).verts
    e, f = pedges.build_edge_table(_mesh(scene).indices.numpy())
    weight = torch.from_numpy(_weight(0))
    sampler = Sampler(0, "cpu")
    dverts = pedges.boundary_grad(
        verts, torch.from_numpy(e), torch.from_numpy(f),
        _mesh(scene).indices, cam, weight, W, H,
        lambda r: ppath.trace(scene, r, sampler, max_depth=2), sampler,
        n_samples=8192).numpy()
    delta = 0.02
    for vi, ci in ((0, 0), (2, 1)):
        step = torch.zeros_like(verts)
        step[vi, ci] = delta
        lp = _image_loss(_with_verts(scene, verts + step), cam, weight)
        lm = _image_loss(_with_verts(scene, verts - step), cam, weight)
        fd = (lp - lm) / (2 * delta)
        an = dverts[vi, ci]
        assert np.isfinite(fd) and np.isfinite(an) and abs(fd) > 0.1
        assert abs(an - fd) <= 0.25 * abs(fd) + 0.05, (vi, ci, an, fd)


def test_silhouette_mask_single_triangle(triangle):
    _, scene, cam = triangle
    m = _mesh(scene)
    e, f = pedges.build_edge_table(m.indices.numpy())
    assert e.shape == (3, 2)
    assert pedges.silhouette_mask(m.verts, m.indices, torch.from_numpy(e),
                                  torch.from_numpy(f), cam.origin).all()
