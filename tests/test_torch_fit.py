"""The port's differentiable fit (diff/fit.py) against the JAX package's,
on the CPU with the same injected noise in both: render_loss and its
material gradients (cornell_box, and the teapot through the kernel's find),
the vertex fit through refreshed tables, project_materials, three Adam
steps, an albedo recovery, and the CLI's `fit`."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hobbyraytracer_tpu.diff import fit as jfit
from hobbyraytracer_tpu.scene import build_scene as jax_build_scene
from hobbyraytracer_tpu.scene import load_scene_desc as jax_load_scene_desc
from hobbyraytracer_tpu_torch.core.rng import Sampler
from hobbyraytracer_tpu_torch.diff import fit as pfit
from hobbyraytracer_tpu_torch.scene import convert
from hobbyraytracer_tpu_torch.scene import ir as pir

from _torch_parity import (ROOT, SCENES, Noise, NoiseSampler,
                           jax_camera_arrays, jax_scene_arrays,
                           patch_jax_fit_rng)

torch.set_num_threads(2)

KEY = jax.random.PRNGKey(0)


def _carried(name, bilinear=False):
    job = jax_build_scene(jax_load_scene_desc(f"{SCENES}/{name}.yaml"))
    scene_j = job.scene
    if bilinear:
        scene_j = scene_j.replace(
            textures=scene_j.textures.replace(bilinear=True))
    return (scene_j, job.camera,
            convert.scene_from_arrays(jax_scene_arrays(scene_j)),
            convert.camera_from_arrays(jax_camera_arrays(job.camera)))


def _grads(params):
    """Material gradients as numpy; a parameter outside the graph has a
    zero gradient, as JAX gives it."""
    return {f: (np.zeros(t.shape, np.float32) if t.grad is None
                else t.grad.numpy()) for f, t in params["materials"].items()}


def _perturbed(scene_j):
    m = scene_j.materials
    return scene_j.replace(materials=m.replace(
        albedo=jnp.clip(m.albedo * 0.3 + 0.3, 0, 1),
        roughness=jnp.clip(m.roughness + 0.4, 0, 1)))


@pytest.fixture(scope="module")
def cornell():
    return _carried("cornell_box")


def test_render_loss_matches_jax_on_cornell(monkeypatch, cornell):
    """render_loss and its material gradients against JAX's
    value_and_grad(render_loss) at 12x12, 2 spp, depth 3, from the same
    carried-across parameters (scene/convert.py:params_from_arrays), with
    the same injected noise: rtol 2e-3, atol 2e-5 (tests/test_grad.py's
    tolerance)."""
    scene_j, cam_j, scene_p, cam_p = cornell
    w = h = 12
    spp, depth = 2, 3
    noise = Noise(11)
    patch_jax_fit_rng(monkeypatch, noise, KEY, spp)
    sampler = NoiseSampler(noise)
    with jax.disable_jit():
        target_j = jfit.render_linear(scene_j, cam_j, w, h, KEY, spp, depth)
    target_p = pfit.render_linear(scene_p, cam_p, w, h, sampler, spp,
                                  depth).detach()
    np.testing.assert_allclose(target_p.numpy(), np.asarray(target_j),
                               rtol=1e-4, atol=1e-6)
    assert target_p.max() > 0
    params_j, rebuild_j = jfit.select_params(_perturbed(scene_j))
    arrays = {"materials": {f: np.asarray(a) for f, a in
                            params_j["materials"].items()}}
    params_p = convert.params_from_arrays(arrays)
    _, rebuild_p = pfit.select_params(scene_p)
    with jax.disable_jit():
        loss_j, g_j = jax.value_and_grad(jfit.render_loss)(
            params_j, rebuild_j, cam_j, w, h, KEY, spp, target_j, depth)
    loss_p = pfit.render_loss(params_p, rebuild_p, cam_p, w, h, sampler,
                              spp, target_p, depth)
    loss_p.backward()
    assert float(loss_j) > 0
    np.testing.assert_allclose(float(loss_p.detach()), float(loss_j),
                               rtol=2e-3)
    g_p = _grads(params_p)
    assert np.abs(g_p["albedo"]).max() > 0
    for f in pfit.MAT_FIELDS:
        np.testing.assert_allclose(g_p[f], np.asarray(g_j["materials"][f]),
                                   rtol=2e-3, atol=2e-5, err_msg=f)
    back = convert.params_to_arrays(params_p)
    for f, a in arrays["materials"].items():
        np.testing.assert_array_equal(back["materials"][f], a)


def _masked_loss(img, target, mask, xp):
    """_loss_from_image over the pixels in `mask` only."""
    if xp is torch:
        from hobbyraytracer_tpu_torch.ops.film import tonemap
    else:
        from hobbyraytracer_tpu.ops.film import tonemap
    diff = (tonemap(img, grad_eps=1e-6) - tonemap(target, grad_eps=1e-6))
    return (diff ** 2 * mask[:, None]).sum() / (3 * mask.sum())


def test_render_loss_matches_jax_on_teapot_kernel_replay(monkeypatch):
    """The teapot through "kernel_replay" (JAX: "auto_diff", its Pallas
    find in interpret mode) at 16x16, 1 spp, depth 3. XLA's CPU FMAs make
    a bounce ray re-hit its own triangle on one side only now and then
    (ROADMAP Queue 3, "Mesh self-hits"); at 1 spp a pixel is one path, so
    the pixels whose radiance differs are counted (at most 5%) and the
    loss and its material gradients are compared over the others: rtol
    2e-3, atol 2e-5."""
    monkeypatch.setenv("HRT_PALLAS_INTERPRET", "1")
    scene_j, cam_j, scene_p, cam_p = _carried("teapot_scene")
    w = h = 16
    spp, depth = 1, 3
    noise = Noise(12)
    patch_jax_fit_rng(monkeypatch, noise, KEY, spp)
    sampler = NoiseSampler(noise)
    pert_j = _perturbed(scene_j)
    params_j, rebuild_j = jfit.select_params(pert_j)
    params_p = convert.params_from_arrays({"materials": {
        f: np.asarray(a) for f, a in params_j["materials"].items()}})
    _, rebuild_p = pfit.select_params(scene_p)
    with jax.disable_jit():
        target_j = jfit.render_linear(scene_j, cam_j, w, h, KEY, spp, depth,
                                      mesh_backend="auto_diff")
        img_j = jfit.render_linear(rebuild_j(params_j), cam_j, w, h, KEY,
                                   spp, depth, mesh_backend="auto_diff")
    target_p = pfit.render_linear(scene_p, cam_p, w, h, sampler, spp,
                                  depth).detach()
    img_p = pfit.render_linear(rebuild_p(params_p), cam_p, w, h, sampler,
                               spp, depth).detach()
    same = np.ones((w * h,), bool)
    for a, b in ((target_p.numpy(), np.asarray(target_j)),
                 (img_p.numpy(), np.asarray(img_j))):
        same &= (np.abs(a - b) <= 1e-4 + 1e-4 * np.abs(b)).all(axis=1)
    assert 1.0 - same.mean() <= 0.05, (~same).sum()
    mask = same.astype(np.float32)
    target = np.asarray(target_j)

    def loss_j(p):
        img = jfit.render_linear(rebuild_j(p), cam_j, w, h, KEY, spp, depth,
                                 mesh_backend="auto_diff")
        return _masked_loss(img, jnp.asarray(target), jnp.asarray(mask), jnp)

    with jax.disable_jit():
        lj, g_j = jax.value_and_grad(loss_j)(params_j)
    img = pfit.render_linear(rebuild_p(params_p), cam_p, w, h, sampler, spp,
                             depth)
    lp = _masked_loss(img, torch.tensor(target), torch.from_numpy(mask),
                      torch)
    lp.backward()
    np.testing.assert_allclose(float(lp.detach()), float(lj), rtol=2e-3)
    g_p = _grads(params_p)
    assert np.abs(g_p["albedo"]).max() > 0
    for f in pfit.MAT_FIELDS:
        np.testing.assert_allclose(g_p[f], np.asarray(g_j["materials"][f]),
                                   rtol=2e-3, atol=2e-5, err_msg=f)


def test_vertex_fit_kernel_replay_equals_lockstep():
    """tests/test_grad.py::test_pallas_replay_vertex_grads_with_moving_verts
    in the port: shiny_teapot with bilinear lookups (smooth in the
    direction, so the vertex gradients are not zero), the mesh moved by
    (0.6, -0.4, 0.5), a vertex fit's loss and gradients by "kernel_replay"
    over the tables refreshed from the moved vertices against "lockstep":
    bit for bit."""
    _, _, scene, cam = _carried("shiny_teapot", bilinear=True)
    assert scene.textures.bilinear
    w = h = 16
    target = pfit.render_linear(scene, cam, w, h, Sampler(9, "cpu"), 1,
                                3).detach()
    out = {}
    for backend in ("kernel_replay", "lockstep"):
        params, rebuild = pfit.select_params(scene, fit_vertices=True)
        with torch.no_grad():
            params["verts"][0] += torch.tensor([0.6, -0.4, 0.5])
        mesh = next(i.mesh for i in rebuild(params).instances
                    if i.kind == "mesh")
        assert torch.equal(mesh.verts, params["verts"][0])
        loss = pfit.render_loss(params, rebuild, cam, w, h, Sampler(5, "cpu"),
                                1, target, 3, mesh_backend=backend)
        loss.backward()
        out[backend] = (loss.detach(), params)
    (la, pa), (lb, pb) = out["kernel_replay"], out["lockstep"]
    assert torch.equal(la, lb)
    assert pa["verts"][0].grad.abs().max() > 0
    assert torch.equal(pa["verts"][0].grad, pb["verts"][0].grad)
    for f in pfit.MAT_FIELDS:
        ga, gb = pa["materials"][f].grad, pb["materials"][f].grad
        assert (ga is None and gb is None) or torch.equal(ga, gb), f


def test_project_materials_matches_jax():
    rng = np.random.default_rng(3)
    mats = {"albedo": rng.uniform(-0.5, 1.5, (5, 3)),
            "roughness": rng.uniform(-0.5, 1.5, (5,)),
            "strength": rng.uniform(-2, 2, (5,)),
            "ior": rng.uniform(0.5, 3.5, (5,)),
            "metallness": rng.uniform(-1, 2, (5,))}
    mats = {f: a.astype(np.float32) for f, a in mats.items()}
    params = convert.params_from_arrays({"materials": mats})
    out = pfit.project_materials(params)
    assert out is params and params["materials"]["albedo"].requires_grad
    want = jfit.project_materials({"materials": {
        f: jnp.asarray(a) for f, a in mats.items()}})
    for f in mats:
        np.testing.assert_array_equal(
            params["materials"][f].detach().numpy(),
            np.asarray(want["materials"][f]), err_msg=f)


def test_fit_steps_match_jax(monkeypatch, cornell):
    """Three fit_materials steps (Adam, lr 5e-2) from the same perturbed
    materials carried across, with the same injected noise: the losses
    within rtol 1e-3, and so are the fitted materials."""
    scene_j, cam_j, _, cam_p = cornell
    w = h = 12
    spp, depth = 2, 3
    noise = Noise(13)
    patch_jax_fit_rng(monkeypatch, noise, KEY, spp)
    sampler = NoiseSampler(noise)
    with jax.disable_jit():
        target_j = jfit.render_linear(scene_j, cam_j, w, h, KEY, spp, depth)
        res_j = jfit.fit_materials(_perturbed(scene_j), cam_j, target_j, w, h,
                                   steps=3, lr=5e-2, n_samples=spp,
                                   max_depth=depth, key=KEY, verbose=False)
    start = convert.scene_from_arrays(jax_scene_arrays(_perturbed(scene_j)))
    res_p = pfit.fit_materials(start, cam_p, torch.tensor(
        np.asarray(target_j)), w, h, steps=3, lr=5e-2, n_samples=spp,
        max_depth=depth, sampler=sampler, verbose=False)
    assert len(res_p.losses) == 3 and res_p.losses[0] > 0
    np.testing.assert_allclose(res_p.losses, np.asarray(res_j.losses),
                               rtol=1e-3)
    for f in pfit.MAT_FIELDS:
        np.testing.assert_allclose(
            res_p.params["materials"][f].detach().numpy(),
            np.asarray(res_j.params["materials"][f]), rtol=1e-3, atol=1e-5,
            err_msg=f)
    assert res_p.losses[-1] < res_p.losses[0]


def test_fit_recovers_albedo(cornell):
    """tests/test_grad.py::test_fit_recovers_albedo in the port, with
    fewer steps: cornell_box at 16x16, 4 spp, depth 4, 24 Adam steps at lr
    5e-2 from albedo * 0.3 + 0.3 take the loss below a quarter of its
    start, and the red wall comes back red."""
    _, _, scene, cam = cornell
    w = h = 16
    sampler = Sampler(3, "cpu")
    with torch.no_grad():
        target = pfit.render_linear(scene, cam, w, h, sampler, 4, 4)
    m = scene.materials
    start = pir.replace(scene, materials=pir.replace(
        m, albedo=torch.clamp(m.albedo * 0.3 + 0.3, 0, 1)))
    res = pfit.fit_materials(start, cam, target, w, h, steps=24, lr=5e-2,
                             n_samples=4, max_depth=4, sampler=sampler,
                             verbose=False)
    assert np.isfinite(res.losses).all()
    assert res.losses[-1] < 0.25 * res.losses[0], res.losses
    red = res.scene.materials.albedo[2].detach().numpy()
    assert red[0] > 2.5 * red[1], red


def test_cli_fit_on_cpu_without_jax():
    """`fit --device cpu` on shiny_teapot at 16x16 for 2 steps, in a
    process that never loads JAX: rc 0 (the final loss below the first),
    the loss lines and the final loss printed."""
    code = (
        "import sys\n"
        "from hobbyraytracer_tpu_torch.cli.main import main\n"
        f"rc = main(['fit', {SCENES + '/shiny_teapot.yaml'!r}, '--steps', "
        "'2', '--width', '16', '--height', '16', '--device', 'cpu'])\n"
        "loaded = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith(('jax.', 'jaxlib', 'hobbyraytracer_tpu.')))\n"
        "assert not loaded, loaded\n"
        "print('RC', rc)\n")
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "RC 0" in proc.stdout
    assert "fit step 0: loss" in proc.stdout
    assert "fit step 1: loss" in proc.stdout
    assert "final loss:" in proc.stdout
