"""The fit step's graph route (diff/fit.py:fit_route, fit_materials) on the
CPU: which configurations replay a CUDA graph and which run eagerly; a fit
step reads nothing on the host besides its loss (what a capture needs);
the checkpoints without a stashed generator state give the numbers they
gave before and JAX's; the material rows gathered by index_select
(ops/shade.py:rows) equal indexing's, and their gradients indexing's and
JAX's. The card's cases (graph against eager, bit for bit) are in
tests/test_torch_cuda.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint as torch_checkpoint

from hobbyraytracer_tpu.diff import fit as jfit
from hobbyraytracer_tpu.scene import build_scene as jax_build_scene
from hobbyraytracer_tpu.scene import load_scene_desc as jax_load_scene_desc
from hobbyraytracer_tpu_torch.core.rng import Sampler
from hobbyraytracer_tpu_torch.diff import fit as pfit
from hobbyraytracer_tpu_torch.integrator import path as ppath
from hobbyraytracer_tpu_torch.kernels import build as kbuild
from hobbyraytracer_tpu_torch.kernels import mesh_traverse as kmod
from hobbyraytracer_tpu_torch.ops import shade
from hobbyraytracer_tpu_torch.scene import build_scene, convert
from hobbyraytracer_tpu_torch.scene import ir as pir
from hobbyraytracer_tpu_torch.scene import load_scene_desc

from _torch_parity import (FOG_YAML, SCENES, TEAPOT, Noise, NoiseSampler,
                           jax_camera_arrays, jax_scene_arrays,
                           no_host_reads, patch_jax_fit_rng)

torch.set_num_threads(2)

KEY = jax.random.PRNGKey(0)
SHINY = f"{SCENES}/shiny_teapot.yaml"
CUDA = torch.device("cuda")


@pytest.fixture(scope="module")
def shiny():
    job = build_scene(load_scene_desc(SHINY))
    return job.scene, job.camera


def _fit(scene, camera, steps=2, size=12, **kwargs):
    """A small fit of the perturbed materials back to the scene's own
    render (2 spp, depth 3)."""
    sampler = Sampler(4, "cpu")
    with torch.no_grad():
        target = pfit.render_linear(scene, camera, size, size, sampler, 2, 3)
    m = scene.materials
    start = pir.replace(scene, materials=pir.replace(
        m, albedo=torch.clamp(m.albedo * 0.3 + 0.3, 0, 1)))
    return pfit.fit_materials(start, camera, target, size, size,
                              steps=steps, n_samples=2, max_depth=3,
                              sampler=sampler, verbose=False, **kwargs)


@pytest.mark.parametrize("rule", ["cuda", "cpu", "boundary", "uncorrelated",
                                  "plain find", "finds read the host",
                                  "sharded step"])
def test_fit_route_is_chosen_by_rule(monkeypatch, tmp_path, shiny, rule):
    """fit_route: a CUDA device replays the step from a graph; the CPU,
    boundary=True, correlated=False, the mesh find forced to its plain
    version, a scene whose finds read the host and the sharded step (more
    than one worker) run eagerly. On the CPU fit_materials never makes a
    graph, and eager=True gives the same fit bit for bit."""
    scene, camera = shiny
    assert pfit.fit_route(scene, CUDA)
    if rule == "cuda":
        return
    if rule == "cpu":
        assert not pfit.fit_route(scene, "cpu")

        def no_graph(*args, **kwargs):
            raise AssertionError("made a graph on the CPU")

        monkeypatch.setattr(kbuild, "GraphReplay", no_graph)
        a, b = (_fit(scene, camera, eager=eager) for eager in (False, True))
        assert np.array_equal(a.losses, b.losses)
        for f in pfit.MAT_FIELDS:
            assert torch.equal(a.params["materials"][f],
                               b.params["materials"][f]), f
    elif rule == "boundary":
        assert not pfit.fit_route(scene, CUDA, boundary=True)
    elif rule == "uncorrelated":
        assert not pfit.fit_route(scene, CUDA, correlated=False)
    elif rule == "plain find":
        monkeypatch.setattr(kmod, "traverse_clusters",
                            kmod.traverse_clusters_plain)
        assert not pfit.fit_route(scene, CUDA)
    elif rule == "finds read the host":
        path = tmp_path / "fog.yaml"
        path.write_text(FOG_YAML % TEAPOT.replace(
            "scenes/teapot_scene.yaml", "assets/teapot.obj"))
        fog = build_scene(load_scene_desc(str(path))).scene
        assert pir.finds_read_host(fog) and not pfit.fit_route(fog, CUDA)
    else:
        assert not pfit.fit_route(scene, CUDA, workers=2)


@pytest.mark.parametrize("fit_vertices", [False, True])
def test_fit_step_reads_no_host(monkeypatch, shiny, fit_vertices):
    """Three steps of fit_materials on shiny_teapot (the kernel_replay find;
    a vertex fit refreshes the kernel's tables every step) with every step
    under a guard that fails on a host read (Tensor.item, __bool__,
    nonzero...) outside the kernel wrappers, whose plain versions stand in
    for the kernels here, and Adam's step, which reads its step count on
    the CPU only (on a card capturable=True keeps it there): the loss,
    read by the loop after the step, is the one host read. The fit equals
    the unguarded one bit for bit. The vertex fit looks its textures up
    bilinearly, so that the vertices get a gradient."""
    scene, camera = shiny
    if fit_vertices:
        scene = pir.replace(scene, textures=pir.replace(scene.textures))
        scene.textures.bilinear = True
    run_step = pfit._run_step
    steps = []

    def guarded(step, graph):
        with no_host_reads(monkeypatch, [(torch.optim.Adam, "step")]):
            loss = run_step(step, graph)
        steps.append(loss)
        return loss

    ref = _fit(scene, camera, 3, fit_vertices=fit_vertices)
    monkeypatch.setattr(pfit, "_run_step", guarded)
    res = _fit(scene, camera, 3, fit_vertices=fit_vertices)
    assert len(steps) == 3
    assert np.array_equal(res.losses, ref.losses)
    assert np.isfinite(res.losses).all() and res.losses[0] > 0
    for name, leaf in res.params["materials"].items():
        assert torch.equal(leaf, ref.params["materials"][name]), name
    if fit_vertices:
        assert torch.equal(res.params["verts"][0], ref.params["verts"][0])
        assert res.params["verts"][0].grad.abs().max() > 0


def _stashing_rng_state(fn, *args, **kwargs):
    """torch.utils.checkpoint as the port called it before: the generator
    states stashed and restored around each recompute."""
    kwargs["preserve_rng_state"] = True
    return torch_checkpoint(fn, *args, **kwargs)


def _loss_and_grads(scene, camera, sampler, target, w, h, spp, depth,
                    fit_vertices=False, params=None):
    if params is None:
        params, rebuild = pfit.select_params(scene, fit_vertices)
    else:
        _, rebuild = pfit.select_params(scene, fit_vertices)
    loss = pfit.render_loss(params, rebuild, camera, w, h, sampler, spp,
                            target, depth)
    loss.backward()
    leaves = dict(params["materials"])
    leaves.update({f"verts{i}": v for i, v in
                   enumerate(params.get("verts", []))})
    return loss.detach(), {k: (torch.zeros_like(v) if v.grad is None
                               else v.grad) for k, v in leaves.items()}


@pytest.mark.parametrize("fit_vertices", [False, True])
def test_checkpoints_without_rng_state_change_nothing(monkeypatch, shiny,
                                                      fit_vertices):
    """render_loss and its gradients (shiny_teapot 12x12 @ 2 spp, depth 3,
    through the kernel_replay find; the vertex fit with the mesh moved)
    with the checkpoints of trace_diff and render_linear_slice stashing no
    generator state equal those with the states stashed, bit for bit: every
    draw is threefry's, none a torch generator's."""
    scene, camera = shiny
    sampler = Sampler(6, "cpu")
    w = h = 12
    with torch.no_grad():
        target = pfit.render_linear(scene, camera, w, h, sampler, 2, 3)
    m = scene.materials
    start = pir.replace(scene, materials=pir.replace(
        m, roughness=torch.clamp(m.roughness + 0.4, 0, 1)))
    out = []
    for stash in (False, True):
        if stash:
            monkeypatch.setattr(ppath, "checkpoint", _stashing_rng_state)
            monkeypatch.setattr(pfit, "checkpoint", _stashing_rng_state)
        params, _ = pfit.select_params(start, fit_vertices)
        if fit_vertices:
            with torch.no_grad():
                params["verts"][0] += torch.tensor([0.05, -0.02, 0.03])
        out.append(_loss_and_grads(start, camera, sampler, target, w, h, 2,
                                   3, fit_vertices, params))
    (la, ga), (lb, gb) = out
    assert float(la) > 0 and torch.equal(la, lb)
    assert ga["albedo"].abs().max() > 0
    for name in ga:
        assert torch.equal(ga[name], gb[name]), name


def test_checkpoints_without_rng_state_match_jax(monkeypatch):
    """render_loss and its material gradients on cornell_box (12x12 @ 2
    spp, depth 3, the same injected noise in both) against JAX's
    value_and_grad(render_loss), with the checkpoints stashing no
    generator state: rtol 2e-3, atol 2e-5 (tests/test_torch_fit.py's
    tolerance)."""
    job = jax_build_scene(jax_load_scene_desc(f"{SCENES}/cornell_box.yaml"))
    scene_j, cam_j = job.scene, job.camera
    scene_p = convert.scene_from_arrays(jax_scene_arrays(scene_j))
    cam_p = convert.camera_from_arrays(jax_camera_arrays(cam_j))
    w = h = 12
    spp, depth = 2, 3
    noise = Noise(21)
    patch_jax_fit_rng(monkeypatch, noise, KEY, spp)
    sampler = NoiseSampler(noise)
    m = scene_j.materials
    start_j = scene_j.replace(materials=m.replace(
        albedo=jnp.clip(m.albedo * 0.3 + 0.3, 0, 1)))
    params_j, rebuild_j = jfit.select_params(start_j)
    params_p = convert.params_from_arrays({"materials": {
        f: np.asarray(a) for f, a in params_j["materials"].items()}})
    with jax.disable_jit():
        target_j = jfit.render_linear(scene_j, cam_j, w, h, KEY, spp, depth)
        loss_j, g_j = jax.value_and_grad(jfit.render_loss)(
            params_j, rebuild_j, cam_j, w, h, KEY, spp, target_j, depth)
    target_p = torch.from_numpy(np.array(target_j))
    loss_p, g_p = _loss_and_grads(scene_p, cam_p, sampler, target_p, w, h,
                                  spp, depth, params=params_p)
    assert float(loss_j) > 0
    np.testing.assert_allclose(float(loss_p), float(loss_j), rtol=2e-3)
    assert g_p["albedo"].abs().max() > 0
    for f in pfit.MAT_FIELDS:
        np.testing.assert_allclose(g_p[f].numpy(),
                                   np.asarray(g_j["materials"][f]),
                                   rtol=2e-3, atol=2e-5, err_msg=f)


@pytest.mark.parametrize("shape", [(5, 3), (5,)])
def test_material_rows_match_indexing_and_jax(shape):
    """ops/shade.py:rows (index_select) against table[mid] on 4,096 lanes
    of which most fall into two rows, as a wavefront falls into a scene's
    materials: the forward bitwise equal, the gradient (an index_add_
    where indexing's is a sorted index_put_) within rtol 1e-6 of
    indexing's and of JAX's gather's; the int tables' rows equal."""
    rng = np.random.default_rng(8)
    table_np = rng.uniform(0.1, 1.0, shape).astype(np.float32)
    mid_np = np.where(rng.uniform(size=4096) < 0.97,
                      rng.integers(1, 3, 4096),
                      rng.integers(0, shape[0], 4096)).astype(np.int64)
    g_np = rng.uniform(0.0, 1.0, (4096,) + shape[1:]).astype(np.float32)
    mid, g = torch.from_numpy(mid_np), torch.from_numpy(g_np)
    grads = []
    for gather in (shade.rows, lambda t, i: t[i]):
        table = torch.from_numpy(table_np).requires_grad_(True)
        out = gather(table, mid)
        grads.append((out.detach(), torch.autograd.grad(out, table, g)[0]))
    (new, g_new), (old, g_old) = grads
    assert torch.equal(new, old) and new.shape == (4096,) + shape[1:]
    np.testing.assert_allclose(g_new.numpy(), g_old.numpy(), rtol=1e-6)
    _, vjp = jax.vjp(lambda t: t[jnp.asarray(mid_np)], jnp.asarray(table_np))
    (g_jax,) = vjp(jnp.asarray(g_np))
    np.testing.assert_allclose(g_new.numpy(), np.asarray(g_jax), rtol=1e-6)
    assert (g_new[1:3] > 100).all()
    ids = torch.from_numpy(rng.integers(-1, 4, shape[:1]).astype(np.int32))
    assert torch.equal(shade.rows(ids, mid), ids[mid])
