"""The fit step's graph route (diff/fit.py:fit_route, fit_materials) on the
CPU: which configurations replay a CUDA graph and which run eagerly; a fit
step reads nothing on the host besides its loss (what a capture needs);
the checkpoints without a stashed generator state give the numbers they
gave before and JAX's; the material rows gathered by index_select
(ops/shade.py:rows) equal indexing's, and their gradients indexing's and
JAX's; the step graph kept across fits (FIT_GRAPHS), with an eager
stand-in for the graph: fits that reuse it equal fresh fits, each field of
its key and each change in place of what the capture holds tells fits
apart, its draws read the key from a slot and the results are the
caller's own. The card's cases (graph against eager, bit
for bit) are in tests/test_torch_cuda.py."""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint as torch_checkpoint

from hobbyraytracer_tpu.diff import fit as jfit
from hobbyraytracer_tpu.scene import build_scene as jax_build_scene
from hobbyraytracer_tpu.scene import load_scene_desc as jax_load_scene_desc
from hobbyraytracer_tpu_torch import tracing
from hobbyraytracer_tpu_torch.core.rng import KeySlot, Sampler
from hobbyraytracer_tpu_torch.diff import fit as pfit
from hobbyraytracer_tpu_torch.integrator import path as ppath
from hobbyraytracer_tpu_torch.kernels import build as kbuild
from hobbyraytracer_tpu_torch.ops import intersect as isect
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
SMOKE = f"{SCENES}/cornell_smoke.yaml"
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
                                  "plain find", "eager",
                                  "finds read the host", "sharded step"])
def test_fit_route_is_chosen_by_rule(monkeypatch, tmp_path, shiny, rule):
    """fit_route: a CUDA device replays the step from a graph; the CPU,
    boundary=True, correlated=False, either comparison switch
    (kernels/build.py:plain_versions, eager), a scene whose finds read the
    host and the sharded step (more than one worker) run eagerly. On the
    CPU fit_materials never makes a graph, and under eager() gives the
    same fit bit for bit."""
    scene, camera = shiny
    assert pfit.fit_route(scene, CUDA)
    if rule == "cuda":
        return
    if rule == "cpu":
        assert not pfit.fit_route(scene, "cpu")

        def no_graph(*args, **kwargs):
            raise AssertionError("made a graph on the CPU")

        monkeypatch.setattr(kbuild, "GraphReplay", no_graph)
        a = _fit(scene, camera)
        with kbuild.eager():
            b = _fit(scene, camera)
        assert np.array_equal(a.losses, b.losses)
        for f in pfit.MAT_FIELDS:
            assert torch.equal(a.params["materials"][f],
                               b.params["materials"][f]), f
    elif rule == "boundary":
        assert not pfit.fit_route(scene, CUDA, boundary=True)
    elif rule == "uncorrelated":
        assert not pfit.fit_route(scene, CUDA, correlated=False)
    elif rule == "plain find":
        with kbuild.plain_versions():
            assert not pfit.fit_route(scene, CUDA)
        assert pfit.fit_route(scene, CUDA)
    elif rule == "eager":
        with kbuild.eager():
            assert not pfit.fit_route(scene, CUDA)
        assert pfit.fit_route(scene, CUDA)
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


# --- the step graph kept across fits (diff/fit.py:FIT_GRAPHS) --------------

@pytest.fixture
def kept(monkeypatch):
    """The graph route on the CPU: graphs are on for it as for a card
    (kernels/build.py:graphs_on, outside its switches), GraphReplay is a
    stand-in that runs the step eagerly every time, and FIT_GRAPHS a cache
    of its own -> the list of stand-ins made (one a captured graph)."""
    made = []

    class EagerGraph:
        def __init__(self, device):
            self.device = -1     # torch.cuda.device(-1) makes no change
            made.append(self)

        def __call__(self, fn):
            return fn()

    graphs_on = kbuild.graphs_on
    monkeypatch.setattr(kbuild, "graphs_on", lambda device: graphs_on(CUDA))
    monkeypatch.setattr(kbuild, "GraphReplay", EagerGraph)
    monkeypatch.setattr(pfit, "FIT_GRAPHS", pfit.FitGraphs())
    return made


@pytest.fixture(scope="module")
def smoke():
    job = build_scene(load_scene_desc(SMOKE))
    return job.scene, job.camera


def _fit_job(scene, camera, size=12, spp=2, depth=3):
    """(start scene, target) of a small fit: the albedos perturbed, the
    target the scene's own render."""
    with torch.no_grad():
        target = pfit.render_linear(scene, camera, size, size,
                                    Sampler(4, "cpu"), spp, depth)
    m = scene.materials
    return pir.replace(scene, materials=pir.replace(
        m, albedo=torch.clamp(m.albedo * 0.3 + 0.3, 0, 1))), target


def _run(start, camera, target, seed, size=12, spp=2, depth=3, steps=2,
         **kwargs):
    return pfit.fit_materials(start, camera, target, size, size,
                              steps=steps, n_samples=spp, max_depth=depth,
                              sampler=Sampler(seed, "cpu"), verbose=False,
                              **kwargs)


def _eager_run(*args, **kwargs):
    """_run with nothing captured (kernels/build.py:eager)."""
    with kbuild.eager():
        return _run(*args, **kwargs)


def _tensors(res) -> list:
    return pfit._leaves(res.params)


def _assert_same_fit(a, b):
    assert np.array_equal(a.losses, b.losses)
    for f in pfit.MAT_FIELDS:
        assert torch.equal(a.params["materials"][f],
                           b.params["materials"][f]), f
    assert len(a.params.get("verts", [])) == len(b.params.get("verts", []))
    for va, vb in zip(a.params.get("verts", []), b.params.get("verts", [])):
        assert torch.equal(va, vb)


@pytest.mark.parametrize("fit_vertices", [False, True],
                         ids=["materials", "vertices"])
def test_kept_fit_equals_fresh_fits(kept, shiny, fit_vertices):
    """Three fits of one scene and camera with three seeds: the first
    captures, the other two reset the kept buffers and replay (1 capture,
    2 hits), and each equals a fresh eager fit of its seed bit for
    bit: the losses, every material field and, in a vertex fit, the
    vertices. The first fit's result is as it was after the third, and no
    result (params, gradients, the fitted scene's materials) shares
    storage with the kept fit's buffers."""
    scene, camera = shiny
    if fit_vertices:
        scene = pir.replace(scene, textures=pir.replace(scene.textures))
        scene.textures.bilinear = True
    start, target = _fit_job(scene, camera)
    runs = []
    for seed in (1, 2, 3):
        runs.append(_run(start, camera, target, seed,
                         fit_vertices=fit_vertices))
        if seed == 1:
            first = [t.clone() for t in _tensors(runs[0])]
    graphs = pfit.FIT_GRAPHS
    assert (len(kept), graphs.captures, graphs.hits) == (1, 1, 2)
    for seed, res in zip((1, 2, 3), runs):
        _assert_same_fit(res, _eager_run(start, camera, target, seed,
                                         fit_vertices=fit_vertices))
    assert all(torch.equal(a, b) for a, b in zip(_tensors(runs[0]), first))
    assert len(runs[0].losses) == 2 and len(set(map(tuple, (
        r.losses for r in runs)))) == 3
    (fit,) = graphs.kept.values()
    own = {t.data_ptr() for p in fit.leaves for t in (p, p.grad)}
    own.add(fit.target.data_ptr())
    for res in runs:
        ptrs = [t.data_ptr() for p in _tensors(res) for t in (p, p.grad)]
        ptrs += [getattr(res.scene.materials, f).data_ptr()
                 for f in pfit.MAT_FIELDS]
        assert not own & set(ptrs)


MISSES = {
    "size": dict(size=10),
    "spp": dict(spp=1),
    "depth": dict(depth=2),
    "lr": dict(lr=1e-2),
    "scene object": dict(start=lambda s: pir.replace(s)),
    "camera object": dict(camera=lambda c: pir.replace(c)),
    "fit_vertices": dict(fit_vertices=True),
    "traced": dict(traced=True),
}


@pytest.mark.parametrize("field_", list(MISSES))
def test_each_key_field_tells_fits_apart(kept, shiny, field_):
    """A fit that differs from the kept one in one field of the key (the
    film size, spp, depth, lr, the scene or camera object, fit_vertices,
    traced) misses and captures a graph of its own, whose fit equals a
    fresh eager one; a second such fit hits it. A traced fit's graph is
    kept beside the untraced one, so an untraced fit after it still hits;
    any other miss replaces the kept fit."""
    scene, camera = shiny
    start, target = _fit_job(scene, camera)
    _run(start, camera, target, 1)
    change = dict(MISSES[field_])
    traced = change.pop("traced", False)
    start2 = change.pop("start", lambda s: s)(start)
    camera2 = change.pop("camera", lambda c: c)(camera)
    if "size" in change or "spp" in change or "depth" in change:
        args = {"size": change.get("size", 12), "spp": change.get("spp", 2),
                "depth": change.get("depth", 3)}
        _, target2 = _fit_job(scene, camera2, **args)
    else:
        target2 = target

    def second():
        with tracing.recording() if traced else contextlib.nullcontext():
            return _run(start2, camera2, target2, 2, **change)

    res = second()
    graphs = pfit.FIT_GRAPHS
    assert (len(kept), graphs.captures, graphs.hits) == (2, 2, 0)
    assert len(graphs.kept) == (2 if traced else 1)
    _assert_same_fit(res, _eager_run(start2, camera2, target2, 2, **change))
    second()
    assert (len(kept), graphs.hits) == (2, 1)
    _run(start, camera, target, 3)
    assert (len(kept), graphs.hits) == ((2, 2) if traced else (3, 1))
    tracing.RECORDER.drain()


@pytest.mark.parametrize("scene_name", ["shiny_teapot", "cornell_smoke"])
def test_render_loss_under_a_key_slot_equals_host_keys(shiny, smoke,
                                                       scene_name):
    """render_loss and its material gradients (12x12 @ 2 spp, depth 3)
    drawing from Sampler.slotted(slot), the slot filled with the sampler's
    key, equal those drawing from the host key bit for bit: on
    shiny_teapot (the metal lobe's unit_sphere, 5 folds after the slot)
    and cornell_smoke (its media's in_ball, 6 folds, the kernel's
    MAX_PATH)."""
    scene, camera = shiny if scene_name == "shiny_teapot" else smoke
    start, target = _fit_job(scene, camera)
    host = Sampler(7, "cpu")
    slot = KeySlot("cpu")
    slot.fill(host.key)
    out = [_loss_and_grads(start, camera, s, target, 12, 12, 2, 3)
           for s in (host, host.slotted(slot))]
    (la, ga), (lb, gb) = out
    assert float(la) > 0 and torch.equal(la, lb)
    assert ga["albedo"].abs().max() > 0
    for name in ga:
        assert torch.equal(ga[name], gb[name]), name


IN_PLACE = {
    "use_lens": lambda start, camera: (camera, "use_lens", True),
    "bilinear": lambda start, camera: (start.textures, "bilinear", True),
    "buffer reassigned": lambda start, camera: (
        camera, "origin", camera.origin.clone()),
    "find switch": lambda start, camera: (
        isect, "NO_COHSORT", not isect.NO_COHSORT),
}


@pytest.mark.parametrize("change", list(IN_PLACE))
def test_a_change_in_place_tells_fits_apart(kept, shiny, change):
    """The same scene and camera objects, changed in place between two
    fits: a flag the step branches on as it is recorded (Camera.use_lens,
    TextureTable.bilinear), a buffer set to another tensor (the graph
    reads the old one's address) or a switch of the finds
    (ops/intersect.py). The fit after the change misses and captures a
    graph of its own, and equals a fresh eager fit under the change; once
    the change is undone the next fit misses again."""
    scene, camera = shiny
    start, target = _fit_job(scene, camera)
    _run(start, camera, target, 1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(*IN_PLACE[change](start, camera))
        res = _run(start, camera, target, 2)
        graphs = pfit.FIT_GRAPHS
        assert (len(kept), graphs.captures, graphs.hits) == (2, 2, 0)
        _assert_same_fit(res, _eager_run(start, camera, target, 2))
    _run(start, camera, target, 3)
    assert (len(kept), graphs.captures, graphs.hits) == (3, 3, 0)


def test_clear_drops_the_kept_fits(kept, shiny):
    """FitGraphs.clear drops every kept fit, traced or not: the next fit
    of the same key captures again, and the counts stay."""
    scene, camera = shiny
    start, target = _fit_job(scene, camera)
    _run(start, camera, target, 1)
    with tracing.recording():
        _run(start, camera, target, 1)
    tracing.RECORDER.drain()
    graphs = pfit.FIT_GRAPHS
    assert len(graphs.kept) == 2
    graphs.clear()
    assert not graphs.kept and (graphs.captures, graphs.hits) == (2, 0)
    _run(start, camera, target, 2)
    _run(start, camera, target, 3)
    assert (len(kept), graphs.captures, graphs.hits) == (3, 3, 1)


def test_fit_span_says_how_its_graph_ran(kept, shiny):
    """hrt.fit's attribute `graph`: "capture" for a fit that captured its
    graph, "hit" for one that replayed a kept graph, "eager" for an eager
    fit."""
    scene, camera = shiny
    start, target = _fit_job(scene, camera)
    tracing.RECORDER.drain()
    with tracing.recording() as rec:
        for run in (_run, _run, _eager_run):
            run(start, camera, target, 1)
    roots = [s for s in rec.drain() if s["type"] == "span"
             and s["name"] == "hrt.fit"]
    assert [r["attrs"]["graph"] for r in roots] == ["capture", "hit",
                                                    "eager"]
