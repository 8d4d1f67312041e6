"""The batch integrator's graph route (integrator/path.py: batch_route,
BatchRun) on the CPU: which configurations take it; its steps (start,
blocks of B bounces, add) run eagerly equal `trace`'s per-bounce loop bit
for bit, over chunks and pixel slices too; the steps read nothing on the
host (what a capture needs); the key slot (core/rng.py:KeySlot) draws
under the key last written into it; and the route's draws and radiance
equal the JAX package's sample_radiance. The card's cases (graphs against
eager, bit for bit) are in tests/test_torch_cuda.py."""
import contextlib

import jax
import numpy as np
import pytest
import torch

from hobbyraytracer_tpu.integrator import path as jpath
from hobbyraytracer_tpu.scene import build_scene as jax_build_scene
from hobbyraytracer_tpu.scene import load_scene_desc as jax_load_scene_desc
from hobbyraytracer_tpu_torch.core import rng as prng
from hobbyraytracer_tpu_torch.core.rng import KeySlot, Sampler
from hobbyraytracer_tpu_torch.integrator import path as ppath
from hobbyraytracer_tpu_torch.kernels import build as kbuild
from hobbyraytracer_tpu_torch.kernels import threefry as tf
from hobbyraytracer_tpu_torch.scene import build_scene, convert
from hobbyraytracer_tpu_torch.scene import ir as pir
from hobbyraytracer_tpu_torch.scene import load_scene_desc

from _torch_parity import (BALLS, FOG_YAML, SCENES, TEAPOT,
                           jax_camera_arrays, jax_scene_arrays,
                           no_host_reads)

torch.set_num_threads(2)

SMOKE = f"{SCENES}/cornell_smoke.yaml"
CUDA = torch.device("cuda")


def _job(path):
    job = build_scene(load_scene_desc(path))
    return job.scene, job.camera


@pytest.fixture(scope="module")
def teapot():
    return _job(TEAPOT)


@pytest.fixture(scope="module")
def smoke():
    return _job(SMOKE)


def _bounces_of_loop(monkeypatch, fn):
    """fn() -> (its result, the bounces `trace` ran, one count a sample)."""
    calls = []
    real = ppath._bounce

    def counted(*args, **kwargs):
        calls.append(args[4])
        return real(*args, **kwargs)

    monkeypatch.setattr(ppath, "_bounce", counted)
    out = fn()
    monkeypatch.setattr(ppath, "_bounce", real)
    return out, calls


@pytest.mark.parametrize("rule", ["cuda", "cpu", "lockstep", "fog",
                                  "plain_versions", "eager"])
def test_batch_route_is_chosen_by_rule(monkeypatch, tmp_path, teapot, smoke,
                                       rule):
    """batch_route: a CUDA device, unless a bounce reads the host. The CPU,
    mesh_backend "lockstep" and a medium bounded by a clustered mesh run
    the per-bounce loop; on the CPU radiance_sum and sample_radiance build
    no BatchRun, under eager() or not. Either comparison switch
    (kernels/build.py:plain_versions, eager) keeps the batch route and
    turns its graphs off (graphs_on), and gives the same sum."""
    balls = _job(BALLS)[0]
    if rule == "cuda":
        for scene in (teapot[0], smoke[0], balls):
            assert ppath.batch_route(scene, CUDA)
            assert ppath.batch_route(scene, CUDA, "kernel_replay")
    elif rule == "cpu":
        for scene in (teapot[0], smoke[0], balls):
            assert not ppath.batch_route(scene, "cpu")

        def no_run(*args, **kwargs):
            raise AssertionError("built a BatchRun on the CPU")

        monkeypatch.setattr(ppath, "BatchRun", no_run)
        scene, camera = teapot
        for switch in (contextlib.nullcontext, kbuild.eager):
            with switch():
                ppath.radiance_sum(scene, camera, 4, 4, 2, Sampler(0, "cpu"),
                                   max_depth=2, sample_chunk=1)
                ppath.sample_radiance(scene, camera, 4, 4, Sampler(0, "cpu"),
                                      1, max_depth=2)
    elif rule in ("plain_versions", "eager"):
        scene, camera = teapot

        def render():
            return ppath.radiance_sum(scene, camera, 4, 4, 2,
                                      Sampler(0, "cpu"), max_depth=2)

        want = render()
        with getattr(kbuild, rule)():
            for s in (teapot[0], smoke[0], balls):
                assert ppath.batch_route(s, CUDA)
            assert not kbuild.graphs_on(CUDA)
            got = render()
        assert kbuild.graphs_on(CUDA) and torch.equal(got, want)
    elif rule == "lockstep":
        assert not ppath.batch_route(teapot[0], CUDA, "lockstep")
    else:
        path = tmp_path / "fog.yaml"
        path.write_text(FOG_YAML % TEAPOT.replace(
            "scenes/teapot_scene.yaml", "assets/teapot.obj"))
        fog = build_scene(load_scene_desc(str(path))).scene
        assert pir.finds_read_host(fog) and not ppath.batch_route(fog, CUDA)


@pytest.mark.parametrize("name", ["teapot", "smoke"])
@pytest.mark.parametrize("block,depth", [(1, 50), (3, 50), (8, 50), (3, 7),
                                         (8, 7)])
def test_blocks_equal_the_per_bounce_loop(monkeypatch, request, name, block,
                                          depth):
    """BatchRun's steps run eagerly (2 samples of 8x8) against
    sample_radiance's per-bounce loop: the sums equal bit for bit (depth
    50: the lanes all end before it and the loop stops early; depth 7, not
    a multiple of B: the last block is shorter). The blocks run the
    loop's bounces rounded up to whole blocks, capped at max_depth; the
    static buffers stay the same tensors."""
    scene, camera = request.getfixturevalue(name)
    want, loop = _bounces_of_loop(monkeypatch, lambda: ppath._sample_loop(
        scene, camera, 8, 8, Sampler(3, "cpu"), 2, depth))
    monkeypatch.setattr(ppath, "BOUNCE_BLOCK", block)
    run = ppath.BatchRun(scene, camera, 8, 8, Sampler(3, "cpu"), depth)
    buffers = run.carry + (run.acc, run.live)
    got = run.sample_sum(Sampler(3, "cpu"), 2)
    assert got is run.acc and torch.equal(got, want)
    assert all(a is b for a, b in zip(run.carry + (run.acc, run.live),
                                      buffers))
    per_sample = []
    for bounce in loop:
        if bounce == 0:
            per_sample.append(0)
        per_sample[-1] += 1
    assert len(per_sample) == 2 and run.samples == 2
    assert run.bounces == sum(min(-(-k // block) * block, depth)
                              for k in per_sample), per_sample
    if depth == 50:
        assert max(per_sample) < 50
    else:
        assert per_sample == [7, 7]


def test_blocks_over_chunks_and_slices(monkeypatch, smoke):
    """radiance_sum on the batch route's steps (batch_route forced, eager
    on the CPU) against the per-bounce loop: 3 spp in chunks of 2, the
    whole 8x8 image and rows 32..63 of it (a span: the draws sliced), the
    progress reports the same, bit for bit."""
    scene, camera = smoke

    def render(**kw):
        seen = []
        out = ppath.radiance_sum(scene, camera, 8, 8, 3, Sampler(6, "cpu"),
                                 max_depth=5, sample_chunk=2,
                                 progress_cb=lambda d, t: seen.append((d, t)),
                                 **kw)
        return out, seen

    loop = [render(), render(pix0=32, n_pix=32)]
    monkeypatch.setattr(ppath, "batch_route", lambda *a, **k: True)
    runs = []
    real = ppath.BatchRun
    monkeypatch.setattr(ppath, "BatchRun", lambda *a, **k: runs.append(
        real(*a, **k)) or runs[-1])
    blocks = [render(), render(pix0=32, n_pix=32)]
    assert len(runs) == 2 and runs[1].span == (32, 64)
    assert all(r.graphs is None and r.samples == 3 for r in runs)
    for (a, seen_a), (b, seen_b) in zip(loop, blocks):
        assert torch.equal(a, b) and seen_a == seen_b
    assert torch.equal(loop[1][0], loop[0][0][32:])


@pytest.mark.parametrize("name", ["teapot", "smoke"])
def test_steps_read_no_host(monkeypatch, request, name):
    """start, a block of 3 bounces and add, as a capture runs them: no host
    read outside the kernel wrappers (the run's one read a block, of
    `live`, is the caller's), and the carry after them equals the
    per-bounce loop's after 3 bounces."""
    scene, camera = request.getfixturevalue(name)
    monkeypatch.setattr(ppath, "BOUNCE_BLOCK", 3)
    run = ppath.BatchRun(scene, camera, 8, 8, Sampler(2, "cpu"), 6)
    run.slot.fill(Sampler(2, "cpu").fold_in(0).key)
    run.acc.zero_()
    with no_host_reads(monkeypatch):
        run.start()
        run.block(run.blocks[0])
        run.add()
    assert [len(b) for b in run.blocks] == [3, 3]
    assert len(run.steps()) == 4
    ku, kv, kt = Sampler(2, "cpu").fold_in(0).split(3)
    x, y = ppath.pixel_grid(8, 8, "cpu")
    rays = ppath.get_rays(camera, (x + ku.key_uniform(x.shape)) / 7,
                          (y + kv.key_uniform(y.shape)) / 7, kt, 0)
    carry = ppath._start(rays)
    for bounce in range(3):
        carry = ppath._bounce(scene, kt, "kernel", None, bounce, *carry)
    for a, b in zip(run.carry, carry):
        assert torch.equal(a, b)
    assert torch.equal(run.acc, carry[2]) and bool(run.live)


def test_key_slot_draws_under_its_last_fill():
    """A sampler of a KeySlot draws under the key last written into the
    slot: filled with fold_in(key, s), its splits, streams and in_ball
    (path 5 after the slot) equal the host keys' draws bit for bit (the
    ball within 0: the same ops on the same uniforms), also when the
    slot's keys were made before the fill; the slot refuses device keys,
    and a device fold after a slot's host folds is refused."""
    host = Sampler(9, "cpu").fold_in(1000004)
    slot = KeySlot("cpu")
    kt = Sampler(0, "cpu").slotted(slot).split(3)[2]
    assert kt.key.path == (2,) and kt.key.words is slot.words
    for s in (0, 1, 7):
        slot.fill(host.fold_in(s).key)
        want = host.fold_in(s).split(3)[2]
        assert torch.equal(kt.key_uniform((33,)), want.key_uniform((33,)))
        assert torch.equal(kt.uniform(prng.MEDIUM_FLIGHT, 3, (20,)),
                           want.uniform(prng.MEDIUM_FLIGHT, 3, (20,)))
        assert torch.equal(kt.in_ball(prng.SCATTER_BALL, 4, (17,),
                                      span=(5, 40)),
                           want.in_ball(prng.SCATTER_BALL, 4, (17,),
                                        span=(5, 40)))
    with pytest.raises(ValueError, match="host words"):
        slot.fill(kt.key)
    with pytest.raises(ValueError, match="one fold"):
        kt.fold_in(torch.tensor(3, dtype=torch.int32))


@pytest.mark.parametrize("n_path", [5, 6])
@pytest.mark.parametrize("with_it", [False, True], ids=["words", "words+it"])
def test_threefry_plain_with_slot_words_matches_jax(n_path, with_it):
    """threefry_plain with the key words in a (2,) int32 tensor (a slot
    holding fold_in(fold_in(key, 1000003), 1), as the batch route writes
    it) and 5 or 6 folds after it (with_it: a device iteration first):
    bits and uniforms equal the plain version on the host-folded words and
    jax.random's uniforms on the JAX key folded the same way."""
    jk = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(3),
                                               1000003), 1)
    words = tuple(int(w) for w in np.asarray(jax.random.key_data(jk)))
    slot = KeySlot("cpu")
    slot.fill(prng.Key(words))
    path = (2, prng.SCATTER_BALL, 11, 0, 1, 5)[:n_path]
    it = torch.tensor(123_456, dtype=torch.int32) if with_it else None
    host = tf._key_plain(words, it, ())
    host = (int(host[0]), int(host[1]))
    folds = ((123_456,) if with_it else ()) + path
    for d in folds:
        jk = jax.random.fold_in(jk, d)
    for floats in (False, True):
        got = tf.threefry_plain(slot.words, it, path, 300, 17, floats, "cpu")
        want = tf.threefry_plain(host, None, path, 300, 17, floats, "cpu")
        assert torch.equal(got, want)
    full = np.asarray(jax.random.uniform(jk, (317,)))[17:]
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  full.view(np.uint32))
    with pytest.raises(ValueError, match="at most 6"):
        tf.threefry_draw(slot.words, None, path + (1,) * (7 - n_path), 4, 0,
                         True, "cpu")


def test_batch_route_matches_jax_with_real_samplers(monkeypatch):
    """The route's steps (eagerly, the key in the slot) on cornell_smoke (two
    box media: in_ball draws with 5 folds after the slot) at 6x6, 2 spp,
    depth 8, against the JAX package's sample_radiance run eagerly with
    the same seed: every draw of the longest path comes from the slot, and
    the sums agree within rtol 1e-5, atol 1e-6 on every pixel (the maps'
    cos, sin, sqrt and cbrt are libm's against XLA's; the scene has no
    mesh, so no self-hit lane to leave out; they were equal bit for bit
    at three seeds)."""
    job = jax_build_scene(jax_load_scene_desc(SMOKE))
    scene = convert.scene_from_arrays(jax_scene_arrays(job.scene))
    camera = convert.camera_from_arrays(jax_camera_arrays(job.camera))
    paths = []
    real = tf.threefry_draw

    def spy(words, it, path, *args):
        paths.append((isinstance(words, torch.Tensor), len(path)))
        return real(words, it, path, *args)

    monkeypatch.setattr(tf, "threefry_draw", spy)
    run = ppath.BatchRun(scene, camera, 6, 6, Sampler(1, "cpu"), 8)
    got = run.sample_sum(Sampler(1, "cpu"), 2).numpy()
    assert (True, 5) in paths and all(slot for slot, _ in paths)
    with jax.disable_jit():
        want = np.asarray(jpath.sample_radiance(
            job.scene, job.camera, 6, 6, jax.random.PRNGKey(1), 2, 8))
    assert got.shape == want.shape == (36, 3) and got.max() > 0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
