"""The port's multi-worker render and fit (parallel/shard.py) on CPU workers
([cpu] * 8, the counterpart of the JAX package's eight virtual CPU devices),
held against the single-worker port and, for the pixel slice, against the
JAX package:

(a) render_linear_slice equals the rows of render_linear bit for bit, and
    JAX's render_linear_slice under the same injected draws;
(b) the batch render over 8 workers equals path.render_image;
(c) the wavefront render over 8 workers agrees with one worker
    statistically, drains uneven slices, and resumes a stacked checkpoint
    bit for bit (another mesh size is refused);
(d) the sharded loss and its gradients equal the single-worker ones (the
    cornell box, and shiny_teapot through "kernel_replay"), three sharded
    steps descend, two gloo processes give the one-process image;
(e) the CLI with --device cpu,cpu resumes a stacked checkpoint and fits on
    a 2-device mesh; entry.py's contract.
"""
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from hobbyraytracer_tpu.diff import fit as jfit
from hobbyraytracer_tpu.scene import build_scene as jax_build_scene
from hobbyraytracer_tpu.scene import load_scene_desc as jax_load_scene_desc
from hobbyraytracer_tpu_torch.core.rng import Sampler
from hobbyraytracer_tpu_torch.diff import fit as pfit
from hobbyraytracer_tpu_torch.integrator import path as ppath
from hobbyraytracer_tpu_torch.integrator import wavefront as pwf
from hobbyraytracer_tpu_torch.io import checkpoint as pckpt
from hobbyraytracer_tpu_torch.parallel import shard
from hobbyraytracer_tpu_torch.scene import build_scene, load_scene_desc
from hobbyraytracer_tpu_torch.scene import convert

from _torch_parity import (ROOT, SCENES, Noise, NoiseSampler,
                           jax_camera_arrays, jax_scene_arrays,
                           patch_jax_fit_rng)

torch.set_num_threads(2)

CPU8 = [torch.device("cpu")] * 8
CORNELL = f"{SCENES}/cornell_box.yaml"


@pytest.fixture(scope="module")
def cornell():
    job = build_scene(load_scene_desc(CORNELL))
    return job.scene, job.camera


def _perturbed(scene, a=0.3, b=0.3, dr=0.4):
    from hobbyraytracer_tpu_torch.scene import ir
    m = scene.materials
    return ir.replace(scene, materials=ir.replace(
        m, albedo=torch.clamp(m.albedo * a + b, 0.0, 1.0),
        roughness=torch.clamp(m.roughness + dr, 0.0, 1.0)))


@pytest.mark.parametrize("pix0,n_pix", [(0, 64), (64, 32), (160, 96)])
def test_render_linear_slice_is_rows_of_render_linear(cornell, pix0, n_pix):
    """16x16, 2 spp, depth 3: the slice's radiance equals those rows of the
    whole image's, bit for bit (slices of whole 32-element vectors: see
    tests/test_torch_checkpoint.py on torch's CPU kernels)."""
    scene, camera = cornell
    s = Sampler(5, "cpu")
    with torch.no_grad():
        full = pfit.render_linear(scene, camera, 16, 16, s, 2, 3)
        part = pfit.render_linear_slice(scene, camera, 16, 16, s, 2, pix0,
                                        n_pix, 3)
    assert part.shape == (n_pix, 3) and full.max() > 0
    assert torch.equal(part, full[pix0:pix0 + n_pix])


def test_render_linear_slice_matches_jax(monkeypatch):
    """cornell_box 16x16, 1 spp, depth 3, the pixels 96..191: the port's
    render_linear_slice against JAX's (eager) with the same injected draws
    (its jitter through core.rng.uniform with a span on the raw sample
    keys, its integrator's draws sliced), rtol 1e-4 / atol 1e-6 (the
    render tolerance of tests/test_torch_fit.py)."""
    job = jax_build_scene(jax_load_scene_desc(CORNELL))
    scene = convert.scene_from_arrays(jax_scene_arrays(job.scene))
    camera = convert.camera_from_arrays(jax_camera_arrays(job.camera))
    key = jax.random.PRNGKey(0)
    noise = Noise(31)
    patch_jax_fit_rng(monkeypatch, noise, key, 1)
    with jax.disable_jit():
        img_j = jfit.render_linear_slice(job.scene, job.camera, 16, 16, key,
                                         1, 96, 96, 3)
    with torch.no_grad():
        img_p = pfit.render_linear_slice(scene, camera, 16, 16,
                                         NoiseSampler(noise), 1, 96, 96, 3)
    np.testing.assert_allclose(img_p.numpy(), np.asarray(img_j), rtol=1e-4,
                               atol=1e-6)
    assert img_p.max() > 0


def test_shard_rays_splits_the_batch():
    """shard_rays: 10 rays over 3 workers in slices of 4, 4 and 2, in
    order."""
    from hobbyraytracer_tpu_torch.core.types import Rays
    o = torch.arange(30, dtype=torch.float32).reshape(10, 3)
    parts = shard.shard_rays(Rays(o=o, d=-o), ["cpu"] * 3)
    assert [p.o.shape[0] for p in parts] == [4, 4, 2]
    assert torch.equal(torch.cat([p.o for p in parts]), o)
    assert torch.equal(torch.cat([p.d for p in parts]), -o)


def test_batch_render_sharded_matches_single(cornell):
    """The batch render (16x16 @ 4 spp in chunks of 2, depth 8) over 8 CPU
    workers against path.render_image: atol 1e-6."""
    scene, camera = cornell
    single = ppath.render_image(scene, camera, 16, 16, 4, Sampler(0, "cpu"),
                                max_depth=8, sample_chunk=2)
    sharded = shard.render_sharded(scene, camera, 16, 16, 4,
                                   Sampler(0, "cpu"), CPU8, max_depth=8,
                                   sample_chunk=2)
    np.testing.assert_allclose(sharded.numpy(), single.numpy(), atol=1e-6)
    assert single.max() > 0


def test_sharded_wavefront_render(cornell):
    """24x24 @ 96 spp, depth 8: 8 workers (pool 8 * 512) against one
    worker (pool 2048) with other random streams: image means within 15%,
    4x4 block means correlate > 0.85 (tests/test_dist.py's size and
    thresholds)."""
    scene, camera = cornell
    seen = []
    img_s = shard.render_wavefront_sharded(
        scene, camera, 24, 24, 96, Sampler(0, "cpu"), CPU8, max_depth=8,
        pool=8 * 512, progress_cb=lambda r, t: seen.append((r, t))).numpy()
    img_1 = pwf.render_image(scene, camera, 24, 24, 96, Sampler(1, "cpu"),
                             max_depth=8, pool=2048).numpy()
    assert seen[-1] == (24 * 24 * 96,) * 2
    assert np.isfinite(img_s).all()
    assert abs(img_s.mean() - img_1.mean()) / img_1.mean() < 0.15
    bs = img_s.reshape(6, 4, 6, 4, 3).mean(axis=(1, 3, 4))
    b1 = img_1.reshape(6, 4, 6, 4, 3).mean(axis=(1, 3, 4))
    assert np.corrcoef(bs.ravel(), b1.ravel())[0, 1] > 0.85


def test_sharded_wavefront_uneven_items(cornell):
    """10x9 @ 3 spp: 90 items over 8 workers (12 each, the last 6): every
    sample retires, the image is finite."""
    scene, camera = cornell
    seen = []
    img = shard.render_wavefront_sharded(
        scene, camera, 10, 9, 3, Sampler(0, "cpu"), CPU8, max_depth=4,
        pool=8 * 64, progress_cb=lambda r, t: seen.append((r, t)))
    assert img.shape == (9, 10, 3) and torch.isfinite(img).all()
    assert seen[-1] == (10 * 9 * 3,) * 2


class Stop(Exception):
    pass


def test_stacked_checkpoint_resumes_exactly(tmp_path, cornell):
    """16x16 @ 4 spp over 8 workers (pool 8 * 64, blocks of 4): a render
    stopped at its first checkpoint, its stacked state saved and loaded,
    resumes to the uninterrupted image bit for bit; a 4-worker mesh and a
    single-worker state are refused."""
    scene, camera = cornell
    kw = dict(max_depth=6, pool=8 * 64, steps_per_call=4)
    ref = shard.render_wavefront_sharded(scene, camera, 16, 16, 4,
                                         Sampler(5, "cpu"), CPU8, **kw)
    path = str(tmp_path / "stacked.npz")
    meta = pckpt.render_meta(16, 16, 4, pwf.SAMPLE_CHUNK, n_workers=8)

    def save_once(s):
        pckpt.save_state(path, s, meta=meta)
        raise Stop

    with pytest.raises(Stop):
        shard.render_wavefront_sharded(scene, camera, 16, 16, 4,
                                       Sampler(5, "cpu"), CPU8,
                                       checkpoint_cb=save_once, **kw)
    state = pckpt.load_state(path, expect=meta, device="cpu")
    assert state.retired.shape == (8,) and state.it == [4] * 8
    assert int(state.retired.sum()) < 16 * 16 * 4
    out = shard.render_wavefront_sharded(scene, camera, 16, 16, 4,
                                         Sampler(5, "cpu"), CPU8,
                                         state=state, **kw)
    assert torch.equal(out, ref)
    with pytest.raises(ValueError, match="same mesh size"):
        shard.render_wavefront_sharded(scene, camera, 16, 16, 4,
                                       Sampler(5, "cpu"), CPU8[:4],
                                       state=state, **kw)
    with pytest.raises(ValueError, match="single-device"):
        shard.render_wavefront_sharded(
            scene, camera, 16, 16, 4, Sampler(5, "cpu"), CPU8,
            state=pwf.init_state(16, 16, 64, "cpu"), **kw)


def _loss_and_grads(loss_fn, params):
    loss = loss_fn(params)
    loss.backward()
    return float(loss.detach()), {
        f: (np.zeros(t.shape, np.float32) if t.grad is None
            else t.grad.numpy().copy())
        for f, t in params["materials"].items()}


@pytest.mark.parametrize("name,w,h,backend", [
    ("cornell_box", 16, 16, "kernel_replay"),
    ("shiny_teapot", 16, 8, "kernel_replay")])
def test_sharded_loss_matches_single(name, w, h, backend):
    """sharded_render_loss over 8 workers against render_loss (1 spp,
    depth 3, target at 2 spp, the materials perturbed): loss rtol 1e-6,
    material gradients rtol 1e-5 / atol 1e-8; on shiny_teapot every find
    goes through "kernel_replay" (K1's plain version on the CPU). At least
    one gradient is non-zero."""
    job = build_scene(load_scene_desc(f"{SCENES}/{name}.yaml"))
    scene, camera = job.scene, job.camera
    s = Sampler(4, "cpu")
    with torch.no_grad():
        target = pfit.render_linear(scene, camera, w, h, s, 2, 3)
    start = _perturbed(scene, 0.6, 0.1, 0.1)
    p1, rebuild1 = pfit.select_params(start)
    p8, rebuild8 = pfit.select_params(start)
    l1, g1 = _loss_and_grads(lambda p: pfit.render_loss(
        p, rebuild1, camera, w, h, s, 1, target, 3, mesh_backend=backend),
        p1)
    l8, g8 = _loss_and_grads(lambda p: shard.sharded_render_loss(
        p, rebuild8, camera, w, h, s, 1, target, CPU8, 3,
        mesh_backend=backend), p8)
    assert l1 > 0
    np.testing.assert_allclose(l8, l1, rtol=1e-6)
    nonzero = 0
    for f in pfit.MAT_FIELDS:
        np.testing.assert_allclose(g8[f], g1[f], rtol=1e-5, atol=1e-8,
                                   err_msg=f)
        nonzero += int(np.abs(g1[f]).max() > 0)
    assert nonzero >= 1


def test_sharded_fit_step_descends(cornell):
    """Three sharded_fit_steps over 8 workers (16x16, 2 spp, depth 3, Adam
    lr 5e-2) from the albedo perturbed toward a target: the loss falls."""
    scene, camera = cornell
    s = Sampler(3, "cpu")
    with torch.no_grad():
        target = pfit.render_linear(scene, camera, 16, 16, s, 2, 3)
    params, rebuild = pfit.select_params(_perturbed(scene, 0.5, 0.2, 0.0))
    opt = torch.optim.Adam(shard._leaves(params), lr=5e-2)
    step = shard.make_sharded_fit_step(rebuild, camera, 16, 16, 2, target,
                                       CPU8, opt, max_depth=3)
    losses = [step(params, s) for _ in range(3)]
    assert losses[-1] < losses[0], losses
    assert float(params["materials"]["albedo"].detach().max()) <= 1.0


_WORKER = """
import sys
import numpy as np
import torch
torch.set_num_threads(1)
from hobbyraytracer_tpu_torch.core.rng import Sampler
from hobbyraytracer_tpu_torch.parallel import shard
from hobbyraytracer_tpu_torch.scene import build_scene, load_scene_desc
rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
shard.init_multihost(f"localhost:{port}", 2, rank, backend="gloo")
job = build_scene(load_scene_desc(sys.argv[4]))
img = shard.render_wavefront_sharded(job.scene, job.camera, 8, 8, 2,
                                     Sampler(4, "cpu"), ["cpu"],
                                     max_depth=4, pool=64)
if rank == 0:
    np.save(out, img.numpy())
torch.distributed.destroy_process_group()
"""


def _free_port():
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def test_two_processes_equal_two_workers(tmp_path, cornell):
    """Two gloo processes with one CPU worker each render 8x8 @ 2 spp;
    their all-reduced image equals, bit for bit, one process's render over
    two workers."""
    scene, camera = cornell
    port = str(_free_port())
    out = str(tmp_path / "img.npy")
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(r), port, out, CORNELL],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(2)]
    for p in procs:
        _, err = p.communicate(timeout=240)
        assert p.returncode == 0, err[-2000:]
    torch.set_num_threads(1)
    try:
        img = shard.render_wavefront_sharded(scene, camera, 8, 8, 2,
                                             Sampler(4, "cpu"), ["cpu"] * 2,
                                             max_depth=4, pool=64)
    finally:
        torch.set_num_threads(2)
    np.testing.assert_array_equal(np.load(out), img.numpy())


def test_cli_resumes_a_stacked_checkpoint(tmp_path, capsys, cornell):
    """`render --device cpu,cpu --checkpoint --resume`: a two-worker
    render stopped at its first checkpoint (written as the CLI writes it)
    resumes through the CLI, which prints "Resumed checkpoint" with the
    samples done; its PNG equals an uninterrupted CLI render's."""
    from hobbyraytracer_tpu_torch.cli.main import main
    scene, camera = cornell
    ck = str(tmp_path / "ck.npz")
    args = ["render", CORNELL, "--spp", "4", "--width", "8", "--height", "8",
            "--pool", "16", "--max-depth", "4", "--seed", "3", "--device",
            "cpu,cpu"]
    meta = pckpt.render_meta(8, 8, 4, pwf.SAMPLE_CHUNK, n_workers=2)

    def save_once(s):
        pckpt.save_state(ck, s, meta=meta)
        raise Stop

    with pytest.raises(Stop):
        shard.render_wavefront_sharded(
            scene, camera, 8, 8, 4, Sampler(3, "cpu"), ["cpu"] * 2,
            max_depth=4, pool=16, checkpoint_cb=save_once)
    done = int(pckpt.load_state(ck, device="cpu").retired.sum())
    assert 0 < done < 8 * 8 * 4
    a, b = str(tmp_path / "a.png"), str(tmp_path / "b.png")
    assert main(args + ["-o", a]) == 0
    capsys.readouterr()
    assert main(args + ["-o", b, "--checkpoint", ck, "--resume",
                        "--checkpoint-every", "0"]) == 0
    text = capsys.readouterr().out
    assert f"Resumed checkpoint: {ck} ({done} samples done)" in text
    assert "(2 workers)" in text
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    # the writer wrote a later state over the one it resumed
    assert int(pckpt.load_state(ck, device="cpu").retired.sum()) > done


def test_cli_fit_on_a_two_device_mesh(capsys):
    """`fit --device cpu,cpu` (cornell 16x16, 2 spp, depth 3, 3 steps)
    prints the reference's "(2-device mesh)" lines and descends (rc 0)."""
    from hobbyraytracer_tpu_torch.cli.main import main
    rc = main(["fit", CORNELL, "--device", "cpu,cpu", "--width", "16",
               "--height", "16", "--spp", "2", "--max-depth", "3",
               "--steps", "3", "--seed", "1"])
    text = capsys.readouterr().out
    assert "fit step 0: loss" in text and "(2-device mesh)" in text
    assert rc == 0, text


def test_entry_contract():
    """entry.py: the forward step's (1024, 3) output, and the dry run over
    four CPU workers."""
    from hobbyraytracer_tpu_torch import entry
    fn, args = entry.entry("cpu")
    out = fn(*args)
    assert out.shape == (1024, 3) and torch.isfinite(out).all()
    entry.dryrun_multichip(4, "cpu")


def test_cli_two_processes(tmp_path, capsys):
    """`render --num-processes 2 --coordinator ... --process-id i --device
    cpu` in two processes: process 0 writes the PNG of the two-worker
    render, byte for byte the one `--device cpu,cpu` writes in one
    process; --checkpoint across processes is refused (rc 1)."""
    from hobbyraytracer_tpu_torch.cli.main import main
    common = ["render", CORNELL, "--spp", "2", "--width", "8", "--height",
              "8", "--pool", "64", "--max-depth", "4"]
    one = str(tmp_path / "one.png")
    assert main(common + ["-o", one, "--device", "cpu,cpu"]) == 0
    port = str(_free_port())
    two = str(tmp_path / "two.png")
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "hobbyraytracer_tpu_torch.cli.main", *common,
         "-o", two, "--device", "cpu", "--num-processes", "2",
         "--coordinator", f"localhost:{port}", "--process-id", str(r)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(2)]
    for p in procs:
        out, err = p.communicate(timeout=240)
        assert p.returncode == 0, (out + err)[-2000:]
        assert "(2 workers)" in out
    with open(one, "rb") as fa, open(two, "rb") as fb:
        assert fa.read() == fb.read()
    capsys.readouterr()
    assert main(common + ["-o", two, "--device", "cpu", "--num-processes",
                          "2", "--checkpoint", str(tmp_path / "ck.npz")]) == 1
    assert "not supported across processes" in capsys.readouterr().out


@pytest.mark.parametrize("outcome", ["ok", "error"])
@pytest.mark.parametrize("cmd", ["render", "fit"])
def test_cli_leaves_its_process_group(monkeypatch, tmp_path, cmd, outcome):
    """`render` and `fit` with --num-processes 2 leave the process group
    they joined, when they return (rc 0) and when they raise. The group is
    a real one-process gloo group standing in for rank 0 of two (each
    process of a real pair must leave, or one may abort at exit): the test
    records init_process_group and destroy_process_group and checks that
    no group is left."""
    import torch.distributed as dist

    from hobbyraytracer_tpu_torch.cli.main import main
    calls = []
    init, destroy = dist.init_process_group, dist.destroy_process_group

    def recorded_init(backend, init_method, world_size, rank):
        calls.append(("init", backend, world_size, rank))
        init(backend, init_method=f"tcp://localhost:{_free_port()}",
             world_size=1, rank=0)

    def recorded_destroy(*args, **kwargs):
        calls.append(("destroy",))
        destroy(*args, **kwargs)

    def boom(*args, **kwargs):
        raise RuntimeError("the command failed")

    monkeypatch.setattr(dist, "init_process_group", recorded_init)
    monkeypatch.setattr(dist, "destroy_process_group", recorded_destroy)
    if outcome == "error":
        monkeypatch.setattr(shard, "render_wavefront_sharded", boom)
        monkeypatch.setattr(pfit, "fit_materials", boom)
    scene = CORNELL if cmd == "render" else f"{SCENES}/shiny_teapot.yaml"
    argv = [cmd, scene, "--spp", "2", "--width", "16", "--height", "16",
            "--max-depth", "3", "--device", "cpu", "--num-processes", "2",
            "--coordinator", "localhost:1", "--process-id", "0"]
    argv += (["-o", str(tmp_path / "out.png"), "--pool", "64"]
             if cmd == "render" else ["--steps", "2"])
    if outcome == "ok":
        assert main(argv) == 0
    else:
        with pytest.raises(RuntimeError, match="the command failed"):
            main(argv)
    assert calls == [("init", "gloo", 2, 0), ("destroy",)]
    assert not dist.is_initialized()
