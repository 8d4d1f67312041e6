"""Checkpoint/resume of the port (io/checkpoint.py, render_state's state= and
checkpoint_cb=) and the span-sliced draws (core/rng.py) its sharded paths
rest on, held against the JAX package on the CPU:

(a) every span-sliced draw equals the rows of the full draw, bitwise;
(b) the .npz format: every field round-trips, a mismatched geometry is
    refused, a v3 file loads, and a file written by either package loads
    in the other field for field;
(c) an interrupted and resumed render equals the uninterrupted one bit for
    bit, and a JAX mid-render state finishes in the port as JAX finishes
    it, under the same injected noise;
(d) a stacked (multi-worker) state is refused by render_state, and a
    state whose pool is dry comes back at once.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hobbyraytracer_tpu.integrator import wavefront as jwf
from hobbyraytracer_tpu.io import checkpoint as jckpt
from hobbyraytracer_tpu.scene import build_scene as jax_build_scene
from hobbyraytracer_tpu.scene import load_scene_desc as jax_load_scene_desc
from hobbyraytracer_tpu_torch.core import rng as prng
from hobbyraytracer_tpu_torch.core.rng import Sampler
from hobbyraytracer_tpu_torch.integrator import wavefront as pwf
from hobbyraytracer_tpu_torch.io import checkpoint as pckpt
from hobbyraytracer_tpu_torch.scene import convert

from _torch_parity import (SCENES, Noise, NoiseSampler, jax_camera_arrays,
                           jax_scene_arrays, patch_jax_rng)

torch.set_num_threads(2)

W = H = 12
SPP = 4
KW = dict(max_depth=6, pool=128)


@pytest.fixture(scope="module")
def cornell():
    job = jax_build_scene(jax_load_scene_desc(f"{SCENES}/cornell_box.yaml"))
    return (job, convert.scene_from_arrays(jax_scene_arrays(job.scene)),
            convert.camera_from_arrays(jax_camera_arrays(job.camera)))


_DRAWS = ["uniform", "randint", "unit_sphere", "in_ball"]


@pytest.mark.parametrize("kind,offset,n", [
    (k, o, n) for k in _DRAWS for o, n in ((0, 32), (32, 64), (96, 32))]
    + [(k, o, n) for k in ("uniform", "randint")
       for o, n in ((13, 19), (40, 24))])
def test_span_draw_is_the_rows_of_the_full_draw(kind, offset, n):
    """span=(offset, 128) of a (n,) draw is rows offset:offset+n of the
    (128,) draw of the same stream, bit for bit (unit_sphere and in_ball
    slice the ray axis of their (2,) + shape and (3,) + shape uniforms).
    Their sin, cos and pow are elementwise, but torch's CPU kernels compute
    the remainder of a 32-element vector loop by another code path, so
    their slices here are whole multiples of 32 elements; a CUDA kernel
    computes every element alike."""
    s = Sampler(3, "cpu")
    extra = (5,) if kind == "randint" else ()
    full = getattr(s, kind)(prng.SCATTER_SPHERE, 9, (128,), *extra)
    part = getattr(s, kind)(prng.SCATTER_SPHERE, 9, (n,), *extra,
                            span=(offset, 128))
    assert part.shape == (n,) + full.shape[1:]
    assert torch.equal(part, full[offset:offset + n])


def _fields(state):
    return {f: (np.asarray(state.it, np.int32) if f == "it"
                else getattr(state, f).numpy()) for f in pckpt._FIELDS}


def _jfields(state):
    return {f: np.asarray(getattr(state, f)) for f in pckpt._FIELDS}


def _assert_same_fields(a, b):
    for f in pckpt._FIELDS:
        assert a[f].dtype == b[f].dtype, (f, a[f].dtype, b[f].dtype)
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)


def _busy_state():
    """A port state with something in every field."""
    rng = np.random.default_rng(4)
    st = pwf.init_state(8, 8, 32, "cpu")
    st.fb += torch.from_numpy(rng.random((3, 64), dtype=np.float32))
    st.o = torch.from_numpy(rng.normal(size=(32, 3)).astype(np.float32))
    st.item = torch.from_numpy(rng.integers(-1, 64, 32).astype(np.int32))
    st.depth = torch.from_numpy(rng.integers(-1, 9, 32).astype(np.int32))
    st.defer = torch.from_numpy(rng.random(32) < 0.3)
    st.counter.fill_(5)
    st.retired.fill_(40)
    st.it = 9
    return st


def test_roundtrip_preserves_all_fields(tmp_path):
    st = _busy_state()
    path = str(tmp_path / "rt.npz")
    pckpt.save_state(path, st)
    back = pckpt.load_state(path, device="cpu")
    assert back.it == 9 and isinstance(back.it, int)
    _assert_same_fields(_fields(back), _fields(st))


def test_meta_mismatch_rejected(tmp_path):
    """v4 metadata: another sample count or worker count is refused with
    the reference's messages; a file with no expectation, and a v3 file
    (no metadata), load."""
    st = pwf.init_state(8, 8, 32, "cpu")
    path = str(tmp_path / "meta.npz")
    meta = pckpt.render_meta(8, 8, samples=16, sample_chunk=4, n_workers=1)
    pckpt.save_state(path, st, meta=meta)
    pckpt.load_state(path, expect=meta, device="cpu")
    pckpt.load_state(path, device="cpu")
    with pytest.raises(ValueError, match="samples"):
        pckpt.load_state(path, expect=pckpt.render_meta(8, 8, 32, 4, 1),
                         device="cpu")
    with pytest.raises(ValueError, match="N-device mesh"):
        pckpt.load_state(path, expect=pckpt.render_meta(8, 8, 16, 4, 4),
                         device="cpu")
    legacy = str(tmp_path / "legacy.npz")
    arrays = _fields(st)
    arrays["__version__"] = np.int32(3)
    np.savez(legacy, **arrays)
    pckpt.load_state(legacy, expect=meta, device="cpu")
    arrays["__version__"] = np.int32(5)
    np.savez(legacy, **arrays)
    with pytest.raises(ValueError, match="version 5"):
        pckpt.load_state(legacy, device="cpu")


def test_files_cross_between_the_packages(tmp_path):
    """A state written by JAX's save_state loads in the port field for
    field (dtypes included), and the port's in JAX's load_state; so does a
    stacked two-worker state, with its geometry checked by JAX."""
    j = jwf.init_state(8, 8, 32)
    j = j.replace(counter=jnp.int32(5), it=jnp.int32(9), fb=j.fb + 1.25,
                  item=j.item.at[3].set(17), defer=j.defer.at[2].set(True))
    jpath = str(tmp_path / "jax.npz")
    meta = pckpt.render_meta(8, 8, 4, 4, 1)
    jckpt.save_state(jpath, j, meta=meta)
    p = pckpt.load_state(jpath, expect=meta, device="cpu")
    assert p.it == 9
    _assert_same_fields(_fields(p), _jfields(j))

    st = _busy_state()
    ppath = str(tmp_path / "port.npz")
    pckpt.save_state(ppath, st, meta=meta)
    _assert_same_fields(_jfields(jckpt.load_state(ppath, expect=meta)),
                        _fields(st))

    from hobbyraytracer_tpu_torch.parallel import shard
    stacked = shard._stack([st, _busy_state()], "cpu")
    spath = str(tmp_path / "stacked.npz")
    smeta = pckpt.render_meta(8, 8, 4, 4, 2)
    pckpt.save_state(spath, stacked, meta=smeta)
    back = jckpt.load_state(spath, expect=smeta)
    assert back.retired.shape == (2,) and back.fb.shape == (2, 3, 64)
    _assert_same_fields(_jfields(back), _fields(stacked))
    with pytest.raises(ValueError, match="N-device mesh"):
        jckpt.load_state(spath, expect=meta)
    again = pckpt.load_state(spath, expect=smeta, device="cpu")
    assert again.it == [9, 9]


class Stop(Exception):
    pass


def _interrupted(render, path, meta=None, **kwargs):
    """Run `render` until its first checkpoint_cb, save that state to
    `path` and stop."""
    def save_once(s):
        pckpt.save_state(path, s, meta=meta)
        raise Stop

    with pytest.raises(Stop):
        render(checkpoint_cb=save_once, **kwargs)


def test_resume_is_exact(tmp_path, cornell):
    """cornell_box 12x12 @ 4 spp, pool 128: a render stopped after its
    first block of 16 iterations, saved, loaded and resumed equals the
    uninterrupted render bit for bit (fb, retired, counter and the final
    `it`); progress reaches the total."""
    _, scene, camera = cornell
    seen = []
    kw = dict(KW, steps_per_call=16)
    ref = pwf.render_state(scene, camera, W, H, SPP, Sampler(7, "cpu"),
                           progress_cb=lambda r, t: seen.append((r, t)), **kw)
    assert seen[-1] == (W * H * SPP,) * 2
    path = str(tmp_path / "ck.npz")
    meta = pckpt.render_meta(W, H, SPP, pwf.SAMPLE_CHUNK)
    _interrupted(lambda **k: pwf.render_state(
        scene, camera, W, H, SPP, Sampler(7, "cpu"), **k), path, meta, **kw)
    state = pckpt.load_state(path, expect=meta, device="cpu")
    assert 0 < int(state.retired) < W * H * SPP and state.it == 16
    out = pwf.render_state(scene, camera, W, H, SPP, Sampler(7, "cpu"),
                           state=state, **KW)
    assert torch.equal(out.fb, ref.fb)
    assert int(out.retired) == int(ref.retired) == W * H * SPP
    assert int(out.counter) == int(ref.counter)
    assert out.it == ref.it


def test_dry_state_returns_at_once(cornell):
    """A finished state handed back to render_state comes back at once:
    no iteration runs, `it` and the framebuffer unchanged."""
    _, scene, camera = cornell
    st = pwf.render_state(scene, camera, 6, 6, 2, Sampler(1, "cpu"),
                          max_depth=4, pool=32)
    fb, it = st.fb.clone(), st.it
    calls = []
    again = pwf.render_state(scene, camera, 6, 6, 2, Sampler(1, "cpu"),
                             max_depth=4, pool=32, state=st,
                             checkpoint_cb=calls.append)
    assert again.it == it and torch.equal(again.fb, fb) and not calls


def test_stacked_state_rejected_single_device(cornell):
    _, scene, camera = cornell
    from hobbyraytracer_tpu_torch.parallel import shard
    base = pwf.init_state(8, 8, 32, "cpu")
    stacked = shard._stack([base, pwf.init_state(8, 8, 32, "cpu")], "cpu")
    with pytest.raises(ValueError, match="stacked worker"):
        pwf.render_state(scene, camera, 8, 8, 2, Sampler(0, "cpu"),
                         state=stacked, max_depth=4, pool=32)


def test_jax_checkpoint_resumes_in_the_port(monkeypatch, tmp_path, cornell):
    """JAX's render_state of cornell_box 12x12 @ 4 spp (pool 128, depth 6;
    eager, with injected noise) checkpoints after its first block of 16
    iterations and renders on to the end. The port loads that JAX file and
    resumes it under the same noise: it finishes where JAX's uninterrupted
    render does (retired, counter and `it` equal) with the same
    framebuffer, rtol 1e-4 / atol 1e-5 (the state-for-state tolerance of
    tests/test_torch_wavefront.py; the scene has no mesh, so no lane
    differs by a self-hit)."""
    job, scene, camera = cornell
    noise = Noise(23)
    patch_jax_rng(monkeypatch, noise)
    path = str(tmp_path / "jax_mid.npz")
    meta = pckpt.render_meta(W, H, SPP, pwf.SAMPLE_CHUNK)
    saved = []

    def save_first(s):
        if not saved:
            jckpt.save_state(path, s, meta=meta)
            saved.append(int(s.retired))

    with jax.disable_jit():
        js = jwf.render_state(job.scene, job.camera, W, H, SPP,
                              jax.random.PRNGKey(0), steps_per_call=16,
                              checkpoint_cb=save_first, **KW)
    assert 0 < saved[0] < W * H * SPP
    state = pckpt.load_state(path, expect=meta, device="cpu")
    assert state.it == 16
    ps = pwf.render_state(scene, camera, W, H, SPP, NoiseSampler(noise),
                          state=state, steps_per_call=5, **KW)
    assert int(ps.retired) == int(js.retired) == W * H * SPP
    assert int(ps.counter) == int(js.counter)
    assert ps.it == int(js.it)
    np.testing.assert_allclose(ps.fb.numpy(), np.asarray(js.fb), rtol=1e-4,
                               atol=1e-5)
    assert ps.fb.max() > 0


def test_async_writer_skips_raises_and_joins(tmp_path, capsys):
    """The CLI's AsyncCheckpoint: a call before `every` seconds writes
    nothing; a due call writes a snapshot (later in-place updates of the
    live state do not reach the file); a failed write raises at the next
    call; close() reports the failure of the last write."""
    from hobbyraytracer_tpu_torch.cli.main import AsyncCheckpoint
    st = _busy_state()
    path = str(tmp_path / "w.npz")
    lazy = AsyncCheckpoint(path, None, every=3600.0)
    lazy(st)
    lazy.close()
    assert lazy.thread is None
    w = AsyncCheckpoint(path, None, every=0.0)
    before = st.fb.clone()
    w(st)
    st.fb += 1.0           # the render goes on updating its state in place
    w.close()
    assert torch.equal(pckpt.load_state(path, device="cpu").fb, before)
    bad = AsyncCheckpoint(str(tmp_path / "no" / "dir.npz"), None, every=0.0)
    bad(st)
    bad.thread.join()
    with pytest.raises(RuntimeError, match="checkpoint write failed"):
        bad(st)
    bad.close()
    assert "final checkpoint write failed" in capsys.readouterr().out


def test_debug_nans_names_the_first_bad_field():
    """--debug-nans' check: a finite state passes; a NaN in `thr` raises
    FloatingPointError naming the field and the lane."""
    from hobbyraytracer_tpu_torch.cli.main import check_finite
    st = _busy_state()
    check_finite(st)
    st.thr[7, 1] = float("nan")
    with pytest.raises(FloatingPointError, match=r"thr at \(7, 1\)"):
        check_finite(st)
