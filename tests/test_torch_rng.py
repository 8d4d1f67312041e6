"""The port's sampler (core/rng.py and kernels/threefry.py) against
jax.random and hobbyraytracer_tpu.core.rng, on the CPU:

(a) keys: Sampler(seed)'s words are jax.random.PRNGKey(seed)'s, and
    fold_in, split and stream are jax.random's, with the iteration a host
    int or a 0-d int32 tensor;
(b) draws: uniform and randint bit for bit, with and without span=, by
    draw kind, shape and iteration (host int and 0-d tensor); the sphere,
    ball and disk maps on those uniforms within 2.5e-7 (their cos, sin,
    sqrt and cbrt are the libraries' own, last bits apart on a few
    percent of elements);
(c) call sites: each site of the port draws from the keys the JAX
    package's counterpart draws from, in the same order and at the same
    shapes (both packages' draw functions spied on), and, where the site's
    output shows its draws directly, that output agrees.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hobbyraytracer_tpu.core import rng as jrng
from hobbyraytracer_tpu.diff import edges as jedges
from hobbyraytracer_tpu.integrator import path as jpath
from hobbyraytracer_tpu.integrator import wavefront as jwf
from hobbyraytracer_tpu.ops import shade as jshade
from hobbyraytracer_tpu.scene import build_scene as jax_build_scene
from hobbyraytracer_tpu.scene import ir as jir
from hobbyraytracer_tpu.scene import load_scene_desc as jax_load_scene_desc
from hobbyraytracer_tpu.core.types import Hits as JHits
from hobbyraytracer_tpu.core.types import Rays as JRays
from hobbyraytracer_tpu_torch.core import rng as prng
from hobbyraytracer_tpu_torch.core.rng import Sampler
from hobbyraytracer_tpu_torch.core.types import Rays
from hobbyraytracer_tpu_torch.diff import edges as pedges
from hobbyraytracer_tpu_torch.integrator import path as ppath
from hobbyraytracer_tpu_torch.integrator import wavefront as pwf
from hobbyraytracer_tpu_torch.kernels import threefry as tf
from hobbyraytracer_tpu_torch.ops import shade as pshade
from hobbyraytracer_tpu_torch.parallel import shard as pshard
from hobbyraytracer_tpu_torch.scene import convert
from hobbyraytracer_tpu_torch.scene import ir as pir

from _torch_parity import (BALLS, SCENES, TEAPOT, jax_camera_arrays,
                           jax_scene_arrays)

torch.set_num_threads(2)

CORNELL = f"{SCENES}/cornell_box.yaml"
SMOKE = f"{SCENES}/cornell_smoke.yaml"
SEEDS = (0, 7, 100, 101, 102, 2 ** 31 - 1)
MAP_ATOL = 2.5e-7   # the maps' float32 results, last bits apart


def _jwords(k) -> tuple:
    return tuple(int(x) for x in np.asarray(k).tolist())


def _pwords(key: prng.Key) -> tuple:
    k0, k1 = tf._key_plain(key.words, key.it, key.path)
    return int(k0), int(k1)


def _it(iteration, as_tensor):
    return (torch.tensor(iteration, dtype=torch.int32) if as_tensor
            else iteration)


# ------------------------------------------------------------------ keys

@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_is_jax_s(seed):
    """Sampler(seed).key holds jax.random.PRNGKey(seed)'s two words."""
    assert Sampler(seed, "cpu").key.words == _jwords(
        jax.random.key_data(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("seed", (0, 7, 2 ** 31 - 1))
@pytest.mark.parametrize("as_tensor", [False, True], ids=["int", "tensor"])
def test_fold_in_split_stream_are_jax_s(seed, as_tensor):
    """fold_in (incl. the worker and chunk indices), split(2, 3, 5) and
    stream(purpose, iteration) give jax.random's words; with a tensor
    iteration the folds after it are derived on the tensor's device and
    give the same words."""
    jk = jax.random.PRNGKey(seed)
    s = Sampler(seed, "cpu")
    for i in (0, 1, 5, 1000003, 1000004, 2 ** 32 - 1):
        assert s.fold_in(i).key.words == _jwords(jax.random.fold_in(jk, i))
    for n in (2, 3, 5):
        want = [_jwords(k) for k in jax.random.split(jk, n)]
        assert [k.key.words for k in s.split(n)] == want
    for purpose in (prng.PIXEL_JITTER_U, prng.LENS, prng.EDGE_PICK):
        for it in (0, 3, 1000):
            want = jrng.stream(jk, purpose, it)
            got = s.stream(purpose, _it(it, as_tensor))
            assert _pwords(got.key) == _jwords(want)
            # a streamed key streamed again and split (the lens's in_disk)
            want2 = jax.random.split(jrng.stream(want, prng.LENS), 2)[1]
            got2 = got.stream(prng.LENS, 0).split(2)[1]
            assert _pwords(got2.key) == _jwords(want2)


def test_device_fold_is_taken_once():
    s = Sampler(0, "cpu").stream(1, torch.tensor(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="one fold"):
        s.fold_in(torch.tensor(3, dtype=torch.int32))


# ----------------------------------------------------------------- draws

_KINDS = ("uniform", "unit_sphere", "in_ball", "in_disk", "randint")
_SHAPES = [((7,), None), ((64,), (0, 64)), ((40,), (17, 100)),
           ((5, 3), None), ((4, 3), (2, 9))]


def _jax_draw(kind, key, shape, span):
    if kind == "randint":
        full = jax.random.randint(key, ((span[1],) + shape[1:]) if span
                                  else shape, 0, 1000)
        return full[span[0]:span[0] + shape[0]] if span else full
    return getattr(jrng, kind)(key, shape, span)


@pytest.mark.parametrize("kind", _KINDS)
@pytest.mark.parametrize("shape,span", _SHAPES,
                         ids=[f"{s}-{p}" for s, p in _SHAPES])
@pytest.mark.parametrize("it,as_tensor", [(3, False), (3, True),
                                          (1000003, False)],
                         ids=["int", "tensor", "large"])
def test_draw_matches_jax(kind, shape, span, it, as_tensor):
    """Sampler.<kind>(purpose, it, shape, span) against core.rng's draw on
    rng.stream(key, purpose, it) (randint: jax.random.randint, 0..1000):
    uniform and randint bit for bit, the maps within MAP_ATOL, shapes and
    dtypes equal (randint int64)."""
    purpose = prng.SCATTER_SPHERE
    s = Sampler(11, "cpu")
    args = (purpose, _it(it, as_tensor), shape)
    got = (s.randint(*args, 1000, span=span) if kind == "randint"
           else getattr(s, kind)(*args, span=span))
    want = np.asarray(_jax_draw(kind, jrng.stream(jax.random.PRNGKey(11),
                                                   purpose, it), shape, span))
    assert tuple(got.shape) == want.shape
    if kind == "randint":
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want)
    elif kind == "uniform":
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      want.view(np.uint32))
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=MAP_ATOL)


@pytest.mark.parametrize("kind", ["unit_sphere", "in_ball", "in_disk"])
def test_map_uniforms_are_jax_s(kind):
    """Under each map, the uniforms are jax.random's bit for bit: the
    map's split keys (in_ball: unit_sphere on the first half) drawn as
    uniforms equal core.rng's uniforms on the same keys."""
    jk = jrng.stream(jax.random.PRNGKey(4), prng.SCATTER_BALL, 9)
    pk = Sampler(4, "cpu").stream(prng.SCATTER_BALL, 9)
    jks, pks = list(jax.random.split(jk)), pk.split(2)
    if kind == "in_ball":
        jks = list(jax.random.split(jks[0])) + [jks[1]]
        pks = pks[0].split(2) + [pks[1]]
    for j, p in zip(jks, pks):
        np.testing.assert_array_equal(
            p.key_uniform((300,)).numpy().view(np.uint32),
            np.asarray(jrng.uniform(j, (300,))).view(np.uint32))


def test_randint_ranges_match_jax():
    """key_randint over spans that need the wrapped uint32 products
    (high above 2**16 and up to int32's top), and high <= 0 -> 0."""
    jk = jax.random.fold_in(jax.random.PRNGKey(3), prng.EDGE_PICK)
    pk = Sampler(3, "cpu").fold_in(prng.EDGE_PICK)
    for high in (1, 2, 7, 65_535, 65_537, 1_000_003, 2 ** 31 - 1):
        np.testing.assert_array_equal(
            pk.key_randint((500,), high).numpy(),
            np.asarray(jax.random.randint(jk, (500,), 0, high)))
    assert not pk.key_randint((20,), 0).any()


def test_span_draws_only_its_rows():
    """A span draw is a counter offset: the plain version is asked for the
    slice's elements only, and they equal those rows of the whole draw."""
    s = Sampler(2, "cpu")
    calls = []
    real = tf.threefry_draw

    def spy(words, it, path, n, offset, floats, device):
        calls.append((n, offset))
        return real(words, it, path, n, offset, floats, device)

    full = s.uniform(prng.LENS, 4, (1000, 3))
    tf.threefry_draw = spy
    try:
        part = s.uniform(prng.LENS, 4, (10, 3), span=(500, 1000))
    finally:
        tf.threefry_draw = real
    assert calls == [(30, 1500)]
    assert torch.equal(part, full[500:510])


def test_threefry_plain_matches_python_ints():
    """The plain version's tensor arithmetic against the same function on
    Python ints, with a device iteration and a path."""
    it = torch.tensor(-5, dtype=torch.int32)
    bits = tf.threefry_plain((123, 456), it, (6, 0, 1), 50, 7, False, "cpu")
    k = tf.threefry2x32(123, 456, 0, (-5) & 0xFFFFFFFF)
    for d in (6, 0, 1):
        k = tf.threefry2x32(k[0], k[1], 0, d)
    want = []
    for i in range(7, 57):
        a, b = tf.threefry2x32(k[0], k[1], 0, i)
        want.append(a ^ b)
    assert bits.tolist() == want


def test_off_cpu_draw_never_runs_the_plain_version(monkeypatch, tmp_path):
    """A draw on a device that is not the CPU goes to the kernel, which
    must build first: without nvcc it raises; the plain version never
    runs in its place."""
    from hobbyraytracer_tpu_torch.kernels import build as kbuild

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    def plain(*args, **kwargs):
        raise AssertionError("fell back to the plain version")

    monkeypatch.setattr(kbuild, "find_nvcc", no_nvcc)
    monkeypatch.setattr(tf, "THREEFRY", kbuild.KernelLibrary(
        "threefry", build_dir=str(tmp_path)))
    monkeypatch.setattr(tf, "threefry_plain", plain)
    with pytest.raises(RuntimeError, match="nvcc"):
        Sampler(0, "meta").uniform(prng.LENS, 0, (8,))
    assert tf.THREEFRY.launches == 0


# ------------------------------------------------------------ call sites

def _carried(path, lens=False):
    job = jax_build_scene(jax_load_scene_desc(path))
    if lens:
        job.camera = job.camera.replace(use_lens=True,
                                        lens_radius=jnp.float32(0.1))
    scene = convert.scene_from_arrays(jax_scene_arrays(job.scene))
    camera = convert.camera_from_arrays(jax_camera_arrays(job.camera))
    camera.use_lens = lens
    return job, scene, camera


def _spy(monkeypatch):
    """Record every uniform and randint draw of both packages as (kind,
    key words, full shape) in two lists: the port's Sampler._uniform /
    _randint, the JAX package's jax.random.uniform / randint (which
    core.rng.uniform calls, on the full batch of a span)."""
    seen_p, seen_j = [], []

    def full(shape, span):
        shape = tuple(int(x) for x in shape)
        return shape if span is None else (int(span[1]),) + shape[1:]

    pu, pr = Sampler._uniform, Sampler._randint

    def p_uniform(self, key, shape, span=None):
        seen_p.append(("u", _pwords(key), full(shape, span)))
        return pu(self, key, shape, span)

    def p_randint(self, key, shape, high, span=None):
        seen_p.append(("i", _pwords(key), full(shape, span)))
        return pr(self, key, shape, high, span)

    ju, ji = jax.random.uniform, jax.random.randint

    def j_uniform(key, shape=(), dtype=jnp.float32, *a, **kw):
        seen_j.append(("u", _jwords(key), tuple(int(x) for x in shape)))
        return ju(key, shape, dtype, *a, **kw)

    def j_randint(key, shape, minval, maxval, *a, **kw):
        seen_j.append(("i", _jwords(key), tuple(int(x) for x in shape)))
        return ji(key, shape, minval, maxval, *a, **kw)

    monkeypatch.setattr(Sampler, "_uniform", p_uniform)
    monkeypatch.setattr(Sampler, "_randint", p_randint)
    monkeypatch.setattr(jax.random, "uniform", j_uniform)
    monkeypatch.setattr(jax.random, "randint", j_randint)
    return seen_p, seen_j


def _regenerate_both(path, lens, it, as_tensor):
    job, scene, camera = _carried(path, lens)
    w = h = 8
    total = w * h
    js = jwf.init_state(w, h, 64).replace(it=jnp.int32(it))
    ps = pwf.init_state(w, h, 64, "cpu")
    ps.it = _it(it, as_tensor)

    def run_p():
        pwf._regenerate(ps, camera, w, h, total, Sampler(5, "cpu"))
        return ps.o, ps.d

    def run_j():
        s = jwf._regenerate(js, job.camera, w, h, total,
                            jax.random.PRNGKey(5))
        return s.o, s.d
    return run_p, run_j


def _site_jitter(as_tensor):
    return _regenerate_both(CORNELL, False, 6, as_tensor)


def _site_lens(as_tensor):
    return _regenerate_both(CORNELL, True, 6, as_tensor)


def _site_scatter(as_tensor):
    """shade.scatter on the balls' camera-ray hits (lambertian, metal and
    dielectric: the unit-sphere and the dielectric choice draws)."""
    job, scene, camera = _carried(BALLS)
    rng = np.random.default_rng(1)
    o = np.repeat(np.asarray(job.camera.origin)[None], 256, 0)
    d = np.asarray(job.camera.lower_left_corner)[None] + (
        rng.uniform(0, 1, (256, 1)) * np.asarray(job.camera.horizontal)
        + rng.uniform(0, 1, (256, 1)) * np.asarray(job.camera.vertical)
        - np.asarray(job.camera.origin))
    o, d = o.astype(np.float32), d.astype(np.float32)
    jr = JRays(o=jnp.asarray(o), d=jnp.asarray(d))
    pr = Rays(o=torch.from_numpy(o), d=torch.from_numpy(d))
    hp = pir.intersect_scene(scene, pr)
    # the same hit records on both sides, so that the scatters differ by
    # their draws and their own rounding only
    hj = JHits(**{f: jnp.asarray(getattr(hp, f).numpy())
                  for f in ("hit", "t", "p", "normal", "uv", "front_face",
                            "mat_id")})
    assert len(set(hp.mat_id.tolist())) >= 3

    def run_p():
        return pshade.scatter(scene.materials, scene.textures, pr, hp,
                              Sampler(9, "cpu"), _it(3, as_tensor))[1:]

    def run_j():
        return jshade.scatter(job.scene.materials, job.scene.textures, jr,
                              hj, jax.random.PRNGKey(9), 3)[1:]
    return run_p, run_j


def _site_rr(as_tensor):
    """One segment of cornell_smoke (media flights, lambertian,
    dielectric and isotropic scatters, Russian roulette) after one
    regenerate, at iteration 4."""
    job, scene, camera = _carried(SMOKE)
    w = h = 8
    js = jwf.init_state(w, h, 64).replace(it=jnp.int32(4))
    ps = pwf.init_state(w, h, 64, "cpu")
    ps.it = _it(4, as_tensor)
    key, sampler = jax.random.PRNGKey(2), Sampler(2, "cpu")
    js = jwf._regenerate(js, job.camera, w, h, w * h * 4, key)
    pwf._regenerate(ps, camera, w, h, w * h * 4, sampler)

    def run_p():
        pwf._segment(ps, scene, w, h, sampler, 50, 16)
        return ()

    def run_j():
        jwf._segment(js, job.scene, w, h, key, 50, 16)
        return ()
    return run_p, run_j


def _site_medium(as_tensor):
    """_intersect_medium's free flight (MEDIUM_FLIGHT, bounce * 131 +
    index) on cornell_smoke's second medium, rays through its box."""
    job, scene, camera = _carried(SMOKE)
    med_j, med_p = job.scene.media[1], scene.media[1]
    rng = np.random.default_rng(3)
    c = (np.asarray(med_p.bmin) + np.asarray(med_p.bmax)) / 2
    o = (c + rng.normal(0, 1, (128, 3)) * 400).astype(np.float32)
    d = (c - o + rng.normal(0, 20, (128, 3))).astype(np.float32)
    jr = JRays(o=jnp.asarray(o), d=jnp.asarray(d))
    pr = Rays(o=torch.from_numpy(o), d=torch.from_numpy(d))

    def run_p():
        h = pir._intersect_medium(med_p, pr, Sampler(8, "cpu"),
                                  _it(5, as_tensor), 1, 1e-3, 1e30)
        return h.hit, torch.where(h.hit, h.t, 0.0)

    def run_j():
        h = jir._intersect_medium(med_j, jr, jax.random.PRNGKey(8), 5, 1,
                                  1e-3, 1e30)
        return h.hit, jnp.where(h.hit, h.t, 0.0)
    return run_p, run_j


def _site_batch_split(as_tensor):
    """The batch integrator's sample s: fold_in(key, s), split in three:
    the jitters from the first two keys, the lens and the bounces from the
    third (cornell_box with the lens on, depth 2). as_tensor: through the
    graph route's steps run eagerly, fold_in(key, s) in the key slot."""
    job, scene, camera = _carried(CORNELL, lens=True)

    def run_p():
        if as_tensor:
            return ppath.BatchRun(scene, camera, 6, 6, Sampler(4, "cpu"),
                                  2).sample_sum(Sampler(4, "cpu"), 2)
        return ppath.sample_radiance(scene, camera, 6, 6, Sampler(4, "cpu"),
                                     2, max_depth=2)

    def run_j():
        return jpath.sample_radiance(job.scene, job.camera, 6, 6,
                                     jax.random.PRNGKey(4), 2, max_depth=2)
    return run_p, run_j


def _site_chunk_fold_in(as_tensor):
    """The batch render's sample chunks: chunk i draws from fold_in(key,
    1000003 + i) (cornell_box, 3 spp in chunks of 2, depth 1). as_tensor:
    through the graph route's steps run eagerly (batch_route forced on the
    CPU), fold_in(fold_in(key, 1000003 + i), s) in the key slot."""
    job, scene, camera = _carried(CORNELL)

    def run_p():
        if as_tensor:
            route = ppath.batch_route
            ppath.batch_route = lambda *a, **k: True
            try:
                return ppath.render_image(scene, camera, 4, 4, 3,
                                          Sampler(6, "cpu"), max_depth=1,
                                          sample_chunk=2)
            finally:
                ppath.batch_route = route
        return ppath.render_image(scene, camera, 4, 4, 3, Sampler(6, "cpu"),
                                  max_depth=1, sample_chunk=2)

    def run_j():
        return jpath.render_image(job.scene, job.camera, 4, 4, 3,
                                  jax.random.PRNGKey(6), max_depth=1,
                                  sample_chunk=2)
    return run_p, run_j


def _site_edges(as_tensor):
    """boundary_grad's picks and positions: randint on fold_in(key,
    EDGE_PICK) and uniform on fold_in(key, EDGE_S), not streams."""
    job, scene, camera = _carried(TEAPOT)
    mj = next(i for i in job.scene.instances if i.kind == "mesh").mesh
    mp = next(i for i in scene.instances if i.kind == "mesh").mesh
    e, f = jedges.build_edge_table(np.asarray(mj.indices))
    weight = np.ones((16, 16, 3), np.float32)

    def run_p():
        return pedges.boundary_grad(
            mp.verts, torch.from_numpy(e), torch.from_numpy(f), mp.indices,
            camera, torch.from_numpy(weight), 16, 16,
            lambda r: torch.zeros_like(r.o), Sampler(1, "cpu"),
            n_samples=256)

    def run_j():
        return jedges.boundary_grad(
            mj.verts, jnp.asarray(e), jnp.asarray(f), mj.indices,
            job.camera, jnp.asarray(weight), 16, 16,
            lambda r: jnp.zeros_like(r.o), jax.random.PRNGKey(1),
            n_samples=256)
    return run_p, run_j


_SITES = {"jitter": _site_jitter, "lens": _site_lens,
          "scatter": _site_scatter, "rr": _site_rr, "medium": _site_medium,
          "batch_split": _site_batch_split,
          "chunk_fold_in": _site_chunk_fold_in, "edges": _site_edges}
_WAVEFRONT_SITES = ("jitter", "lens", "scatter", "rr", "medium")
_SLOT_SITES = ("batch_split", "chunk_fold_in")


# the wavefront sites run with the iteration a host int and a 0-d tensor,
# the batch sites with host keys and with the key in a device slot; the
# others take no iteration
_SITE_CASES = [(site, as_tensor) for site in _SITES
               for as_tensor in ((False, True) if site in _WAVEFRONT_SITES
                                 + _SLOT_SITES else (False,))]


@pytest.mark.parametrize(
    "site,as_tensor", _SITE_CASES,
    ids=[f"{'tensor' if t else 'int'}-{site}" for site, t in _SITE_CASES])
def test_call_site_draws_match_jax(monkeypatch, site, as_tensor):
    """The site draws from jax's keys at jax's shapes, in jax's order;
    its outputs agree (rtol 1e-5; hit masks equal)."""
    monkeypatch.setenv("HRT_PALLAS_INTERPRET", "1")
    run_p, run_j = _SITES[site](as_tensor)
    seen_p, seen_j = _spy(monkeypatch)
    out_p = run_p()
    with jax.disable_jit():
        out_j = run_j()
    assert seen_j and seen_p == seen_j
    if not isinstance(out_p, tuple):
        out_p, out_j = (out_p,), (out_j,)
    for a, b in zip(out_p, out_j):
        a, b = a.detach().numpy(), np.asarray(b)
        if a.dtype == bool:
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def test_shard_workers_draw_from_fold_in(monkeypatch):
    """render_wavefront_sharded's worker g draws from fold_in(key, g) (the
    reference's parallel/shard.py:170): worker g's first jitter draws are
    on stream(fold_in(key, g), PIXEL_JITTER_U / _V, 0), one value for each
    of its 4 lanes."""
    job, scene, camera = _carried(CORNELL)
    seen_p, _ = _spy(monkeypatch)
    pshard.render_wavefront_sharded(scene, camera, 4, 4, 1,
                                    Sampler(3, "cpu"), ["cpu", "cpu"],
                                    pool=8, max_depth=1)
    key = jax.random.PRNGKey(3)
    for g in (0, 1):
        for purpose in (prng.PIXEL_JITTER_U, prng.PIXEL_JITTER_V):
            want = _jwords(jrng.stream(jax.random.fold_in(key, g), purpose,
                                       0))
            assert ("u", want, (4,)) in seen_p, (g, purpose)
