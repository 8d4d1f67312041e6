"""Shared helpers of the tests/test_torch_*.py parity tests (not collected:
the name does not start with test_).

- the JAX package's SceneIR / Camera flattened into the nested dicts of
  numpy arrays that hobbyraytracer_tpu_torch.scene.convert reads;
- random meshes, rays and the teapot's cluster tables for the mesh-find
  tests, and the agreement check between two mesh finds;
- the scattered-balls scene's sphere pool and a random pool with their
  cluster tables, for the sphere-find tests;
- models on the CPU of the CUDA kernels' schedules (the mesh traversal,
  the sphere find, the key kernel and the dense sphere scan's order);
- `Noise`: seeded numpy noise per (purpose, iteration), fed identically
  to the port (through a Sampler subclass) and to the JAX package
  (through a monkeypatch of hobbyraytracer_tpu.core.rng; for the fit's
  per-sample keys, also of jax.random.uniform and jax.checkpoint);
- `no_host_reads`: a guard that fails on any host read outside the
  kernel wrappers (what a CUDA graph's capture must not meet), and
  FOG_YAML, a scene whose medium is bounded by a mesh (its finds read the
  host).
"""
from __future__ import annotations

import contextlib
import os
import zlib

import numpy as np
import torch

from hobbyraytracer_tpu_torch.core.rng import Sampler
from hobbyraytracer_tpu_torch.kernels import mesh_traverse as kmod
from hobbyraytracer_tpu_torch.kernels import sphere_traverse as skmod
from hobbyraytracer_tpu_torch.kernels.mesh_traverse import (
    pack_bounds, pack_mesh_soa, pack_mesh_stream)
from hobbyraytracer_tpu_torch.scene import objloader
from hobbyraytracer_tpu_torch.scene.bvh import build_clusters

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
SCENES = os.path.join(ROOT, "scenes")
TEAPOT = os.path.join(SCENES, "teapot_scene.yaml")
HIRES = os.path.join(SCENES, "teapot_hires.yaml")
BALLS = os.path.join(SCENES, "scattered_balls.yaml")


# a constant medium bounded by a mesh (format it with the mesh's path)
FOG_YAML = """
film: {width: 16, height: 16, samples: 1, output: fog.png}
camera: {position: [0, 2.5, 8.5], look_at: [0, 2.5, 0], up: [0, 1, 0],
         fov: 45, aperture: 0.0, focal_distance: 8.5,
         background: [0.6, 0.7, 0.9]}
materials:
  - {name: white, type: lambertian, albedo: [0.73, 0.73, 0.73]}
objects:
  - {type: xz_rect, x: [-2.5, 2.5], z: [-2.5, 2.5], k: 0, material: white}
  - type: constant_medium
    density: 2.0
    albedo: [0.9, 0.9, 0.9]
    boundary: {type: mesh, path: %s}
"""

HOST_READS = ("item", "__bool__", "__int__", "__float__", "__index__",
              "tolist", "nonzero")
# the kernel wrappers: one launch on the card, so their plain versions,
# which stand in for them on the CPU, may read the host
KERNEL_WRAPPERS = ((kmod, "traverse_clusters"), (kmod, "coherence_keys"),
                   (skmod, "intersect_spheres_kernel"))


@contextlib.contextmanager
def no_host_reads(monkeypatch, allowed=()):
    """Inside the block, Tensor.item / __bool__ / __int__ / __float__ /
    __index__ / tolist / nonzero and torch.nonzero raise, except inside a
    kernel wrapper or one of `allowed`, (owner, attribute) pairs of other
    functions that may."""
    state = {"armed": False, "inside": 0}

    def guard(name, orig):
        def f(*args, **kwargs):
            if state["armed"] and not state["inside"]:
                raise AssertionError(f"the block read the host: {name}")
            return orig(*args, **kwargs)
        return f

    def lifted(orig):
        def f(*args, **kwargs):
            state["inside"] += 1
            try:
                return orig(*args, **kwargs)
            finally:
                state["inside"] -= 1
        return f

    for name in HOST_READS:
        monkeypatch.setattr(torch.Tensor, name,
                            guard(name, getattr(torch.Tensor, name)))
    monkeypatch.setattr(torch, "nonzero", guard("nonzero", torch.nonzero))
    for owner, name in KERNEL_WRAPPERS + tuple(allowed):
        monkeypatch.setattr(owner, name, lifted(getattr(owner, name)))
    state["armed"] = True
    try:
        yield
    finally:
        state["armed"] = False


def np_tree(x):
    return np.asarray(x)


def jax_scene_arrays(scene) -> dict:
    """JAX SceneIR -> the dict layout of scene/convert.py."""
    rect_f = ("axis", "a0", "a1", "b0", "b1", "k", "mat_id")
    mesh_f = ("verts", "normals", "uvs", "indices", "mat_id", "cluster_id",
              "cluster_bmin", "cluster_bmax", "tri_soa", "bounds8")
    mat_f = ("mtype", "albedo", "albedo_tex", "roughness", "roughness_tex",
             "strength", "strength_tex", "ior", "metallness",
             "metallness_tex")
    tex_f = ("ttype", "solid", "solid2", "atlas", "offset", "width",
             "height")
    sphere_f = ("center", "radius", "mat_id", "kernel_table",
                "kernel_bounds", "kernel_ids")

    def spheres(table):
        return {f: (None if getattr(table, f) is None
                    else np_tree(getattr(table, f))) for f in sphere_f}

    def optional(obj, fields):
        return {f: (None if getattr(obj, f) is None
                    else np_tree(getattr(obj, f))) for f in fields}

    def mesh(m):
        if m is None:
            return None
        return dict(optional(m, mesh_f), use_bvh=bool(m.use_bvh))

    def transform(tr):
        return None if tr is None else {
            "translate": np_tree(tr.translate),
            "scale": np_tree(tr.scale), "quat": np_tree(tr.quat)}

    instances = []
    for inst in scene.instances:
        instances.append({
            "kind": inst.kind,
            "spheres": (spheres(inst.spheres) if inst.spheres is not None
                        else None),
            "rects": ({f: np_tree(getattr(inst.rects, f)) for f in rect_f}
                      if inst.rects is not None else None),
            "mesh": mesh(inst.mesh),
            "transform": transform(inst.transform)})
    media = [dict(optional(med, ("center", "radius", "bmin", "bmax",
                                 "neg_inv_density", "mat_id")),
                  btype=med.btype, mesh=mesh(med.mesh),
                  transform=transform(med.transform))
             for med in scene.media]
    m = scene.materials
    return {
        "rects": {f: np_tree(getattr(scene.rects, f)) for f in rect_f},
        "instances": instances,
        "materials": dict({f: np_tree(getattr(m, f)) for f in mat_f},
                          present=tuple(m.present),
                          textured=tuple(m.textured),
                          tex_types=tuple(m.tex_types)),
        "textures": dict({f: np_tree(getattr(scene.textures, f))
                          for f in tex_f},
                         bilinear=bool(scene.textures.bilinear)),
        "background_tex": int(np.asarray(scene.background_tex)),
        "spheres": spheres(scene.spheres),
        "media": media,
    }


def jax_camera_arrays(cam) -> dict:
    f = ("origin", "lower_left_corner", "horizontal", "vertical", "u", "v",
         "w", "lens_radius")
    return dict({k: np_tree(getattr(cam, k)) for k in f},
                use_lens=bool(cam.use_lens))


def assert_tree_close(a, b, path="", atol=1e-6):
    """Nested dict/list/tuple equality: ints and bools exact, floats within
    atol (absolute) and 1e-6 relative."""
    if isinstance(a, dict):
        assert set(a) == set(b), (path, sorted(a), sorted(b))
        for k in a:
            assert_tree_close(a[k], b[k], f"{path}.{k}", atol)
    elif isinstance(a, (list, tuple)) and not isinstance(a, np.ndarray):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_tree_close(x, y, f"{path}[{i}]", atol)
    elif a is None or isinstance(a, (str, bool, int)):
        assert a == b, (path, a, b)
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, (path, a.shape, b.shape)
        assert a.dtype == b.dtype, (path, a.dtype, b.dtype)
        if np.issubdtype(a.dtype, np.floating):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=atol,
                                       err_msg=path)
        else:
            np.testing.assert_array_equal(a, b, err_msg=path)


class Noise:
    """Deterministic numpy noise per (purpose, iteration, shape)."""

    def __init__(self, seed=0):
        self.seed = seed

    def fold_in(self, index) -> "Noise":
        """Independent noise for sub-render `index` (Sampler.fold_in)."""
        return Noise((self.seed, int(index)))

    def _rng(self, purpose, iteration, shape, kind):
        h = zlib.crc32(repr((self.seed, int(purpose), int(iteration),
                             tuple(shape), kind)).encode())
        return np.random.default_rng(h)

    def uniform(self, purpose, iteration, shape) -> np.ndarray:
        return self._rng(purpose, iteration, shape, "u").random(
            tuple(shape), dtype=np.float32)

    def randint(self, purpose, iteration, shape, high) -> np.ndarray:
        return self._rng(purpose, iteration, shape, "i").integers(
            0, high, tuple(shape))

    def unit_sphere(self, purpose, iteration, shape) -> np.ndarray:
        g = self._rng(purpose, iteration, shape, "s").normal(
            size=tuple(shape) + (3,))
        return (g / np.linalg.norm(g, axis=-1, keepdims=True)).astype(
            np.float32)


    def in_ball(self, purpose, iteration, shape) -> np.ndarray:
        g = self._rng(purpose, iteration, shape, "b")
        d = g.normal(size=tuple(shape) + (3,))
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        return (d * np.cbrt(g.random(tuple(shape)))[..., None]).astype(
            np.float32)

    def in_disk(self, purpose, iteration, shape) -> np.ndarray:
        g = self._rng(purpose, iteration, shape, "d")
        r = np.sqrt(g.random(tuple(shape)))
        phi = g.random(tuple(shape)) * (2.0 * np.pi)
        return np.stack([r * np.cos(phi), r * np.sin(phi)], -1).astype(
            np.float32)


def _span_rows(full: np.ndarray, shape, span) -> np.ndarray:
    """Rows offset:offset+n of a full-batch draw (core/rng.py span)."""
    if span is None:
        return full
    return full[int(span[0]):int(span[0]) + int(tuple(shape)[0])]


def _full(shape, span):
    return tuple(shape) if span is None else (int(span[1]),) + tuple(
        shape)[1:]


class NoiseSampler(Sampler):
    """The port's Sampler drawing from a `Noise` instead of threefry; a
    span draws the full batch's noise and takes its rows.

    The key operations keep the noise's (purpose, iteration) streams where
    the port draws from a folded, split or streamed key: fold_in(tag)'s
    own draws (key_uniform, key_randint) are the parent's (tag, 0) stream;
    split(n)'s keys i < n - 1 draw the (i, 0) stream from their own key
    (the batch integrator's jitter keys: PIXEL_JITTER_U is 0 and
    PIXEL_JITTER_V 1) and key n - 1 is the sampler itself; stream(purpose,
    it)'s draws at iteration 0 read iteration `it` (the wavefront lens
    streams (LENS, it) and draws (LENS, 0) from it)."""

    def __init__(self, noise: Noise, device="cpu", tag=None, iteration=0):
        super().__init__(0, device)
        self.noise = noise
        self.tag = tag                  # (noise, purpose) of the own draws
        self.iteration = iteration      # read where a draw asks for 0

    def _it(self, iteration):
        return self.iteration if int(iteration) == 0 else iteration

    def split(self, n):
        return [NoiseSampler(self.noise, self.device, (self.noise, i))
                for i in range(n - 1)] + [self]

    def stream(self, purpose, iteration):
        return NoiseSampler(self.noise, self.device, iteration=iteration)

    def key_uniform(self, shape, span=None):
        noise, tag = self.tag
        return self._out(noise.uniform(tag, 0, _full(shape, span)), shape,
                         span)

    def key_randint(self, shape, high, span=None):
        noise, tag = self.tag
        return self._out(noise.randint(tag, 0, _full(shape, span), high),
                         shape, span)

    def _out(self, full, shape, span):
        return torch.from_numpy(np.ascontiguousarray(
            _span_rows(full, shape, span))).to(self.device)

    def uniform(self, purpose, iteration, shape, span=None):
        return self._out(self.noise.uniform(purpose, self._it(iteration),
                                            _full(shape, span)), shape, span)

    def fold_in(self, index):
        return NoiseSampler(self.noise.fold_in(index), self.device,
                            (self.noise, index))

    def randint(self, purpose, iteration, shape, high, span=None):
        return self._out(self.noise.randint(purpose, self._it(iteration),
                                            _full(shape, span), high),
                         shape, span)

    def unit_sphere(self, purpose, iteration, shape, span=None):
        return self._out(self.noise.unit_sphere(purpose, self._it(iteration),
                                                _full(shape, span)),
                         shape, span)

    def in_ball(self, purpose, iteration, shape, span=None):
        return self._out(self.noise.in_ball(purpose, self._it(iteration),
                                            _full(shape, span)), shape, span)

    def in_disk(self, purpose, iteration, shape, span=None):
        return self._out(self.noise.in_disk(purpose, self._it(iteration),
                                            _full(shape, span)), shape, span)


def patch_jax_rng(monkeypatch, noise: Noise) -> None:
    """Route hobbyraytracer_tpu.core.rng draws to `noise` (eager calls
    only: the stream index is read as a Python int); a span draws the full
    batch's noise and takes its rows. A stream of a key that is already a
    stream keeps that stream's index: the wavefront integrator hands
    get_rays stream(key, LENS, it), which get_rays streams again by LENS
    (bounce 0), and the draw is the port's (LENS, it)."""
    import jax.numpy as jnp

    from hobbyraytracer_tpu.core import rng

    def draw(kind):
        def f(k, shape=(), span=None):
            full = getattr(noise, kind)(k[0], k[1], _full(shape, span))
            return jnp.asarray(_span_rows(full, shape, span))
        return f

    def stream(key, purpose, bounce=0):
        if isinstance(key, tuple):
            return int(purpose), key[1]
        return int(purpose), int(np.asarray(bounce))

    monkeypatch.setattr(rng, "stream", stream)
    for kind in ("uniform", "unit_sphere", "in_ball", "in_disk"):
        monkeypatch.setattr(rng, kind, draw(kind))


def patch_jax_fit_rng(monkeypatch, noise: Noise, key, n_samples) -> None:
    """Route the draws of the JAX package's diff/fit.py:render_linear and
    render_linear_slice (sample s of n_samples: pixel jitter from
    jax.random.uniform, or from core.rng.uniform with a span, on the keys
    ku, kv split from fold_in(key, s); the integrator's draws through
    hobbyraytracer_tpu.core.rng on the third of them, the lens's
    in_disk(stream(kt, LENS)) among them) to noise.fold_in(s), as the
    port's Sampler.fold_in(s) draws them; a span draws the full
    batch's noise and takes its rows. Also run jax.checkpoint's body as it
    is (it would trace it). Eager calls only (under jax.disable_jit())."""
    import jax
    import jax.numpy as jnp

    from hobbyraytracer_tpu.core import rng

    def raw(k):
        return np.asarray(jax.random.key_data(k)
                          if jnp.issubdtype(k.dtype, jax.dtypes.prng_key)
                          else k).tobytes()

    jitter, trace_keys = {}, {}
    for s in range(n_samples):
        ku, kv, kt = jax.random.split(jax.random.fold_in(key, s), 3)
        jitter[raw(ku)] = (s, 0)          # PIXEL_JITTER_U
        jitter[raw(kv)] = (s, 1)          # PIXEL_JITTER_V
        trace_keys[raw(kt)] = s
    real_uniform = jax.random.uniform

    def uniform(k, shape=(), dtype=jnp.float32, *args, **kwargs):
        hit = jitter.get(raw(k))
        if hit is None:
            return real_uniform(k, shape, dtype, *args, **kwargs)
        return jnp.asarray(noise.fold_in(hit[0]).uniform(hit[1], 0, shape))

    def draw(kind):
        def f(k, shape=(), span=None):
            if isinstance(k, tuple):      # a stream of the integrator
                src, purpose, it = noise.fold_in(k[0]), k[1], k[2]
            else:                         # a sample's jitter key
                s, purpose = jitter[raw(k)]
                src, it = noise.fold_in(s), 0
            full = getattr(src, kind)(purpose, it, _full(shape, span))
            return jnp.asarray(_span_rows(full, shape, span))
        return f

    monkeypatch.setattr(jax.random, "uniform", uniform)
    monkeypatch.setattr(jax, "checkpoint", lambda f, *a, **k: f)
    monkeypatch.setattr(rng, "stream", lambda k, purpose, bounce=0: (
        trace_keys[raw(k)], int(purpose), int(np.asarray(bounce))))
    for kind in ("uniform", "unit_sphere", "in_ball", "in_disk"):
        monkeypatch.setattr(rng, kind, draw(kind))


def random_mesh(seed, n_tris=500, spread=3.0):
    """Random triangle soup with per-vertex normals and UVs."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(-spread, spread, (n_tris, 3)).astype(np.float32)
    v1 = base + rng.normal(0, 0.3, (n_tris, 3)).astype(np.float32)
    v2 = base + rng.normal(0, 0.3, (n_tris, 3)).astype(np.float32)
    verts = np.concatenate([base, v1, v2], axis=0).astype(np.float32)
    idx = np.arange(3 * n_tris, dtype=np.int32).reshape(3, n_tris).T.copy()
    normals = rng.normal(0, 1, verts.shape).astype(np.float32)
    uvs = rng.uniform(0, 1, (len(verts), 2)).astype(np.float32)
    return verts, idx, normals, uvs


def cluster_tables(verts, idx, normals, uvs, leaf=128):
    """(bounds8 (8,K), tri_soa (K,24,L), tri_id (K,L)) as numpy."""
    cl = build_clusters(verts, idx, leaf_size=leaf)
    corner = idx[np.maximum(cl["tri_id"], 0)]
    soa = pack_mesh_soa(cl["tri_verts"], normals[corner], uvs[corner])
    return pack_bounds(cl["bmin"], cl["bmax"]), soa, cl["tri_id"], cl


def teapot_tables():
    m = objloader.parse_obj(f"{ROOT}/assets/teapot.obj")
    return cluster_tables(m["verts"], m["indices"], m["normals"], m["uvs"])


def hires_tables(n_tris=None):
    """teapot_hires's (or its first n_tris triangles') cluster tables:
    (bounds8, tri_soa (K,24,L), tri_id, stream table (K,32,L))."""
    m = objloader.parse_obj(f"{ROOT}/assets/teapot_hires.obj")
    idx = m["indices"][:n_tris]
    bounds8, soa, tri_id, _ = cluster_tables(m["verts"], idx, m["normals"],
                                             m["uvs"])
    return bounds8, soa, tri_id, pack_mesh_stream(soa, tri_id)


def aimed_rays(seed, n, center=(0.0, 0.0, 0.0), half=1.5, spread=3.0):
    """Rays from a box of half-size `spread` aimed at points of a box of
    half-size `half` around `center`, so most of them reach a mesh there."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    tgt = (rng.uniform(-half, half, (n, 3))
           + np.asarray(center)).astype(np.float32)
    return o, (tgt - o).astype(np.float32), np.ones((n,), bool)


def random_rays(seed, n, spread=6.0, valid_every=1):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    d = rng.normal(0, 1, (n, 3)).astype(np.float32)
    valid = np.zeros((n,), bool)
    valid[::valid_every] = True
    return o, d, valid


def pack_rays8(o, d, valid):
    return np.concatenate([o, d, valid.astype(np.float32)[:, None],
                           np.zeros((len(o), 1), np.float32)], axis=1)


def assert_find_match(t_p, id_p, n_p, uv_p, t_j, id_j, n_j, uv_j, need_uv):
    """Two mesh finds agree: hit masks equal; t with rtol = atol = 1e-6;
    ids differ on < 1% of hits (exact t-ties); normals and UVs within 1e-5
    where the ids agree; uv zeros without need_uv."""
    hit_p, hit_j = t_p < 1e30, t_j < 1e30
    np.testing.assert_array_equal(hit_p, hit_j)
    assert hit_p.any()
    np.testing.assert_allclose(t_p[hit_p], t_j[hit_p], rtol=1e-6, atol=1e-6)
    same = (id_p == id_j) & hit_p
    assert 1.0 - same.sum() / hit_p.sum() < 0.01
    assert (id_p[~hit_p] == -1).all()
    np.testing.assert_allclose(n_p[same], n_j[same], rtol=1e-5, atol=1e-5)
    if need_uv:
        np.testing.assert_allclose(uv_p[same], uv_j[same], rtol=1e-5,
                                   atol=1e-5)
        assert np.abs(uv_p[hit_p]).max() > 0
    else:
        assert (uv_p == 0).all() and (uv_j == 0).all()


def sphere_pool(seed, n, spread=10.0):
    """A random sphere pool: center (n, 3), radius (n,), mat_id (n,)."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(-spread, spread, (n, 3)).astype(np.float32),
            rng.uniform(0.2, 1.5, (n,)).astype(np.float32),
            rng.integers(0, 5, (n,)).astype(np.int32))


def tied_sphere_pool(seed, n=485):
    """sphere_pool with exact ties: spheres 0, 8, ..., 232 repeated under
    higher indices, the first half 4 places later (mostly in the same
    chunk of 128), the second half 245 places later (in a later chunk);
    every source also gets some of `aimed_rays`' targets. -> center,
    radius, mat_id, and the rays (o, d) aimed at the sources."""
    center, radius, mat = sphere_pool(seed, n, spread=10.0)
    src = np.arange(0, 240, 8)
    dst = np.where(src < 120, src + 4, src + 245)
    center[dst], radius[dst] = center[src], radius[src]
    rng = np.random.default_rng(seed + 1)
    o = rng.uniform(-15.0, 15.0, (4000, 3)).astype(np.float32)
    tgt = center[rng.choice(src, 4000)] + rng.normal(0, 0.3, (4000, 3))
    return center, radius, mat, o, (tgt - o).astype(np.float32)


def scan_by_sphere(rays, center, radius, t_min, t_max=1e30):
    """The sphere_scan kernel's order in PyTorch (csrc/sphere_scan.cu):
    every sphere in index order, by the scan's own sphere_t, folded into a
    running minimum with a strict < -> (t, idx int64)."""
    from hobbyraytracer_tpu_torch.kernels.sphere_scan import sphere_t
    n = rays.o.shape[0]
    best_t = torch.full((n,), 1e30, dtype=torch.float32,
                        device=rays.o.device)
    best_i = torch.full((n,), -1, dtype=torch.int64, device=rays.o.device)
    for s in range(center.shape[0]):
        t = sphere_t(rays, center[s:s + 1], radius[s:s + 1], t_min,
                     t_max)[:, 0]
        take = t < best_t
        best_t = torch.where(take, t, best_t)
        best_i = torch.where(take, s, best_i)
    return best_t, best_i


def balls_pool():
    """scenes/scattered_balls.yaml's pooled spheres (485, the ground sphere
    of radius 1000 among them) as numpy: center, radius, mat_id and the
    cluster tables table (4, 8, 128), bounds8 (8, 4), ids (4, 128)."""
    from hobbyraytracer_tpu_torch.scene import build_scene, load_scene_desc
    sp = build_scene(load_scene_desc(BALLS)).scene.spheres
    return tuple(getattr(sp, f).numpy() for f in (
        "center", "radius", "mat_id", "kernel_table", "kernel_bounds",
        "kernel_ids"))


# --- a model of the CUDA mesh traversal's visit schedule -------------------
#
# csrc/mesh_traverse.cuh runs only on a card. Its schedule is modelled here
# in numpy/torch so that the CPU tests can hold it against the plain
# version: a per-ray window of the `window` smallest pending (entry, index)
# pairs filled by one scan over the clusters (the kernel's insertion, slot
# by slot), consumed in order and refilled only when a full window ran out;
# the scan by the ray's own lane when more than `warp_scan_max` lanes of
# its warp of 32 want one, else by the warp (lanes over clusters, then
# `window` reductions on (bits of entry, index)); and the leaf test with
# lanes over triangle slots (lane j holds slots j, j + 32, ... of a pass
# of 32 * lane_slots), reduced over the 32 lanes on (bits of t, slot) as
# the kernel's two integer warp reductions do.

MODEL_LANES = 32


def _model_offer(we, wk, e, c, last_e, last_k):
    """The kernel's `offer`, row-wise: the pairs (e, c) (a row each) go
    into the rows' sorted windows we, wk (rows, W) where they come after
    (last_e, last_k) and below the window's last entry."""
    window = we.shape[1]
    after = (e > last_e) | ((e == last_e) & (c > last_k))
    ins = after & (e < we[:, window - 1])
    for i in range(window - 1, -1, -1):
        here = ins & (e < we[:, i])
        left = max(i - 1, 0)
        shift = here & (e < we[:, left]) & (i > 0)
        we[:, i] = np.where(here, np.where(shift, we[:, left], e), we[:, i])
        wk[:, i] = np.where(here, np.where(shift, wk[:, left], c), wk[:, i])


def _model_scan(entry, last_e, last_k, best_t, window):
    """The kernel's scan_window for every ray at once (each by its own
    lane): entry (R, K) -> (we (R, W) float32, wk (R, W) int64), empty
    slots k = -1."""
    n, k_clusters = entry.shape
    we = np.repeat(best_t[:, None], window, axis=1).astype(np.float32)
    wk = np.full((n, window), -1, np.int64)
    for c in range(k_clusters):
        _model_offer(we, wk, entry[:, c], c, last_e, last_k)
    return we, wk


def _model_scan_warp(entry, last_e, last_k, best_t, window):
    """The kernel's scan_window_warp for one ray: entry (K,) -> (we (W,),
    wk (W,)). Lane j offers clusters j, j + 32, ... to a window of its
    own; then `window` rounds take the smallest (bits of entry, index)
    pair at the head of any lane's window."""
    k_clusters = entry.shape[0]
    pad = -k_clusters % MODEL_LANES
    lanes = np.concatenate([entry, np.full((pad,), np.inf, np.float32)])
    lanes = lanes.reshape(-1, MODEL_LANES).T              # (32, K / 32)
    me = np.full((MODEL_LANES, window), best_t, np.float32)
    mk = np.full((MODEL_LANES, window), -1, np.int64)
    for j in range(lanes.shape[1]):                       # the lanes' offers
        _model_offer(me, mk, lanes[:, j],
                     j * MODEL_LANES + np.arange(MODEL_LANES), last_e, last_k)
    none = np.uint32(0xFFFFFFFF)
    we = np.full((window,), best_t, np.float32)
    wk = np.full((window,), -1, np.int64)
    for i in range(window):
        head = (me[:, 0] + np.float32(0.0)).view(np.uint32)
        key = np.where(mk[:, 0] < 0, none, head)
        e_min = key.min()
        if e_min == none:
            break
        k_min = np.where(key == e_min, mk[:, 0], k_clusters).min()
        we[i] = np.array([e_min], np.uint32).view(np.float32)[0]
        wk[i] = k_min
        owner = int(np.flatnonzero((key == e_min) & (mk[:, 0] == k_min))[0])
        me[owner, :-1] = me[owner, 1:]
        mk[owner, :-1] = mk[owner, 1:]
        mk[owner, window - 1] = -1
    return we, wk


def _model_leaf(o, d, blk, ids, t_max, lane_slots):
    """Lanes-over-slots leaf test of A (ray, cluster) visits: o, d (A, 3),
    blk (A, 9, L), ids (A, L) -> (t (A,), slot (A,), u (A,), v (A,)), t =
    1e30 and slot = -1 without a hit. Arithmetic in torch float32, op for
    op as the kernel (and the plain version) orders it."""
    a, _, leaf = blk.shape
    ox, oy, oz = (o[:, c:c + 1] for c in range(3))
    dx, dy, dz = (d[:, c:c + 1] for c in range(3))
    v0x, v0y, v0z = blk[:, 0], blk[:, 1], blk[:, 2]
    e1x, e1y, e1z = blk[:, 3], blk[:, 4], blk[:, 5]
    e2x, e2y, e2z = blk[:, 6], blk[:, 7], blk[:, 8]
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    inv = 1.0 / torch.where(det == 0.0, 1.0, det)
    tx, ty, tz = ox - v0x, oy - v0y, oz - v0z
    u = (tx * px + ty * py + tz * pz) * inv
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv
    t = (e2x * qx + e2y * qy + e2z * qz) * inv
    good = ((det != 0.0) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
            & (t > 0.0) & (t <= t_max) & (ids >= 0))
    t, u, v, good = (x.numpy() for x in (t, u, v, good))
    big = np.float32(1e30)
    tc = np.full((a,), big, np.float32)
    lc = np.full((a,), -1, np.int64)
    uc = np.zeros((a,), np.float32)
    vc = np.zeros((a,), np.float32)
    none = np.uint32(0xFFFFFFFF)
    rows = np.arange(a)
    for base in range(0, leaf, MODEL_LANES * lane_slots):   # one pass
        t_l = np.full((a, MODEL_LANES), big, np.float32)
        slot_l = np.full((a, MODEL_LANES), none, np.uint32)
        u_l = np.zeros((a, MODEL_LANES), np.float32)
        v_l = np.zeros((a, MODEL_LANES), np.float32)
        for s in range(lane_slots):        # a lane's own slots, ascending
            lo = base + MODEL_LANES * s
            width = min(MODEL_LANES, leaf - lo)
            if width <= 0:
                break
            sl = slice(lo, lo + width)
            take = good[:, sl] & (t[:, sl] < t_l[:, :width])
            t_l[:, :width] = np.where(take, t[:, sl], t_l[:, :width])
            u_l[:, :width] = np.where(take, u[:, sl], u_l[:, :width])
            v_l[:, :width] = np.where(take, v[:, sl], v_l[:, :width])
            slot_l[:, :width] = np.where(
                take, np.arange(lo, lo + width, dtype=np.uint32),
                slot_l[:, :width])
        bits = t_l.view(np.uint32)         # t > 0: the bits order as uints
        t_min = bits.min(axis=1)
        slot = np.where(bits == t_min[:, None], slot_l, none).min(axis=1)
        owner = (slot & np.uint32(31)).astype(np.int64)
        better = t_min.view(np.float32) < tc
        tc = np.where(better, t_min.view(np.float32), tc)
        lc = np.where(better, slot.astype(np.int64), lc)
        uc = np.where(better, u_l[rows, owner], uc)
        vc = np.where(better, v_l[rows, owner], vc)
    return tc, lc, uc, vc


def _model_rounds(entry, valid, best_t, window, warp_scan_max, stats):
    """The kernels' round loop for every ray at once: refills the windows
    that ran empty (refill_windows: by the ray's own lane when more than
    `warp_scan_max` lanes of its warp want a scan, else by the warp), ends
    the rays with nothing left below their best t, and yields (idx, kk):
    the rays that visit now and the cluster each visits. The caller tests
    the leaves and lowers `best_t` (N,) in place before it asks for the next
    round. `stats` gets visits, scans and warp_scans (N,) int64."""
    n, k_clusters = entry.shape
    last_e = np.full((n,), -1.0, np.float32)
    last_k = np.full((n,), -1, np.int64)
    we = np.full((n, window), np.float32(1e30), np.float32)
    wk = np.full((n, window), -1, np.int64)
    more = np.ones((n,), bool)
    done = ~valid
    for name in ("visits", "scans", "warp_scans"):
        stats[name] = np.zeros((n,), np.int64)
    warp_of = np.arange(n) // MODEL_LANES
    while True:
        empty = ~done & (wk[:, 0] < 0)
        scan = np.flatnonzero(empty & more)
        if scan.size:
            wanting = np.bincount(warp_of[scan], minlength=warp_of[-1] + 1)
            own = wanting[warp_of[scan]] > warp_scan_max
            lone, together = scan[own], scan[~own]
            we[lone], wk[lone] = _model_scan(
                entry[lone], last_e[lone], last_k[lone], best_t[lone], window)
            for r in together:
                we[r], wk[r] = _model_scan_warp(
                    entry[r], last_e[r], last_k[r], best_t[r], window)
            # a window that came back full may have left pairs behind,
            # unless it holds every cluster there is
            more[scan] = (wk[scan, window - 1] >= 0) & (k_clusters > window)
            stats["scans"][scan] += 1
            stats["warp_scans"][together] += 1
        done = np.where(empty, wk[:, 0] < 0, done)
        done |= ~done & ~(we[:, 0] < best_t)
        idx = np.flatnonzero(~done)
        if idx.size == 0:
            return
        kk = wk[idx, 0].copy()
        stats["visits"][idx] += 1
        last_e[idx] = we[idx, 0]
        last_k[idx] = kk
        we[idx, :-1] = we[idx, 1:]
        wk[idx, :-1] = wk[idx, 1:]
        wk[idx, window - 1] = -1
        yield idx, kk


def model_traverse(rays8, bounds8, tri_soa, tri_id, t_max=1e30,
                   need_uv=True, window=4, lane_slots=4, warp_scan_max=16):
    """The CUDA traversal's schedule on the CPU (numpy arrays in and out):
    -> (out (N, 8) float32, id (N,) int32, visits (N,) int64 leaf visits,
    scans (N,) int64 slab scans of each ray, warp_scans (N,) int64 those
    of them the ray's warp made together)."""
    from hobbyraytracer_tpu_torch.kernels.mesh_traverse import slab_entries
    rays = torch.from_numpy(np.ascontiguousarray(rays8))
    soa = torch.from_numpy(np.ascontiguousarray(tri_soa[:, :24]))
    if tri_soa.shape[1] == 32:
        tri_id = np.ascontiguousarray(tri_soa[:, 24]).view(np.int32)
    ids_t = torch.from_numpy(np.ascontiguousarray(tri_id))
    n = rays.shape[0]
    o, d = rays[:, 0:3], rays[:, 3:6]
    valid = rays[:, 6] > 0.0
    entry = slab_entries(o, d, valid, torch.from_numpy(bounds8),
                         float(t_max)).numpy()
    out = np.zeros((n, 8), np.float32)
    out[:, 0] = np.float32(1e30)
    best_id = np.full((n,), -1, np.int32)
    stats = {}
    for idx, kk in _model_rounds(entry, valid.numpy(), out[:, 0], window,
                                 warp_scan_max, stats):
        tc, lc, uc, vc = _model_leaf(o[idx], d[idx], soa[kk, 0:9],
                                     ids_t[kk], float(t_max), lane_slots)
        take = tc < out[idx, 0]
        idx, kk, tc, lc, uc, vc = (x[take] for x in (idx, kk, tc, lc, uc, vc))
        a = tri_soa[kk, 9:24, lc]                         # (A', 15)
        w0 = np.float32(1.0) - uc - vc
        out[idx, 0] = tc
        for c in range(3):
            out[idx, 1 + c] = (w0 * a[:, c] + uc * a[:, 3 + c]
                               + vc * a[:, 6 + c])
        if need_uv:
            for c in range(2):
                out[idx, 4 + c] = (w0 * a[:, 9 + c] + uc * a[:, 11 + c]
                                   + vc * a[:, 13 + c])
        best_id[idx] = tri_id[kk, lc]
    return out, best_id, stats["visits"], stats["scans"], stats["warp_scans"]


# --- models of the sphere kernel K4 and the key kernel K3 ------------------
#
# csrc/sphere_traverse.cu walks the same windows as the mesh kernels
# (_model_rounds) and tests a round's leaves in one of two ways, chosen by
# the number of lanes of the warp that visit: each lane for itself, slot
# after slot with a strict < fold, or the warp for each of them, lanes over
# sphere slots reduced on (bits of t, slot). In both the root is computed
# only where disc > 0.
# csrc/coherence_keys.cu picks each axis' near and far bound by the ray's
# direction and keeps one running limit, over boxes padded to a multiple of
# 4 with boxes at 1e30.


def _model_sphere_leaf(o, d, blk, t_min, t_max, lanes_over_slots,
                       lane_slots=4):
    """A (ray, cluster) visits of the sphere kernel: o, d (A, 3), blk (A, 4,
    L) rows [cx cy cz r2] -> (t (A,), slot (A,)), 1e30 and -1 without a hit.
    Torch float32, op for op as the kernel orders it; sqrt and the roots
    only for the (visit, sphere) pairs with disc > 0."""
    a_n, _, leaf = blk.shape
    ox, oy, oz = (o[:, c:c + 1] for c in range(3))
    dx, dy, dz = (d[:, c:c + 1] for c in range(3))
    a = (dx * dx + dy * dy + dz * dz).expand(a_n, leaf)
    inv_a = (1.0 / (dx * dx + dy * dy + dz * dz)).expand(a_n, leaf)
    ocx, ocy, ocz = ox - blk[:, 0], oy - blk[:, 1], oz - blk[:, 2]
    half_b = ocx * dx + ocy * dy + ocz * dz
    c = ocx * ocx + ocy * ocy + ocz * ocz - blk[:, 3]
    disc = half_b * half_b - a * c
    sel = disc > 0.0                     # only these reach the root path
    hb, ia = half_b[sel], inv_a[sel]
    sq = torch.sqrt(disc[sel])
    r1 = (-hb - sq) * ia
    r2 = (-hb + sq) * ia
    in1 = (r1 >= t_min) & (r1 <= t_max)
    in2 = (r2 >= t_min) & (r2 <= t_max)
    big = np.float32(1e30)
    t = torch.full((a_n, leaf), float(big))
    t[sel] = torch.where(in1, r1, torch.where(in2, r2, float(big)))
    t = t.numpy()
    none = np.uint32(0xFFFFFFFF)
    tc = np.full((a_n,), big, np.float32)
    lc = np.full((a_n,), -1, np.int64)
    if not lanes_over_slots:             # a strict < fold, slot after slot
        for l in range(leaf):
            better = t[:, l] < tc
            tc = np.where(better, t[:, l], tc)
            lc = np.where(better, l, lc)
        return tc, lc
    for base in range(0, leaf, MODEL_LANES * lane_slots):   # one pass
        t_l = np.full((a_n, MODEL_LANES), big, np.float32)
        slot_l = np.full((a_n, MODEL_LANES), none, np.uint32)
        for s in range(lane_slots):      # a lane's own slots, ascending
            lo = base + MODEL_LANES * s
            width = min(MODEL_LANES, leaf - lo)
            if width <= 0:
                break
            take = t[:, lo:lo + width] < t_l[:, :width]
            t_l[:, :width] = np.where(take, t[:, lo:lo + width],
                                      t_l[:, :width])
            slot_l[:, :width] = np.where(
                take, np.arange(lo, lo + width, dtype=np.uint32),
                slot_l[:, :width])
        # ordered_bits: the bits of t as unsigned integers that order as t
        bits = t_l.view(np.uint32)
        bits = np.where(bits >> 31, ~bits, bits | np.uint32(0x80000000))
        t_best = bits.min(axis=1)
        slot = np.where(bits == t_best[:, None], slot_l, none).min(axis=1)
        t_w = t_l[np.arange(a_n), (slot & np.uint32(31)).astype(np.int64)]
        better = t_w < tc
        tc = np.where(better, t_w, tc)
        lc = np.where(better, slot.astype(np.int64), lc)
    return tc, lc


def sphere_warp_visit_max(leaf, miss_ops=19, broadcast_ops=24):
    """The sphere kernel's rule for a round's visits: with more visiting
    lanes than this each lane visits for itself (`leaf` misses a round),
    else the warp visits for each of them (a broadcast and a pass of misses
    per 32 slots a ray)."""
    return miss_ops * leaf // (broadcast_ops + miss_ops * ((leaf + 31) // 32))


def model_sphere_traverse(rays8, bounds8, table, ids, t_min, t_max=1e30,
                          window=4, warp_visit_max=None, warp_scan_max=16):
    """The CUDA sphere kernel's schedule on the CPU (numpy in and out): ->
    (t (N,) float32, id (N,) int32, visits (N,), scans (N,) int64, by_warp
    (N,) int64 those of the visits that the ray's warp made together).
    `warp_visit_max` None is the kernel's rule; 0 makes every visit the
    lane's own and 32 every visit the warp's."""
    from hobbyraytracer_tpu_torch.kernels.mesh_traverse import slab_entries
    rays = torch.from_numpy(np.ascontiguousarray(rays8))
    tab = torch.from_numpy(np.ascontiguousarray(table[:, 0:4]))
    n = rays.shape[0]
    o, d = rays[:, 0:3], rays[:, 3:6]
    valid = rays[:, 6] > 0.0
    t_min, t_max = float(np.float32(t_min)), float(np.float32(t_max))
    entry = slab_entries(o, d, valid, torch.from_numpy(bounds8),
                         t_max).numpy()
    best_t = np.full((n,), np.float32(1e30), np.float32)
    best_id = np.full((n,), -1, np.int32)
    if warp_visit_max is None:
        warp_visit_max = sphere_warp_visit_max(table.shape[2])
    by_warp = np.zeros((n,), np.int64)
    stats = {}
    for idx, kk in _model_rounds(entry, valid.numpy(), best_t, window,
                                 warp_scan_max, stats):
        warp = idx // MODEL_LANES
        together = np.bincount(warp)[warp] <= warp_visit_max
        tc = np.empty((idx.size,), np.float32)
        lc = np.empty((idx.size,), np.int64)
        for sel, lanes_over_slots in ((~together, False), (together, True)):
            if sel.any():
                tc[sel], lc[sel] = _model_sphere_leaf(
                    o[idx[sel]], d[idx[sel]], tab[kk[sel]], t_min, t_max,
                    lanes_over_slots)
        by_warp[idx[together]] += 1
        take = tc < best_t[idx]
        best_t[idx[take]] = tc[take]
        best_id[idx[take]] = ids[kk[take], lc[take]]
    return best_t, best_id, stats["visits"], stats["scans"], by_warp


def model_keys(rays8, bounds8, t_max=1e30):
    """The CUDA key kernel's loop on the CPU (numpy in and out): boxes
    padded to a multiple of 4 with boxes at 1e30; per ray and axis the near
    and the far bound chosen by the sign of 1/d, not by a min and a max of
    the two products; one running limit a ray (min(e_min, t_max), 0 for an
    invalid ray) that a box must stay strictly below, boxes in index order;
    e_min is the limit of a ray that took a box.
    -> (e_min (N,) float32, first (N,) int32)."""
    n, k_clusters = rays8.shape[0], bounds8.shape[1]
    stride = -(-k_clusters // 4) * 4
    boxes = np.full((6, stride), np.float32(1e30), np.float32)
    boxes[:, :k_clusters] = bounds8[:6]
    boxes = torch.from_numpy(boxes)
    rays = torch.from_numpy(np.ascontiguousarray(rays8))
    o, d = rays[:, 0:3], rays[:, 3:6]
    valid = (rays[:, 6] > 0.0).numpy()
    lo = hi = None
    for ax in range(3):
        inv = 1.0 / torch.where(d[:, ax:ax + 1].abs() < 1e-30, 1e-30,
                                d[:, ax:ax + 1])
        neg = inv < 0.0
        near = torch.where(neg, boxes[3 + ax:4 + ax], boxes[ax:ax + 1])
        far = torch.where(neg, boxes[ax:ax + 1], boxes[3 + ax:4 + ax])
        lo_ax = (near - o[:, ax:ax + 1]) * inv
        hi_ax = (far - o[:, ax:ax + 1]) * inv
        lo = lo_ax if lo is None else torch.maximum(lo, lo_ax)
        hi = hi_ax if hi is None else torch.minimum(hi, hi_ax)
    e = torch.clamp(lo, min=0.0).numpy()
    hi = hi.numpy()
    lim = np.where(valid, np.float32(t_max), np.float32(0.0))
    first = np.full((n,), -1, np.int32)       # -1 until a box was taken
    for c in range(stride):
        better = (hi[:, c] > e[:, c]) & (e[:, c] < lim)
        lim = np.where(better, e[:, c], lim)
        first = np.where(better, c, first).astype(np.int32)
    return (np.where(first < 0, np.float32(np.inf), lim).astype(np.float32),
            np.maximum(first, 0))


def tie_tables(seed=5, n_tris=400):
    """Tables built to have exact t-ties: each 64-triangle leaf of a random
    mesh is doubled to 128 slots with a copy of itself rolled by 5 slots
    (equal triangles in different lanes of the leaf test, under other ids),
    and the whole table is doubled (every cluster a second time under a
    higher index, with an equal box and equal triangles). The winner must
    be the lowest slot of the lowest cluster. -> (bounds8, tri_soa (2K, 24,
    128), tri_id (2K, 128))."""
    bounds8, soa, tri_id, _ = cluster_tables(*random_mesh(seed, n_tris),
                                             leaf=64)
    rolled = np.roll(tri_id, 5, axis=1)
    soa = np.concatenate([soa, np.roll(soa, 5, axis=2)], axis=2)
    tri_id = np.concatenate(
        [tri_id, np.where(rolled >= 0, rolled + n_tris, -1)], axis=1)
    soa = np.concatenate([soa, soa], axis=0)
    tri_id = np.concatenate(
        [tri_id, np.where(tri_id >= 0, tri_id + 2 * n_tris, -1)], axis=0)
    bounds8 = np.concatenate([bounds8, bounds8], axis=1)
    return (np.ascontiguousarray(bounds8), np.ascontiguousarray(soa),
            np.ascontiguousarray(tri_id.astype(np.int32)))


def refill_rays(rays8, bounds8, t_final, window, t_max=1e30):
    """How many rays enter more than `window` clusters before their final
    hit (slab entry below the final t): each of them consumes a full
    window and scans again."""
    from hobbyraytracer_tpu_torch.kernels.mesh_traverse import slab_entries
    rays = torch.as_tensor(rays8)
    entry = slab_entries(rays[:, 0:3], rays[:, 3:6], rays[:, 6] > 0.0,
                         torch.as_tensor(bounds8), t_max)
    entered = (entry < torch.as_tensor(t_final)[:, None]).sum(dim=1)
    return int((entered > window).sum())
