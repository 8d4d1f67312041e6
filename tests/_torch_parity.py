"""Shared helpers of the tests/test_torch_*.py parity tests (not collected:
the name does not start with test_).

- the JAX package's SceneIR / Camera flattened into the nested dicts of
  numpy arrays that hobbyraytracer_tpu_torch.scene.convert reads;
- random meshes, rays and the teapot's cluster tables for the mesh-find
  tests, and the agreement check between two mesh finds;
- `Noise`: seeded numpy noise per (purpose, iteration), fed identically
  to the port (through a Sampler subclass) and to the JAX package
  (through a monkeypatch of hobbyraytracer_tpu.core.rng).
"""
from __future__ import annotations

import os
import zlib

import numpy as np
import torch

from hobbyraytracer_tpu_torch.core.rng import Sampler
from hobbyraytracer_tpu_torch.kernels.mesh_traverse import (pack_bounds,
                                                            pack_mesh_soa)
from hobbyraytracer_tpu_torch.scene import objloader
from hobbyraytracer_tpu_torch.scene.bvh import build_clusters

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
SCENES = os.path.join(ROOT, "scenes")
TEAPOT = os.path.join(SCENES, "teapot_scene.yaml")


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
    instances = []
    for inst in scene.instances:
        mesh = None
        if inst.mesh is not None:
            mesh = {f: (None if getattr(inst.mesh, f) is None
                        else np_tree(getattr(inst.mesh, f))) for f in mesh_f}
            mesh["use_bvh"] = bool(inst.mesh.use_bvh)
        tr = inst.transform
        instances.append({
            "kind": inst.kind,
            "rects": ({f: np_tree(getattr(inst.rects, f)) for f in rect_f}
                      if inst.rects is not None else None),
            "mesh": mesh,
            "transform": (None if tr is None else {
                "translate": np_tree(tr.translate),
                "scale": np_tree(tr.scale), "quat": np_tree(tr.quat)})})
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
        "spheres": {"center": np_tree(scene.spheres.center),
                    "radius": np_tree(scene.spheres.radius),
                    "mat_id": np_tree(scene.spheres.mat_id)},
        "media": list(scene.media),
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

    def __init__(self, seed: int = 0):
        self.seed = seed

    def _rng(self, purpose, iteration, shape, kind):
        h = zlib.crc32(repr((self.seed, int(purpose), int(iteration),
                             tuple(shape), kind)).encode())
        return np.random.default_rng(h)

    def uniform(self, purpose, iteration, shape) -> np.ndarray:
        return self._rng(purpose, iteration, shape, "u").random(
            tuple(shape), dtype=np.float32)

    def unit_sphere(self, purpose, iteration, shape) -> np.ndarray:
        g = self._rng(purpose, iteration, shape, "s").normal(
            size=tuple(shape) + (3,))
        return (g / np.linalg.norm(g, axis=-1, keepdims=True)).astype(
            np.float32)


class NoiseSampler(Sampler):
    """The port's Sampler drawing from a `Noise` instead of generators."""

    def __init__(self, noise: Noise, device="cpu"):
        super().__init__(0, device)
        self.noise = noise

    def uniform(self, purpose, iteration, shape):
        return torch.from_numpy(self.noise.uniform(purpose, iteration,
                                                   shape)).to(self.device)

    def unit_sphere(self, purpose, iteration, shape):
        return torch.from_numpy(self.noise.unit_sphere(
            purpose, iteration, shape)).to(self.device)


def patch_jax_rng(monkeypatch, noise: Noise) -> None:
    """Route hobbyraytracer_tpu.core.rng draws to `noise` (eager calls
    only: the stream index is read as a Python int)."""
    import jax.numpy as jnp

    from hobbyraytracer_tpu.core import rng

    monkeypatch.setattr(rng, "stream", lambda key, purpose, bounce=0: (
        int(purpose), int(np.asarray(bounce))))
    monkeypatch.setattr(rng, "uniform", lambda k, shape=(), span=None:
                        jnp.asarray(noise.uniform(k[0], k[1], shape)))
    monkeypatch.setattr(rng, "unit_sphere", lambda k, shape=(), span=None:
                        jnp.asarray(noise.unit_sphere(k[0], k[1], shape)))


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
