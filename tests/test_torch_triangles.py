"""The port's triangle finds outside any kernel (ops/intersect.py:
triangle_t, triangle_attribs, intersect_triangles, the lockstep
intersect_mesh_clustered, aabb_hit, the lockstep branch of
intersect_triangles_bvh, the cohsort switch of the fused find) and their
routing in scene/ir.py, against the JAX package's on seeded inputs. Float
results within rtol = atol = 1e-6 unless a test says otherwise (XLA's CPU
build contracts a*b+c into FMAs, PyTorch rounds each op)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hobbyraytracer_tpu.core.types import Rays as JRays
from hobbyraytracer_tpu.ops import intersect as jisect
from hobbyraytracer_tpu.scene import ir as jir
from hobbyraytracer_tpu_torch.core.types import Rays
from hobbyraytracer_tpu_torch.kernels import mesh_traverse as kmod
from hobbyraytracer_tpu_torch.ops import intersect as pisect
from hobbyraytracer_tpu_torch.scene import ir as pir

from _torch_parity import (aimed_rays, cluster_tables, random_mesh,
                           random_rays, teapot_tables)

torch.set_num_threads(2)

BIG = 1e30


def _both(o, d):
    return (Rays(o=torch.from_numpy(o), d=torch.from_numpy(d)),
            JRays(o=jnp.asarray(o), d=jnp.asarray(d)))


def _tri_rays(seed, n, n_tris):
    """Triangles around the origin and rays aimed into them, some of them
    along an axis (the permutation's ties) and some away from the mesh."""
    verts, idx, _, _ = random_mesh(seed, n_tris, spread=1.5)
    o, d, _ = aimed_rays(seed + 1, n)
    d[:8] = np.eye(3, dtype=np.float32)[np.arange(8) % 3] * np.float32(2.0)
    d[8:16] *= -1.0
    return verts, idx, o, d


@pytest.mark.parametrize("form", ["shared", "per_ray"])
def test_triangle_t_matches_jax(form):
    """Both forms of the watertight test: one (T, 3) table for all rays,
    and (R, T, 3) triangles gathered per ray. Hit masks equal apart from
    edge-on rays (< 0.2% of pairs), t within 1e-6 on the common hits."""
    verts, idx, o, d = _tri_rays(3, 256, 96)
    v = verts[idx]                                        # (T, 3, 3)
    rp, rj = _both(o, d)
    sel = (lambda a, c: a[..., c, :])
    if form == "per_ray":
        # each ray's own 7 triangles: the nearest candidates of the shared
        # form (its hits, where it has any, among them)
        near = np.argsort(np.asarray(jisect.triangle_t(
            rj, *(jnp.asarray(sel(v, c)) for c in range(3)), BIG)),
            axis=1, kind="stable")[:, :7]
        v = v[near]                                       # (R, 7, 3, 3)
    t_p = pisect.triangle_t(rp, *(torch.from_numpy(sel(v, c).copy())
                                  for c in range(3)), BIG).numpy()
    t_j = np.asarray(jisect.triangle_t(rj, *(jnp.asarray(sel(v, c))
                                             for c in range(3)), BIG))
    assert t_p.shape == t_j.shape == (256, v.shape[-3])
    hit_p, hit_j = t_p < BIG, t_j < BIG
    assert hit_j.sum() > 50
    assert (hit_p != hit_j).mean() < 0.002
    both = hit_p & hit_j
    np.testing.assert_allclose(t_p[both], t_j[both], rtol=1e-6, atol=1e-6)
    # a finite t_max cuts the far hits in both
    t_cut = float(np.median(t_j[hit_j]))
    cut_p = pisect.triangle_t(rp, *(torch.from_numpy(sel(v, c).copy())
                                    for c in range(3)), t_cut).numpy()
    assert ((cut_p < BIG) <= (t_p <= t_cut * (1 + 1e-6))).all()
    assert 0 < (cut_p < BIG).sum() < hit_p.sum()


def test_triangle_attribs_match_jax():
    """Barycentrics of each ray's own triangle (hit or not: the function
    does not test): within 1e-5 where the triangle faces the ray squarely
    (|det| not tiny), summing to 1."""
    verts, idx, o, d = _tri_rays(7, 300, 300)
    v = verts[idx]                                        # (300, 3, 3)
    rp, rj = _both(o, d)
    b_p = [b.numpy() for b in pisect.triangle_attribs(
        rp, *(torch.from_numpy(v[:, c].copy()) for c in range(3)))]
    b_j = [np.asarray(b) for b in jisect.triangle_attribs(
        rj, *(jnp.asarray(v[:, c]) for c in range(3)))]
    ok = np.abs(np.stack(b_j)).max(axis=0) < 50.0         # well-conditioned
    assert ok.mean() > 0.8
    for a, b in zip(b_p, b_j):
        np.testing.assert_allclose(a[ok], b[ok], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(sum(b_p)[ok], 1.0, atol=1e-4)


@pytest.mark.parametrize("n_tris,chunk", [(1, 128), (40, 128), (300, 128),
                                          (300, 64)])
def test_intersect_triangles_matches_jax(n_tris, chunk):
    """The dense scan at 1 triangle, under one chunk, and over several
    chunks with a padded last one (300 = 2 * 128 + 44): hit masks equal,
    t within 1e-6, ids (through mat-independent normals) agreeing on
    > 99% of hits, normals and uvs within 1e-5 there."""
    verts, idx, normals, uvs = random_mesh(11, n_tris, spread=1.5)
    if n_tris == 1:     # one triangle wide enough for the rays to find
        verts = np.asarray([[-2, -2, 0], [2, -2, 0.3], [0, 2, -0.2]],
                           np.float32)
    o, d, _ = aimed_rays(12, 400)
    rp, rj = _both(o, d)
    h_p = pisect.intersect_triangles(
        rp, *(torch.from_numpy(a) for a in (verts, normals, uvs, idx)),
        torch.tensor(3, dtype=torch.int32), BIG, chunk=chunk)
    h_j = jisect.intersect_triangles(
        rj, *(jnp.asarray(a) for a in (verts, normals, uvs, idx)),
        jnp.int32(3), BIG, chunk=chunk)
    hit = np.asarray(h_j.hit)
    np.testing.assert_array_equal(h_p.hit.numpy(), hit)
    assert hit.any()
    np.testing.assert_allclose(h_p.t.numpy(), np.asarray(h_j.t), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(h_p.mat_id.numpy(), np.asarray(h_j.mat_id))
    assert h_p.mat_id.dtype == torch.int32
    same = hit & (np.abs(h_p.normal.numpy() - np.asarray(h_j.normal)).max(
        axis=1) < 1e-4)
    assert same[hit].mean() > 0.99
    np.testing.assert_allclose(h_p.uv.numpy()[same], np.asarray(h_j.uv)[same],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(h_p.p.numpy()[hit], np.asarray(h_j.p)[hit],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(h_p.front_face.numpy()[same],
                                  np.asarray(h_j.front_face)[same])


def test_intersect_triangles_empty_mesh():
    rp, _ = _both(*aimed_rays(1, 8)[:2])
    h = pisect.intersect_triangles(
        rp, torch.zeros((0, 3)), torch.zeros((0, 3)), torch.zeros((0, 2)),
        torch.zeros((0, 3), dtype=torch.int32),
        torch.tensor(0, dtype=torch.int32), BIG)
    assert not h.hit.any() and (h.mat_id == -1).all()


def _assert_find(t_p, id_p, t_j, id_j):
    """The repo's template for two mesh finds (tests/test_kernels.py): hit
    masks equal, t with rtol = atol = 1e-6, under 1% of ids differing
    (exact t-ties)."""
    hit_p, hit_j = t_p < BIG, t_j < BIG
    np.testing.assert_array_equal(hit_p, hit_j)
    assert hit_j.any()
    np.testing.assert_allclose(t_p[hit_j], t_j[hit_j], rtol=1e-6, atol=1e-6)
    assert ((id_p != id_j) & hit_j).mean() < 0.01
    assert (id_p[~hit_j] == -1).all()


@pytest.mark.parametrize("case", ["random", "valid_every_3", "leaf64",
                                  "teapot"])
def test_lockstep_find_matches_jax_lockstep_and_kernel(case):
    """intersect_mesh_clustered against the JAX lockstep find (blocks of 64
    rays) and against the JAX Pallas kernel in interpret mode, on a random
    mesh (600 rays: not a multiple of any block), with two lanes of three
    dead, with 64-triangle leaves, and on the teapot's tables. The chunk of
    100 rays makes the port's find cross chunk borders."""
    if case == "teapot":
        _, _, tri_id, cl = teapot_tables()
        o, d, valid = aimed_rays(4, 600, center=(0.0, 1.5, 0.0), half=2.0,
                                 spread=8.0)
    else:
        leaf = 64 if case == "leaf64" else 128
        verts, idx, normals, uvs = random_mesh(0 if case == "random" else 2,
                                               500 if leaf == 128 else 200)
        _, _, tri_id, cl = cluster_tables(verts, idx, normals, uvs, leaf=leaf)
        o, d, valid = random_rays(1, 600, valid_every=3 if case ==
                                  "valid_every_3" else 1)
    rp, rj = _both(o, d)
    tabs = (cl["tri_verts"], tri_id, cl["bmin"], cl["bmax"])
    t_p, id_p, hit_p = pisect.intersect_mesh_clustered(
        rp, *(torch.from_numpy(np.ascontiguousarray(a)) for a in tabs), BIG,
        ray_valid=torch.from_numpy(valid), chunk=100)
    assert id_p.dtype == torch.int32
    assert not hit_p[~torch.from_numpy(valid)].any()
    np.testing.assert_array_equal(hit_p.numpy(), t_p.numpy() < BIG)
    jt = tuple(jnp.asarray(a) for a in tabs)
    t_x, id_x, _ = jisect.intersect_mesh_clustered(
        rj, *jt, BIG, ray_valid=jnp.asarray(valid))
    _assert_find(t_p.numpy(), id_p.numpy(), np.asarray(t_x), np.asarray(id_x))
    t_k, id_k, _, _, _ = jisect.intersect_mesh_clustered_pallas(
        rj, *jt, BIG, ray_valid=jnp.asarray(valid), interpret=True)
    _assert_find(t_p.numpy(), id_p.numpy(), np.asarray(t_k), np.asarray(id_k))


def test_lockstep_find_matches_plain_kernel_version():
    """The lockstep find and the plain version of K1 walk the same visits
    over the same leaf arithmetic, so on build-time vertices they agree
    bit for bit, t and ids."""
    bounds8, soa, tri_id, cl = teapot_tables()
    o, d, valid = aimed_rays(9, 500, center=(0.0, 1.5, 0.0), half=2.0,
                             spread=8.0)
    rp, _ = _both(o, d)
    t_l, id_l, _ = pisect.intersect_mesh_clustered(
        rp, *(torch.from_numpy(np.ascontiguousarray(cl[f])) for f in (
            "tri_verts", "tri_id", "bmin", "bmax")), BIG)
    rays8 = torch.cat([rp.o, rp.d, torch.ones((500, 1)),
                       torch.zeros((500, 1))], dim=1)
    out, id_k = kmod.traverse_clusters_plain(
        rays8, torch.from_numpy(bounds8), torch.from_numpy(soa),
        torch.from_numpy(tri_id), need_uv=False)
    assert torch.equal(out[:, 0], t_l) and torch.equal(id_k, id_l)


def test_aabb_hit_matches_jax():
    """Random boxes and rays, an axis-parallel direction (inv_d = inf)
    among them; scalar and per-ray windows."""
    rng = np.random.default_rng(21)
    n = 512
    o = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = rng.normal(0, 1, (n, 3)).astype(np.float32)
    d[:32, 0] = 0.0
    with np.errstate(divide="ignore"):
        inv = (1.0 / d).astype(np.float32)
    lo = rng.uniform(-2, 0, (n, 3)).astype(np.float32)
    hi = lo + rng.uniform(0.1, 2, (n, 3)).astype(np.float32)
    t_hi = rng.uniform(1, 6, (n,)).astype(np.float32)
    for tmin, tmax in ((1e-3, BIG), (0.5, t_hi)):
        got = pisect.aabb_hit(
            torch.from_numpy(o), torch.from_numpy(inv), torch.from_numpy(lo),
            torch.from_numpy(hi), tmin,
            torch.from_numpy(tmax) if isinstance(tmax, np.ndarray) else tmax)
        ref = jisect.aabb_hit(jnp.asarray(o), jnp.asarray(inv),
                              jnp.asarray(lo), jnp.asarray(hi), tmin,
                              jnp.asarray(tmax))
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        assert 0 < got.sum() < n


@pytest.fixture(scope="module")
def small_mesh():
    verts, idx, normals, uvs = random_mesh(31, 200, spread=1.5)
    bounds8, soa, tri_id, cl = cluster_tables(verts, idx, normals, uvs,
                                              leaf=64)
    return dict(verts=verts, indices=idx, normals=normals, uvs=uvs,
                tri_id=tri_id, tri_verts=cl["tri_verts"], bmin=cl["bmin"],
                bmax=cl["bmax"], tri_soa=soa, bounds8=bounds8)


def _lockstep_hits_port(m, rp, verts):
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in m.items()}
    tri_verts = verts[t["indices"][t["tri_id"].clamp(min=0).long()].long()]
    return pisect.intersect_triangles_bvh(
        rp, t["tri_id"], None, None, torch.tensor(2, dtype=torch.int32), BIG,
        backend="lockstep", verts=verts, normals=t["normals"], uvs=t["uvs"],
        indices=t["indices"], tri_verts=tri_verts, bmin=t["bmin"],
        bmax=t["bmax"])


def _lockstep_hits_jax(m, rj, verts):
    j = {k: jnp.asarray(v) for k, v in m.items()}
    tri_verts = verts[j["indices"][jnp.maximum(j["tri_id"], 0)]]
    return jisect.intersect_triangles_bvh(
        rj, verts, j["normals"], j["uvs"], j["indices"], tri_verts,
        j["tri_id"], j["bmin"], j["bmax"], jnp.int32(2), BIG, backend="xla")


def test_lockstep_branch_matches_jax_with_gradient(small_mesh):
    """The lockstep branch of intersect_triangles_bvh: the hit record
    against the JAX backend="xla" branch (masks equal, t within 1e-6,
    normals and uv within 1e-5 where the same triangle won), and the
    gradient of sum(t) + sum(normal) + sum(uv) over the hits with respect
    to verts against jax.grad: within 2e-3 * the largest entry on the
    vertices whose rays found the same triangle in both (float32 sums of
    quotients whose denominators differ by an ulp)."""
    m = small_mesh
    o, d, _ = aimed_rays(32, 300)
    rp, rj = _both(o, d)
    verts_p = torch.from_numpy(m["verts"]).requires_grad_(True)
    h_p = _lockstep_hits_port(m, rp, verts_p)
    h_j = _lockstep_hits_jax(m, rj, jnp.asarray(m["verts"]))
    hit = np.asarray(h_j.hit)
    np.testing.assert_array_equal(h_p.hit.numpy(), hit)
    assert hit.sum() > 100
    np.testing.assert_allclose(h_p.t.detach().numpy(), np.asarray(h_j.t),
                               rtol=1e-6, atol=1e-6)
    same = hit & (np.abs(h_p.normal.detach().numpy()
                         - np.asarray(h_j.normal)).max(axis=1) < 1e-4)
    assert same[hit].mean() > 0.99
    np.testing.assert_allclose(h_p.uv.detach().numpy()[same],
                               np.asarray(h_j.uv)[same], rtol=1e-5, atol=1e-5)
    assert h_p.t.requires_grad

    sel = torch.from_numpy(same)

    def loss_p(h):
        return (h.t[sel].sum() + h.normal[sel].sum() + h.uv[sel].sum())

    def loss_j(v):
        h = _lockstep_hits_jax(m, rj, v)
        s = jnp.asarray(same)
        return (jnp.where(s, h.t, 0.0).sum()
                + jnp.where(s[:, None], h.normal, 0.0).sum()
                + jnp.where(s[:, None], h.uv, 0.0).sum())

    loss_p(h_p).backward()
    g_p = verts_p.grad.numpy()
    g_j = np.asarray(jax.grad(loss_j)(jnp.asarray(m["verts"])))
    assert np.isfinite(g_p).all()
    assert np.abs(g_j).max() > 0
    np.testing.assert_allclose(g_p, g_j, rtol=2e-3,
                               atol=2e-3 * np.abs(g_j).max())


def test_lockstep_branch_keeps_find_t_when_replay_misses(small_mesh,
                                                         monkeypatch):
    """A hit whose replay through triangle_t misses keeps the find's t
    (the reference's t_replay < BIG else t_nd)."""
    o, d, _ = aimed_rays(33, 64)
    rp, _ = _both(o, d)
    verts = torch.from_numpy(small_mesh["verts"])
    want = _lockstep_hits_port(small_mesh, rp, verts)
    monkeypatch.setattr(pisect, "triangle_t", lambda r, a, b, c, t_max: (
        torch.full((r.o.shape[0], 1), BIG)))
    got = _lockstep_hits_port(small_mesh, rp, verts)
    assert got.hit.any() and torch.equal(got.hit, want.hit)
    np.testing.assert_allclose(got.t.numpy(), want.t.numpy(), rtol=1e-5)


def test_bvh_backend_names():
    with pytest.raises(ValueError, match="lockstep"):
        pisect.intersect_triangles_bvh(None, None, None, None, None, BIG,
                                       backend="xla")


@pytest.mark.parametrize("cohsort", [None, False, True])
def test_fused_find_cohsort(monkeypatch, small_mesh, cohsort):
    """cohsort=False skips the key and the argsort altogether (neither is
    called) and gives the same result, lane for lane and bit for bit, as
    the sorted call; None reads NO_COHSORT at call time."""
    m = small_mesh
    o, d, valid = random_rays(34, 300, spread=3.0, valid_every=2)
    rp, _ = _both(o, d)
    tabs = tuple(torch.from_numpy(m[f]) for f in ("tri_id", "tri_soa",
                                                  "bounds8"))
    want = pisect.intersect_mesh_clustered_fused(
        rp, *tabs, BIG, torch.from_numpy(valid), cohsort=True)
    calls = []
    real_key = pisect.coherence_key
    monkeypatch.setattr(pisect, "coherence_key", lambda *a, **k: (
        calls.append(1), real_key(*a, **k))[1])
    if cohsort is None:
        monkeypatch.setattr(pisect, "NO_COHSORT", True)
    got = pisect.intersect_mesh_clustered_fused(
        rp, *tabs, BIG, torch.from_numpy(valid), cohsort=cohsort)
    assert len(calls) == (1 if cohsort else 0)
    assert want[2].any()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_no_cohsort_env_is_read_at_import():
    """HRT_NO_COHSORT is read once at import, any non-empty value setting
    it, as in the reference; both packages agree in a fresh process."""
    import os
    import subprocess
    import sys
    code = ("import jax; jax.config.update('jax_platforms', 'cpu')\n"
            "from hobbyraytracer_tpu.ops import intersect as j\n"
            "from hobbyraytracer_tpu_torch.ops import intersect as p\n"
            "print('COHSORT', j.NO_COHSORT, p.NO_COHSORT)\n")
    for value, want in (("1", "True True"), ("", "False False")):
        env = dict(os.environ, HRT_NO_COHSORT=value,
                   PYTHONPATH=os.path.dirname(os.path.dirname(
                       os.path.abspath(__file__))))
        out = subprocess.run([sys.executable, "-c", code], env=env,
                             capture_output=True, text=True, timeout=300)
        assert f"COHSORT {want}" in out.stdout, out.stdout + out.stderr


def _one_mesh_scenes(m, dense):
    """A port scene and a JAX scene holding the same single mesh instance,
    clustered or dense, under one transform."""
    from hobbyraytracer_tpu_torch.scene import convert
    from hobbyraytracer_tpu.ops import shade as jshade
    from hobbyraytracer_tpu.ops import texture as jtex
    mesh = {f: m[f] for f in ("verts", "normals", "uvs", "indices")}
    mesh["mat_id"] = np.int32(1)
    tables = {"cluster_id": m["tri_id"], "cluster_bmin": m["bmin"],
              "cluster_bmax": m["bmax"], "tri_soa": m["tri_soa"],
              "bounds8": m["bounds8"]}
    mesh.update({k: (None if dense else v) for k, v in tables.items()})
    tr = {"translate": np.asarray([0.2, -0.1, 0.3], np.float32),
          "scale": np.asarray([1.5, 1.5, 1.5], np.float32),
          "quat": np.asarray([0.9238795, 0.0, 0.3826834, 0.0], np.float32)}
    jmesh = jir.MeshGeom(**{k: (None if v is None else jnp.asarray(v))
                            for k, v in mesh.items()}, use_bvh=not dense)
    jscene = jir.SceneIR(
        spheres=jir.SphereTable(jnp.zeros((0, 3)), jnp.zeros((0,)),
                                jnp.zeros((0,), jnp.int32)),
        rects=jir.RectTable(*(jnp.zeros((0,), jnp.int32 if i in (0, 6)
                                        else jnp.float32) for i in range(7))),
        instances=(jir.Instance(kind="mesh", mesh=jmesh, transform=jir.
                                Transform(**{k: jnp.asarray(v)
                                             for k, v in tr.items()})),),
        media=(),
        materials=jshade.build_table([{"mtype": 0}, {"mtype": 0}]),
        textures=jtex.build_table([{"type": 0, "solid": (1.0, 1.0, 1.0)}]),
        background_tex=jnp.int32(0))
    from _torch_parity import jax_scene_arrays
    return convert.scene_from_arrays(jax_scene_arrays(jscene)), jscene


@pytest.mark.parametrize("route", ["dense", "lockstep", "kernel"])
def test_mesh_routes_of_intersect_scene_match_jax(monkeypatch, small_mesh,
                                                  route):
    """scene/ir.py's three ways for a mesh instance under a transform,
    each against the reference's: a mesh without tables through the dense
    scan; mesh_backend="lockstep" against the reference's "xla" (bounds
    recomputed from the live vertices in both); "kernel" against "auto"
    with the Pallas kernel in interpret mode. Hit masks equal but for
    edge-on rays (< 0.5%), t within 1e-5 and points within 1e-4 on the
    common hits."""
    monkeypatch.setenv("HRT_PALLAS_INTERPRET", "1")
    pscene, jscene = _one_mesh_scenes(small_mesh, dense=route == "dense")
    assert pscene.instances[0].mesh.use_bvh == (route != "dense")
    o, d, _ = aimed_rays(35, 400, half=2.0, spread=5.0)
    rp, rj = _both(o, d)
    backend = {"dense": ("kernel", "auto"), "lockstep": ("lockstep", "xla"),
               "kernel": ("kernel", "auto")}[route]
    h_p = pir.intersect_scene(pscene, rp, mesh_backend=backend[0])
    h_j = jir.intersect_scene(jscene, rj, jax.random.PRNGKey(0), 0,
                              mesh_backend=backend[1])
    hit_p, hit_j = h_p.hit.numpy(), np.asarray(h_j.hit)
    assert hit_j.sum() > 100
    assert (hit_p != hit_j).mean() < 0.005
    both = hit_p & hit_j
    np.testing.assert_allclose(h_p.t.numpy()[both], np.asarray(h_j.t)[both],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(h_p.p.numpy()[both], np.asarray(h_j.p)[both],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(h_p.mat_id.numpy()[both],
                                  np.asarray(h_j.mat_id)[both])
    if route != "dense":     # the reference's names are not the port's
        with pytest.raises(ValueError, match="mesh_backend"):
            pir.intersect_scene(pscene, rp, mesh_backend="xla")


def test_lockstep_backend_tracks_moved_vertices(small_mesh):
    """The lockstep backend finds a mesh where its vertices are now: after
    the vertex buffer moves by 10 units the kernel backend (build-time
    tables) still reports the old hits, the lockstep backend the moved
    ones."""
    pscene, _ = _one_mesh_scenes(small_mesh, dense=False)
    o, d, _ = aimed_rays(36, 200, half=1.0, spread=4.0)
    rp, _ = _both(o, d)
    before = pir.intersect_scene(pscene, rp, mesh_backend="lockstep")
    assert before.hit.float().mean() > 0.3
    mesh = pscene.instances[0].mesh
    mesh.verts += torch.tensor([10.0, 0.0, 0.0])
    stale = pir.intersect_scene(pscene, rp, mesh_backend="kernel")
    moved = pir.intersect_scene(pscene, rp, mesh_backend="lockstep")
    assert stale.hit.float().mean() > 0.3
    assert moved.hit.float().mean() < 0.5 * before.hit.float().mean()
