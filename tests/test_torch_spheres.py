"""The port's sphere path against the JAX package's on the same numpy
inputs: the sphere cluster build (byte for byte), the dense scan (sphere_t,
sphere_uv, intersect_spheres), the clustered find's plain version against
the Pallas sphere kernel in interpret mode, intersect_spheres_clustered with
its differentiable replay, a transformed sphere instance, and the routing on
SPHERE_KERNEL; and, with no JAX, the order of the sphere_scan kernel (one
sphere at a time, strict <) against the chunked scan, the scan's wrapper on
the CPU, and the dense route's gradient replay against the scan's own
gradients.

Tolerances. XLA's CPU build contracts a*b+c into FMAs where PyTorch rounds
each op, and the sphere discriminant hb*hb - a*c cancels: on a random pool
t agrees within rtol 1e-5 on >= 99% of hits and 1e-4 on all. On the
scattered-balls pool the ground sphere (radius 1000, c = |oc|^2 - r^2 of
order 1e6 cancelling to order 10) needs rtol 5e-4 for t, and a ray grazing a
small sphere may hit it on one side only; such rays are counted (<= 0.5%)."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hobbyraytracer_tpu.core.types import Rays as JRays
from hobbyraytracer_tpu.kernels import sphere_traverse as jsk
from hobbyraytracer_tpu.ops import intersect as jisect
from hobbyraytracer_tpu.scene import bvh as jbvh
from hobbyraytracer_tpu.scene import ir as jir
from hobbyraytracer_tpu_torch.core.types import Rays
from hobbyraytracer_tpu_torch.kernels import build as kbuild
from hobbyraytracer_tpu_torch.kernels import sphere_scan as sc
from hobbyraytracer_tpu_torch.kernels import sphere_traverse as sk
from hobbyraytracer_tpu_torch.ops import intersect as pisect
from hobbyraytracer_tpu_torch.scene import bvh as pbvh
from hobbyraytracer_tpu_torch.scene import ir as pir

from _torch_parity import (ROOT, aimed_rays, balls_pool, pack_rays8,
                           random_rays, scan_by_sphere, sphere_pool,
                           tied_sphere_pool)

torch.set_num_threads(2)

T = torch.from_numpy
T_MIN, BIG = 1e-3, 1e30


def _oracle():
    """The pool and rays of tests/test_intersect.py's sphere-kernel oracle:
    485 random spheres, 700 random rays."""
    rng = np.random.default_rng(3)
    center = rng.uniform(-10, 10, (485, 3)).astype(np.float32)
    radius = rng.uniform(0.2, 1.5, (485,)).astype(np.float32)
    mat = rng.integers(0, 5, (485,)).astype(np.int32)
    o = rng.uniform(-15, 15, (700, 3)).astype(np.float32)
    d = rng.normal(0, 1, (700, 3)).astype(np.float32)
    return center, radius, mat, o, d


def _balls_rays(n, seed=21):
    """Rays above the ground aimed into the balls scene."""
    o, d, valid = aimed_rays(seed, n, center=(0.0, 0.5, 0.0), half=6.0,
                             spread=12.0)
    o[:, 1] = np.abs(o[:, 1]) + 0.3
    return o, d, valid


def _jrays(o, d):
    return JRays(o=jnp.asarray(o), d=jnp.asarray(d))


@pytest.mark.parametrize("pool", ["balls", "random-485", "random-3000-leaf16"])
def test_build_sphere_clusters_matches_reference(pool):
    """table, bounds8 and ids byte for byte; the balls pool gives K = 4."""
    if pool == "balls":
        center, radius = balls_pool()[:2]
        leaf = 128
    else:
        n, leaf = (485, 128) if pool == "random-485" else (3000, 16)
        center, radius, _ = sphere_pool(5, n)
        radius[::9] *= -1.0          # |radius| bounds, radius^2 in the table
    got = pbvh.build_sphere_clusters(center, radius, leaf_size=leaf)
    ref = jbvh.build_sphere_clusters(center, radius, leaf_size=leaf)
    assert set(got) == set(ref) == {"table", "bounds8", "ids"}
    for k in ref:
        assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape
        assert got[k].tobytes() == ref[k].tobytes(), k
    k_clusters = got["ids"].shape[0]
    assert got["table"].shape == (k_clusters, 8, leaf)
    assert got["bounds8"].shape == (8, k_clusters)
    if pool == "balls":
        assert k_clusters == 4
    pad = got["ids"] < 0
    assert (got["table"][:, 3][pad] == -1.0).all()
    assert np.array_equal(np.sort(got["ids"][~pad]), np.arange(len(center)))


def test_sphere_t_matches_jax():
    """(R, S) candidate t of the dense scan on a random pool and on a pool
    with the two miss rules' edge (disc == 0 counts as a hit there): masks
    equal, t within rtol 1e-5 on >= 99% of the pairs that hit and 1e-4 on
    all (FMA contraction in XLA's discriminant)."""
    center, radius, _ = sphere_pool(6, 200)
    o, d, _ = random_rays(7, 1500, spread=15.0)
    tj = np.asarray(jisect.sphere_t(_jrays(o, d), jnp.asarray(center),
                                    jnp.asarray(radius), T_MIN, BIG))
    tp = pisect.sphere_t(Rays(o=T(o), d=T(d)), T(center), T(radius), T_MIN,
                         BIG).numpy()
    assert tp.shape == (1500, 200) and tp.dtype == np.float32
    hit_j, hit_p = tj < BIG, tp < BIG
    assert hit_j.sum() > 300
    assert (hit_j != hit_p).mean() < 1e-5      # grazing pairs only
    both = hit_j & hit_p
    rel = np.abs(tp - tj)[both] / np.abs(tj[both])
    assert (rel <= 1e-5).mean() >= 0.99 and rel.max() <= 1e-4, rel.max()
    assert (tp[~hit_p] == np.float32(BIG)).all()
    # an exactly representable tangent: disc == 0 is a hit of the dense scan
    # (root (-hb - 1) / a, as the reference computes it), in both packages
    o1 = np.asarray([[0.0, 1.0, -4.0]], np.float32)
    d1 = np.asarray([[0.0, 0.0, 1.0]], np.float32)
    c1 = np.zeros((1, 3), np.float32)
    r1 = np.ones((1,), np.float32)
    tj1 = np.asarray(jisect.sphere_t(_jrays(o1, d1), jnp.asarray(c1),
                                     jnp.asarray(r1), T_MIN, BIG))
    tp1 = pisect.sphere_t(Rays(o=T(o1), d=T(d1)), T(c1), T(r1), T_MIN,
                          BIG).numpy()
    np.testing.assert_array_equal(tp1, tj1)
    assert tp1[0, 0] == 3.0


def test_sphere_uv_matches_jax_with_poles():
    """sphere_uv on random unit normals (atol 1e-6) and at the poles and
    the seam, where arccos meets +-1 and atan2 signed zeros: finite, inside
    [0, 1], and equal to JAX's."""
    n = np.random.default_rng(8).normal(size=(2000, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    edge = np.asarray([[0, 1, 0], [0, -1, 0], [0.0, 1.0000001, 0.0],
                       [0, -1.0000001, 0], [1, 0, 0], [-1, 0, 0],
                       [-1, 0, -0.0], [0, 0, 1], [0, 0, -1], [0, 0, 0]],
                      np.float32)
    for arr, atol in ((n, 1e-6), (edge, 0.0)):
        uj = np.asarray(jisect.sphere_uv(jnp.asarray(arr)))
        up = pisect.sphere_uv(T(arr)).numpy()
        assert np.isfinite(up).all() and up.min() >= 0.0 and up.max() <= 1.0
        np.testing.assert_allclose(up, uj, rtol=0, atol=atol)
    up = pisect.sphere_uv(T(edge)).numpy()
    assert up[0, 1] == 1.0 and up[1, 1] == 0.0    # theta = acos(-n.y)


@pytest.mark.parametrize("case", ["random-485", "random-300-chunk64",
                                  "three", "balls"])
def test_intersect_spheres_matches_jax(case):
    """The dense scan's hit record against JAX's: hit masks, mat_id and
    front_face equal, t rtol 1e-5 (>= 99% of hits) and 1e-4 (all), p, normal
    and uv atol 2e-3 (t's error times |d| / radius). 485 spheres pad the
    last chunk of 128; 300 on chunks of 64 too; 3 spheres are one short
    chunk. The balls pool (ground sphere) needs rtol 5e-4 on t and may
    differ on grazing rays (<= 0.5% of rays, left out of the rest)."""
    chunk = 128
    if case == "balls":
        center, radius, mat = balls_pool()[:3]
        o, d, _ = _balls_rays(3000)
    else:
        n = {"random-485": 485, "random-300-chunk64": 300, "three": 3}[case]
        chunk = 64 if case == "random-300-chunk64" else 128
        center, radius, mat = sphere_pool(9, n, spread=10.0 if n > 3 else 2.0)
        o, d, _ = random_rays(10, 3000, spread=15.0 if n > 3 else 4.0)
    hj = jisect.intersect_spheres(_jrays(o, d), jnp.asarray(center),
                                  jnp.asarray(radius), jnp.asarray(mat),
                                  T_MIN, BIG, chunk=chunk)
    hp = pisect.intersect_spheres(Rays(o=T(o), d=T(d)), T(center), T(radius),
                                  T(mat), T_MIN, BIG, chunk=chunk)
    _assert_hits_match(hp, hj, balls=case == "balls")


def _assert_hits_match(hp, hj, balls=False):
    hit_j, hit_p = np.asarray(hj.hit), hp.hit.numpy()
    mat_j, mat_p = np.asarray(hj.mat_id), hp.mat_id.numpy()
    assert hp.mat_id.dtype == torch.int32 and hit_j.sum() > 100
    off = (hit_j != hit_p) | (mat_j != mat_p)
    if balls:
        assert off.mean() <= 0.005, off.sum()
    else:
        assert not off.any(), off.sum()
    m = hit_j & ~off
    np.testing.assert_array_equal(hp.front_face.numpy()[m],
                                  np.asarray(hj.front_face)[m])
    tj, tp = np.asarray(hj.t), hp.t.detach().numpy()
    rel = np.abs(tp - tj)[m] / np.abs(tj[m])
    if balls:
        assert rel.max() <= 5e-4, rel.max()
    else:
        assert (rel <= 1e-5).mean() >= 0.99 and rel.max() <= 1e-4, rel.max()
    assert (tp[~hit_p] == np.float32(BIG)).all() and (mat_p[~hit_p] == -1).all()
    for f, atol in (("p", 2e-3), ("normal", 2e-2 if balls else 2e-3),
                    ("uv", 5e-3 if balls else 2e-3)):
        a, b = getattr(hp, f).detach().numpy()[m], np.asarray(getattr(hj, f))[m]
        if f == "uv":   # u wraps at the seam
            du = np.abs(a[:, 0] - b[:, 0])
            a, b = a.copy(), b.copy()
            a[:, 0], b[:, 0] = np.minimum(du, 1.0 - du), 0.0
        np.testing.assert_allclose(a, b, rtol=0, atol=atol, err_msg=f)


def _pallas_find(rays8, bounds8, table, ids, block=256):
    """The JAX sphere kernel in interpret mode on (N, 8) rays, padded to
    whole blocks with dead lanes as its wrapper pads them."""
    n = len(rays8)
    pad = -n % block
    r8 = np.concatenate([rays8, np.zeros((pad, 8), np.float32)])
    r8[n:, 3:6] = 1.0
    t, i = jsk.intersect_spheres_pallas(
        jnp.asarray(r8).reshape(-1, block, 8), jnp.asarray(bounds8),
        jnp.asarray(table), jnp.asarray(ids), t_min=T_MIN, interpret=True)
    return np.asarray(t).reshape(-1)[:n], np.asarray(i).reshape(-1)[:n]


@pytest.mark.parametrize("pool", ["oracle", "balls"])
def test_plain_find_matches_pallas_kernel(pool):
    """intersect_spheres_plain (the rounding and visit order of kernel K4)
    against intersect_spheres_pallas(interpret=True): ids equal but for
    counted ties and grazing rays (none on the oracle, <= 0.5% of rays on
    the balls pool), t within rtol 1e-5 (oracle) / 5e-4 (balls: the ground
    sphere's cancellation under XLA's FMAs) where the ids agree; dead lanes
    give BIG and -1 in both."""
    if pool == "oracle":
        center, radius, _, o, d = _oracle()
        sc = pbvh.build_sphere_clusters(center, radius)
        table, bounds8, ids = sc["table"], sc["bounds8"], sc["ids"]
        valid = np.ones((len(o),), bool)
    else:
        _, _, _, table, bounds8, ids = balls_pool()
        o, d, valid = _balls_rays(3000)
    valid[::5] = False
    rays8 = pack_rays8(o, d, valid)
    tj, ij = _pallas_find(rays8, bounds8, table, ids)
    tp, ip = sk.intersect_spheres_plain(T(rays8), T(bounds8), T(table),
                                        T(ids), T_MIN)
    tp, ip = tp.numpy(), ip.numpy()
    assert ip.dtype == np.int32 and tp.dtype == np.float32
    assert (ij >= 0).sum() > 150
    differ = ip != ij
    assert differ.mean() <= (0.0 if pool == "oracle" else 0.005), differ.sum()
    m = (ij >= 0) & ~differ
    np.testing.assert_allclose(tp[m], tj[m], atol=0,
                               rtol=1e-5 if pool == "oracle" else 5e-4)
    for t, i in ((tp, ip), (tj, ij)):
        assert (t[~valid] == np.float32(BIG)).all() and (i[~valid] == -1).all()
        assert (t[i < 0] == np.float32(BIG)).all()
    # the wrapper runs the plain version for CPU tensors, any leading shape
    tw, iw = sk.intersect_spheres_kernel(
        T(rays8).reshape(5, -1, 8), T(bounds8), T(table), T(ids), T_MIN)
    assert tw.shape == iw.shape == (5, len(o) // 5)
    assert np.array_equal(tw.reshape(-1).numpy(), tp)
    assert np.array_equal(iw.reshape(-1).numpy(), ip)


def test_plain_find_equals_dense_argmin():
    """Visit policy: on the oracle pool the clustered find returns the
    dense scan's nearest sphere (the same ids; t within 1e-5, since the
    clustered find squares the radius on the host and takes disc > 0)."""
    center, radius, mat, o, d = _oracle()
    sc = pbvh.build_sphere_clusters(center, radius)
    rays8 = pack_rays8(o, d, np.ones((len(o),), bool))
    tp, ip = sk.intersect_spheres_plain(T(rays8), T(sc["bounds8"]),
                                        T(sc["table"]), T(sc["ids"]), T_MIN)
    t_all = pisect.sphere_t(Rays(o=T(o), d=T(d)), T(center), T(radius),
                            T_MIN, BIG)
    t_d, i_d = t_all.min(dim=1)
    hit = t_d < BIG
    assert torch.equal(ip >= 0, hit)
    assert torch.equal(ip[hit].long(), i_d[hit])
    torch.testing.assert_close(tp[hit], t_d[hit], rtol=1e-5, atol=0)


@pytest.mark.parametrize("pool", ["oracle", "balls"])
def test_intersect_spheres_clustered_matches_jax(pool):
    """The clustered route (plain find + replay + attributes) against the
    JAX one (Pallas kernel in interpret mode + replay), and against the
    port's dense route; on the oracle also d(sum t)/d(center) through the
    replay against JAX's gradient (atol 1e-2 of |g| ~ 15, at most 3 spheres
    apart: the subgradient at ties and tangents)."""
    if pool == "oracle":
        center, radius, mat, o, d = _oracle()
        sc = pbvh.build_sphere_clusters(center, radius)
        table, bounds8, ids = sc["table"], sc["bounds8"], sc["ids"]
    else:
        center, radius, mat, table, bounds8, ids = balls_pool()
        o, d, _ = _balls_rays(2000)
    jargs = [jnp.asarray(x) for x in (radius, mat, table, bounds8, ids)]

    def jax_route(c):
        return jisect.intersect_spheres_clustered(
            _jrays(o, d), c, *jargs, T_MIN, BIG, interpret=True)

    cp = T(center).clone().requires_grad_(pool == "oracle")
    rays = Rays(o=T(o), d=T(d))
    hp = pisect.intersect_spheres_clustered(
        rays, cp, T(radius), T(mat), T(table), T(bounds8), T(ids), T_MIN, BIG)
    _assert_hits_match(hp, jax_route(jnp.asarray(center)),
                       balls=pool == "balls")
    hd = pisect.intersect_spheres(rays, T(center), T(radius), T(mat), T_MIN,
                                  BIG)
    off = (hd.hit != hp.hit) | (hd.mat_id != hp.mat_id)
    assert off.float().mean() <= (0.0 if pool == "oracle" else 0.005)
    m = hd.hit & ~off
    torch.testing.assert_close(hp.t.detach()[m], hd.t[m], rtol=1e-4, atol=0)
    if pool != "oracle":
        return
    torch.where(hp.hit, hp.t, 0.0).sum().backward()
    g_j = jax.grad(lambda c: jnp.sum(jnp.where(
        jax_route(c).hit, jax_route(c).t, 0.0)))(jnp.asarray(center))
    diff = np.abs(cp.grad.numpy() - np.asarray(g_j))
    assert np.abs(np.asarray(g_j)).max() > 1.0
    assert (diff.max(axis=1) > 1e-2).sum() <= 3, diff.max()
    # the find itself carries no gradient: rays that need one get it from
    # the replay
    ro = T(o).clone().requires_grad_(True)
    h = pisect.intersect_spheres_clustered(
        Rays(o=ro, d=T(d)), T(center), T(radius), T(mat), T(table),
        T(bounds8), T(ids), T_MIN, BIG)
    torch.where(h.hit, h.t, 0.0).sum().backward()
    assert torch.isfinite(ro.grad).all() and ro.grad.abs().max() > 0


def test_clustered_keeps_kernel_t_where_replay_misses(monkeypatch):
    """A lane whose replay misses (here: the find reports a sphere the
    replay cannot hit) keeps the find's t, and a lane without a winner is
    a miss whatever t the find left there."""
    center = np.asarray([[0.0, 0.0, 0.0], [50.0, 0.0, 0.0]], np.float32)
    radius = np.asarray([1.0, 1.0], np.float32)
    mat = np.asarray([3, 4], np.int32)
    o = np.asarray([[0.0, 0.0, -5.0]] * 3, np.float32)
    d = np.asarray([[0.0, 0.0, 1.0]] * 3, np.float32)
    fake = (torch.tensor([4.0, 7.5, 2.0]), torch.tensor([0, 1, -1],
                                                        dtype=torch.int32))
    monkeypatch.setattr(sk, "intersect_spheres_kernel", lambda *a, **k: fake)
    z = torch.zeros((1, 8, 2))
    h = pisect.intersect_spheres_clustered(
        Rays(o=T(o), d=T(d)), T(center), T(radius), T(mat), z,
        torch.zeros((8, 1)), torch.zeros((1, 2), dtype=torch.int32), T_MIN,
        BIG)
    assert h.hit.tolist() == [True, True, False]
    assert h.t.tolist() == [4.0, 7.5, np.float32(BIG)]
    assert h.mat_id.tolist() == [3, 4, -1]


def test_transformed_sphere_instance_matches_jax():
    """A sphere instance under a TRS transform takes the dense scan in both
    packages; whole-scene closest hit with a pooled sphere beside it."""
    from hobbyraytracer_tpu.core import quat as jquat
    from hobbyraytracer_tpu.ops import shade as jshade
    from hobbyraytracer_tpu.ops import texture as jtex
    from hobbyraytracer_tpu_torch.ops import shade as pshade
    from hobbyraytracer_tpu_torch.ops import texture as ptex
    rot = np.asarray(jquat.from_euler(jnp.radians(jnp.asarray(
        [20.0, -40.0, 10.0]))))
    tr = dict(translate=np.asarray([0.5, 0.2, -0.3], np.float32),
              scale=np.asarray([1.5, 1.5, 1.5], np.float32))
    c_i = np.asarray([[0.2, 0.1, 0.0]], np.float32)
    c_p = np.asarray([[-2.5, 0.0, 1.0]], np.float32)
    one = np.ones((1,), np.float32)
    specs = [{"mtype": 0}, {"mtype": 0}, {"mtype": 0}]
    tex = [{"type": 0, "solid": (1.0, 1.0, 1.0)}]
    empty = dict(axis=np.zeros(0, np.int32), mat_id=np.zeros(0, np.int32),
                 **{f: np.zeros(0, np.float32)
                    for f in ("a0", "a1", "b0", "b1", "k")})
    jscene = jir.SceneIR(
        spheres=jir.SphereTable(jnp.asarray(c_p), jnp.asarray(one),
                                jnp.asarray([1], jnp.int32)),
        rects=jir.RectTable(**{k: jnp.asarray(v) for k, v in empty.items()}),
        instances=(jir.Instance(
            kind="sphere",
            spheres=jir.SphereTable(jnp.asarray(c_i), jnp.asarray(one * 0.8),
                                    jnp.asarray([2], jnp.int32)),
            transform=jir.Transform(jnp.asarray(tr["translate"]),
                                    jnp.asarray(tr["scale"]),
                                    jnp.asarray(rot))),),
        media=(), materials=jshade.build_table(specs),
        textures=jtex.build_table(tex), background_tex=jnp.asarray(0))
    pscene = pir.SceneIR(
        pir.RectTable(**empty),
        [pir.Instance("sphere", spheres=pir.SphereTable(c_i, one * 0.8, [2]),
                      transform=pir.Transform(tr["translate"], tr["scale"],
                                              rot))],
        pshade.build_table(specs), ptex.build_table(tex), 0,
        spheres=pir.SphereTable(c_p, one, [1]))
    o, d, _ = aimed_rays(11, 2000, center=(-0.5, 0.1, 0.2), half=2.5,
                         spread=6.0)
    hj = jir.intersect_scene(jscene, _jrays(o, d), None, 0)
    hp = pir.intersect_scene(pscene, Rays(o=T(o), d=T(d)))
    assert set(np.unique(hp.mat_id.numpy())) == {-1, 1, 2}
    _assert_hits_match(hp, hj)


def test_routing_follows_sphere_kernel(monkeypatch):
    """intersect_scene sends pooled spheres through the clustered find only
    when SPHERE_KERNEL is on and the table carries cluster tables; the knob
    is read from HRT_SPHERE_KERNEL at import, off by default."""
    from hobbyraytracer_tpu_torch.scene import build_scene, load_scene_desc
    from _torch_parity import BALLS
    scene = build_scene(load_scene_desc(BALLS)).scene
    o, d, _ = _balls_rays(300)
    rays = Rays(o=T(o), d=T(d))
    calls = []
    real_c, real_d = pisect.intersect_spheres_clustered, pisect.intersect_spheres
    monkeypatch.setattr(pisect, "intersect_spheres_clustered", lambda *a, **k: (
        calls.append(("clustered", kbuild.SWITCHES["plain"])),
        real_c(*a, **k))[1])
    monkeypatch.setattr(pisect, "intersect_spheres", lambda *a, **k: (
        calls.append(("dense", None)), real_d(*a, **k))[1])
    assert pisect.SPHERE_KERNEL is False
    h_dense = pir.intersect_scene(scene, rays)
    monkeypatch.setattr(pisect, "SPHERE_KERNEL", True)
    h_clus = pir.intersect_scene(scene, rays)
    with kbuild.plain_versions():
        pir.intersect_scene(scene, rays)
    small = pir.SceneIR(scene.rects, [], scene.materials, scene.textures, 0,
                        spheres=pir.SphereTable(scene.spheres.center[:100],
                                                scene.spheres.radius[:100],
                                                scene.spheres.mat_id[:100]))
    assert small.spheres.kernel_table is None
    pir.intersect_scene(small, rays)
    assert calls == [("dense", None), ("clustered", False),
                     ("clustered", True), ("dense", None)]
    assert (h_dense.mat_id != h_clus.mat_id).float().mean() <= 0.005
    assert scene.spheres.kernel_table.shape == (4, 8, 128)
    code = ("from hobbyraytracer_tpu_torch.ops import intersect as i; "
            "print('KNOB', i.SPHERE_KERNEL)")
    for val, want in (("1", "True"), ("0", "False")):
        proc = subprocess.run(
            [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
            text=True, timeout=120,
            env=dict(os.environ, HRT_SPHERE_KERNEL=val, PYTHONPATH=ROOT))
        assert f"KNOB {want}" in proc.stdout, proc.stdout + proc.stderr


def _scan_case(pool):
    """(center, radius, mat_id, o, d) of a sphere_scan test pool: the balls
    scene's 485 spheres with rays aimed into it, or 485 random spheres with
    repeated ones (exact ties) and rays aimed at them."""
    if pool == "balls":
        center, radius, mat = balls_pool()[:3]
        return (center, radius, mat, *_balls_rays(3000)[:2])
    return tied_sphere_pool(31)


@pytest.mark.parametrize("chunk", [1, 7, 128, "n"])
@pytest.mark.parametrize("pool", ["balls", "random-ties"])
def test_sphere_by_sphere_order_equals_the_scan(pool, chunk):
    """The sphere_scan kernel's order written in PyTorch (each sphere in
    index order, folded in with a strict <) equals the chunked scan bit for
    bit, t and winner, for chunks of 1, 7, 128 and the whole pool: the
    lowest index at the smallest t wins either way. On the random pool,
    with spheres repeated in the same chunk and in later ones, a counted
    number of rays meets an exact tie."""
    center, radius, mat, o, d = _scan_case(pool)
    rays = Rays(o=T(o), d=T(d))
    n = len(center) if chunk == "n" else chunk
    t_k, i_k = scan_by_sphere(rays, T(center), T(radius), T_MIN, BIG)
    t_s, i_s = sc.scan_spheres_plain(rays, T(center), T(radius), T_MIN, BIG,
                                     n)
    assert torch.equal(t_k, t_s) and torch.equal(i_k, i_s)
    hit = i_k >= 0
    assert 0.2 < hit.float().mean() < 1.0
    assert (t_k[~hit] == BIG).all() and (t_k[hit] < BIG).all()
    if pool != "balls":
        t_all = sc.sphere_t(rays, T(center), T(radius), T_MIN, BIG)
        ties = hit & ((t_all == t_k[:, None]).sum(dim=1) > 1)
        assert ties.sum() >= 100
    h = pisect.intersect_spheres(rays, T(center), T(radius), T(mat), T_MIN,
                                 BIG, chunk=n)
    assert torch.equal(h.t, t_k) and torch.equal(h.hit, hit)
    assert torch.equal(h.mat_id[hit], T(mat)[i_k[hit]])


def test_scan_wrapper_runs_the_plain_version_on_the_cpu():
    """scan_spheres on CPU tensors is the plain version: the same bits, no
    launch counted; it refuses an empty pool."""
    center, radius, _, o, d = _scan_case("balls")
    rays = Rays(o=T(o), d=T(d))
    before = sc.SCAN_KERNEL.launches
    t, i = sc.scan_spheres(rays, T(center), T(radius), T_MIN, BIG)
    t_p, i_p = sc.scan_spheres_plain(rays, T(center), T(radius), T_MIN, BIG)
    assert torch.equal(t, t_p) and torch.equal(i, i_p)
    assert i.dtype == torch.int64 and t.dtype == torch.float32
    t0, i0 = sc.scan_spheres(Rays(o=T(o)[:0], d=T(d)[:0]), T(center),
                             T(radius), T_MIN, BIG)
    assert t0.shape == i0.shape == (0,)
    assert sc.SCAN_KERNEL.launches == before == 0
    with pytest.raises(ValueError, match="S >= 1"):
        sc.scan_spheres(rays, T(center)[:0], T(radius)[:0], T_MIN, BIG)


@pytest.mark.parametrize("chunk", [128, "n"])
@pytest.mark.parametrize("pool", ["balls", "random-384"])
def test_dense_route_replays_the_scan_gradient(pool, chunk):
    """With gradients wanted, intersect_spheres finds the winner without
    them and replays its quadratic: t equals the scan's bit for bit, and
    the gradients of a loss over t, p and the normal with respect to the
    rays' origins and directions, the centers and the radii are the scan's
    own (autograd through the chunked scan over the whole pool) within
    float32 rounding of a sum's order (1e-5 of the largest). The replay
    never sees the scan's pad spheres, whose 0 * inf makes the padded
    scan's direction gradient NaN, so a 128-chunk find of 485 spheres gives
    finite gradients too."""
    if pool == "balls":
        center, radius, mat = balls_pool()[:3]
        o, d = _balls_rays(3000)[:2]
    else:
        center, radius, mat = sphere_pool(9, 384, spread=10.0)
        o, d, _ = random_rays(10, 3000, spread=15.0)
    n = len(center) if chunk == "n" else chunk
    w = torch.linspace(0.1, 1.0, len(o))

    def grads(find):
        leaves = [T(x).clone().requires_grad_() for x in (o, d, center,
                                                          radius)]
        rays = Rays(o=leaves[0], d=leaves[1])
        h = find(rays, leaves[2], leaves[3])
        loss = ((torch.where(h.hit, h.t, 0.0) * w).sum()
                + (h.p * w[:, None]).sum() + (h.normal * w[:, None]).sum())
        return h, torch.autograd.grad(loss, leaves)

    h_r, g_r = grads(lambda r, c, rad: pisect.intersect_spheres(
        r, c, rad, T(mat), T_MIN, BIG, chunk=n))
    h_s, g_s = grads(lambda r, c, rad: pisect._sphere_attribs(
        r, c, rad, T(mat), *sc.scan_spheres_plain(r, c, rad, T_MIN, BIG,
                                                  len(center))))
    assert h_r.t.requires_grad and torch.equal(h_r.t, h_s.t)
    assert h_r.hit.float().mean() > 0.2
    for name, a, b in zip(("o", "d", "center", "radius"), g_r, g_s):
        assert torch.isfinite(a).all() and torch.isfinite(b).all(), name
        assert b.abs().max() > 0, name
        assert (a - b).abs().max() <= 1e-5 * b.abs().max(), name
