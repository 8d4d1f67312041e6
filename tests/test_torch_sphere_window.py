"""The schedules of the CUDA sphere kernel K4 (csrc/sphere_traverse.cu) and
of the key kernel K3 (csrc/coherence_keys.cu), modelled on the CPU
(tests/_torch_parity.py: model_sphere_traverse, model_keys).

K4: one slab scan per ray into a window of W pending (entry, index) pairs
with a refill when a full window ran out, the root computed only where
disc > 0, and a round's leaves tested either slot after slot by each ray's
own lane or by the warp with lanes over sphere slots reduced on (bits of t,
slot), as the number of visiting lanes decides. K3: boxes padded to a
multiple of 4 with boxes at 1e30, the near and far bound of each axis
chosen by the ray's direction, one running limit a ray and a strict argmin.

Both models are held bitwise (tolerance 0; model and plain version round op
for op) against intersect_spheres_plain and coherence_keys_plain, and once
each against the JAX kernel in interpret mode (K4: equal hit masks, ids
equal but for exact ties, t within 1e-5 relative on >= 99% of hits and 1e-4
on all, since XLA's CPU build contracts the discriminant into FMAs; K3:
e_min and first exactly equal). The kernels themselves are held against the
plain versions on the card in tests/test_torch_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hobbyraytracer_tpu.kernels import mesh_traverse as jk
from hobbyraytracer_tpu.kernels import sphere_traverse as jsk
from hobbyraytracer_tpu_torch.kernels import mesh_traverse as pk
from hobbyraytracer_tpu_torch.kernels import sphere_traverse as sk
from hobbyraytracer_tpu_torch.scene.bvh import build_sphere_clusters

from _torch_parity import (aimed_rays, balls_pool, cluster_tables,
                           hires_tables, model_keys, model_sphere_traverse,
                           pack_rays8, random_mesh, random_rays, refill_rays,
                           sphere_pool, teapot_tables)

torch.set_num_threads(2)

T = torch.from_numpy
T_MIN = 1e-3


def _plain(rays8, bounds8, table, ids, t_min=T_MIN, t_max=1e30):
    t, i = sk.intersect_spheres_plain(T(rays8), T(bounds8), T(table), T(ids),
                                      t_min, t_max)
    return t.numpy(), i.numpy()


def _pool(name):
    """(rays8, bounds8, table, ids) of a named case."""
    if name == "balls":           # K = 4, L = 128: the scene's own tables
        _, _, _, table, bounds8, ids = balls_pool()
        o, d, valid = aimed_rays(41, 700, center=(0.0, 0.5, 0.0), half=6.0,
                                 spread=12.0)
        o[:, 1] = np.abs(o[:, 1]) + 0.3
        valid[560::3] = False     # whole warps, then ones with dead lanes
    elif name == "random-leaf16":  # K = 64: most rays outrun the window
        center, radius, _ = sphere_pool(42, 700, spread=8.0)
        sc = build_sphere_clusters(center, radius, leaf_size=16)
        bounds8, table, ids = sc["bounds8"], sc["table"], sc["ids"]
        o, d, valid = random_rays(43, 1200, spread=10.0)
        valid[640::2] = False     # whole warps, then half-empty ones
    elif name == "random-leaf160":  # a leaf of two passes of 128 slots
        center, radius, _ = sphere_pool(44, 1500, spread=8.0)
        sc = build_sphere_clusters(center, radius, leaf_size=160)
        bounds8, table, ids = sc["bounds8"], sc["table"], sc["ids"]
        o, d, valid = random_rays(45, 333, spread=10.0)
        valid[192::2] = False
    elif name == "ties":
        # every sphere twice in its leaf (another slot, another id) and
        # every cluster twice (a higher index, an equal box): the lowest
        # slot of the lowest cluster must win
        center, radius, _ = sphere_pool(46, 300, spread=6.0)
        sc = build_sphere_clusters(center, radius, leaf_size=32)
        table = np.concatenate([sc["table"], np.roll(sc["table"], 5, axis=2)],
                               axis=2)
        rolled = np.roll(sc["ids"], 5, axis=1)
        ids = np.concatenate([sc["ids"], np.where(rolled >= 0, rolled + 300,
                                                  -1)], axis=1)
        table = np.concatenate([table, table], axis=0)
        ids = np.concatenate([ids, np.where(ids >= 0, ids + 600, -1)], axis=0)
        bounds8 = np.concatenate([sc["bounds8"], sc["bounds8"]], axis=1)
        bounds8, table, ids = (np.ascontiguousarray(x) for x in (
            bounds8, table, ids.astype(np.int32)))
        o, d, valid = aimed_rays(47, 500, half=5.0, spread=9.0)
    elif name == "inside":
        # rays that start inside a sphere (a dielectric's bounce): the near
        # root lies below t_min, the far one inside the window
        center, radius, _ = sphere_pool(48, 400, spread=6.0)
        sc = build_sphere_clusters(center, radius, leaf_size=64)
        bounds8, table, ids = sc["bounds8"], sc["table"], sc["ids"]
        rng = np.random.default_rng(49)
        pick = rng.integers(0, 400, 450)
        step = rng.normal(0, 1, (450, 3))
        step *= (rng.uniform(0, 0.9, (450, 1)) * radius[pick, None]
                 / np.linalg.norm(step, axis=1, keepdims=True))
        o = (center[pick] + step).astype(np.float32)
        d = rng.normal(0, 1, (450, 3)).astype(np.float32)
        valid = np.ones((450,), bool)
    else:
        raise ValueError(name)
    return pack_rays8(o, d, valid), bounds8, table, ids


# warp_visit_max of model_sphere_traverse: every visit the lane's own, every
# visit the warp's, the kernel's rule
VISITS = {"own-lane": 0, "by-warp": 32, "kernel-rule": None}


@pytest.mark.parametrize("visits_by", list(VISITS))
@pytest.mark.parametrize("window", [1, 2, 4])
@pytest.mark.parametrize("pool", ["balls", "random-leaf16", "random-leaf160",
                                  "ties", "inside"])
def test_sphere_schedule_matches_plain(pool, window, visits_by):
    """The modelled schedule equals the plain version bit for bit for every
    window size and kind of leaf test: on the balls pool (the ground
    sphere's cancellation), on 16-sphere leaves where most rays refill, on
    160-sphere leaves (two passes of the lanes), on duplicated spheres and
    clusters, and on rays that start inside a sphere. N is never a multiple
    of 32 but on the 16-sphere leaves; dead rays give 1e30 / -1."""
    rays8, bounds8, table, ids = _pool(pool)
    t_m, id_m, visits, scans, by_warp = model_sphere_traverse(
        rays8, bounds8, table, ids, T_MIN, window=window,
        warp_visit_max=VISITS[visits_by])
    t_p, id_p = _plain(rays8, bounds8, table, ids)
    assert (id_p >= 0).sum() > 50
    np.testing.assert_array_equal(t_m, t_p)
    np.testing.assert_array_equal(id_m, id_p)
    valid = rays8[:, 6] > 0
    assert (t_m[~valid] == np.float32(1e30)).all()
    assert (id_m[~valid] == -1).all()
    assert (scans[~valid] == 0).all() and (scans[valid] >= 1).all()
    k_clusters = bounds8.shape[1]
    assert (visits <= scans * window).all()
    if k_clusters <= window:      # one scan holds every cluster
        assert (scans[valid] == 1).all()
    if visits_by == "kernel-rule":
        # both kinds of visit ran (on the balls pool too few of these rays
        # enter a box in one round for a lane to visit for itself)
        assert 0 < by_warp.sum() <= visits.sum()
        assert pool == "balls" or by_warp.sum() < visits.sum()
    else:
        assert (by_warp == (visits if VISITS[visits_by] else 0)).all()
    if pool == "random-leaf16":
        n_refill = refill_rays(rays8, bounds8, t_p, window)
        assert n_refill > 50 and (scans > 1).sum() >= n_refill
    if pool == "ties":            # every hit is a four-way tie
        assert (id_p[id_p >= 0] < 300).all()
    if pool == "inside":          # the far root: the ray leaves its sphere
        assert (id_p >= 0).all() and (t_p >= np.float32(T_MIN)).all()


def test_sphere_schedule_narrow_window():
    """A narrow [t_min, t_max]: near roots below t_min give way to far
    roots, hits past t_max are misses, in model and plain version alike."""
    rays8, bounds8, table, ids = _pool("random-leaf16")
    for warp_visit_max in VISITS.values():
        t_m, id_m, *_ = model_sphere_traverse(rays8, bounds8, table, ids, 0.5,
                                              t_max=6.0,
                                              warp_visit_max=warp_visit_max)
        t_p, id_p = _plain(rays8, bounds8, table, ids, 0.5, 6.0)
        hit = id_p >= 0
        assert 50 < hit.sum() < hit.size
        assert ((t_p[hit] >= 0.5) & (t_p[hit] <= 6.0)).all()
        np.testing.assert_array_equal(t_m, t_p)
        np.testing.assert_array_equal(id_m, id_p)


@pytest.mark.parametrize("visits_by", list(VISITS))
def test_sphere_schedule_matches_pallas_kernel(visits_by):
    """The modelled schedule against the JAX sphere kernel in interpret mode
    on a random pool (485 spheres, K = 4), 700 rays padded to its 256-ray
    blocks: hit masks equal, ids equal but for exact ties, t within 1e-5
    relative on >= 99% of hits and 1e-4 on all (XLA's CPU build contracts
    the discriminant hb*hb - a*c into FMAs, and it cancels)."""
    center, radius, _ = sphere_pool(3, 485)
    sc = build_sphere_clusters(center, radius)
    o, d, valid = random_rays(50, 700, spread=15.0, valid_every=1)
    valid[::5] = False
    rays8 = pack_rays8(o, d, valid)
    padded = np.concatenate([rays8, np.zeros((768 - 700, 8), np.float32)])
    padded[700:, 3:6] = 1.0
    t_j, id_j = jsk.intersect_spheres_pallas(
        jnp.asarray(padded).reshape(-1, 256, 8), jnp.asarray(sc["bounds8"]),
        jnp.asarray(sc["table"]), jnp.asarray(sc["ids"]), t_min=T_MIN,
        interpret=True)
    t_j = np.asarray(t_j).reshape(-1)[:700]
    id_j = np.asarray(id_j).reshape(-1)[:700]
    t_m, id_m, *_ = model_sphere_traverse(
        rays8, sc["bounds8"], sc["table"], sc["ids"], T_MIN,
        warp_visit_max=VISITS[visits_by])
    assert (id_j >= 0).sum() > 150
    np.testing.assert_array_equal(id_m >= 0, id_j >= 0)
    same = id_m == id_j
    assert same.mean() >= 0.995   # exact ties between clusters only
    hit = (id_j >= 0) & same
    rel = np.abs(t_m - t_j)[hit] / np.abs(t_j[hit])
    assert (rel <= 1e-5).mean() >= 0.99 and rel.max() <= 1e-4, rel.max()


def _key_case(name):
    """(rays8, bounds8) of a named case."""
    if name == "teapot":          # K = 30
        bounds8 = teapot_tables()[0]
        rays = random_rays(51, 700, spread=2.0, valid_every=3)
    elif name == "teapot_hires":  # K = 822
        bounds8 = hires_tables()[0]
        rays = aimed_rays(52, 333, center=(0.0, 1.5, 0.0), spread=4.0)
    elif name == "random-301":    # K % 4 = 1; rays start inside many boxes
        bounds8 = cluster_tables(*random_mesh(53, n_tris=2408), leaf=8)[0]
        rays = random_rays(54, 1000, spread=3.0)
        rays[2][::7] = False
    else:
        raise ValueError(name)
    return pack_rays8(*rays), np.ascontiguousarray(bounds8)


@pytest.mark.parametrize("t_max", [1e30, 4.0, 2.0])
@pytest.mark.parametrize("case", ["teapot", "teapot_hires", "random-301"])
def test_key_tile_matches_plain(case, t_max):
    """The modelled loop equals coherence_keys_plain exactly at K = 30, 822
    and 301 (K % 4 = 1: three padding boxes at 1e30 that must never win),
    with the whole ray and with a t_max that cuts far boxes off; rays inside
    several boxes tie at entry 0 and get the lowest index; invalid rays and
    rays that miss every box give (+inf, 0)."""
    rays8, bounds8 = _key_case(case)
    k_clusters = bounds8.shape[1]
    assert (case != "random-301") or k_clusters % 4 == 1
    e_m, f_m = model_keys(rays8, bounds8, t_max=t_max)
    e_p, f_p = pk.coherence_keys_plain(T(rays8), T(bounds8), t_max)
    e_p, f_p = e_p.numpy(), f_p.numpy()
    np.testing.assert_array_equal(e_m, e_p)
    np.testing.assert_array_equal(f_m, f_p)
    miss = ~np.isfinite(e_p)
    assert miss.any() and (~miss).sum() > 100
    assert (e_p[~miss] < t_max).all()
    assert (f_p[miss] == 0).all() and (f_p < k_clusters).all()
    if case == "random-301":
        rays = T(rays8)
        entry = pk.slab_entries(rays[:, 0:3], rays[:, 3:6], rays[:, 6] > 0.0,
                                T(bounds8), t_max).numpy()
        tied = ((entry == e_p[:, None]).sum(axis=1) >= 2) & ~miss
        assert tied.sum() > 100
        assert (f_p[tied] == np.argmax(entry[tied] == e_p[tied, None],
                                       axis=1)).all()
        assert (e_p[~(rays8[:, 6] > 0)] == np.inf).all()


def test_key_tile_matches_pallas_kernel():
    """The modelled loop against the JAX key kernel in interpret mode on the
    teapot's boxes, 700 rays padded to its 2048-ray tile: e_min and first
    exactly equal (the slab test has no sum for XLA to contract)."""
    rays8, bounds8 = _key_case("teapot")
    padded = np.concatenate([rays8, np.zeros((2048 - 700, 8), np.float32)])
    e_j, f_j = jk.coherence_keys_pallas(jnp.asarray(padded[None]),
                                        jnp.asarray(bounds8), interpret=True)
    e_m, f_m = model_keys(rays8, bounds8)
    finite = np.isfinite(e_m)
    assert finite.sum() > 100 and not finite.all()
    np.testing.assert_array_equal(e_m, np.asarray(e_j)[0, 0, :700])
    np.testing.assert_array_equal(f_m, np.asarray(f_j)[0, 0, :700])
