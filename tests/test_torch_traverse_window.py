"""The visit schedule of the CUDA mesh traversal kernels K1 and K2
(csrc/mesh_traverse.cuh), modelled on the CPU (tests/_torch_parity.py:
model_traverse): one slab scan per ray into a window of W pending (entry,
index) pairs with a refill when a full window ran out, the scan made by
the ray's own lane or by its warp with lanes over clusters, and the leaf
test with lanes over triangle slots reduced on (t, slot). The model is held
bitwise against traverse_clusters_plain (hit mask, id, t, normal, uv:
tolerance 0, both round op for op), and once against the JAX kernel in
interpret mode (equal hit masks, t within 1e-6, under 1% of ids differing,
as tests/test_kernels.py). The kernels themselves are held against the plain
version on the card in tests/test_torch_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hobbyraytracer_tpu.kernels import mesh_traverse as jk
from hobbyraytracer_tpu_torch.kernels import mesh_traverse as pk

from _torch_parity import (aimed_rays, assert_find_match, cluster_tables, model_traverse,
                           pack_rays8, random_mesh, random_rays, refill_rays,
                           teapot_tables, tie_tables)

torch.set_num_threads(2)


def _plain(rays8, bounds8, soa, tri_id, need_uv):
    out, ids = pk.traverse_clusters_plain(
        torch.from_numpy(rays8), torch.from_numpy(bounds8),
        torch.from_numpy(soa),
        None if tri_id is None else torch.from_numpy(tri_id),
        need_uv=need_uv)
    return out.numpy(), ids.numpy()


def _case(name):
    """(rays8, bounds8, tri_soa, tri_id) of a named case."""
    if name == "teapot":          # K = 30, L = 128: the main path's tables
        bounds8, soa, tri_id, _ = teapot_tables()
        rays = random_rays(31, 500, spread=2.0, valid_every=3)
    elif name == "random-leaf8":  # K = 300: most rays enter many clusters
        bounds8, soa, tri_id, _ = cluster_tables(
            *random_mesh(32, n_tris=2400), leaf=8)
        rays = random_rays(33, 1500)
        rays[2][768::2] = False   # whole warps, then half-empty ones
    elif name == "random-leaf64":
        bounds8, soa, tri_id, _ = cluster_tables(*random_mesh(34), leaf=64)
        rays = aimed_rays(35, 500, half=3.0, spread=6.0)
        rays[2][::3] = False
    elif name == "random-leaf160":  # a leaf of two passes of 128 slots
        bounds8, soa, tri_id, _ = cluster_tables(
            *random_mesh(36, n_tris=800), leaf=160)
        rays = aimed_rays(37, 300, half=3.0, spread=6.0)
    else:
        raise ValueError(name)
    return pack_rays8(*rays), bounds8, soa, tri_id


@pytest.mark.parametrize("window", [1, 2, 4])
@pytest.mark.parametrize("mesh", ["teapot", "random-leaf8", "random-leaf64",
                                  "random-leaf160"])
def test_window_schedule_matches_plain(mesh, window):
    """The modelled schedule equals the plain version bit for bit for every
    window size, on 128-, 8-, 64- and 160-triangle leaves; with 8-triangle
    leaves many rays outrun the window and scan again."""
    rays8, bounds8, soa, tri_id = _case(mesh)
    need_uv = window != 2
    out_m, id_m, visits, scans, warp_scans = model_traverse(
        rays8, bounds8, soa, tri_id, need_uv=need_uv, window=window)
    out_p, id_p = _plain(rays8, bounds8, soa, tri_id, need_uv)
    assert (id_p >= 0).sum() > 20
    np.testing.assert_array_equal(out_m, out_p)
    np.testing.assert_array_equal(id_m, id_p)
    valid = rays8[:, 6] > 0
    assert (scans[~valid] == 0).all() and (scans[valid] >= 1).all()
    # a scan serves at most `window` visits, and one more scan follows
    # only a full window that was used up
    assert (visits <= scans * window).all()
    assert (scans <= visits // window + 1).all()
    if mesh == "random-leaf8":
        n_refill = refill_rays(rays8, bounds8, out_p[:, 0], window)
        assert n_refill > 50
        assert (scans > 1).sum() >= n_refill
    if window == 1:   # the schedule a rescan per visit gives
        assert (scans[valid] == visits[valid] + 1).all()
    # both kinds of scan ran: every lane of a full warp for itself at
    # first, the warp together for the few lanes that refill later
    if mesh in ("random-leaf8", "random-leaf160"):
        assert (warp_scans > 0).any() and (scans > warp_scans).any()


@pytest.mark.parametrize("warp_scan_max", [0, 32])
def test_window_schedule_scan_kinds_agree(warp_scan_max):
    """Every scan by the ray's own lane (0) and every scan by the warp (32)
    give the plain version's result bit for bit, refills included."""
    rays8, bounds8, soa, tri_id = _case("random-leaf8")
    out_m, id_m, _, scans, warp_scans = model_traverse(
        rays8, bounds8, soa, tri_id, window=2, warp_scan_max=warp_scan_max)
    out_p, id_p = _plain(rays8, bounds8, soa, tri_id, True)
    np.testing.assert_array_equal(out_m, out_p)
    np.testing.assert_array_equal(id_m, id_p)
    assert (scans > 1).sum() > 50
    assert (warp_scans == (scans if warp_scan_max else 0)).all()


@pytest.mark.parametrize("window", [1, 4])
def test_window_schedule_streaming_layout(window):
    """The 32-row table (ids from row 24) gives the 24-row table's result."""
    rays8, bounds8, soa, tri_id = _case("random-leaf64")
    stream = pk.pack_mesh_stream(soa, tri_id)
    out_m, id_m, *_ = model_traverse(rays8, bounds8, stream, None,
                                       window=window)
    out_p, id_p = _plain(rays8, bounds8, stream, None, True)
    np.testing.assert_array_equal(out_m, out_p)
    np.testing.assert_array_equal(id_m, id_p)


@pytest.mark.parametrize("window", [1, 2, 4])
def test_window_schedule_exact_ties(window):
    """Duplicated triangles inside a leaf (in other lanes of the leaf test)
    and duplicated clusters: the lowest slot of the lowest cluster wins, as
    in the plain version."""
    bounds8, soa, tri_id = tie_tables()
    n_tris = 400
    rays8 = pack_rays8(*aimed_rays(38, 600, half=3.0, spread=6.0))
    out_m, id_m, *_ = model_traverse(rays8, bounds8, soa, tri_id,
                                       window=window)
    out_p, id_p = _plain(rays8, bounds8, soa, tri_id, True)
    hit = id_p >= 0
    assert hit.sum() > 50
    # every hit is a four-way tie; the first copy's id wins
    assert (id_p[hit] < n_tris).all()
    np.testing.assert_array_equal(out_m, out_p)
    np.testing.assert_array_equal(id_m, id_p)


def test_window_schedule_matches_pallas_kernel():
    """The modelled schedule against the JAX kernel in interpret mode on
    the teapot's tables, 600 rays padded to the TPU's 256-ray blocks."""
    bounds8, soa, tri_id, _ = teapot_tables()
    o, d, valid = random_rays(2, 600, spread=2.0, valid_every=3)
    rays8 = pack_rays8(o, d, valid)
    padded = np.concatenate([rays8, np.zeros((768 - 600, 8), np.float32)])
    out_j, id_j = jk.traverse_clusters_pallas(
        jnp.asarray(padded.reshape(-1, 256, 8)), jnp.asarray(bounds8),
        jnp.asarray(soa), jnp.asarray(tri_id), interpret=True, need_uv=True)
    out_j = np.asarray(out_j).reshape(-1, 8)[:600]
    id_j = np.asarray(id_j).reshape(-1)[:600]
    out_m, id_m, *_ = model_traverse(rays8, bounds8, soa, tri_id)
    assert_find_match(out_m[:, 0], id_m, out_m[:, 1:4], out_m[:, 4:6],
                      out_j[:, 0], id_j, out_j[:, 1:4], out_j[:, 4:6], True)
