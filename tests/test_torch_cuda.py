"""The CUDA kernels of the port on the card: K1 (resident table), K2
(streaming table), K3 (coherence keys), K4 (clustered sphere find),
sphere_scan (the dense sphere scan) and threefry (the draws), each against
its plain PyTorch version, and K2 against K1; the wavefront render, the
fit's steps and the batch integrator's samples replayed from CUDA graphs
against the eager render and fit, and the render's block graph kept
across renders against a cleared cache. All are built with -fmad=false and
round op for op as PyTorch does, so kernel and plain version are equal
(tolerance 0), not only within the parity tolerances. Every test here
needs a CUDA card and skips without one; the file imports neither JAX nor
the JAX package, so it also runs where JAX is not installed:

    python -m pytest --noconftest -o markers=cuda tests/test_torch_cuda.py -q

(tests/conftest.py imports JAX, hence --noconftest there; it also
registers the `cuda` marker, hence -o markers=cuda.)"""
import contextlib

import numpy as np
import pytest
import torch

from hobbyraytracer_tpu_torch.core.rng import Sampler
from hobbyraytracer_tpu_torch.core.types import Rays
from hobbyraytracer_tpu_torch.integrator import wavefront
from hobbyraytracer_tpu_torch.kernels import build as kbuild
from hobbyraytracer_tpu_torch.kernels import mesh_traverse as pk
from hobbyraytracer_tpu_torch.kernels import sphere_scan as sc
from hobbyraytracer_tpu_torch.kernels import sphere_traverse as sk
from hobbyraytracer_tpu_torch.scene.bvh import build_sphere_clusters
from hobbyraytracer_tpu_torch.scene import build_scene, load_scene_desc

from _torch_parity import (BALLS, HIRES, SCENES, TEAPOT, aimed_rays,
                           assert_find_match, balls_pool, cluster_tables,
                           hires_tables, pack_rays8, random_mesh, random_rays,
                           refill_rays, sphere_pool, teapot_tables)

torch.set_num_threads(2)

# kSmemMaxK in csrc/mesh_traverse.cuh: up to this K the kernels stage the
# cluster boxes in shared memory, past it they read them from global memory
SMEM_MAX_K = 2048
# kWindow in csrc/mesh_traverse.cuh: the pending visits a ray keeps from one
# slab scan; a ray that enters more clusters than this scans again
WINDOW = 4
# kSphereSmemBytes in csrc/sphere_traverse.cu: K4 stages a sphere pool's
# boxes (6 rows of K padded to a multiple of 4) and its table (one 16-byte
# word a sphere, clusters L | 1 words apart) in shared memory while they fit
# this, and reads the table from global memory past it
SPHERE_SMEM_BYTES = 48 * 1024

pytestmark = pytest.mark.cuda


def _count_iterations(monkeypatch):
    """Count the iterations (segments) that render_state issues, the ones
    replayed from its CUDA graph included: _pool_run returns one retired
    count an iteration."""
    n = [0]
    pool_run = wavefront._pool_run

    def counted(*args, **kwargs):
        counts = pool_run(*args, **kwargs)
        n[0] += len(counts)
        return counts

    monkeypatch.setattr(wavefront, "_pool_run", counted)
    return n


def _plain(on: bool):
    """kernels/build.py:plain_versions() when `on`, else no switch."""
    return kbuild.plain_versions() if on else contextlib.nullcontext()


def _eager(on: bool):
    """kernels/build.py:eager() when `on`, else no switch."""
    return kbuild.eager() if on else contextlib.nullcontext()


@pytest.fixture(autouse=True)
def own_render_graphs(monkeypatch):
    """Each test starts with no kept block graph (integrator/wavefront.py:
    RENDER_GRAPHS), so its first graph render of a configuration captures
    one, and leaves none behind."""
    monkeypatch.setattr(wavefront, "RENDER_GRAPHS", wavefront.RenderGraphs())


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _on(dev, *arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                 for a in arrays)


def _ordered(rays8, b8, order):
    """The rays as they were drawn ("unsorted": neighbours in a warp go
    anywhere) or sorted by the coherence key, as the mesh find sorts them
    before it calls the kernel."""
    if order == "unsorted":
        return rays8
    from hobbyraytracer_tpu_torch.ops.intersect import coherence_key
    key = coherence_key(rays8[:, 0:3], rays8[:, 3:6], rays8[:, 6] > 0.0, b8,
                        1e30)
    return rays8[torch.argsort(key, stable=True)].contiguous()


@pytest.mark.parametrize("order", ["sorted", "unsorted"])
@pytest.mark.parametrize("need_uv", [False, True])
@pytest.mark.parametrize("mesh", ["teapot", "random-leaf64"])
def test_kernel_matches_plain(dev, mesh, need_uv, order):
    """Kernel vs plain version on the card, on rays sorted by the coherence
    key and in random order. Built with -fmad=false, the kernel rounds op
    for op as PyTorch does, so outputs are equal, not only within the
    parity tolerances."""
    if mesh == "teapot":
        bounds8, soa, tri_id, _ = teapot_tables()
        o, d, valid = random_rays(3, 5000, spread=2.0, valid_every=2)
    else:
        bounds8, soa, tri_id, _ = cluster_tables(*random_mesh(1), leaf=64)
        o, d, valid = random_rays(4, 5000, valid_every=2)
    rays8, b8, tab, ids = _on(dev, pack_rays8(o, d, valid), bounds8, soa,
                              tri_id)
    rays8 = _ordered(rays8, b8, order)
    before = pk.KERNEL.launches
    out_k, id_k = pk.traverse_clusters(rays8, b8, tab, ids, need_uv=need_uv)
    assert pk.KERNEL.launches == before + 1
    out_p, id_p = pk.traverse_clusters_plain(rays8, b8, tab, ids,
                                             need_uv=need_uv)
    torch.cuda.synchronize()
    out_k, id_k, out_p, id_p = (x.cpu().numpy()
                                for x in (out_k, id_k, out_p, id_p))
    assert_find_match(out_k[:, 0], id_k, out_k[:, 1:4], out_k[:, 4:6],
                      out_p[:, 0], id_p, out_p[:, 1:4], out_p[:, 4:6],
                      need_uv)
    np.testing.assert_array_equal(out_k, out_p)
    np.testing.assert_array_equal(id_k, id_p)


def test_kernel_argument_checks(dev):
    bounds8, soa, tri_id, _ = teapot_tables()
    o, d, valid = random_rays(5, 64, spread=2.0)
    rays8, b8, tab, ids = _on(dev, pack_rays8(o, d, valid), bounds8, soa,
                              tri_id)
    with pytest.raises(TypeError):
        pk.traverse_clusters(rays8.double(), b8, tab, ids)
    with pytest.raises(ValueError, match="contiguous"):
        pk.traverse_clusters(rays8, b8, tab.transpose(1, 2).contiguous()
                             .transpose(1, 2), ids)
    with pytest.raises(ValueError, match="is on"):
        pk.traverse_clusters(rays8, b8.cpu(), tab, ids)
    with pytest.raises(ValueError, match="24, L"):
        pk.traverse_clusters(rays8, b8, tab[:, :20].contiguous(), ids)
    # K1 takes any K: 300 copies of one cluster (past the old cap of 256)
    big = 300
    out, _ = pk.traverse_clusters(rays8, b8[:, :1].repeat(1, big),
                                  tab[:1].repeat(big, 1, 1),
                                  ids[:1].repeat(big, 1))
    assert out.shape == (64, 8)
    out, ids_out = pk.traverse_clusters(rays8[:0], b8, tab, ids)
    assert out.shape == (0, 8) and ids_out.shape == (0,)


def test_stream_kernel_argument_checks(dev):
    """The 32-row layout: ids come from row 24 (tri_id is not read, so it
    may be anything), the table's checks still apply."""
    bounds8, soa, tri_id, _ = teapot_tables()
    stream = pk.pack_mesh_stream(soa, tri_id)
    o, d, valid = random_rays(6, 64, spread=2.0)
    rays8, b8, tab = _on(dev, pack_rays8(o, d, valid), bounds8, stream)
    before = (pk.KERNEL.launches, pk.KERNEL_STREAM.launches)
    out, ids = pk.traverse_clusters(rays8, b8, tab, None)
    assert (pk.KERNEL.launches, pk.KERNEL_STREAM.launches) == (
        before[0], before[1] + 1)
    assert out.shape == (64, 8) and ids.dtype == torch.int32
    with pytest.raises(TypeError):
        pk.traverse_clusters(rays8, b8, tab.double(), None)
    with pytest.raises(ValueError, match="contiguous"):
        pk.traverse_clusters(rays8, b8, tab.transpose(1, 2).contiguous()
                             .transpose(1, 2), None)
    with pytest.raises(ValueError, match="bounds8"):
        pk.traverse_clusters(rays8, b8[:, :-1].contiguous(), tab, None)
    with pytest.raises(ValueError, match="is on"):
        pk.traverse_clusters(rays8, b8, tab.cpu(), None)
    with pytest.raises(ValueError, match="32, L"):
        pk.traverse_clusters(rays8, b8, tab[:, :31].contiguous(), None)
    with pytest.raises(ValueError, match="CUDA"):
        pk.coherence_keys(rays8.to("meta"), b8.to("meta"))
    with pytest.raises(ValueError, match="bounds8"):
        pk.coherence_keys(rays8, b8[:6].contiguous())
    out, ids = pk.traverse_clusters(rays8[:0], b8, tab, None)
    assert out.shape == (0, 8) and ids.shape == (0,)


def _mesh_case(name):
    """(bounds8, tri_soa, tri_id, stream table, (o, d, valid)) of a case."""
    if name == "teapot_hires":
        b8, soa, ids, stream = hires_tables()
        rays = aimed_rays(11, 20_000, center=(0.0, 1.5, 0.0), spread=4.0)
    elif name == "hires-40k":     # K = 313: K1 past its old cap of 256
        b8, soa, ids, stream = hires_tables(40_000)
        rays = aimed_rays(12, 20_000, center=(0.0, 1.5, 0.0), spread=4.0)
    elif name == "random-20k-leaf8":  # K = 2500: boxes read from global
        b8, soa, ids, _ = cluster_tables(*random_mesh(3, n_tris=20_000),
                                         leaf=8)
        assert b8.shape[1] > SMEM_MAX_K
        stream = pk.pack_mesh_stream(soa, ids)
        rays = random_rays(14, 8000, valid_every=2)
    else:                         # K > 256 on 8-triangle leaves
        b8, soa, ids, _ = cluster_tables(*random_mesh(2, n_tris=2400),
                                         leaf=8)
        stream = pk.pack_mesh_stream(soa, ids)
        rays = random_rays(13, 8000, valid_every=2)
    return b8, soa, ids, stream, rays


@pytest.mark.parametrize("order", ["sorted", "unsorted"])
@pytest.mark.parametrize("need_uv", [False, True])
@pytest.mark.parametrize("mesh", ["random-leaf8", "hires-40k",
                                  "teapot_hires", "random-20k-leaf8"])
def test_stream_kernel_matches_plain_and_resident(dev, mesh, need_uv, order):
    """K2 vs its plain version, and K2 vs K1 on the same mesh in its two
    layouts, on sorted and on unsorted rays: all bitwise equal (K > 256 in
    every case; the boxes staged in shared memory up to K = 2048, read
    from global memory past it)."""
    b8, soa, ids, stream, rays = _mesh_case(mesh)
    assert b8.shape[1] > 256
    rays8, b8, soa, ids, stream = _on(dev, pack_rays8(*rays), b8, soa, ids,
                                      stream)
    rays8 = _ordered(rays8, b8, order)
    before = (pk.KERNEL.launches, pk.KERNEL_STREAM.launches)
    out_s, id_s = pk.traverse_clusters(rays8, b8, stream, ids,
                                       need_uv=need_uv)
    out_r, id_r = pk.traverse_clusters(rays8, b8, soa, ids, need_uv=need_uv)
    assert (pk.KERNEL.launches, pk.KERNEL_STREAM.launches) == (
        before[0] + 1, before[1] + 1)
    out_p, id_p = pk.traverse_clusters_plain(rays8, b8, stream, None,
                                             need_uv=need_uv)
    torch.cuda.synchronize()
    out_s, id_s, out_r, id_r, out_p, id_p = (
        x.cpu().numpy() for x in (out_s, id_s, out_r, id_r, out_p, id_p))
    assert (id_s >= 0).mean() > 0.05
    np.testing.assert_array_equal(out_s, out_p)
    np.testing.assert_array_equal(id_s, id_p)
    np.testing.assert_array_equal(out_s, out_r)
    np.testing.assert_array_equal(id_s, id_r)


@pytest.mark.parametrize("mesh", ["random-leaf8", "random-20k-leaf8"])
def test_kernels_match_plain_on_refilling_rays(dev, mesh):
    """Rays that enter more clusters than the kernels' window holds (8-
    triangle leaves: K = 300 with the boxes in shared memory, K = 2500 with
    them in global memory) use a full window up and scan again: a counted
    share of the rays does, and K1, K2 and the plain version still agree
    bit for bit."""
    b8, soa, ids, stream, _ = _mesh_case(mesh)
    rays8, b8, soa, ids, stream = _on(
        dev, pack_rays8(*random_rays(15, 40_000)), b8, soa, ids, stream)
    out_p, id_p = pk.traverse_clusters_plain(rays8, b8, soa, ids)
    n_refill = refill_rays(rays8, b8, out_p[:, 0], WINDOW)
    assert n_refill >= 1000, f"only {n_refill} of 40000 rays refill"
    for table in (soa, stream):
        out_k, id_k = pk.traverse_clusters(rays8, b8, table, ids)
        torch.cuda.synchronize()
        assert torch.equal(out_k, out_p) and torch.equal(id_k, id_p)
    assert (id_p >= 0).float().mean() > 0.05


@pytest.mark.parametrize("n_rays", [1, 33, 4097])
def test_kernels_take_any_ray_count(dev, n_rays):
    """A ray count that fills neither a warp nor a block: the lanes past
    the last ray idle through the warp's rounds, and K1 and K2 equal the
    plain version."""
    b8, soa, ids, stream, rays = _mesh_case("hires-40k")
    rays8, b8, soa, ids, stream = _on(dev, pack_rays8(*rays)[:n_rays], b8,
                                      soa, ids, stream)
    out_p, id_p = pk.traverse_clusters_plain(rays8, b8, soa, ids)
    for table in (soa, stream):
        out_k, id_k = pk.traverse_clusters(rays8, b8, table, ids)
        torch.cuda.synchronize()
        assert out_k.shape == (n_rays, 8) and id_k.shape == (n_rays,)
        assert torch.equal(out_k, out_p) and torch.equal(id_k, id_p)
    assert n_rays == 1 or (id_p >= 0).any()


@pytest.mark.parametrize("mesh", ["random-leaf8", "teapot_hires",
                                  "random-20k-leaf8"])
def test_key_kernel_matches_plain(dev, mesh):
    """K3 vs its plain version: e_min and first exactly equal, with the
    boxes in shared memory (K <= 2048) and in global memory (K = 2500)."""
    b8, _, _, _, rays = _mesh_case(mesh)
    rays8, b8 = _on(dev, pack_rays8(*rays), b8)
    before = pk.KEY_KERNEL.launches
    e_k, f_k = pk.coherence_keys(rays8, b8)
    assert pk.KEY_KERNEL.launches == before + 1
    e_p, f_p = pk.coherence_keys_plain(rays8, b8)
    torch.cuda.synchronize()
    assert f_k.dtype == torch.int32 and e_k.shape == (rays8.shape[0],)
    assert torch.isfinite(e_k).any() and not torch.isfinite(e_k).all()
    assert torch.equal(e_k, e_p) and torch.equal(f_k, f_p)


@pytest.mark.parametrize("n_rays", [1, 33, 4097])
@pytest.mark.parametrize("mesh", ["hires-821", "random-20k-leaf8"])
def test_key_kernel_takes_any_cluster_and_ray_count(dev, mesh, n_rays):
    """K3 at a K that is no multiple of 4 (teapot_hires's first 821 boxes:
    three padding boxes in the staging, which must never win) and at K =
    2,500 (boxes read from global memory), with ray counts that fill neither
    a warp nor a block: e_min and first exactly equal."""
    if mesh == "hires-821":
        b8, _, _, _, rays = _mesh_case("teapot_hires")
        b8 = np.ascontiguousarray(b8[:, :821])
    else:
        b8, _, _, _, rays = _mesh_case(mesh)
    assert b8.shape[1] % 4 != 0 or b8.shape[1] > SMEM_MAX_K
    rays8, b8 = _on(dev, pack_rays8(*rays)[:n_rays], b8)
    e_k, f_k = pk.coherence_keys(rays8, b8)
    e_p, f_p = pk.coherence_keys_plain(rays8, b8)
    torch.cuda.synchronize()
    assert e_k.shape == f_k.shape == (n_rays,)
    assert torch.equal(e_k, e_p) and torch.equal(f_k, f_p)


def test_render_through_kernel_matches_plain(dev):
    """A whole render through the kernel and through the plain version with
    one seed: the images agree (the framebuffer's index_add_ uses atomics,
    so sums may differ in the last bits)."""
    job = build_scene(load_scene_desc(TEAPOT))
    scene, camera = job.scene.to(dev), job.camera.to(dev)
    pk.KERNEL.launches = 0
    imgs = []
    for plain in (False, True):
        with _plain(plain):
            imgs.append(wavefront.render_image(scene, camera, 32, 32, 4,
                                               Sampler(3, dev), pool=2048))
    assert pk.KERNEL.launches > 0
    assert torch.isfinite(imgs[0]).all()
    torch.testing.assert_close(imgs[0], imgs[1], rtol=1e-5, atol=1e-5)


def test_hires_render_goes_through_k2(dev, monkeypatch):
    """A tiny teapot_hires render: through K2 only (K1 never launches), in
    either key mode, and equal to the render through the plain versions."""
    from hobbyraytracer_tpu_torch.ops import intersect as pisect
    job = build_scene(load_scene_desc(HIRES))
    scene, camera = job.scene.to(dev), job.camera.to(dev)
    imgs = []
    for mode, plain in (("auto", False), ("pallas", False),
                        ("pallas", True)):
        monkeypatch.setattr(pisect, "KEY_MODE", mode)
        pk.KERNEL.launches = pk.KERNEL_STREAM.launches = 0
        pk.KEY_KERNEL.launches = 0
        with _plain(plain):
            imgs.append(wavefront.render_image(scene, camera, 16, 16, 4,
                                               Sampler(5, dev), pool=1024))
        assert pk.KERNEL.launches == 0
        assert (pk.KERNEL_STREAM.launches > 0) == (not plain)
        assert (pk.KEY_KERNEL.launches > 0) == (mode == "pallas"
                                                and not plain)
    assert torch.isfinite(imgs[0]).all()
    for img in imgs[1:]:
        torch.testing.assert_close(img, imgs[0], rtol=1e-5, atol=1e-5)


def _sphere_case(name):
    """(bounds8, table, ids, (o, d, valid), staged in shared memory?)."""
    if name == "balls":          # K = 4: the scene's own tables
        _, _, _, table, bounds8, ids = balls_pool()
        rays = aimed_rays(21, 20_000, center=(0.0, 0.5, 0.0), half=6.0,
                          spread=12.0)
        rays[2][::7] = False
        return bounds8, table, ids, rays, True
    n, leaf = (5000, 128) if name == "random-5000" else (3000, 16)
    center, radius, _ = sphere_pool(22, n, spread=20.0)
    sc = build_sphere_clusters(center, radius, leaf_size=leaf)
    return (sc["bounds8"], sc["table"], sc["ids"],
            random_rays(23, 20_000, spread=25.0, valid_every=2), False)


@pytest.mark.parametrize("pool", ["balls", "random-5000", "random-3000-leaf16"])
def test_sphere_kernel_matches_plain(dev, pool):
    """K4 vs its plain version: t and ids bitwise equal (tolerance 0), on
    the balls scene's tables (K = 4, staged in shared memory) and on random
    pools of 5,000 spheres (K = 64) and 3,000 on 16-sphere leaves (K = 256),
    both past the staging, their tables read from global memory. Dead lanes
    give 1e30 and -1."""
    bounds8, table, ids, rays, staged = _sphere_case(pool)
    k_clusters, _, leaf = table.shape
    assert (24 * (-(-k_clusters // 4) * 4) + 16 * k_clusters * (leaf | 1)
            <= SPHERE_SMEM_BYTES) == staged
    assert staged or table.shape[0] >= 40
    rays8, b8, tab, idt = _on(dev, pack_rays8(*rays), bounds8, table, ids)
    before = sk.SPHERE_KERNEL.launches
    t_k, id_k = sk.intersect_spheres_kernel(rays8, b8, tab, idt, 1e-3)
    assert sk.SPHERE_KERNEL.launches == before + 1
    t_p, id_p = sk.intersect_spheres_plain(rays8, b8, tab, idt, 1e-3)
    torch.cuda.synchronize()
    assert t_k.shape == id_k.shape == (rays8.shape[0],)
    assert id_k.dtype == torch.int32 and t_k.dtype == torch.float32
    hit = id_k >= 0
    assert 0.05 < hit.float().mean() < 1.0
    assert torch.equal(t_k, t_p) and torch.equal(id_k, id_p)
    dead = rays8[:, 6] <= 0
    assert dead.any() and (t_k[dead] == 1e30).all() and (id_k[dead] == -1).all()
    assert (t_k[~hit] == 1e30).all() and (t_k[hit] < 1e30).all()
    # a narrower window is honoured (far roots and misses past t_max)
    t_w, id_w = sk.intersect_spheres_kernel(rays8, b8, tab, idt, 0.5, 9.0)
    t_q, id_q = sk.intersect_spheres_plain(rays8, b8, tab, idt, 0.5, 9.0)
    assert torch.equal(t_w, t_q) and torch.equal(id_w, id_q)
    assert ((t_w >= 0.5) & (t_w <= 9.0) | (id_w < 0)).all()


@pytest.mark.parametrize("order", ["drawn", "random"])
@pytest.mark.parametrize("pool", ["random-5000", "random-3000-leaf16"])
def test_sphere_kernel_matches_plain_on_refilling_rays(dev, pool, order):
    """Pools whose K exceeds the kernel's window: a counted number of rays
    enters more clusters than the window holds and scans again, and K4 still
    equals the plain version bit for bit, also with the rays in a seeded
    random order (each ray's result moves with it)."""
    bounds8, table, ids, _, _ = _sphere_case(pool)
    rays8, b8, tab, idt = _on(
        dev, pack_rays8(*random_rays(25, 50_000, spread=25.0)), bounds8,
        table, ids)
    if order == "random":
        rays8 = rays8[torch.randperm(rays8.shape[0], generator=torch
                                     .Generator().manual_seed(0)).to(dev)]
        rays8 = rays8.contiguous()
    t_p, id_p = sk.intersect_spheres_plain(rays8, b8, tab, idt, 1e-3)
    n_refill = refill_rays(rays8, b8, t_p, WINDOW)
    assert n_refill >= 1000, f"only {n_refill} of 50000 rays refill"
    t_k, id_k = sk.intersect_spheres_kernel(rays8, b8, tab, idt, 1e-3)
    torch.cuda.synchronize()
    assert torch.equal(t_k, t_p) and torch.equal(id_k, id_p)
    assert (id_p >= 0).float().mean() > 0.05


@pytest.mark.parametrize("n_rays", [1, 33, 4097])
@pytest.mark.parametrize("pool", ["balls", "random-5000"])
def test_sphere_kernel_takes_any_ray_count(dev, pool, n_rays):
    """A ray count that fills neither a warp nor a block, on the staged
    pool and on the one read from global memory: the lanes past the last
    ray idle through the warp's rounds, and K4 equals the plain version."""
    bounds8, table, ids, rays, _ = _sphere_case(pool)
    rays8, b8, tab, idt = _on(dev, pack_rays8(*rays)[1:n_rays + 1], bounds8,
                              table, ids)
    t_k, id_k = sk.intersect_spheres_kernel(rays8, b8, tab, idt, 1e-3)
    t_p, id_p = sk.intersect_spheres_plain(rays8, b8, tab, idt, 1e-3)
    torch.cuda.synchronize()
    assert t_k.shape == id_k.shape == (n_rays,)
    assert torch.equal(t_k, t_p) and torch.equal(id_k, id_p)
    assert n_rays == 1 or (id_p >= 0).any()


def test_sphere_kernel_argument_checks(dev):
    _, _, _, table, bounds8, ids = balls_pool()
    o, d, valid = random_rays(24, 64, spread=8.0)
    rays8, b8, tab, idt = _on(dev, pack_rays8(o, d, valid), bounds8, table,
                              ids)
    with pytest.raises(TypeError):
        sk.intersect_spheres_kernel(rays8.double(), b8, tab, idt, 1e-3)
    with pytest.raises(TypeError):
        sk.intersect_spheres_kernel(rays8, b8, tab, idt.long(), 1e-3)
    with pytest.raises(ValueError, match="contiguous"):
        sk.intersect_spheres_kernel(rays8, b8, tab.transpose(1, 2)
                                    .contiguous().transpose(1, 2), idt, 1e-3)
    with pytest.raises(ValueError, match="is on"):
        sk.intersect_spheres_kernel(rays8, b8, tab, idt.cpu(), 1e-3)
    with pytest.raises(ValueError, match="8, L"):
        sk.intersect_spheres_kernel(rays8, b8, tab[:, :4].contiguous(), idt,
                                    1e-3)
    with pytest.raises(ValueError, match="bounds8"):
        sk.intersect_spheres_kernel(rays8, b8[:, :-1].contiguous(), tab, idt,
                                    1e-3)
    with pytest.raises(ValueError, match="CUDA"):
        sk.intersect_spheres_kernel(rays8.to("meta"), b8, tab, idt, 1e-3)
    t, i = sk.intersect_spheres_kernel(rays8[:0], b8, tab, idt, 1e-3)
    assert t.shape == (0,) and i.shape == (0,)
    t, i = sk.intersect_spheres_kernel(rays8.reshape(4, 16, 8), b8, tab, idt,
                                       1e-3)
    assert t.shape == (4, 16) and i.shape == (4, 16)


def test_balls_render_routes(dev, monkeypatch):
    """A tiny scattered_balls render by the default route (dense scan, K4
    never launched), through K4 (SPHERE_KERNEL on) and through K4's plain
    version: the two clustered renders agree; the dense one agrees with
    them but for tangent rays and rounding (>= 99% of pixels within 1e-3)."""
    from hobbyraytracer_tpu_torch.ops import intersect as pisect
    job = build_scene(load_scene_desc(BALLS))
    scene, camera = job.scene.to(dev), job.camera.to(dev)
    imgs = {}
    for name, on, plain in (("dense", False, False), ("k4", True, False),
                            ("plain", True, True)):
        monkeypatch.setattr(pisect, "SPHERE_KERNEL", on)
        sk.SPHERE_KERNEL.launches = 0
        with _plain(plain):
            imgs[name] = wavefront.render_image(scene, camera, 32, 24, 4,
                                                Sampler(7, dev), pool=2048)
        assert (sk.SPHERE_KERNEL.launches > 0) == (name == "k4")
        assert torch.isfinite(imgs[name]).all()
    near = (imgs["k4"] - imgs["plain"]).abs().amax(dim=2) < 1e-3
    assert near.float().mean() >= 0.99
    near = (imgs["k4"] - imgs["dense"]).abs().amax(dim=2) < 1e-3
    assert near.float().mean() >= 0.99


# --- the dense sphere scan (sphere_scan) ------------------------------------

def _scan_both(rays, center, radius, t_min=1e-3, t_max=1e30):
    """The kernel and the plain chunked scan on the same card tensors,
    synchronised; the kernel's launch counted once (none for no rays)."""
    before = sc.SCAN_KERNEL.launches
    t_k, i_k = sc.scan_spheres(rays, center, radius, t_min, t_max)
    assert sc.SCAN_KERNEL.launches == before + (rays.o.shape[0] > 0)
    t_p, i_p = sc.scan_spheres_plain(rays, center, radius, t_min, t_max)
    torch.cuda.synchronize()
    assert t_k.dtype == torch.float32 and i_k.dtype == torch.int64
    assert t_k.shape == i_k.shape == (rays.o.shape[0],)
    return t_k, i_k, t_p, i_p


def _balls_on(dev):
    """The balls scene's pooled spheres on the card: center, radius, mat."""
    center, radius, mat = balls_pool()[:3]
    return _on(dev, center, radius, mat)


@pytest.mark.parametrize("n_spheres", [1, 127, 128, 129, 485])
def test_sphere_scan_matches_plain(dev, n_spheres):
    """The kernel against the chunked scan, t and index bit for bit
    (tolerance 0), on random pools of one sphere, just under, at and just
    over one chunk of 128, and 485 (three chunks and a padded fourth), in
    the default window and a narrower one."""
    center, radius, _ = sphere_pool(41, n_spheres,
                                    spread=10.0 if n_spheres > 1 else 1.0)
    o, d, _ = random_rays(42, 30_000, spread=15.0 if n_spheres > 1 else 3.0)
    rays = Rays(*_on(dev, o, d))
    c, r = _on(dev, center, radius)
    t_k, i_k, t_p, i_p = _scan_both(rays, c, r)
    assert torch.equal(t_k, t_p) and torch.equal(i_k, i_p)
    hit = i_k >= 0
    assert hit.any() and (t_k[~hit] == 1e30).all() and (t_k[hit] < 1e30).all()
    t_k, i_k, t_p, i_p = _scan_both(rays, c, r, 0.5, 9.0)
    assert torch.equal(t_k, t_p) and torch.equal(i_k, i_p)
    assert ((t_k >= 0.5) & (t_k <= 9.0) | (i_k < 0)).all()


def _grazing_rays(center, radius, n, seed):
    """Rays that pass a small sphere of the pool at about its radius from
    its center (disc near 0, of either sign) -> o, d, the grazed index."""
    rng = np.random.default_rng(seed)
    small = np.flatnonzero(radius < 2.0)
    j = rng.choice(small, n)
    o = (rng.uniform(-12.0, 12.0, (n, 3))
         + np.asarray([0.0, 12.5, 0.0])).astype(np.float32)
    w = center[j] - o
    u = np.cross(w, rng.normal(0, 1, (n, 3)))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    scale = 1.0 + rng.choice([-1e-6, 0.0, 1e-6], n)
    tgt = center[j] + u * (radius[j] * scale)[:, None]
    return o, (tgt - o).astype(np.float32), j


@pytest.mark.parametrize("rays", ["aimed", "grazing", "ground"])
def test_sphere_scan_on_the_balls_pool(dev, rays):
    """The kernel against the chunked scan on the balls scene's 485
    spheres, bit for bit: rays aimed into the scene; rays that graze a
    small sphere (the grazed sphere hit by some and missed by others);
    rays down at the ground sphere of radius 1000 (most end on it)."""
    center, radius, _ = balls_pool()[:3]
    if rays == "aimed":
        o, d, _ = aimed_rays(43, 50_000, center=(0.0, 0.5, 0.0), half=6.0,
                             spread=12.0)
        o[:, 1] = np.abs(o[:, 1]) + 0.3
    elif rays == "grazing":
        o, d, j = _grazing_rays(center, radius, 50_000, 44)
    else:
        rng = np.random.default_rng(45)
        o = np.stack([rng.uniform(-50, 50, 50_000), rng.uniform(0.3, 3.0,
                      50_000), rng.uniform(-50, 50, 50_000)], 1)
        d = np.stack([rng.normal(0, 1, 50_000), -rng.uniform(0.01, 1.0,
                      50_000), rng.normal(0, 1, 50_000)], 1)
        o, d = o.astype(np.float32), d.astype(np.float32)
    r = Rays(*_on(dev, o, d))
    c, rad = _on(dev, center, radius)
    t_k, i_k, t_p, i_p = _scan_both(r, c, rad)
    assert torch.equal(t_k, t_p) and torch.equal(i_k, i_p)
    assert (i_k >= 0).float().mean() > 0.2
    if rays == "grazing":
        own = sc.winner_t(r, c, rad, torch.from_numpy(j).to(dev), 1e-3, 1e30)
        assert 0.05 < (own < 1e30).float().mean() < 0.95
    if rays == "ground":
        ground = int(np.flatnonzero(radius == 1000.0)[0])
        assert (i_k == ground).float().mean() > 0.5


def test_sphere_scan_keeps_the_root_of_one_at_disc_zero(dev):
    """Rays that touch a sphere with disc exactly 0: spheres on a grid 10
    apart in y and z, and each ray o = c + (-k, r, 0) along x with |d| = m
    (integers and powers of two, so half_b^2 = a c = k^2 m^2 exactly) meets
    only its own. The scan takes the square root of 1 there, so t = (k m -
    1) / m^2 and not the tangent's k / m; the kernel gives that bit for bit,
    and its winner is each ray's own sphere."""
    rng = np.random.default_rng(46)
    n = 4096
    iy, iz = np.divmod(np.arange(n), 64)
    cen = np.stack([rng.integers(-20, 20, n), 10 * iy, 10 * iz],
                   1).astype(np.float32)
    rad = rng.integers(1, 4, n).astype(np.float32)
    k = rng.integers(3, 30, n).astype(np.float32)
    m = rng.choice([1.0, 2.0, 4.0], n).astype(np.float32)
    o = cen + np.stack([-k, rad, np.zeros(n, np.float32)], 1)
    d = np.stack([m, np.zeros(n), np.zeros(n)], 1).astype(np.float32)
    c, r = _on(dev, cen, rad)
    rays = Rays(*_on(dev, o, d))
    t_k, i_k, t_p, i_p = _scan_both(rays, c, r)
    assert torch.equal(t_k, t_p) and torch.equal(i_k, i_p)
    assert torch.equal(i_k, torch.arange(n, device=dev))
    assert torch.equal(t_k, torch.from_numpy((k * m - 1.0) / (m * m)).to(dev))


@pytest.mark.parametrize("n_rays", [0, 1, 33, 196_608])
def test_sphere_scan_takes_any_ray_count(dev, n_rays):
    """No rays (no launch), a ray count that fills neither a warp nor a
    block, and the main path's pool of 196,608 on the balls pool: the
    kernel equals the chunked scan."""
    c, r, _ = _balls_on(dev)
    o, d, _ = aimed_rays(47, max(n_rays, 1), center=(0.0, 0.5, 0.0),
                         half=6.0, spread=12.0)
    o[:, 1] = np.abs(o[:, 1]) + 0.3
    rays = Rays(*_on(dev, o[:n_rays], d[:n_rays]))
    t_k, i_k, t_p, i_p = _scan_both(rays, c, r)
    assert torch.equal(t_k, t_p) and torch.equal(i_k, i_p)
    assert n_rays <= 1 or (i_k >= 0).any()


def test_sphere_scan_on_a_mid_render_pool(dev):
    """The rays of a balls render's pool after three segments (camera rays,
    bounces off lambertian, metal and glass, dead lanes): the kernel
    equals the chunked scan bit for bit."""
    job = build_scene(load_scene_desc(BALLS))
    scene, camera = job.scene.to(dev), job.camera.to(dev)
    state, _ = _pool_after(scene, camera, dev, 3)
    sp = scene.spheres
    t_k, i_k, t_p, i_p = _scan_both(Rays(o=state.o, d=state.d), sp.center,
                                    sp.radius)
    assert torch.equal(t_k, t_p) and torch.equal(i_k, i_p)
    assert 0.1 < (i_k >= 0).float().mean() < 1.0


def test_sphere_scan_argument_checks(dev):
    c, r, _ = _balls_on(dev)
    o, d, _ = random_rays(48, 64, spread=8.0)
    rays8 = _on(dev, np.concatenate([o, d, o[:, :2]], 1))[0]
    o, d = _on(dev, o, d)
    rays = Rays(o=o, d=d)
    with pytest.raises(TypeError):
        sc.scan_spheres(Rays(o=o.double(), d=d.double()), c, r, 1e-3, 1e30)
    with pytest.raises(TypeError):
        sc.scan_spheres(rays, c, r.double(), 1e-3, 1e30)
    with pytest.raises(ValueError, match="is on"):
        sc.scan_spheres(rays, c.cpu(), r, 1e-3, 1e30)
    with pytest.raises(ValueError, match="is on"):
        sc.scan_spheres(Rays(o=o, d=d.cpu()), c, r, 1e-3, 1e30)
    with pytest.raises(ValueError, match="contiguous"):
        sc.scan_spheres(Rays(o=rays8[:, 0:3], d=rays8[:, 3:6]), c, r, 1e-3,
                        1e30)
    with pytest.raises(ValueError, match="shape"):
        sc.scan_spheres(rays, c, r[:-1].contiguous(), 1e-3, 1e30)
    with pytest.raises(ValueError, match="shape"):
        sc.scan_spheres(rays, torch.cat([c, r[:, None]], 1), r, 1e-3, 1e30)
    with pytest.raises(ValueError, match="shape"):
        sc.scan_spheres(Rays(o=o[:, :2].contiguous(), d=d), c, r, 1e-3,
                        1e30)
    with pytest.raises(ValueError, match="S >= 1"):
        sc.scan_spheres(rays, c[:0], r[:0], 1e-3, 1e30)
    with pytest.raises(ValueError, match="CUDA"):
        sc.scan_spheres(Rays(o=o.to("meta"), d=d.to("meta")), c.to("meta"),
                        r.to("meta"), 1e-3, 1e30)


def test_balls_render_through_the_scan_kernel_equals_plain(dev, monkeypatch):
    """A small scattered_balls render by the default route (the scan
    kernel, blocks replayed from a CUDA graph) against the plain versions
    (kernels/build.py:plain_versions: the chunked scan, eager), under
    deterministic algorithms: the framebuffers bit for bit; the kernel
    launched once a segment on the default route and never under the
    switch."""
    segments = _count_iterations(monkeypatch)
    job = build_scene(load_scene_desc(BALLS))
    scene, camera = job.scene.to(dev), job.camera.to(dev)
    out = {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for plain in (False, True):
            before, segments[0] = sc.SCAN_KERNEL.launches, 0
            with _plain(plain):
                st = wavefront.render_state(scene, camera, 48, 27, 4,
                                            Sampler(7, dev), pool=2048)
            out[plain] = (st.fb, sc.SCAN_KERNEL.launches - before,
                          segments[0])
    finally:
        torch.use_deterministic_algorithms(False)
    (fb, scans, segs), (fb_plain, scans_plain, _) = out[False], out[True]
    assert torch.isfinite(fb).all() and fb.abs().sum() > 0
    assert torch.equal(fb, fb_plain)
    assert scans == segs > 0 and scans_plain == 0


@pytest.mark.parametrize("pool", ["balls", "random-384"])
def test_sphere_scan_gradient_replay_on_card(dev, pool):
    """Gradients wanted: intersect_spheres finds the winner through the
    kernel and replays its quadratic. The replayed t is the kernel's bit
    for bit, and the gradients of a loss over t, p and the normal with
    respect to the rays' origins and directions, the centers and the radii
    are the chunked scan's own (autograd through it, one chunk: no pad
    spheres) within float32 rounding of a sum's order (1e-5 of the
    largest; the backward's index_add_ sums in the order its atomics
    land)."""
    if pool == "balls":
        center, radius, mat = balls_pool()[:3]
        o, d, _ = aimed_rays(49, 20_000, center=(0.0, 0.5, 0.0), half=6.0,
                             spread=12.0)
        o[:, 1] = np.abs(o[:, 1]) + 0.3
    else:
        center, radius, mat = sphere_pool(50, 384, spread=10.0)
        o, d, _ = random_rays(51, 20_000, spread=15.0)
    from hobbyraytracer_tpu_torch.ops import intersect as pisect
    cpu = (o, d, center, radius)
    mat_d, w = _on(dev, mat, np.linspace(0.1, 1.0, len(o), dtype=np.float32))
    t_k, _ = sc.scan_spheres(Rays(*_on(dev, o, d)), *_on(dev, center, radius),
                             1e-3, 1e30)

    def grads(find):
        leaves = [x.requires_grad_() for x in _on(dev, *cpu)]
        h = find(Rays(o=leaves[0], d=leaves[1]), leaves[2], leaves[3])
        loss = ((torch.where(h.hit, h.t, 0.0) * w).sum()
                + (h.p * w[:, None]).sum() + (h.normal * w[:, None]).sum())
        return h, torch.autograd.grad(loss, leaves)

    before = sc.SCAN_KERNEL.launches
    h_r, g_r = grads(lambda r, c, rad: pisect.intersect_spheres(
        r, c, rad, mat_d, 1e-3, 1e30))
    assert sc.SCAN_KERNEL.launches == before + 1
    h_s, g_s = grads(lambda r, c, rad: pisect._sphere_attribs(
        r, c, rad, mat_d, *sc.scan_spheres_plain(r, c, rad, 1e-3, 1e30,
                                                 len(center))))
    torch.cuda.synchronize()
    assert h_r.t.requires_grad
    assert torch.equal(h_r.t, t_k) and torch.equal(h_s.t, t_k)
    assert h_r.hit.float().mean() > 0.2
    for name, a, b in zip(("o", "d", "center", "radius"), g_r, g_s):
        assert torch.isfinite(a).all() and torch.isfinite(b).all(), name
        assert b.abs().max() > 0, name
        assert (a - b).abs().max() <= 1e-5 * b.abs().max(), name


# --- the pool sort, the lockstep find and media on the card ---------------

TWO_TEAPOTS = TEAPOT.replace("teapot_scene", "two_teapots")
SMOKE = TEAPOT.replace("teapot_scene", "cornell_smoke")


def _pool_after(scene, camera, dev, n_segments, w=96, h=96, spp=4,
                pool=4096):
    """A wavefront pool on the card after n_segments segments and a
    regenerate: the state, and its sampler."""
    sampler = Sampler(3, dev)
    _, n_chunks, _ = wavefront._chunk_geometry(spp, wavefront.SAMPLE_CHUNK)
    total = w * h * n_chunks
    state = wavefront.init_state(w, h, pool, device=dev)
    for _ in range(n_segments):
        wavefront._regenerate(state, camera, w, h, total, sampler)
        wavefront._segment(state, scene, w, h, sampler, 50, spp)
    wavefront._regenerate(state, camera, w, h, total, sampler)
    return state, sampler


def test_kernel_on_pool_permuted_rays_without_cohsort(dev):
    """K1 as the pool sort calls it: a mid-render two_teapots pool permuted
    by wavefront_sort_key, each mesh found with cohsort=False (one launch,
    no key, no argsort). Bitwise equal to the plain version on the same
    rays, and lane for lane to the call that sorts per mesh."""
    from hobbyraytracer_tpu_torch.core.types import Rays
    from hobbyraytracer_tpu_torch.ops import intersect as isect
    job = build_scene(load_scene_desc(TWO_TEAPOTS))
    scene, camera = job.scene.to(dev), job.camera.to(dev)
    state, _ = _pool_after(scene, camera, dev, 3)
    wavefront._pool_permute(state, scene)
    active = wavefront._active(state)
    assert 0 < int(active.sum()) < active.numel() or bool(active.all())
    for inst in scene.instances:
        m = inst.mesh
        r = inst.transform.ray_to_object(Rays(o=state.o, d=state.d))
        before = pk.KERNEL.launches
        got = isect.intersect_mesh_clustered_fused(
            r, m.cluster_id, m.tri_soa, m.bounds8, 1e30, active,
            cohsort=False)
        assert pk.KERNEL.launches == before + 1
        with kbuild.plain_versions():
            plain = isect.intersect_mesh_clustered_fused(
                r, m.cluster_id, m.tri_soa, m.bounds8, 1e30, active,
                cohsort=False)
        sorted_ = isect.intersect_mesh_clustered_fused(
            r, m.cluster_id, m.tri_soa, m.bounds8, 1e30, active,
            cohsort=True)
        torch.cuda.synchronize()
        assert bool(got[2].any())
        for a, b, c in zip(got, plain, sorted_):
            assert torch.equal(a, b) and torch.equal(a, c)


def test_lockstep_find_matches_kernel_on_card(dev):
    """The lockstep find (plain PyTorch on the card) against K1 on the
    teapot's tables: the template of the repo's kernel tests (hit masks
    equal, t within 1e-6, under 1% of ids differing); here both walk the
    same visits over the same arithmetic, so t is equal."""
    from hobbyraytracer_tpu_torch.core.types import Rays
    from hobbyraytracer_tpu_torch.ops import intersect as isect
    bounds8, soa, tri_id, cl = teapot_tables()
    o, d, valid = aimed_rays(9, 20_000, center=(0.0, 1.5, 0.0), half=2.0,
                             spread=8.0)
    rays8, b8, tab, ids, tv, bmin, bmax = _on(
        dev, pack_rays8(o, d, valid), bounds8, soa, tri_id, cl["tri_verts"],
        cl["bmin"], cl["bmax"])
    r = Rays(o=rays8[:, 0:3].contiguous(), d=rays8[:, 3:6].contiguous())
    before = pk.KERNEL.launches
    t_l, id_l, hit_l = isect.intersect_mesh_clustered(r, tv, ids, bmin, bmax,
                                                      1e30)
    assert pk.KERNEL.launches == before       # no kernel behind it
    out_k, id_k = pk.traverse_clusters(rays8, b8, tab, ids, need_uv=False)
    torch.cuda.synchronize()
    hit_k = out_k[:, 0] < 1e30
    assert torch.equal(hit_l, hit_k) and bool(hit_k.any())
    np.testing.assert_allclose(t_l[hit_k].cpu().numpy(),
                               out_k[hit_k, 0].cpu().numpy(), rtol=1e-6,
                               atol=1e-6)
    assert float(((id_l != id_k) & hit_k).float().mean()) < 0.01


def test_smoke_segment_on_card_matches_cpu(dev):
    """One cornell_smoke segment (media, the glass sphere, no kernel) on
    the card against the CPU from the same state under the same injected
    noise: int fields equal on >= 99% of the lanes, floats within 1e-3
    relative there (the card contracts nothing, but its exp, log and
    trigonometric functions round otherwise than the CPU's)."""
    from _torch_parity import Noise, NoiseSampler
    job = build_scene(load_scene_desc(SMOKE))
    w = h = 64
    spp, pool = 2, 4096
    states = {}
    for where in ("cpu", dev):
        scene, camera = job.scene.to(where), job.camera.to(where)
        sampler = NoiseSampler(Noise(4), where)
        _, n_chunks, _ = wavefront._chunk_geometry(spp,
                                                   wavefront.SAMPLE_CHUNK)
        st = wavefront.init_state(w, h, pool, device=where)
        for _ in range(2):
            wavefront._regenerate(st, camera, w, h, w * h * n_chunks, sampler)
            wavefront._segment(st, scene, w, h, sampler, 50, spp)
        states[str(where)] = st
    a, b = states["cpu"], states[str(dev)]
    agree = torch.ones((pool,), dtype=torch.bool)
    for f in ("item", "depth", "sub", "defer"):
        agree &= getattr(a, f) == getattr(b, f).cpu()
    assert float(agree.float().mean()) >= 0.99
    for f in ("o", "d", "thr", "rad"):
        x, y = getattr(a, f)[agree], getattr(b, f).cpu()[agree]
        close = ((x - y).abs() <= 1e-3 * y.abs() + 1e-3).all(dim=1)
        assert float(close.float().mean()) >= 0.99, f
    assert int(a.counter) == int(b.counter)


def test_two_teapots_render_launches_k1_twice_a_segment(dev, monkeypatch):
    """A small two_teapots render by the default route and with the pool
    sorted every second segment: K1 launches twice a segment in both (the
    segments counted as they are issued, eager or replayed from the graph:
    render_state's `it` stops where the pool ran dry, before the no-op
    segments of its last block), every sample retires, and the two images
    agree statistically (a permuted lane draws other numbers from the same
    streams): means within 10%."""
    job = build_scene(load_scene_desc(TWO_TEAPOTS))
    scene, camera = job.scene.to(dev), job.camera.to(dev)
    segments = _count_iterations(monkeypatch)
    imgs = []
    for pool_sort in (0, 2):
        pk.KERNEL.launches = segments[0] = 0
        st = wavefront.render_state(scene, camera, 48, 48, 4, Sampler(5, dev),
                                    pool=2048, pool_sort=pool_sort)
        assert pk.KERNEL.launches == 2 * segments[0]
        assert st.it <= segments[0]
        assert int(st.retired) == 48 * 48 * 4
        imgs.append(wavefront.framebuffer(st).cpu())
    assert torch.isfinite(imgs[0]).all()
    assert abs(float(imgs[0].mean()) - float(imgs[1].mean())) <= (
        0.1 * float(imgs[0].mean()))


@pytest.mark.parametrize("scene_path,rows", [(TEAPOT, 24), (HIRES, 32)])
@pytest.mark.parametrize("moved", [False, True])
def test_refreshed_tables_on_card_equal_cpu(dev, scene_path, rows, moved):
    """scene/ir.py:refresh_kernel_tables on the card gives the CPU's
    tables byte for byte (the build's vertices, and moved), in the mesh's
    own layout."""
    from hobbyraytracer_tpu_torch.scene import ir as pir
    job = build_scene(load_scene_desc(scene_path))
    mesh = next(i.mesh for i in job.scene.instances if i.kind == "mesh")
    assert mesh.tri_soa.shape[1] == rows
    shift = torch.tensor([0.6, -0.4, 0.5]) if moved else torch.zeros(3)
    verts = mesh.verts + shift
    cpu = pir.refresh_kernel_tables(pir.replace(mesh, verts=verts))
    card = pir.refresh_kernel_tables(pir.replace(mesh.to(dev),
                                                 verts=verts.to(dev)))
    for f in ("tri_soa", "bounds8", "cluster_bmin", "cluster_bmax"):
        a, b = getattr(cpu, f), getattr(card, f).cpu()
        assert a.shape == b.shape and a.numpy().tobytes() == \
            b.numpy().tobytes(), f


def test_kernel_replay_grads_kernel_equal_plain(dev):
    """"kernel_replay" through K1 and under plain_versions() (the find by
    K1's plain version) on the card: hits, and the gradients of the hit t and
    normal to the vertices, bitwise equal; K1 launched once, by the kernel
    call only."""
    from hobbyraytracer_tpu_torch.ops import intersect as pisect
    from hobbyraytracer_tpu_torch.core.types import Rays
    verts, idx, normals, uvs = (torch.from_numpy(a).to(dev)
                                for a in random_mesh(7, 600))
    bounds8, soa, tri_id, _ = cluster_tables(*random_mesh(7, 600))
    o, d, valid = random_rays(8, 4096, spread=4.0, valid_every=2)
    rays = Rays(o=torch.from_numpy(o).to(dev), d=torch.from_numpy(d).to(dev))
    out = []
    for plain in (False, True):
        v = verts.clone().requires_grad_(True)
        pk.KERNEL.launches = 0
        with _plain(plain):
            h = pisect.intersect_triangles_bvh(
                rays, *_on(dev, tri_id, soa, bounds8),
                torch.tensor(0, dtype=torch.int32, device=dev), 1e30,
                ray_valid=torch.from_numpy(valid).to(dev),
                backend="kernel_replay", verts=v, normals=normals, uvs=uvs,
                indices=idx)
        loss = (torch.where(h.hit, h.t, 0.0).sum()
                + (h.normal * h.hit[:, None]).sum())
        (g,) = torch.autograd.grad(loss, v)
        torch.cuda.synchronize()
        assert pk.KERNEL.launches == (0 if plain else 1)
        out.append((h.hit, h.t.detach(), h.normal.detach(), g))
    assert out[0][0].any() and (out[0][3] != 0).any()
    for a, b in zip(*out):
        assert torch.equal(a, b)


def test_kernel_replay_raises_when_the_kernel_cannot_run(dev, monkeypatch,
                                                         tmp_path):
    """"kernel_replay" on CUDA tensors whose kernel does not build raises;
    neither the plain version nor the lockstep find takes over."""
    from hobbyraytracer_tpu_torch.core.types import Rays
    from hobbyraytracer_tpu_torch.kernels import build as kbuild
    from hobbyraytracer_tpu_torch.ops import intersect as pisect
    from hobbyraytracer_tpu_torch.scene import ir as pir

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    def other(*args, **kwargs):
        raise AssertionError("fell back from the kernel")

    monkeypatch.setattr(kbuild, "find_nvcc", no_nvcc)
    monkeypatch.setattr(kbuild, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(pk, "KERNEL", kbuild.KernelLibrary("mesh_traverse"))
    monkeypatch.setattr(pk, "traverse_clusters_plain", other)
    monkeypatch.setattr(pisect, "intersect_mesh_clustered", other)
    scene = build_scene(load_scene_desc(TEAPOT)).scene.to(dev)
    o, d, _ = random_rays(9, 256)
    rays = Rays(o=torch.from_numpy(o).to(dev), d=torch.from_numpy(d).to(dev))
    with pytest.raises(RuntimeError, match="nvcc"):
        pir.intersect_scene(scene, rays, mesh_backend="kernel_replay")
    assert pk.KERNEL.launches == 0


@pytest.mark.parametrize("pix0,n_pix", [(0, 64), (37, 101), (1000, 3000)])
def test_render_linear_slice_rows_on_card(dev, pix0, n_pix):
    """On the card every element of an elementwise kernel is computed
    alike, so a pixel slice equals the rows of the whole image bit for bit
    at any offset and length (the teapot at 64x64, 2 spp, depth 3, K1
    finding)."""
    from hobbyraytracer_tpu_torch.diff import fit as pfit
    job = build_scene(load_scene_desc(TEAPOT))
    scene, camera = job.scene.to(dev), job.camera.to(dev)
    s = Sampler(5, dev)
    with torch.no_grad():
        full = pfit.render_linear(scene, camera, 64, 64, s, 2, 3)
        part = pfit.render_linear_slice(scene, camera, 64, 64, s, 2, pix0,
                                        n_pix, 3)
    assert torch.equal(part, full[pix0:pix0 + n_pix])
    assert full.max() > 0


def test_stacked_resume_on_card(dev, tmp_path):
    """The teapot at 64x64 @ 4 spp over [cuda, cuda] under deterministic
    algorithms: a stacked state saved at the first checkpoint, loaded onto
    the card and resumed gives the uninterrupted image bit for bit."""
    from hobbyraytracer_tpu_torch.io import checkpoint as ckpt
    from hobbyraytracer_tpu_torch.parallel import shard
    job = build_scene(load_scene_desc(TEAPOT))
    scene, camera = job.scene.to(dev), job.camera.to(dev)
    path = str(tmp_path / "ck.npz")

    class Stop(Exception):
        pass

    def save_once(state):
        ckpt.save_state(path, state)
        raise Stop

    def render(**kw):
        return shard.render_wavefront_sharded(
            scene, camera, 64, 64, 4, Sampler(2, dev), [dev, dev],
            max_depth=8, pool=4096, **kw)

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        ref = render()
        with pytest.raises(Stop):
            render(checkpoint_cb=save_once)
        state = ckpt.load_state(path, device=dev)
        assert 0 < int(state.retired.sum()) < 64 * 64 * 4
        assert torch.equal(render(state=state), ref)
    finally:
        torch.use_deterministic_algorithms(False)


def test_long_tail_render_on_card(dev, monkeypatch, tmp_path):
    """chip_smoke.py's long-tail scene (a binary PLY teapot, a PNG checker
    on the back wall, the lens on) at 64x64 @ 4 spp on the card: K1 once a
    segment and no other kernel, every sample retired, a finite image that
    the lens changed; the checker's lookups on the card equal the host's,
    none debug cyan; the image written as TGA and BMP reads back equal."""
    import importlib.util
    import os

    from hobbyraytracer_tpu_torch.io import images
    from hobbyraytracer_tpu_torch.ops import film
    from hobbyraytracer_tpu_torch.ops import texture as ptex
    from _torch_parity import ROOT
    monkeypatch.chdir(ROOT)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    job = build_scene(load_scene_desc(smoke.long_tail_scene(str(tmp_path))))
    job.camera.use_lens = True
    tex = job.scene.textures
    tid = int((tex.ttype == ptex.TEX_IMAGE).nonzero()[0])
    u, v = torch.rand((2, 1024), generator=torch.Generator().manual_seed(0))
    p = torch.zeros((1024, 3))
    ids = torch.full((1024,), tid, dtype=torch.int32)
    host = ptex.colour_value(tex, ids, u, v, p)
    # Module.to moves the tables in place: the host lookup comes first
    scene, camera = job.scene.to(dev), job.camera.to(dev)
    on_card = ptex.colour_value(scene.textures, ids.to(dev), u.to(dev),
                                v.to(dev), p.to(dev)).cpu()
    assert torch.equal(on_card, host)
    assert not (on_card == torch.tensor(ptex.DEBUG_CYAN)).all(dim=1).any()
    segments = _count_iterations(monkeypatch)
    imgs = []
    for lens in (True, False):
        camera.use_lens = lens
        for lib in (pk.KERNEL, pk.KERNEL_STREAM, pk.KEY_KERNEL,
                    sk.SPHERE_KERNEL):
            lib.launches = 0
        segments[0] = 0
        st = wavefront.render_state(scene, camera, 64, 64, 4, Sampler(3, dev),
                                    pool=4096)
        assert pk.KERNEL.launches == segments[0] > 0
        assert (pk.KERNEL_STREAM.launches, pk.KEY_KERNEL.launches,
                sk.SPHERE_KERNEL.launches) == (0, 0, 0)
        assert int(st.retired) == 64 * 64 * 4
        imgs.append(wavefront.framebuffer(st).cpu())
    assert torch.isfinite(imgs[0]).all() and not torch.equal(*imgs)
    u8 = film.quantize(film.tonemap(imgs[0] / 4.0).reshape(64, 64, 3)
                       .numpy())
    for ext in ("tga", "bmp"):
        out = str(tmp_path / f"long_tail.{ext}")
        assert film.output_film(u8, out)
        assert np.array_equal(images.read_image(out), u8)


# --- threefry and the graph route -------------------------------------------

@pytest.mark.parametrize("floats", [True, False], ids=["uniform", "bits"])
@pytest.mark.parametrize("it", [None, 0, 9, -7])
@pytest.mark.parametrize("path", [(), (6, 0, 1), (1, 2, 3, 4)])
def test_threefry_kernel_matches_plain(dev, floats, it, path):
    """threefry.cu against its plain version on the card, bit for bit, at
    1, 33 and 196,608 elements and a counter offset past 2**32 / 3, with
    and without a device iteration and 0, 3 or 4 folds after it; one
    launch a draw."""
    from hobbyraytracer_tpu_torch.kernels import threefry as tf
    it_t = None if it is None else torch.tensor(it, dtype=torch.int32,
                                                device=dev)
    for n, offset in ((1, 0), (33, 5), (196_608, 0), (4097, 1_500_000_000)):
        before = tf.THREEFRY.launches
        k = tf.threefry_draw((123, 456), it_t, path, n, offset, floats, dev)
        assert tf.THREEFRY.launches == before + 1
        p = tf.threefry_plain((123, 456), it_t, path, n, offset, floats, dev)
        torch.cuda.synchronize()
        assert k.dtype == p.dtype and torch.equal(k, p)
        assert torch.equal(p.cpu(), tf.threefry_plain(
            (123, 456), None if it_t is None else it_t.cpu(), path, n,
            offset, floats, "cpu"))


def test_sampler_draws_on_card_equal_cpu(dev):
    """Every draw of the Sampler on the card against the CPU's, with the
    iteration a host int and a 0-d tensor on the card: uniforms and
    randint bit for bit, the maps within 1e-6 (the card's cos, sin, sqrt
    and pow round otherwise)."""
    for it in (3, torch.tensor(3, dtype=torch.int32, device=dev)):
        it_cpu = it if isinstance(it, int) else it.cpu()
        gpu, cpu = Sampler(5, dev), Sampler(5, "cpu")
        for kind in ("uniform", "unit_sphere", "in_ball", "in_disk"):
            a = getattr(gpu, kind)(2, it, (5000,), span=(100, 9000)).cpu()
            b = getattr(cpu, kind)(2, it_cpu, (5000,), span=(100, 9000))
            if kind == "uniform":
                assert torch.equal(a, b)
            else:
                assert (a - b).abs().max() <= 1e-6, kind
        assert torch.equal(gpu.randint(201, it, (999,), 777).cpu(),
                           cpu.randint(201, it_cpu, (999,), 777))


@pytest.mark.parametrize("scene_path,sphere_kernel,key_mode", [
    (TEAPOT, False, "auto"), (TWO_TEAPOTS, False, "auto"),
    (BALLS, True, "auto"), (BALLS, False, "auto"), (HIRES, False, "auto"),
    (HIRES, False, "pallas")],
    ids=["teapot", "two_teapots", "balls-k4", "balls-scan", "hires",
         "hires-k3"])
def test_graph_render_equals_eager(dev, monkeypatch, scene_path,
                                   sphere_kernel, key_mode):
    """A 64x64 @ 4 spp render (pool 2048, 3 iterations a block, so that
    blocks replay several times) through the CUDA graph against eager()
    under deterministic algorithms: framebuffer, `it` and retired equal,
    every kernel's launches equal (the replays add the captured launches),
    one graph captured. key_mode "pallas" takes the coherence keys from K3,
    which then launches in both renders; the balls without K4 launch the
    sphere_scan kernel."""
    from hobbyraytracer_tpu_torch.kernels import threefry as tf
    from hobbyraytracer_tpu_torch.ops import intersect as isect
    monkeypatch.setattr(isect, "SPHERE_KERNEL", sphere_kernel)
    monkeypatch.setattr(isect, "KEY_MODE", key_mode)
    job = build_scene(load_scene_desc(scene_path))
    scene, camera = job.scene.to(dev), job.camera.to(dev)
    assert wavefront.graph_route(scene, dev, pool_sort=0)
    captured = []

    class Counted(wavefront._BlockGraph):
        def capture(self, *args):
            captured.append(1)
            return super().capture(*args)

    monkeypatch.setattr(wavefront, "_BlockGraph", Counted)
    libs = (pk.KERNEL, pk.KERNEL_STREAM, pk.KEY_KERNEL, sk.SPHERE_KERNEL,
            sc.SCAN_KERNEL, tf.THREEFRY)
    out = {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for eager in (True, False):
            for lib in libs:
                lib.launches = 0
            captured.clear()
            with _eager(eager):
                st = wavefront.render_state(scene, camera, 64, 64, 4,
                                            Sampler(1, dev), pool=2048,
                                            steps_per_call=3, pool_sort=0)
            out[eager] = (st, [lib.launches for lib in libs], len(captured))
    finally:
        torch.use_deterministic_algorithms(False)
    (a, la, ca), (b, lb, cb) = out[True], out[False]
    assert (ca, cb) == (0, 1)
    assert torch.equal(a.fb, b.fb) and a.it == b.it
    assert int(a.retired) == int(b.retired) == 64 * 64 * 4
    assert la == lb and la[-1] > 0 and sum(la[:-1]) > 0
    assert (la[2] > 0) == (key_mode == "pallas")


def test_graph_render_on_a_card_that_is_not_current(dev):
    """A render on cuda:1 while cuda:0 is the current device: the graph
    route captures on cuda:1's own stream and equals the eager render bit
    for bit (deterministic algorithms), every kernel launching there; the
    current device stays cuda:0. A state on another card than its block
    graph's is refused."""
    from hobbyraytracer_tpu_torch.kernels import threefry as tf
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    card = torch.device("cuda", 1)
    job = build_scene(load_scene_desc(TEAPOT))
    scene, camera = job.scene.to(card), job.camera.to(card)
    out = {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with torch.cuda.device(0):
            for eager in (True, False):
                for lib in (pk.KERNEL, tf.THREEFRY):
                    lib.launches = 0
                with _eager(eager):
                    st = wavefront.render_state(scene, camera, 48, 48, 4,
                                                Sampler(5, card), pool=1024,
                                                steps_per_call=3)
                assert torch.cuda.current_device() == 0
                out[eager] = (st, pk.KERNEL.launches, tf.THREEFRY.launches)
    finally:
        torch.use_deterministic_algorithms(False)
    (a, a1, at), (b, b1, bt) = out[True], out[False]
    assert a.fb.device == b.fb.device == card
    assert torch.equal(a.fb, b.fb) and a.it == b.it
    assert int(b.retired) == 48 * 48 * 4
    assert (a1, at) == (b1, bt) and a1 > 0 and at > 0
    graph = wavefront._BlockGraph(torch.device("cuda", 0))
    with pytest.raises(ValueError, match="block graph"):
        graph.run(b, lambda st: [])


def test_cli_checkpoints_every_block_on_the_graph_route(dev, monkeypatch,
                                                        tmp_path):
    """The CLI's render on the graph route with --checkpoint-every 0: the
    writer thread fetches a snapshot from the card while the render
    captures and replays its blocks (each write first reads the snapshot
    for 0.3 s, so the first one overlaps the capture). The render and every
    write succeed, and the last checkpoint holds samples of this render."""
    import threading
    import time

    from hobbyraytracer_tpu_torch.cli import main as cli
    from hobbyraytracer_tpu_torch.io import checkpoint as ckpt
    from _torch_parity import ROOT
    monkeypatch.chdir(ROOT)
    save_state = ckpt.save_state
    writes, captured = [], []

    def slow_save(path, snap, meta=None):
        assert threading.current_thread() is not threading.main_thread()
        end = time.perf_counter() + 0.3
        while time.perf_counter() < end:
            snap.fb.cpu()
        save_state(path, snap, meta=meta)
        writes.append(1)

    class Counted(wavefront._BlockGraph):
        def capture(self, *args):
            captured.append(1)
            return super().capture(*args)

    monkeypatch.setattr(ckpt, "save_state", slow_save)
    monkeypatch.setattr(wavefront, "_BlockGraph", Counted)
    path = str(tmp_path / "ck.npz")
    assert cli.main(["render", TEAPOT, "-o", str(tmp_path / "out.png"),
                     "--spp", "8", "--width", "96", "--height", "96",
                     "--device", "cuda", "--checkpoint", path,
                     "--checkpoint-every", "0"]) == 0
    assert captured == [1] and len(writes) >= 1
    state = ckpt.load_state(path, device="cpu")
    assert 0 < int(state.retired) <= 96 * 96 * 8


def test_graph_route_resume_and_checkpoints(dev, tmp_path):
    """On the graph route, checkpoint_cb sees the live state after every
    block (replayed ones too) and a render resumed from a mid-render
    checkpoint equals the uninterrupted one bit for bit (deterministic
    algorithms)."""
    from hobbyraytracer_tpu_torch.io import checkpoint as ckpt
    job = build_scene(load_scene_desc(TEAPOT))
    scene, camera = job.scene.to(dev), job.camera.to(dev)
    path = str(tmp_path / "ck.npz")
    seen = []

    def keep(state):
        seen.append(int(state.retired))
        if len(seen) == 3:
            ckpt.save_state(path, state)

    def render(**kw):
        return wavefront.render_state(scene, camera, 48, 48, 4,
                                      Sampler(2, dev), pool=1024,
                                      steps_per_call=2, **kw)

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        ref = render(checkpoint_cb=keep)
        assert len(seen) > 3 and seen == sorted(seen)
        state = ckpt.load_state(path, device=dev)
        assert 0 < int(state.retired) < 48 * 48 * 4
        out = render(state=state)
    finally:
        torch.use_deterministic_algorithms(False)
    assert torch.equal(out.fb, ref.fb) and out.it == ref.it


# --- the render's block graph kept across renders (RENDER_GRAPHS) -----------

@pytest.mark.parametrize("scene_path", [TEAPOT, BALLS],
                         ids=["teapot", "balls"])
def test_kept_render_graph_equals_a_cleared_cache(dev, scene_path):
    """Three renders of one scene and camera at chip_smoke.py's size
    (640x640 @ 16 spp, pool 196,608) with three seeds through the kept
    block graph (1 capture, then 2 hits that reset the pool in place and
    replay every block) against the same renders with the cache cleared
    before each (each its own capture), under deterministic algorithms:
    framebuffer, `it` and retired equal bit for bit, and each render's
    kernel launches equal, a hit's a capture's (one K1 or sphere_scan
    launch a segment; seed 0's teapot: K1 144 and threefry 720).
    The states handed back share no tensor with the kept pool."""
    from hobbyraytracer_tpu_torch.kernels import threefry as tf
    job = build_scene(load_scene_desc(scene_path))
    scene, camera = job.scene.to(dev), job.camera.to(dev)
    assert wavefront.graph_route(scene, dev)
    libs = (pk.KERNEL, sc.SCAN_KERNEL, tf.THREEFRY)
    graphs = wavefront.RENDER_GRAPHS

    def render(seed, clear):
        if clear:
            graphs.clear()
        for lib in libs:
            lib.launches = 0
        st = wavefront.render_state(scene, camera, 640, 640, 16,
                                    Sampler(seed, dev), pool=196_608)
        return st, [lib.launches for lib in libs]

    seeds = (0, 2 ** 31 + 7, 5)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        kept = [render(s, clear=False) for s in seeds]
        assert (graphs.captures, graphs.hits) == (1, 2)
        fresh = [render(s, clear=True) for s in seeds]
        assert (graphs.captures, graphs.hits) == (4, 2)
    finally:
        torch.use_deterministic_algorithms(False)
    (entry,) = graphs.kept.values()
    pool_ptrs = {getattr(entry.state, f).data_ptr() for f in ("fb", "o",
                                                              "item")}
    for (a, la), (b, lb) in zip(kept, fresh):
        assert torch.equal(a.fb, b.fb) and a.it == b.it
        assert int(a.retired) == int(b.retired) == 640 * 640 * 16
        assert la == lb
        assert not pool_ptrs & {a.fb.data_ptr(), a.o.data_ptr(),
                                a.item.data_ptr()}
        # one find launch a segment issued: blocks of 8, the last past the
        # iteration at which the pool ran dry
        k1, scan, _ = la
        assert (k1 == 0) == (scene_path == BALLS) and k1 * scan == 0
        assert (k1 + scan) % 8 == 0 and 0 <= k1 + scan - a.it < 8
    if scene_path == TEAPOT:   # seed 0, chip_smoke.py's render
        assert kept[0][1] == [144, 0, 720]


def test_slot_folds_draw_the_host_streams_on_the_card(dev):
    """On the card, a key slot with the stream purposes' folds: a slotted
    sampler's draws under a device iteration (threefry.cu reading the
    fold's words from the slot) equal the host key's for every purpose a
    render uses, bit for bit."""
    from hobbyraytracer_tpu_torch.core import rng as rng_mod
    host = Sampler(2 ** 31 + 11, dev)
    slot = rng_mod.KeySlot(dev, rng_mod.STREAM_TAGS)
    slot.fill(host.key)
    slotted = host.slotted(slot)
    it = torch.tensor(9, dtype=torch.int32, device=dev)
    for purpose in range(rng_mod.STREAM_TAGS):
        assert torch.equal(slotted.uniform(purpose, it, (4099,)),
                           host.uniform(purpose, 9, (4099,))), purpose
        assert torch.equal(slotted.unit_sphere(purpose, it, (513,)),
                           host.unit_sphere(purpose, 9, (513,))), purpose


# --- the fit step through a CUDA graph (diff/fit.py:fit_materials) ----------

def _batch_graphs(depth):
    """The graphs a BatchRun captures at max depth `depth`: the start, one
    a block of integrator/path.py:BOUNCE_BLOCK bounces, the add."""
    from hobbyraytracer_tpu_torch.integrator import path as ppath
    return -(-depth // ppath.BOUNCE_BLOCK) + 2


def _counted_graphs(monkeypatch):
    """Count the graphs that kernels/build.py:GraphReplay captures."""
    from hobbyraytracer_tpu_torch.kernels import build as kbuild
    captured = []

    class Counted(kbuild.GraphReplay):
        def capture(self, fn):
            captured.append(1)
            return super().capture(fn)

    monkeypatch.setattr(kbuild, "GraphReplay", Counted)
    return captured


def _fit_job(dev, path, size, spp, depth, fit_vertices):
    """(start scene, camera, target) of a small fit on the card: the
    materials perturbed as the CLI perturbs them and, for a vertex fit,
    the target at half the scene's radiance (the vertices have somewhere
    to go)."""
    from hobbyraytracer_tpu_torch.cli.main import perturb_materials
    from hobbyraytracer_tpu_torch.diff import fit as fit_mod
    job = build_scene(load_scene_desc(path))
    scene, camera = job.scene.to(dev), job.camera.to(dev)
    with torch.no_grad():
        target = fit_mod.render_linear(scene, camera, *size, Sampler(0, dev),
                                       spp, depth)
    if fit_vertices:
        return scene, camera, target * 0.5
    return perturb_materials(scene), camera, target


@pytest.mark.parametrize("path,size,spp,depth,steps,fit_vertices", [
    (f"{SCENES}/shiny_teapot.yaml", (60, 34), 2, 4, 5, False),
    (HIRES, (32, 32), 1, 3, 3, True)], ids=["shiny_teapot", "hires_vertices"])
def test_graph_fit_equals_eager(dev, monkeypatch, path, size, spp, depth,
                                steps, fit_vertices):
    """fit_materials through its CUDA graph (step 0 eager, step 1 captured
    and replayed, the rest replayed) against eager() under
    deterministic algorithms: the losses, the fitted parameters (the
    vertices of teapot_hires's fit, whose 32-row tables are refreshed
    inside every step, through K2) and every kernel's launches equal; one
    graph captured by the graph fit, none by the eager one."""
    from hobbyraytracer_tpu_torch.diff import fit as fit_mod
    from hobbyraytracer_tpu_torch.kernels import threefry as tf
    captured = _counted_graphs(monkeypatch)
    scene, camera, target = _fit_job(dev, path, size, spp, depth,
                                     fit_vertices)
    assert fit_mod.fit_route(scene, dev)
    libs = (pk.KERNEL, pk.KERNEL_STREAM, tf.THREEFRY)
    out = {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for eager in (True, False):
            for lib in libs:
                lib.launches = 0
            captured.clear()
            with _eager(eager):
                res = fit_mod.fit_materials(
                    scene, camera, target, *size, steps=steps,
                    n_samples=spp, max_depth=depth, sampler=Sampler(0, dev),
                    fit_vertices=fit_vertices, verbose=False)
            out[eager] = (res, [lib.launches for lib in libs], len(captured))
    finally:
        torch.use_deterministic_algorithms(False)
    (a, la, ca), (b, lb, cb) = out[True], out[False]
    assert (ca, cb) == (0, 1)
    assert np.array_equal(a.losses, b.losses) and np.isfinite(a.losses).all()
    for name in fit_mod.MAT_FIELDS:
        assert torch.equal(a.params["materials"][name],
                           b.params["materials"][name]), name
    for va, vb in zip(a.params.get("verts", []), b.params.get("verts", [])):
        assert torch.equal(va, vb)
    assert la == lb and la[2] > 0
    assert (la[1] > 0) == fit_vertices and (la[0] > 0) != fit_vertices


def test_cli_fit_takes_the_graph_route(dev, monkeypatch, capsys):
    """`fit --device cuda` (cli/main.py:fit_demo) at a small size: one graph
    captured, the route printed, the loss falls."""
    from hobbyraytracer_tpu_torch.cli import main as cli
    captured = _counted_graphs(monkeypatch)
    assert cli.main(["fit", f"{SCENES}/shiny_teapot.yaml", "--device",
                     "cuda", "--steps", "4", "--width", "48", "--height",
                     "27"]) == 0
    assert captured == [1]
    assert "4 steps on 1 worker(s), through a CUDA graph" in (
        capsys.readouterr().out)


def test_fit_capture_that_reads_the_host_raises(dev, monkeypatch):
    """A fit step that reads a value on the host cannot be captured: the
    capture raises, and fit_materials raises with it instead of going on
    eagerly (the warm-up step, which is eager, reads it freely)."""
    from hobbyraytracer_tpu_torch.diff import fit as fit_mod
    render_loss = fit_mod.render_loss
    calls = []

    def reading(*args, **kwargs):
        loss = render_loss(*args, **kwargs)
        calls.append(float(loss))
        return loss

    monkeypatch.setattr(fit_mod, "render_loss", reading)
    scene, camera, target = _fit_job(dev, f"{SCENES}/shiny_teapot.yaml",
                                     (32, 18), 1, 2, False)
    with pytest.raises(RuntimeError):
        fit_mod.fit_materials(scene, camera, target, 32, 18, steps=3,
                              n_samples=1, max_depth=2,
                              sampler=Sampler(0, dev), verbose=False)
    assert len(calls) == 1
    torch.cuda.synchronize()


@pytest.mark.parametrize("path,size,spp,depth,steps,fit_vertices", [
    (f"{SCENES}/shiny_teapot.yaml", (60, 34), 2, 4, 5, False),
    (HIRES, (32, 32), 1, 3, 3, True)], ids=["shiny_teapot", "hires_vertices"])
def test_kept_fit_graph_equals_eager_fits(dev, monkeypatch, path, size, spp,
                                          depth, steps, fit_vertices):
    """Three fits with three seeds through the step graph kept across fits
    (diff/fit.py:FIT_GRAPHS): shiny_teapot's materials, and teapot_hires's
    vertices, whose 32-row tables the graph refreshes every step (K2).
    One graph captured, by the first, and 2 hits; under deterministic
    algorithms each fit's losses and parameters equal an eager() fit's
    of its seed bit for bit, so a replayed first step after the reset
    reads the reset state, and its launches equal the eager fit's. The
    first fit's result is unaltered by the later fits, and no result
    shares storage with the kept buffers."""
    from hobbyraytracer_tpu_torch.diff import fit as fit_mod
    from hobbyraytracer_tpu_torch.kernels import threefry as tf
    captured = _counted_graphs(monkeypatch)
    monkeypatch.setattr(fit_mod, "FIT_GRAPHS", fit_mod.FitGraphs())
    scene, camera, target = _fit_job(dev, path, size, spp, depth,
                                     fit_vertices)
    libs = (pk.KERNEL, pk.KERNEL_STREAM, tf.THREEFRY)

    def run(seed, eager):
        for lib in libs:
            lib.launches = 0
        with _eager(eager):
            res = fit_mod.fit_materials(
                scene, camera, target, *size, steps=steps, n_samples=spp,
                max_depth=depth, sampler=Sampler(seed, dev), verbose=False,
                fit_vertices=fit_vertices)
        return res, [lib.launches for lib in libs]

    seeds = (11, 12, 2 ** 31 + 13)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        kept = []
        for seed in seeds:
            kept.append(run(seed, False))
            if len(kept) == 1:
                first = [t.clone() for t in
                         fit_mod._leaves(kept[0][0].params)]
        eager = [run(seed, True) for seed in seeds]
    finally:
        torch.use_deterministic_algorithms(False)
    graphs = fit_mod.FIT_GRAPHS
    assert (len(captured), graphs.captures, graphs.hits) == (1, 1, 2)
    for (a, la), (b, lb) in zip(kept, eager):
        assert np.array_equal(a.losses, b.losses)
        assert np.isfinite(a.losses).all()
        for name in fit_mod.MAT_FIELDS:
            assert torch.equal(a.params["materials"][name],
                               b.params["materials"][name]), name
        assert len(a.params.get("verts", [])) == (1 if fit_vertices else 0)
        for va, vb in zip(a.params.get("verts", []),
                          b.params.get("verts", [])):
            assert torch.equal(va, vb)
        assert la == lb and la[2] > 0 and la[1 if fit_vertices else 0] > 0
    assert len({tuple(r.losses) for r, _ in kept}) == 3
    assert all(torch.equal(a, b) for a, b in
               zip(fit_mod._leaves(kept[0][0].params), first))
    (fit,) = graphs.kept.values()
    own = {t.data_ptr() for p in fit.leaves for t in (p, p.grad)}
    own.add(fit.target.data_ptr())
    for res, _ in kept:
        ptrs = {t.data_ptr() for p in fit_mod._leaves(res.params)
                for t in (p, p.grad)}
        ptrs |= {getattr(res.scene.materials, f).data_ptr()
                 for f in fit_mod.MAT_FIELDS}
        assert not own & ptrs


def test_kept_fit_graph_misses_when_the_camera_takes_its_lens(dev,
                                                              monkeypatch):
    """A fit of shiny_teapot (60x34 @ 2 spp, depth 4, 4 steps), then the
    same camera object's use_lens set in place (its lens radius 0.05 from
    the start, which only the lens reads), then a second fit: the second
    misses the pinhole graph and captures its own (2 captures, no hit),
    and each fit equals an eager() fit of its camera bit for bit; the
    lens moved the losses."""
    from hobbyraytracer_tpu_torch.diff import fit as fit_mod
    captured = _counted_graphs(monkeypatch)
    monkeypatch.setattr(fit_mod, "FIT_GRAPHS", fit_mod.FitGraphs())
    size = (60, 34)
    scene, camera, target = _fit_job(dev, f"{SCENES}/shiny_teapot.yaml",
                                     size, 2, 4, False)
    camera.lens_radius.fill_(0.05)

    def run(eager):
        with _eager(eager):
            return fit_mod.fit_materials(
                scene, camera, target, *size, steps=4, n_samples=2,
                max_depth=4, sampler=Sampler(21, dev), verbose=False)

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        fits = []
        for lens in (False, True):
            camera.use_lens = lens
            fits.append((run(False), run(True)))
    finally:
        torch.use_deterministic_algorithms(False)
        camera.use_lens = False
    graphs = fit_mod.FIT_GRAPHS
    assert (len(captured), graphs.captures, graphs.hits) == (2, 2, 0)
    for kept, eager in fits:
        assert np.array_equal(kept.losses, eager.losses)
        for name in fit_mod.MAT_FIELDS:
            assert torch.equal(kept.params["materials"][name],
                               eager.params["materials"][name]), name
    assert not np.array_equal(fits[0][0].losses, fits[1][0].losses)


# --- the batch integrator through CUDA graphs (integrator/path.py:BatchRun) -

SMOKE = f"{SCENES}/cornell_smoke.yaml"


@pytest.mark.parametrize("n_path", [0, 5, 6])
@pytest.mark.parametrize("it", [None, 9])
def test_threefry_kernel_reads_slot_words(dev, n_path, it):
    """threefry.cu with its key words in a (2,) int32 slot on the card
    (KeySlot: a word past 2**31 among them), 0, 5 or 6 folds after it and
    an optional device iteration: bits and uniforms bit for bit the plain
    version's on the card and on the CPU, and the kernel on the host words
    folded the same way."""
    from hobbyraytracer_tpu_torch.core.rng import Key, KeySlot
    from hobbyraytracer_tpu_torch.kernels import threefry as tf
    words = (3_000_000_001, 17)
    slot = KeySlot(dev)
    slot.fill(Key(words))
    path = (2, 3, 11, 0, 1, 5)[:n_path]
    it_t = None if it is None else torch.tensor(it, dtype=torch.int32,
                                                device=dev)
    host = tf._key_plain(words, None if it is None else it_t.cpu(), ())
    host = (int(host[0]), int(host[1]))
    for floats in (True, False):
        for n, offset in ((1, 0), (196_608, 0), (4097, 1_500_000_000)):
            before = tf.THREEFRY.launches
            k = tf.threefry_draw(slot.words, it_t, path, n, offset, floats,
                                 dev)
            assert tf.THREEFRY.launches == before + 1
            p = tf.threefry_plain(slot.words, it_t, path, n, offset, floats,
                                  dev)
            h = tf.threefry_draw(host, None, path, n, offset, floats, dev)
            torch.cuda.synchronize()
            assert torch.equal(k, p) and torch.equal(k, h)
            assert torch.equal(p.cpu(), tf.threefry_plain(
                slot.words.cpu(), None if it_t is None else it_t.cpu(),
                path, n, offset, floats, "cpu"))


def test_replay_draws_the_slot_s_new_key(dev):
    """A CUDA graph that captured draws from a KeySlot's sampler (a split,
    a stream's uniforms and in_ball: 5 folds after the slot) draws, at each
    replay, under the key last written into the slot: replayed after fill
    B, then A, then B, it equals the host keys' eager draws each time."""
    from hobbyraytracer_tpu_torch.core import rng as prng
    from hobbyraytracer_tpu_torch.core.rng import KeySlot
    from hobbyraytracer_tpu_torch.kernels import build as kbuild
    slot = KeySlot(dev)
    kt = Sampler(0, dev).slotted(slot).split(3)[2]
    out_u = torch.empty((4097,), device=dev)
    out_b = torch.empty((4097, 3), device=dev)

    def draw():
        out_u.copy_(kt.uniform(prng.MEDIUM_FLIGHT, 3, (4097,)))
        out_b.copy_(kt.in_ball(prng.SCATTER_BALL, 7, (4097,),
                               span=(10, 5000)))

    keys = [Sampler(5, dev).fold_in(1000003).fold_in(s) for s in (0, 1)]
    want = []
    for k in keys:
        h = k.split(3)[2]
        want.append((h.uniform(prng.MEDIUM_FLIGHT, 3, (4097,)),
                     h.in_ball(prng.SCATTER_BALL, 7, (4097,),
                               span=(10, 5000))))
    graph = kbuild.GraphReplay(dev)
    with torch.cuda.device(dev):
        for i in (0, 1, 0, 1):
            slot.fill(keys[i].key)
            graph(draw)
            torch.cuda.synchronize()
            assert torch.equal(out_u, want[i][0])
            assert torch.equal(out_b, want[i][1])
    assert graph.graph is not None
    assert not torch.equal(want[0][0], want[1][0])


def _batch_renders(dev, monkeypatch, scene, camera, runs, w=64, h=64, spp=3,
                   chunk=2):
    """runs {label: (eager, per-bounce)} -> {label: (radiance sum, launches
    of K1, K2, K4, threefry, graphs captured)} under deterministic
    algorithms; per-bounce forces `trace`'s loop (batch_route False)."""
    from hobbyraytracer_tpu_torch.integrator import path as ppath
    from hobbyraytracer_tpu_torch.kernels import threefry as tf
    captured = _counted_graphs(monkeypatch)
    route = ppath.batch_route
    libs = (pk.KERNEL, pk.KERNEL_STREAM, sk.SPHERE_KERNEL, tf.THREEFRY)
    out = {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for label, (eager, loop) in runs.items():
            monkeypatch.setattr(ppath, "batch_route",
                                (lambda *a, **k: False) if loop else route)
            for lib in libs:
                lib.launches = 0
            captured.clear()
            with _eager(eager):
                total = ppath.radiance_sum(scene, camera, w, h, spp,
                                           Sampler(1, dev),
                                           sample_chunk=chunk)
            torch.cuda.synchronize()
            out[label] = (total, [lib.launches for lib in libs],
                          len(captured))
    finally:
        torch.use_deterministic_algorithms(False)
        monkeypatch.setattr(ppath, "batch_route", route)
    return out


@pytest.mark.parametrize("scene_path,sphere_kernel", [
    (TEAPOT, False), (SMOKE, False), (BALLS, True), (HIRES, False)],
    ids=["teapot", "smoke", "balls-k4", "hires-k2"])
def test_batch_graph_render_equals_eager(dev, monkeypatch, scene_path,
                                         sphere_kernel):
    """radiance_sum at 64x64 @ 3 spp in chunks of 2, depth 50, through
    BatchRun's CUDA graphs against eager() (its steps eagerly) and
    against `trace`'s per-bounce loop, under deterministic algorithms: the
    sums bit for bit equal; the graphs and the eager steps launch every
    kernel alike (the replays add the captured launches), the loop no
    more; the start, each block of bounces and the add captured, nothing
    eagerly."""
    from hobbyraytracer_tpu_torch.integrator import path as ppath
    from hobbyraytracer_tpu_torch.ops import intersect as isect
    monkeypatch.setattr(isect, "SPHERE_KERNEL", sphere_kernel)
    job = build_scene(load_scene_desc(scene_path))
    scene, camera = job.scene.to(dev), job.camera.to(dev)
    assert ppath.batch_route(scene, dev)
    out = _batch_renders(dev, monkeypatch, scene, camera, {
        "eager": (True, False), "graph": (False, False),
        "loop": (True, True)})
    (a, la, ca), (b, lb, cb), (c, lc, cc) = (
        out["eager"], out["graph"], out["loop"])
    assert (ca, cb, cc) == (0, _batch_graphs(50), 0)
    assert torch.equal(a, b) and torch.equal(a, c) and a.max() > 0
    assert la == lb and la[-1] > 0
    assert all(x <= y for x, y in zip(lc, la))
    kernel = {TEAPOT: 0, SMOKE: None, BALLS: 2, HIRES: 1}[scene_path]
    for i in range(3):
        assert (la[i] > 0) == (i == kernel), la


def test_batch_render_sharded_on_one_card(dev, monkeypatch):
    """parallel/shard.py:render_sharded of the teapot (64x64 @ 3 spp in
    chunks of 2) over two workers on the one card, each with graphs of its
    own, against the one-worker render through the graphs and against
    itself under eager(): the images bit for bit equal (deterministic
    algorithms); a worker captures a run's graphs."""
    from hobbyraytracer_tpu_torch.integrator import path as ppath
    from hobbyraytracer_tpu_torch.parallel import shard
    captured = _counted_graphs(monkeypatch)
    job = build_scene(load_scene_desc(TEAPOT))
    scene, camera = job.scene.to(dev), job.camera.to(dev)
    mesh = [torch.device("cuda", 0)] * 2
    imgs, graphs = [], []

    def sharded():
        return shard.render_sharded(scene, camera, 64, 64, 3,
                                    Sampler(4, dev), mesh, sample_chunk=2)

    def sharded_eager():
        with kbuild.eager():
            return sharded()

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for fn in (
                lambda: ppath.render_image(scene, camera, 64, 64, 3,
                                           Sampler(4, dev), sample_chunk=2),
                sharded, sharded_eager):
            captured.clear()
            imgs.append(fn())
            graphs.append(len(captured))
    finally:
        torch.use_deterministic_algorithms(False)
    assert graphs == [_batch_graphs(50), 2 * _batch_graphs(50), 0]
    assert torch.equal(imgs[0], imgs[1]) and torch.equal(imgs[1], imgs[2])


def test_batch_run_replays_under_each_render_s_keys(dev):
    """One BatchRun's graphs serve every sample of every chunk: the run
    used for seed 1, then seed 2 (replays only), equals fresh eager runs
    of each seed bit for bit."""
    from hobbyraytracer_tpu_torch.integrator import path as ppath
    job = build_scene(load_scene_desc(TEAPOT))
    scene, camera = job.scene.to(dev), job.camera.to(dev)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        run = ppath.BatchRun(scene, camera, 48, 48, Sampler(0, dev), 50)
        got = [run.sample_sum(Sampler(seed, dev), 3).clone()
               for seed in (1, 2)]
        with kbuild.eager():
            want = [ppath.BatchRun(scene, camera, 48, 48, Sampler(0, dev),
                                   50).sample_sum(Sampler(seed, dev), 3)
                    for seed in (1, 2)]
    finally:
        torch.use_deterministic_algorithms(False)
    assert run.samples == 6
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert not torch.equal(got[0], got[1])


def test_batch_capture_that_reads_the_host_raises(dev, monkeypatch):
    """A bounce that reads a value on the host cannot be captured: the
    batch render's capture (its second sample) raises, and nothing renders
    eagerly in its place (the warm-up sample, eager, reads it freely)."""
    from hobbyraytracer_tpu_torch.integrator import path as ppath
    bounce = ppath._bounce
    calls = []

    def reading(*args, **kwargs):
        carry = bounce(*args, **kwargs)
        calls.append(float(carry[2].sum()))
        return carry

    monkeypatch.setattr(ppath, "_bounce", reading)
    job = build_scene(load_scene_desc(TEAPOT))
    scene, camera = job.scene.to(dev), job.camera.to(dev)
    with pytest.raises(RuntimeError):
        ppath.render_image(scene, camera, 32, 32, 3, Sampler(0, dev),
                           max_depth=4)
    assert 1 <= len(calls) <= 4
    torch.cuda.synchronize()


def test_batch_entry_points_take_the_graph_route(dev, monkeypatch, tmp_path):
    """The CLI's `render --integrator batch --device cuda`, `bench` with
    BENCH_INTEGRATOR=batch and entry.py's forward step each capture one
    BatchRun's graphs (at depth 50, and at entry.py's depth 12); bench's
    one-sample warm-up render none (a run captures at its second sample).
    Each ends with finite output."""
    from hobbyraytracer_tpu_torch import bench, entry
    from hobbyraytracer_tpu_torch.cli import main as cli
    captured = _counted_graphs(monkeypatch)
    assert cli.main(["render", TEAPOT, "-o", str(tmp_path / "b.png"),
                     "--spp", "3", "--width", "48", "--height", "48",
                     "--device", "cuda", "--integrator", "batch"]) == 0
    assert len(captured) == _batch_graphs(50)
    captured.clear()
    for name, value in (("BENCH_INTEGRATOR", "batch"), ("BENCH_SIZE", "32"),
                        ("BENCH_SPP", "2"), ("BENCH_REPEATS", "1")):
        monkeypatch.setenv(name, value)
    line = bench.run(torch.device("cuda"))
    assert len(captured) == _batch_graphs(50) and line["value"] > 0
    captured.clear()
    fn, example = entry.entry("cuda")
    out = fn(*example)
    assert (len(captured) == _batch_graphs(12)
            and bool(torch.isfinite(out).all()))
