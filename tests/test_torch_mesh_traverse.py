"""The fused mesh traversal (kernel K1) of the port against the JAX
package's Pallas kernel in interpret mode: the plain PyTorch version
against traverse_clusters_pallas and against
intersect_mesh_clustered_pallas, on random meshes and on the teapot's own
tables. Hit masks equal; t with rtol = atol = 1e-6; winning ids differ on
< 1% of hits (exact t-ties); normals and UVs within 1e-5 where the ids
agree. The CUDA kernel itself is held against the plain version in
tests/test_torch_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hobbyraytracer_tpu.core.types import Rays as JRays
from hobbyraytracer_tpu.kernels import mesh_traverse as jk
from hobbyraytracer_tpu.ops import intersect as jisect
from hobbyraytracer_tpu_torch.core.types import Rays
from hobbyraytracer_tpu_torch.kernels import mesh_traverse as pk
from hobbyraytracer_tpu_torch.ops import intersect as pisect
from hobbyraytracer_tpu_torch.scene.bvh import build_clusters

from _torch_parity import (assert_find_match, cluster_tables, pack_rays8,
                           random_mesh, random_rays, teapot_tables)

torch.set_num_threads(2)


@pytest.mark.parametrize("need_uv", [False, True])
@pytest.mark.parametrize("mesh", ["random", "teapot"])
def test_plain_matches_pallas_kernel(mesh, need_uv):
    """traverse_clusters (CPU -> plain version) against
    traverse_clusters_pallas(interpret=True) on 600 rays (not a multiple of
    the TPU's 256-ray block: the JAX side pads with invalid rays), a third
    of them invalid."""
    if mesh == "random":
        bounds8, soa, tri_id, _ = cluster_tables(*random_mesh(0))
        o, d, valid = random_rays(1, 600, valid_every=3)
    else:
        bounds8, soa, tri_id, _ = teapot_tables()
        o, d, valid = random_rays(2, 600, spread=2.0, valid_every=3)
    rays8 = pack_rays8(o, d, valid)
    n_pad = 768
    padded = np.concatenate([rays8, np.zeros((n_pad - 600, 8), np.float32)])
    out_j, id_j = jk.traverse_clusters_pallas(
        jnp.asarray(padded.reshape(-1, 256, 8)), jnp.asarray(bounds8),
        jnp.asarray(soa), jnp.asarray(tri_id), interpret=True,
        need_uv=need_uv)
    out_j = np.asarray(out_j).reshape(-1, 8)[:600]
    id_j = np.asarray(id_j).reshape(-1)[:600]
    out_p, id_p = pk.traverse_clusters(
        torch.from_numpy(rays8), torch.from_numpy(bounds8),
        torch.from_numpy(soa), torch.from_numpy(tri_id), need_uv=need_uv)
    out_p, id_p = out_p.numpy(), id_p.numpy()
    assert out_p.shape == (600, 8) and id_p.dtype == np.int32
    assert (out_p[~valid, 0] == 1e30).all() and (id_p[~valid] == -1).all()
    assert (out_p[:, 6:] == 0).all()
    assert_find_match(out_p[:, 0], id_p, out_p[:, 1:4], out_p[:, 4:6],
                  out_j[:, 0], id_j, out_j[:, 1:4], out_j[:, 4:6], need_uv)


@pytest.mark.parametrize("need_uv", [False, True])
@pytest.mark.parametrize("mesh", ["random", "teapot"])
def test_fused_find_matches_pallas_wrapper(mesh, need_uv):
    """intersect_mesh_clustered_fused (key, stable sort, plain traversal,
    unsort) against intersect_mesh_clustered_pallas(interpret=True) with a
    ray_valid mask and 1000 rays."""
    if mesh == "random":
        bounds8, soa, tri_id, cl = cluster_tables(*random_mesh(4, n_tris=300))
        o, d, valid = random_rays(5, 1000, valid_every=2)
    else:
        bounds8, soa, tri_id, cl = teapot_tables()
        o, d, valid = random_rays(6, 1000, spread=2.0, valid_every=2)
    t_j, g_j, h_j, n_j, uv_j = jisect.intersect_mesh_clustered_pallas(
        JRays(o=jnp.asarray(o), d=jnp.asarray(d)), None,
        jnp.asarray(tri_id), jnp.asarray(cl["bmin"]), jnp.asarray(cl["bmax"]),
        1e30, ray_valid=jnp.asarray(valid), interpret=True,
        tri_soa=jnp.asarray(soa), bounds8=jnp.asarray(bounds8),
        need_uv=need_uv)
    t_p, g_p, h_p, n_p, uv_p = pisect.intersect_mesh_clustered_fused(
        Rays(o=torch.from_numpy(o), d=torch.from_numpy(d)),
        torch.from_numpy(tri_id), torch.from_numpy(soa),
        torch.from_numpy(bounds8), 1e30, ray_valid=torch.from_numpy(valid),
        need_uv=need_uv)
    np.testing.assert_array_equal(h_p.numpy(), np.asarray(h_j))
    assert not h_p.numpy()[~valid].any()
    assert_find_match(t_p.numpy(), g_p.numpy(), n_p.numpy(), uv_p.numpy(),
                  np.asarray(t_j), np.asarray(g_j), np.asarray(n_j),
                  np.asarray(uv_j), need_uv)


def test_plain_is_independent_of_chunk_and_order():
    """The plain version's chunking and the ray order change nothing: each
    ray's visits are its own."""
    bounds8, soa, tri_id, _ = teapot_tables()
    o, d, valid = random_rays(7, 700, spread=2.0)
    rays8 = torch.from_numpy(pack_rays8(o, d, valid))
    tabs = tuple(torch.from_numpy(x) for x in (bounds8, soa, tri_id))
    out, ids = pk.traverse_clusters_plain(rays8, *tabs)
    out_c, ids_c = pk.traverse_clusters_plain(rays8, *tabs, chunk=64)
    perm = torch.randperm(700, generator=torch.Generator().manual_seed(0))
    out_r, ids_r = pk.traverse_clusters_plain(rays8[perm], *tabs)
    assert torch.equal(out, out_c) and torch.equal(ids, ids_c)
    assert torch.equal(out[perm], out_r) and torch.equal(ids[perm], ids_r)
    out3, ids3 = pk.traverse_clusters_plain(rays8.reshape(7, 100, 8), *tabs)
    assert torch.equal(out3.reshape(-1, 8), out)
    assert torch.equal(ids3.reshape(-1), ids)


def test_packing_matches_reference():
    verts, idx, normals, uvs = random_mesh(8, n_tris=260)
    cl = build_clusters(verts, idx, leaf_size=128)
    corner = idx[np.maximum(cl["tri_id"], 0)]
    soa = pk.pack_mesh_soa(cl["tri_verts"], normals[corner], uvs[corner])
    soa_j = np.asarray(jk.pack_mesh_soa(jnp.asarray(cl["tri_verts"]),
                                        jnp.asarray(normals[corner]),
                                        jnp.asarray(uvs[corner])))
    np.testing.assert_array_equal(soa, soa_j)
    np.testing.assert_array_equal(
        pk.pack_bounds(cl["bmin"], cl["bmax"]),
        np.asarray(jk.pack_bounds(jnp.asarray(cl["bmin"]),
                                  jnp.asarray(cl["bmax"]))))
    np.testing.assert_array_equal(
        pk.pack_mesh_stream(soa, cl["tri_id"]),
        np.asarray(jk.pack_mesh_stream(jnp.asarray(soa),
                                       jnp.asarray(cl["tri_id"]))))


def test_streaming_table_is_refused():
    bounds8, soa, tri_id, _ = cluster_tables(*random_mesh(9, n_tris=200))
    stream = torch.from_numpy(pk.pack_mesh_stream(soa, tri_id))
    rays8 = torch.from_numpy(pack_rays8(*random_rays(1, 16)))
    with pytest.raises(NotImplementedError, match="K2"):
        pk.traverse_clusters(rays8, torch.from_numpy(bounds8), stream,
                             torch.from_numpy(tri_id))
