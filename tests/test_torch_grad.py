"""The differentiable pieces of the port against the JAX package's, on the
CPU: safe_arccos's custom derivative, tonemap's grad_eps, bilinear texture
lookups, the kernel-find-then-replay mesh backend ("kernel_replay", the
reference's "pallas_replay"), refresh_kernel_tables, fd_check and
trace_diff."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hobbyraytracer_tpu.core import mathx as jmathx
from hobbyraytracer_tpu.core.types import Rays as JRays
from hobbyraytracer_tpu.diff import fd as jfd
from hobbyraytracer_tpu.integrator import path as jpath
from hobbyraytracer_tpu.ops import film as jfilm
from hobbyraytracer_tpu.ops import intersect as jisect
from hobbyraytracer_tpu.ops import texture as jtex
from hobbyraytracer_tpu.scene import build_scene as jax_build_scene
from hobbyraytracer_tpu.scene import ir as jir
from hobbyraytracer_tpu.scene import load_scene_desc as jax_load_scene_desc
from hobbyraytracer_tpu_torch.core import mathx
from hobbyraytracer_tpu_torch.core.mathx import BIG
from hobbyraytracer_tpu_torch.core.types import Rays
from hobbyraytracer_tpu_torch.diff import fd as pfd
from hobbyraytracer_tpu_torch.diff import fit as pfit
from hobbyraytracer_tpu_torch.integrator import path as ppath
from hobbyraytracer_tpu_torch.kernels import mesh_traverse as pk
from hobbyraytracer_tpu_torch.ops import film as pfilm
from hobbyraytracer_tpu_torch.ops import intersect as pisect
from hobbyraytracer_tpu_torch.ops import texture as ptex
from hobbyraytracer_tpu_torch.ops.camera import get_rays
from hobbyraytracer_tpu_torch.scene import build_scene, convert
from hobbyraytracer_tpu_torch.scene import ir as pir
from hobbyraytracer_tpu_torch.scene import load_scene_desc
from hobbyraytracer_tpu_torch.scene.bvh import build_clusters

from _torch_parity import (HIRES, SCENES, TEAPOT, Noise, NoiseSampler,
                           jax_camera_arrays, jax_scene_arrays, patch_jax_rng)

torch.set_num_threads(2)

ARCCOS_X = (-1.5, -1.0, -0.5, 0.0, 0.999, 1.0, 1.5)


def test_safe_arccos_matches_jax_jvp():
    """Value and derivative at and beyond +-1: the derivative is the
    reference's custom JVP, -1 / sqrt(max(1 - x^2, 1e-12)) of the
    unclipped x (finite at +-1, non-zero outside [-1, 1], where the clamp's
    own derivative would be 0)."""
    x = torch.tensor(ARCCOS_X, dtype=torch.float32, requires_grad=True)
    y = mathx.safe_arccos(x)
    (g,) = torch.autograd.grad(y.sum(), x)
    xj = jnp.asarray(ARCCOS_X, jnp.float32)
    yj = jmathx.safe_arccos(xj)
    gj = jax.vmap(jax.grad(jmathx.safe_arccos))(xj)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(yj),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(g.numpy(), np.asarray(gj), rtol=1e-6)
    assert np.isfinite(g.numpy()).all()
    assert (g.numpy()[[0, -1]] != 0).all()     # beyond the clip


def test_tonemap_grad_eps_matches_jax():
    rng = np.random.default_rng(0)
    c = rng.uniform(-0.5, 4.0, (64, 3)).astype(np.float32)
    c[:8] = 0.0                                 # black pixels
    w = rng.uniform(0.5, 1.5, (64, 3)).astype(np.float32)
    ct = torch.tensor(c, requires_grad=True)
    out = pfilm.tonemap(ct, grad_eps=1e-6)
    (g,) = torch.autograd.grad((out * torch.from_numpy(w)).sum(), ct)
    outj = jfilm.tonemap(jnp.asarray(c), grad_eps=1e-6)
    gj = jax.grad(lambda x: jnp.sum(jfilm.tonemap(x, grad_eps=1e-6)
                                    * jnp.asarray(w)))(jnp.asarray(c))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(outj),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(g.numpy(), np.asarray(gj), rtol=1e-5,
                               atol=1e-6)
    assert np.isfinite(g.numpy()).all()
    # grad_eps 0 is the forward renders' tonemap, bit for bit
    x = ct.detach()
    assert torch.equal(pfilm.tonemap(x), torch.sqrt(torch.clamp(
        (x * (2.51 * x + 0.03)) / (x * (2.43 * x + 0.59) + 0.14), 0, 1)))


@pytest.mark.parametrize("ttype", [ptex.TEX_ENVIRONMENT, ptex.TEX_IMAGE])
def test_bilinear_colour_value_matches_jax(ttype):
    """Bilinear lookups of an environment and an image texture (u, v
    partly outside [0, 1], where they clamp): values and the gradients of
    a weighted sum to u and v, rtol 1e-6."""
    rng = np.random.default_rng(1)
    img = rng.uniform(0, 2, (7, 11, 3)).astype(np.float32)
    specs = [{"type": ptex.TEX_SOLID, "solid": (1, 1, 1)},
             {"type": ttype, "image": img}]
    n = 96
    u = rng.uniform(-0.1, 1.1, n).astype(np.float32)
    v = rng.uniform(-0.1, 1.1, n).astype(np.float32)
    w = rng.uniform(0.5, 1.5, (n, 3)).astype(np.float32)
    tab_p = ptex.build_table(specs)
    tab_p.bilinear = True
    tab_j = jtex.build_table(specs).replace(bilinear=True)
    tid = np.ones((n,), np.int32)
    ut = torch.tensor(u, requires_grad=True)
    vt = torch.tensor(v, requires_grad=True)
    c = ptex.colour_value(tab_p, torch.from_numpy(tid), ut, vt,
                          torch.zeros((n, 3)))
    gu, gv = torch.autograd.grad((c * torch.from_numpy(w)).sum(), (ut, vt))

    def fj(uu, vv):
        return jtex.colour_value(tab_j, jnp.asarray(tid), uu, vv,
                                 jnp.zeros((n, 3), jnp.float32))

    cj = fj(jnp.asarray(u), jnp.asarray(v))
    guj, gvj = jax.grad(lambda a, b: jnp.sum(fj(a, b) * jnp.asarray(w)),
                        argnums=(0, 1))(jnp.asarray(u), jnp.asarray(v))
    np.testing.assert_allclose(c.detach().numpy(), np.asarray(cj),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(gu.numpy(), np.asarray(guj), rtol=1e-6,
                               atol=1e-5)
    np.testing.assert_allclose(gv.numpy(), np.asarray(gvj), rtol=1e-6,
                               atol=1e-5)
    inside = (u > 0) & (u < 1) & (v > 0) & (v < 1)
    assert (np.abs(gu.numpy()[inside]) > 0).all()  # smooth, not piecewise
    # nearest-neighbour (the default) is still the reference's lookup
    tab_p.bilinear = False
    c_near = ptex.colour_value(tab_p, torch.from_numpy(tid),
                               torch.from_numpy(u), torch.from_numpy(v),
                               torch.zeros((n, 3)))
    cj_near = jtex.colour_value(jtex.build_table(specs), jnp.asarray(tid),
                                jnp.asarray(u), jnp.asarray(v),
                                jnp.zeros((n, 3), jnp.float32))
    np.testing.assert_array_equal(c_near.numpy(), np.asarray(cj_near))


def _random_mesh_case(leaf=64):
    """tests/test_grad.py:149-201's random 600-triangle mesh, its cluster
    tables and 64 rays from above."""
    rng = np.random.default_rng(0)
    base = rng.uniform(-2, 2, (200, 3)).astype(np.float32)
    v1 = base + rng.normal(0, 0.4, (200, 3)).astype(np.float32)
    v2 = base + rng.normal(0, 0.4, (200, 3)).astype(np.float32)
    verts = np.concatenate([base, v1, v2]).astype(np.float32)
    idx = np.arange(600, dtype=np.int32).reshape(3, 200).T.copy()
    cl = build_clusters(verts, idx, leaf_size=leaf)
    normals = np.tile(np.asarray([[0, 0, 1]], np.float32), (600, 1))
    uvs = np.zeros((600, 2), np.float32)
    corner = idx[np.maximum(cl["tri_id"], 0)]
    soa = pk.pack_mesh_soa(cl["tri_verts"], normals[corner], uvs[corner])
    bounds8 = pk.pack_bounds(cl["bmin"], cl["bmax"])
    o = rng.uniform(-4, 4, (64, 3)).astype(np.float32)
    o[:, 2] = 5.0
    d = rng.normal(0, 0.3, (64, 3)).astype(np.float32)
    d[:, 2] = -1.0
    return verts, idx, normals, uvs, cl, soa, bounds8, o, d


def _port_replay(case, backend):
    """(t, hit, normal, p, d(sum of hit t)/d verts) of the port's
    intersect_triangles_bvh on the random mesh."""
    verts, idx, normals, uvs, cl, soa, bounds8, o, d = case
    v = torch.tensor(verts, requires_grad=True)
    tri_id = torch.from_numpy(cl["tri_id"])
    idx_t = torch.from_numpy(idx)
    tri_verts, bmin, bmax = pir._live_clusters(pir.replace(pir.MeshGeom(
        verts, normals, uvs, idx, 0, cl["tri_id"], cl["bmin"], cl["bmax"],
        soa, bounds8), verts=v))
    h = pisect.intersect_triangles_bvh(
        Rays(o=torch.from_numpy(o), d=torch.from_numpy(d)), tri_id,
        torch.from_numpy(soa), torch.from_numpy(bounds8),
        torch.tensor(0, dtype=torch.int32), BIG, backend=backend, verts=v,
        normals=torch.from_numpy(normals), uvs=torch.from_numpy(uvs),
        indices=idx_t, tri_verts=tri_verts, bmin=bmin, bmax=bmax)
    (g,) = torch.autograd.grad(torch.where(h.hit, h.t, 0.0).sum(), v)
    return (h.t.detach(), h.hit, h.normal.detach(), h.p.detach(), g)


def test_kernel_replay_equals_lockstep_bitwise():
    """On the CPU the kernel's find is its plain version, whose leaf
    arithmetic the lockstep find shares: the two replay backends agree bit
    for bit (t, hit, normal, hit point, the winning ids, and the vertex
    gradient of the hit t)."""
    case = _random_mesh_case()
    a = _port_replay(case, "kernel_replay")
    b = _port_replay(case, "lockstep")
    assert a[1].any() and (a[4] != 0).any()
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    verts, idx, normals, uvs, cl, soa, bounds8, o, d = case
    rays = Rays(o=torch.from_numpy(o), d=torch.from_numpy(d))
    _, gid_k, _, _, _ = pisect.intersect_mesh_clustered_fused(
        rays, torch.from_numpy(cl["tri_id"]), torch.from_numpy(soa),
        torch.from_numpy(bounds8), BIG, need_uv=False)
    _, gid_l, _ = pisect.intersect_mesh_clustered(
        rays, torch.from_numpy(cl["tri_verts"]),
        torch.from_numpy(cl["tri_id"]), torch.from_numpy(cl["bmin"]),
        torch.from_numpy(cl["bmax"]), BIG)
    assert torch.equal(gid_k, gid_l)


def test_kernel_replay_matches_jax_pallas_replay_and_xla():
    """The port's "kernel_replay" against the JAX package's
    "pallas_replay" (its Pallas find in interpret mode) and its "xla"
    backend: hit masks and winning ids equal, t within 1e-6, the vertex
    gradient of the hit t within rtol 1e-3."""
    case = _random_mesh_case()
    verts, idx, normals, uvs, cl, soa, bounds8, o, d = case
    t_p, hit_p, _, _, g_p = _port_replay(case, "kernel_replay")
    rays_t = Rays(o=torch.from_numpy(o), d=torch.from_numpy(d))
    _, gid_p, _, _, _ = pisect.intersect_mesh_clustered_fused(
        rays_t, torch.from_numpy(cl["tri_id"]), torch.from_numpy(soa),
        torch.from_numpy(bounds8), BIG, need_uv=False)
    rj = JRays(o=jnp.asarray(o), d=jnp.asarray(d))
    tri_id = jnp.asarray(cl["tri_id"])
    for backend in ("pallas_replay", "xla"):
        def f(v, backend=backend):
            tvs = v[jnp.asarray(idx)[jnp.maximum(tri_id, 0)]]
            h = jisect.intersect_triangles_bvh(
                rj, v, jnp.asarray(normals), jnp.asarray(uvs),
                jnp.asarray(idx), tvs, tri_id, jnp.asarray(cl["bmin"]),
                jnp.asarray(cl["bmax"]), jnp.asarray(0, jnp.int32),
                float(BIG), backend=backend, interpret=True,
                tri_soa=jnp.asarray(soa), bounds8=jnp.asarray(bounds8))
            return jnp.sum(jnp.where(h.hit, h.t, 0.0)), h

        (_, h), g = jax.value_and_grad(f, has_aux=True)(jnp.asarray(verts))
        np.testing.assert_array_equal(hit_p.numpy(), np.asarray(h.hit))
        np.testing.assert_allclose(t_p.numpy(), np.asarray(h.t), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(g_p.numpy(), np.asarray(g), rtol=1e-3,
                                   atol=1e-6, err_msg=backend)
    _, gid_j, _, _, _ = jisect.intersect_mesh_clustered_pallas(
        rj, None, tri_id, jnp.asarray(cl["bmin"]), jnp.asarray(cl["bmax"]),
        float(BIG), interpret=True, tri_soa=jnp.asarray(soa),
        bounds8=jnp.asarray(bounds8), need_uv=False)
    np.testing.assert_array_equal(gid_p.numpy(), np.asarray(gid_j))


@pytest.fixture(scope="module")
def mesh_jobs():
    """teapot_scene (24-row table) and teapot_hires (32-row) in both
    packages."""
    return {name: (jax_build_scene(jax_load_scene_desc(path)),
                   build_scene(load_scene_desc(path)))
            for name, path in (("teapot", TEAPOT), ("hires", HIRES))}


MOVE = (0.6, -0.4, 0.5)


@pytest.mark.parametrize("moved", [False, True])
@pytest.mark.parametrize("name,rows", [("teapot", 24), ("hires", 32)])
def test_refresh_kernel_tables_matches_jax(mesh_jobs, name, rows, moved):
    """The port's refresh_kernel_tables against JAX's on the same vertices
    (the build's, and moved by MOVE), both on the CPU: tri_soa, bounds8,
    cluster_bmin and cluster_bmax bitwise equal, the mesh's layout kept.
    At the build's vertices the refreshed tables are also the host
    build's, byte for byte."""
    job_j, job_p = mesh_jobs[name]
    mj = next(i.mesh for i in job_j.scene.instances if i.kind == "mesh")
    mp = next(i.mesh for i in job_p.scene.instances if i.kind == "mesh")
    assert mp.tri_soa.shape[1] == rows
    shift = np.asarray(MOVE if moved else (0, 0, 0), np.float32)
    vj = jnp.asarray(np.asarray(mj.verts) + shift)
    rj = jir.refresh_kernel_tables(mj.replace(verts=vj))
    rp = pir.refresh_kernel_tables(pir.replace(
        mp, verts=mp.verts + torch.from_numpy(shift)))
    assert rp.tri_soa.shape == mp.tri_soa.shape
    for f in ("tri_soa", "bounds8", "cluster_bmin", "cluster_bmax"):
        np.testing.assert_array_equal(getattr(rp, f).numpy(),
                                      np.asarray(getattr(rj, f)), err_msg=f)
    assert rp.cluster_id is mp.cluster_id and rp.normals is mp.normals
    if not moved:   # bytes: the ids bit-cast in row 24 hold NaNs (-1)
        for f in ("tri_soa", "bounds8", "cluster_bmin", "cluster_bmax"):
            assert (getattr(rp, f).numpy().tobytes()
                    == getattr(mp, f).numpy().tobytes()), f


def test_fd_check_matches_jax():
    rng = np.random.default_rng(2)
    x0 = rng.uniform(-1, 1, (4, 3)).astype(np.float32)

    def fp(x):
        return (torch.sin(3 * x) * x * x).sum()

    def fj(x):
        return jnp.sum(jnp.sin(3 * x) * x * x)

    ad_p, fd_p = pfd.fd_check(fp, torch.from_numpy(x0), eps=1e-2,
                              n_probe=5, seed=3)
    ad_j, fd_j = jfd.fd_check(fj, jnp.asarray(x0), eps=1e-2, n_probe=5,
                              seed=3)
    np.testing.assert_allclose(ad_p, np.asarray(ad_j), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(fd_p, fd_j, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(ad_p, fd_p, rtol=2e-2, atol=1e-3)


def _identity_checkpoint(monkeypatch):
    """Run the JAX integrator's remat eagerly: jax.checkpoint would trace
    its body, and the injected noise needs concrete stream indices."""
    monkeypatch.setattr(jax, "checkpoint", lambda f, *a, **k: f)


def test_trace_diff_matches_jax(monkeypatch):
    """trace_diff on cornell_box camera rays (12x12, depth 3) with the same
    injected noise in both packages: radiance and the gradient of a
    weighted sum to the albedo table within rtol 1e-4 (no mesh, so no
    self-hit divergence)."""
    noise = Noise(4)
    patch_jax_rng(monkeypatch, noise)
    _identity_checkpoint(monkeypatch)
    job = jax_build_scene(jax_load_scene_desc(f"{SCENES}/cornell_box.yaml"))
    scene = convert.scene_from_arrays(jax_scene_arrays(job.scene))
    camera = convert.camera_from_arrays(jax_camera_arrays(job.camera))
    w = h = 12
    x, y = ppath.pixel_grid(w, h, "cpu")
    s, t = (x + 0.5) / (w - 1), (y + 0.5) / (h - 1)
    rays = get_rays(camera, s, t)
    wt = np.random.default_rng(5).uniform(0.5, 1.5, (w * h, 3)).astype(
        np.float32)
    params, rebuild = pfit.select_params(scene)
    rad_p = ppath.trace_diff(rebuild(params), rays, NoiseSampler(noise), 3,
                             mesh_backend="kernel_replay")
    (g_p,) = torch.autograd.grad((rad_p * torch.from_numpy(wt)).sum(),
                                 params["materials"]["albedo"])
    rj = JRays(o=jnp.asarray(rays.o.numpy()), d=jnp.asarray(rays.d.numpy()))

    def f(albedo):
        sc = job.scene.replace(materials=job.scene.materials.replace(
            albedo=albedo))
        rad = jpath.trace_diff(sc, rj, jax.random.PRNGKey(0), 3)
        return jnp.sum(rad * jnp.asarray(wt)), rad

    with jax.disable_jit():
        (_, rad_j), g_j = jax.value_and_grad(f, has_aux=True)(
            job.scene.materials.albedo)
    assert float(rad_p.detach().max()) > 0 and (g_p != 0).any()
    np.testing.assert_allclose(rad_p.detach().numpy(), np.asarray(rad_j),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(g_p.numpy(), np.asarray(g_j), rtol=1e-4,
                               atol=1e-6)


def test_trace_diff_has_no_host_read(monkeypatch):
    """trace_diff runs exactly max_depth bounces whatever the rays do (no
    early exit, so no host read of the active mask): rays that all miss
    take max_depth intersect_scene calls."""
    job = build_scene(load_scene_desc(TEAPOT))
    calls = []
    real = pir.intersect_scene
    monkeypatch.setattr(pir, "intersect_scene", lambda *a, **k: (
        calls.append(k["bounce"]), real(*a, **k))[1])
    up = Rays(o=torch.tensor([[0.0, 100.0, 0.0]] * 4),
              d=torch.tensor([[0.0, 1.0, 0.0]] * 4))
    from hobbyraytracer_tpu_torch.core.rng import Sampler
    rad = ppath.trace_diff(job.scene, up, Sampler(0, "cpu"), max_depth=5)
    assert calls == [0, 1, 2, 3, 4]
    assert (rad > 0).all()
