"""The port's participating media (scene/ir.py: Medium, _medium_span,
_mesh_first_t, _intersect_medium, the media loop of intersect_scene) and
its pool-level sort key (wavefront_sort_key) against the JAX package's, on
seeded rays and under identical injected noise; and the reference's own
oracles for the mesh-boundary medium (tests/test_medium_mesh.py) held on
the port."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hobbyraytracer_tpu.core.types import Rays as JRays
from hobbyraytracer_tpu.ops import intersect as jisect
from hobbyraytracer_tpu.scene import build_scene as jax_build_scene
from hobbyraytracer_tpu.scene import ir as jir
from hobbyraytracer_tpu.scene import load_scene_desc as jax_load_scene_desc
from hobbyraytracer_tpu_torch.core.rng import Sampler
from hobbyraytracer_tpu_torch.core.types import Rays
from hobbyraytracer_tpu_torch.ops import intersect as pisect
from hobbyraytracer_tpu_torch.scene import build_scene, convert
from hobbyraytracer_tpu_torch.scene import ir as pir
from hobbyraytracer_tpu_torch.scene import load_scene_desc

from _torch_parity import (HIRES, SCENES, Noise, NoiseSampler,
                           assert_tree_close, jax_scene_arrays, patch_jax_rng)

torch.set_num_threads(2)

SMOKE = f"{SCENES}/cornell_smoke.yaml"
TWO_TEAPOTS = f"{SCENES}/two_teapots.yaml"

CUBE_FACES = ("f 1 3 2\nf 1 4 3\nf 5 6 7\nf 5 7 8\nf 1 2 6\nf 1 6 5\n"
              "f 2 3 7\nf 2 7 6\nf 3 4 8\nf 3 8 7\nf 4 1 5\nf 4 5 8\n")
CUBE_CORNERS = ((-1, -1, -1), (1, -1, -1), (1, 1, -1), (-1, 1, -1),
                (-1, -1, 1), (1, -1, 1), (1, 1, 1), (-1, 1, 1))

SCENE_TMPL = """
film: {{width: 16, height: 16, samples: 4, output: x.png}}
camera:
  position: [0, 0, -6]
  look_at: [0, 0, 0]
  up: [0, 1, 0]
  fov: 40
  aperture: 0.0
  focal_distance: 6
  background: [0.8, 0.8, 0.8]
materials: []
objects:
  - type: constant_medium
    density: 0.7
    albedo: [0.9, 0.9, 0.9]
    boundary: {boundary}
{transform}
"""
TRANSFORM = ("    transform:\n        rotate: [0, 30, 10]\n"
             "        translate: [0.3, -0.2, 0.1]\n"
             "        scale: [1.2, 1.2, 1.2]\n")


def _cube_obj(dz=0.0, vbase=0):
    verts = "".join(f"v {x} {y} {z + dz}\n" for x, y, z in CUBE_CORNERS)
    faces = "".join(
        "f " + " ".join(str(int(t) + vbase) for t in line.split()[1:]) + "\n"
        for line in CUBE_FACES.splitlines())
    return verts + faces


def _subdivided_cube_obj(n=4):
    """The cube [-1, 1]^3 with every face cut into n x n quads (2 n^2
    triangles a face): 192 triangles at n = 4, enough for a cluster BVH."""
    verts, faces = [], []
    for axis in range(3):
        for side in (-1.0, 1.0):
            base = len(verts)
            for i in range(n + 1):
                for j in range(n + 1):
                    p = [0.0, 0.0, 0.0]
                    p[axis] = side
                    p[(axis + 1) % 3] = -1.0 + 2.0 * i / n
                    p[(axis + 2) % 3] = -1.0 + 2.0 * j / n
                    verts.append(p)
            for i in range(n):
                for j in range(n):
                    a = base + i * (n + 1) + j + 1
                    b, c, d = a + 1, a + n + 1, a + n + 2
                    faces += [(a, b, d), (a, d, c)]
    return ("".join(f"v {x} {y} {z}\n" for x, y, z in verts)
            + "".join(f"f {a} {b} {c}\n" for a, b, c in faces))


@pytest.fixture(scope="module")
def media(tmp_path_factory):
    """{name: (port Medium, JAX Medium, port scene, JAX scene)} for a box,
    a sphere, a 12-triangle cube mesh (dense), a 192-triangle cube mesh
    (clustered), two disjoint cubes in one mesh, and the box and the
    sphere under a transform. Both packages build each from one YAML."""
    d = tmp_path_factory.mktemp("media")
    (d / "cube.obj").write_text(_cube_obj())
    (d / "cube192.obj").write_text(_subdivided_cube_obj())
    (d / "two.obj").write_text(_cube_obj() + _cube_obj(4.0, 8))
    boundaries = {
        "box": ("{type: box, min: [-1, -1, -1], max: [1, 1, 1]}", ""),
        "sphere": ("{type: sphere, center: [0.1, 0, 0.2], radius: 1.1}", ""),
        "mesh": ("{type: mesh, path: cube.obj}", ""),
        "mesh192": ("{type: mesh, path: cube192.obj}", ""),
        "two": ("{type: mesh, path: two.obj}", ""),
        "box_tr": ("{type: box, min: [-1, -1, -1], max: [1, 1, 1]}",
                   TRANSFORM),
        "sphere_tr": ("{type: sphere, center: [0.1, 0, 0.2], radius: 1.1}",
                      TRANSFORM),
    }
    out = {}
    for name, (boundary, transform) in boundaries.items():
        path = d / f"{name}.yaml"
        path.write_text(SCENE_TMPL.format(boundary=boundary,
                                          transform=transform))
        ps = build_scene(load_scene_desc(str(path))).scene
        js = jax_build_scene(jax_load_scene_desc(str(path))).scene
        assert_tree_close(convert.scene_to_arrays(ps), jax_scene_arrays(js))
        out[name] = (ps.media[0], js.media[0], ps, js)
    return out


def _rays_np(n=2048, seed=0, aimed=False):
    """Rays from the plane z = -5 generally toward the cube (the
    reference's test rays), or aimed at points around it so that most of
    them cross it."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-4, 4, (n, 3)).astype(np.float32)
    o[:, 2] = -5.0
    if aimed:
        d = (rng.uniform(-1.3, 1.3, (n, 3)) - o).astype(np.float32)
    else:
        d = rng.normal(0, 1, (n, 3)).astype(np.float32)
        d[:, 2] = np.abs(d[:, 2]) + 0.5
    return o, d


def _both(o, d):
    return (Rays(o=torch.from_numpy(o), d=torch.from_numpy(d)),
            JRays(o=jnp.asarray(o), d=jnp.asarray(d)))


def test_media_build_as_the_reference(media):
    box, sphere = media["box"][0], media["sphere"][0]
    assert (box.btype, sphere.btype) == ("box", "sphere")
    assert box.center is None and sphere.bmin is None and box.mesh is None
    assert not media["mesh"][0].mesh.use_bvh          # 12 triangles: dense
    assert media["mesh192"][0].mesh.use_bvh           # 192: clustered
    assert media["box_tr"][0].transform is not None
    # the phase material: isotropic, after the reserved default
    ps = media["box"][2]
    assert int(box.mat_id) == 1 and int(ps.materials.mtype[1]) == 4
    assert copy.deepcopy(ps).to("meta").media[0].bmin.device.type == "meta"
    with pytest.raises(ValueError, match="boundary"):
        pir.Medium("box", -1.0, 1)
    with pytest.raises(ValueError, match="expected"):
        pir.Medium("cylinder", -1.0, 1)


@pytest.mark.parametrize("name", ["box", "sphere", "mesh", "mesh192"])
def test_medium_span_matches_jax(media, name):
    """(t_enter, t_exit, valid) of the three boundary forms, the mesh one
    by the dense scan (12 triangles) and by the lockstep find (192): valid
    equal apart from grazing rays (< 0.5%), the two parameters within 1e-5
    (1e-4 for the meshes, whose exit is a second cast from t1 + 1e-4)."""
    pm, jm = media[name][:2]
    o, d = _rays_np(1024, seed=4, aimed=True)
    rp, rj = _both(o, d)
    t1_p, t2_p, v_p = (x.numpy() for x in pir._medium_span(pm, rp))
    t1_j, t2_j, v_j = (np.asarray(x) for x in jir._medium_span(jm, rj))
    assert v_j.sum() > 100
    assert (v_p != v_j).mean() < 0.005
    both = v_p & v_j
    tol = 1e-4 if name.startswith("mesh") else 1e-5
    np.testing.assert_allclose(t1_p[both], t1_j[both], rtol=tol, atol=tol)
    np.testing.assert_allclose(t2_p[both], t2_j[both], rtol=tol, atol=tol)


def test_box_span_axis_parallel_rays(media):
    """A ray along an axis divides by zero in the box form: inside the
    slab the bounds are -inf/+inf, outside it the span is empty, and an
    origin on a face gives NaN. The port carries all three as the
    reference does, value for value."""
    pm, jm = media["box"][:2]
    o = np.asarray([[0.2, 0.3, -5.0], [0.2, 3.0, -5.0], [1.0, 0.0, -5.0],
                    [0.0, -5.0, 0.5], [-5.0, 0.1, 0.1], [0.0, 0.0, 0.0]],
                   np.float32)
    d = np.asarray([[0, 0, 1], [0, 0, 1], [0, 0, 1], [0, 2, 0], [1, 0, 0],
                    [0, 0, -1]], np.float32)
    rp, rj = _both(o, d)
    got = [x.numpy() for x in pir._medium_span(pm, rp)]
    ref = [np.asarray(x) for x in jir._medium_span(jm, rj)]
    np.testing.assert_array_equal(got[2], ref[2])
    np.testing.assert_array_equal(got[2], [True, False, False, True, True,
                                           True])
    for a, b in zip(got[:2], ref[:2]):
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        np.testing.assert_allclose(a[got[2]], b[got[2]], rtol=1e-6)
    np.testing.assert_allclose(got[0][[0, 3, 4]], [4.0, 2.0, 4.0])


@pytest.mark.parametrize("name", ["box", "sphere", "mesh192", "box_tr",
                                  "sphere_tr"])
def test_intersect_medium_matches_jax_under_noise(monkeypatch, media, name):
    """_intersect_medium with identical injected free-flight draws, at two
    (bounce, medium index) pairs, with a scalar far end and with a per-ray
    one: hit masks equal apart from rays whose flight ends within rounding
    of the exit (< 0.5%), t within 1e-5 and p within 1e-4, the constant
    fields equal."""
    noise = Noise(5)
    patch_jax_rng(monkeypatch, noise)
    pm, jm = media[name][:2]
    o, d = _rays_np(1024, seed=6, aimed=True)
    rp, rj = _both(o, d)
    far = np.random.default_rng(7).uniform(4.0, 9.0, 1024).astype(np.float32)
    sampler = NoiseSampler(noise)
    for bounce, index, t_max in ((0, 0, 1e30), (3, 1, far)):
        h_p = pir._intersect_medium(
            pm, rp, sampler, bounce, index, 1e-3,
            torch.from_numpy(t_max) if isinstance(t_max, np.ndarray)
            else t_max)
        h_j = jir._intersect_medium(jm, rj, jax.random.PRNGKey(0), bounce,
                                    index, 1e-3, jnp.asarray(t_max))
        hit_p, hit_j = h_p.hit.numpy(), np.asarray(h_j.hit)
        assert hit_j.sum() > 50
        assert (hit_p != hit_j).mean() < 0.005
        both = hit_p & hit_j
        np.testing.assert_allclose(h_p.t.numpy()[both],
                                   np.asarray(h_j.t)[both], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(h_p.p.numpy()[both],
                                   np.asarray(h_j.p)[both], rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_array_equal(h_p.mat_id.numpy()[both],
                                      np.asarray(h_j.mat_id)[both])
        assert (h_p.mat_id.numpy()[~hit_p] == -1).all()
        np.testing.assert_array_equal(h_p.normal.numpy(),
                                      np.asarray(h_j.normal))
        assert h_p.front_face.all() and not h_p.uv.any()
        if isinstance(t_max, np.ndarray):
            assert (h_p.t.numpy()[hit_p] <= t_max[hit_p]).all()


def test_flight_stream_is_bounce_times_131_plus_index(media):
    """The free-flight draw of medium i at bounce b comes from the stream
    (MEDIUM_FLIGHT, 131 b + i), so two media of one scene, and one medium
    at two bounces, draw apart."""
    from hobbyraytracer_tpu_torch.core import rng as prng
    seen = []

    class Spy(Sampler):
        def uniform(self, purpose, iteration, shape, span=None):
            seen.append((purpose, iteration, tuple(shape)))
            return super().uniform(purpose, iteration, shape, span)

    rp, _ = _both(*_rays_np(16))
    pir._intersect_medium(media["box"][0], rp, Spy(0, "cpu"), 7, 2, 1e-3,
                          1e30)
    assert seen == [(prng.MEDIUM_FLIGHT, 7 * 131 + 2, (16,))]


def test_scene_with_media_needs_the_sampler(media):
    ps = media["box"][2]
    rp, _ = _both(*_rays_np(16))
    with pytest.raises(ValueError, match="sampler"):
        pir.intersect_scene(ps, rp)
    h = pir.intersect_scene(ps, rp, sampler=Sampler(0, "cpu"), bounce=0)
    assert h.hit.shape == (16,)


# --- the reference's oracles for the mesh-boundary medium, on the port ----

def test_mesh_medium_matches_box_medium(media):
    """The same boundary as a box and as a mesh, the same stream: the
    scatter decisions agree on > 99% of rays and t within 1e-3 where both
    scatter (the clustered mesh too)."""
    rp, _ = _both(*_rays_np())
    sampler = Sampler(0, "cpu")
    hb = pir._intersect_medium(media["box"][0], rp, sampler, 0, 0, 1e-3,
                               float("inf"))
    for name in ("mesh", "mesh192"):
        hm = pir._intersect_medium(media[name][0], rp, sampler, 0, 0, 1e-3,
                                   float("inf"))
        b_hit, m_hit = hb.hit.numpy(), hm.hit.numpy()
        assert (b_hit == m_hit).mean() > 0.99, (b_hit.mean(), m_hit.mean())
        both = b_hit & m_hit
        assert both.any()
        np.testing.assert_allclose(hm.t.numpy()[both], hb.t.numpy()[both],
                                   rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("name", ["mesh", "mesh192"])
def test_mesh_medium_ray_starting_inside(media, name):
    n = 512
    d = np.random.default_rng(1).normal(0, 1, (n, 3)).astype(np.float32)
    rp, _ = _both(np.zeros((n, 3), np.float32), d)
    h = pir._intersect_medium(media[name][0], rp, Sampler(2, "cpu"), 0, 0,
                              1e-3, float("inf"))
    hit = h.hit.numpy()
    assert hit.mean() > 0.2, hit.mean()
    assert (np.abs(h.p.numpy()[hit]) <= 1.0 + 1e-3).all()


def test_mesh_medium_through_full_scene(media):
    rp, _ = _both(*_rays_np(256, seed=3))
    h = pir.intersect_scene(media["mesh"][2], rp, sampler=Sampler(4, "cpu"))
    assert torch.isfinite(h.t).all()
    assert h.hit.any()
    assert (h.mat_id[h.hit] == 1).all()


def test_nonconvex_mesh_boundary_first_span_only(media):
    """Two disjoint cubes (z in [-1, 1] and [3, 5]) in one mesh: a +z ray
    from z = -5 gets the first cube's chord [4, 6], not the second's."""
    n = 8
    o = np.tile(np.asarray([[0.0, 0.0, -5.0]], np.float32), (n, 1))
    o[:, 0] = np.linspace(-0.5, 0.5, n)
    d = np.tile(np.asarray([[0.0, 0.0, 1.0]], np.float32), (n, 1))
    rp, _ = _both(o, d)
    t1, t2, valid = pir._medium_span(media["two"][0], rp)
    assert bool(valid.all())
    np.testing.assert_allclose(t1.numpy(), 4.0, atol=1e-3)
    np.testing.assert_allclose(t2.numpy(), 6.0, atol=1e-3)


# --- cornell_smoke: media after the solids ---------------------------------

def test_smoke_scene_hits_match_jax_under_noise(monkeypatch):
    """intersect_scene on cornell_smoke (six walls, a glass sphere, two box
    media whose phase materials follow the five named ones): with the same
    draws, the material met by each ray is equal on > 99.5% of rays (rays
    whose flight ends at a wall differ by rounding), t within 1e-4
    relative on those; every material of the scene is met, both phase
    materials among them."""
    noise = Noise(8)
    patch_jax_rng(monkeypatch, noise)
    ps = build_scene(load_scene_desc(SMOKE))
    js = jax_build_scene(jax_load_scene_desc(SMOKE))
    assert [int(m.mat_id) for m in ps.scene.media] == [6, 7]
    rng = np.random.default_rng(9)
    n = 4096
    o = rng.uniform(50, 500, (n, 3)).astype(np.float32)
    d = rng.normal(0, 1, (n, 3)).astype(np.float32)
    rp, rj = _both(o, d)
    h_p = pir.intersect_scene(ps.scene, rp, sampler=NoiseSampler(noise),
                              bounce=2)
    h_j = jir.intersect_scene(js.scene, rj, jax.random.PRNGKey(0), 2)
    same = h_p.mat_id.numpy() == np.asarray(h_j.mat_id)
    assert same.mean() > 0.995, same.mean()
    np.testing.assert_allclose(h_p.t.numpy()[same], np.asarray(h_j.t)[same],
                               rtol=1e-4)
    met = set(h_p.mat_id.numpy().tolist())
    assert {6, 7} <= met and len(met - {-1}) >= 6


# --- the pool-level sort key ----------------------------------------------

def _pool_rays(job, n=4096, seed=3):
    """Camera-like rays plus rays from inside the scene, some lanes dead."""
    rng = np.random.default_rng(seed)
    o = np.concatenate([np.tile(np.asarray([[0, 2.5, 8.5]], np.float32),
                                (n // 2, 1)),
                        rng.uniform(-2.4, 2.4, (n // 2, 3)).astype(np.float32)
                        + np.asarray([0, 2.5, 0], np.float32)])
    tgt = rng.uniform(-2.5, 2.5, (n, 3)).astype(np.float32) + np.asarray(
        [0, 1.5, 0], np.float32)
    d = (tgt - o).astype(np.float32)
    valid = rng.random(n) > 0.2
    return o, d, valid


@pytest.mark.parametrize("scene,key_mode", [(TWO_TEAPOTS, "auto"),
                                            (HIRES, "auto"),
                                            (TWO_TEAPOTS, "corridor")])
def test_wavefront_sort_key_matches_jax(monkeypatch, scene, key_mode):
    """wavefront_sort_key over the world-space union of the kernel meshes'
    boxes: equal to the reference's key on > 95% of rays and one Morton
    level off elsewhere: a ray from outside enters through a face of the
    box, and on a max face the entry point's coordinate over the box's
    size is 1 or an ulp less as XLA's FMAs round it, which the 32-cell
    quantisation turns into cell 31 or 30. And the pin: the key
    is the OCTANT form (below 1 << 20 for possible hitters, 1 << 20 for the
    rest) on a mesh of 822 clusters and under KEY_MODE "corridor" too,
    where the per-mesh key takes the corridor form: the reference keys its
    pool sort so."""
    monkeypatch.setenv("HRT_PALLAS_INTERPRET", "1")
    monkeypatch.setattr(pisect, "KEY_MODE", key_mode)
    monkeypatch.setattr(jisect, "KEY_MODE", key_mode)
    pj = build_scene(load_scene_desc(scene))
    jj = jax_build_scene(jax_load_scene_desc(scene))
    assert pir.has_wavefront_sort_key(pj.scene)
    assert jir.has_wavefront_sort_key(jj.scene)
    o, d, valid = _pool_rays(pj)
    rp, rj = _both(o, d)
    k_p = pir.wavefront_sort_key(pj.scene, rp, torch.from_numpy(valid))
    k_j = np.asarray(jir.wavefront_sort_key(jj.scene, rj,
                                            jnp.asarray(valid)))
    assert k_p.dtype == torch.int32
    k_p = k_p.numpy()
    assert (k_p == k_j).mean() > 0.95, (k_p == k_j).mean()
    assert k_p.max() == 1 << 20 and (k_p[~valid] == 1 << 20).all()
    assert ((k_p < 1 << 18) & valid).sum() > 500
    # where the keys differ: a grazing ray that one side counts as a miss
    # (< 0.2%), or the same octant and cells one level apart in an axis
    off = k_p != k_j
    graze = off & ((k_p == 1 << 20) | (k_j == 1 << 20))
    assert graze.mean() < 0.002
    step = off & ~graze
    np.testing.assert_array_equal(k_p[step] >> 15, k_j[step] >> 15)
    for ax in range(3):
        cells = [sum(((k >> (3 * b + ax)) & 1) << b for b in range(5))
                 for k in (k_p[step], k_j[step])]
        assert np.abs(cells[0] - cells[1]).max(initial=0) <= 1
    # without ray_valid every lane is live
    k_all = pir.wavefront_sort_key(pj.scene, rp).numpy()
    np.testing.assert_array_equal(k_all[valid], k_p[valid])
    # the per-mesh key of the same rays: corridor where the mode says so
    mesh = next(i for i in pj.scene.instances if i.kind == "mesh")
    r_obj = mesh.transform.ray_to_object(rp)
    per_mesh = pisect.coherence_key(r_obj.o, r_obj.d,
                                    torch.from_numpy(valid),
                                    mesh.mesh.bounds8, 1e30).numpy()
    corridor = key_mode == "corridor" or scene == HIRES
    assert (per_mesh.max() == 1 << 30) == corridor


def test_no_sort_key_without_a_kernel_mesh(media):
    """A scene whose only mesh is dense, or none, has no pool sort key."""
    ps = media["mesh"][2]
    rp, _ = _both(*_rays_np(8))
    assert not pir.has_wavefront_sort_key(ps)
    assert pir.wavefront_sort_key(ps, rp) is None
    smoke = build_scene(load_scene_desc(SMOKE)).scene
    assert not pir.has_wavefront_sort_key(smoke)
