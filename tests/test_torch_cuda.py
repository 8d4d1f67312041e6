"""The CUDA kernel of the port on the card. Every test here needs a CUDA
card and skips without one; the file imports neither JAX nor the JAX
package, so it also runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(tests/conftest.py imports JAX, hence --noconftest there.)"""
import numpy as np
import pytest
import torch

from hobbyraytracer_tpu_torch.core.rng import Sampler
from hobbyraytracer_tpu_torch.integrator import wavefront
from hobbyraytracer_tpu_torch.kernels import mesh_traverse as pk
from hobbyraytracer_tpu_torch.scene import build_scene, load_scene_desc

from _torch_parity import (TEAPOT, assert_find_match, cluster_tables,
                           pack_rays8, random_mesh, random_rays,
                           teapot_tables)

torch.set_num_threads(2)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


def _on(dev, *arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                 for a in arrays)


@pytest.mark.parametrize("need_uv", [False, True])
@pytest.mark.parametrize("mesh", ["teapot", "random-leaf64"])
def test_kernel_matches_plain(dev, mesh, need_uv):
    """Kernel vs plain version on the card. Built with -fmad=false, the
    kernel rounds op for op as PyTorch does, so outputs are equal, not
    only within the parity tolerances."""
    if mesh == "teapot":
        bounds8, soa, tri_id, _ = teapot_tables()
        o, d, valid = random_rays(3, 5000, spread=2.0, valid_every=2)
    else:
        bounds8, soa, tri_id, _ = cluster_tables(*random_mesh(1), leaf=64)
        o, d, valid = random_rays(4, 5000, valid_every=2)
    rays8, b8, tab, ids = _on(dev, pack_rays8(o, d, valid), bounds8, soa,
                              tri_id)
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
    big = pk.MAX_CLUSTERS + 1
    with pytest.raises(ValueError, match="cap"):
        pk.traverse_clusters(rays8, b8[:, :1].repeat(1, big),
                             tab[:1].repeat(big, 1, 1), ids[:1].repeat(big, 1))
    out, ids_out = pk.traverse_clusters(rays8[:0], b8, tab, ids)
    assert out.shape == (0, 8) and ids_out.shape == (0,)


def test_render_through_kernel_matches_plain(dev):
    """A whole render through the kernel and through the plain version with
    one seed: the images agree (the framebuffer's index_add_ uses atomics,
    so sums may differ in the last bits)."""
    job = build_scene(load_scene_desc(TEAPOT))
    scene, camera = job.scene.to(dev), job.camera.to(dev)
    pk.KERNEL.launches = 0
    imgs = [wavefront.render_image(scene, camera, 32, 32, 4,
                                   Sampler(3, dev), pool=2048,
                                   plain_mesh=plain)
            for plain in (False, True)]
    assert pk.KERNEL.launches > 0
    assert torch.isfinite(imgs[0]).all()
    torch.testing.assert_close(imgs[0], imgs[1], rtol=1e-5, atol=1e-5)
