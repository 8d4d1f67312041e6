"""The port's counterpart of the repository's __graft_entry__.py.

entry(device) -> (fn, example_args): a forward render step of the Cornell
box, fn(scene, camera, sampler) -> the (1024, 3) radiance sum of its 32x32
pixels at 2 spp, max depth 12 (integrator/path.py:sample_radiance).

dryrun_multichip(n_devices, device): one sharded fit step at 16x16 over an
n-worker mesh (parallel/shard.py: per-worker pixel slices, the gradients
summed on worker 0) and one sharded wavefront render at 16x16, 2 spp,
pool n * 64. device "cuda" puts worker i on card i; any other device
("cuda:0", "cpu") puts every worker there.

    python -m hobbyraytracer_tpu_torch.entry [--device cuda] [--workers N]
"""
from __future__ import annotations

import argparse
import os
import sys

_SCENE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "scenes", "cornell_box.yaml")


def _job():
    from .scene import build_scene, load_scene_desc
    return build_scene(load_scene_desc(_SCENE))


def entry(device="cuda"):
    """A forward render step and its example arguments on `device`."""
    from .core.rng import Sampler
    from .integrator import path as path_mod

    job = _job()

    def fn(scene, camera, sampler):
        return path_mod.sample_radiance(scene, camera, 32, 32, sampler, 2, 12)

    return fn, (job.scene.to(device), job.camera.to(device),
                Sampler(0, device))


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """One sharded differentiable fit step and one sharded wavefront render
    over an n_devices-worker mesh; raises when either goes wrong."""
    import math

    import torch

    from .core.rng import Sampler
    from .diff.fit import select_params
    from .parallel import shard

    job = _job()
    mesh = shard.make_mesh(n_devices, device)
    dev0 = mesh[0]
    scene = job.scene.to(dev0)
    camera = job.camera.to(dev0)
    w = h = 16   # 256 pixels: divisible by any small mesh
    sampler = Sampler(0, dev0)
    params, rebuild = select_params(scene)
    target = torch.zeros((w * h, 3), dtype=torch.float32, device=dev0)
    opt = torch.optim.Adam(shard._leaves(params), lr=1e-2)
    loss = shard.sharded_fit_step(params, rebuild, camera, w, h, sampler, 1,
                                  target, mesh, opt, max_depth=3)
    if not (math.isfinite(loss) and loss >= 0.0):
        raise RuntimeError(f"sharded fit step: loss {loss}")
    for p in shard._leaves(params):
        if not bool(torch.isfinite(p).all()):
            raise RuntimeError("sharded fit step: non-finite parameters")
    img = shard.render_wavefront_sharded(scene, camera, w, h, 2, sampler,
                                         mesh, max_depth=4,
                                         pool=n_devices * 64)
    if tuple(img.shape) != (h, w, 3) or not bool(torch.isfinite(img).all()):
        raise RuntimeError(f"sharded wavefront render: image {img.shape}")
    print(f"dryrun_multichip({n_devices}): ok, loss={loss:.6f}, "
          f"wavefront mean={img.mean().item():.4f}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="hobbyraytracer_tpu_torch.entry")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--workers", type=int, default=2)
    args = ap.parse_args(argv)
    fn, example = entry(args.device)
    out = fn(*example)
    print("entry() forward:", tuple(out.shape), out.mean().item())
    dryrun_multichip(args.workers, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
