#!/usr/bin/env python3
"""Time the mesh kernels K1, K2 and K3 built from several source trees, in
one process on one CUDA card, on the rays chip_smoke.py uses.

    python3 scripts/time_mesh_kernels.py [--csrc LABEL=DIR ...] [--reps 20]

Each --csrc names a directory holding mesh_traverse.cu,
mesh_traverse_stream.cu, coherence_keys.cu and mesh_traverse.cuh: another
commit's sources (git show REV:hobbyraytracer_tpu_torch/kernels/csrc/<file>
into DIR) or a variant of the design under study. The package's own
sources are always timed too, as "tree". All trees are built at once with
the package's nvcc flags (their libraries go to build/variants/LABEL), and
ptxas's registers and spills are printed for each.

Cases, all at 196,608 rays with need_uv off:
- K1 on the teapot's tables (K = 30), the pool's after-one-bounce rays
  sorted by the coherence key, and the same rays in a seeded random order;
- K2 on teapot_hires's tables (K = 822), sorted and unsorted likewise;
- K3 on teapot_hires's sorted rays.
Every tree's result must equal the plain PyTorch version's bit for bit on
each case before anything is timed. Then each case is timed for the trees
in the order given and again in reverse (A B C C B A), so that drift of
the card shows as a difference between a tree's two medians (CUDA events,
median of --reps launches each). The card's name and power limit are
printed beside the numbers.
"""
import argparse
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

NAMES = ("mesh_traverse", "mesh_traverse_stream", "coherence_keys")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--csrc", action="append", default=[],
                    metavar="LABEL=DIR")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from hobbyraytracer_tpu_torch.kernels import mesh_traverse as kmod
    from hobbyraytracer_tpu_torch.kernels.build import KernelLibrary
    from hobbyraytracer_tpu_torch.ops import intersect as isect

    if not torch.cuda.is_available():
        raise RuntimeError("time_mesh_kernels.py needs a CUDA card")
    dev = torch.device(cs.DEVICE)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(card)

    trees = {"tree": tuple(KernelLibrary(n) for n in NAMES)}
    for spec in args.csrc:
        label, _, path = spec.partition("=")
        if not path or label in trees:
            raise ValueError(f"--csrc wants a new LABEL=DIR, got {spec!r}")
        trees[label] = tuple(
            KernelLibrary(n, csrc=os.path.abspath(path), build_dir=os.path
                          .join(ROOT, "build", "variants", label))
            for n in NAMES)
    with ThreadPoolExecutor(8) as pool:
        for fut in [pool.submit(lib.load) for libs in trees.values()
                    for lib in libs]:
            fut.result()
    for label, libs in trees.items():
        for lib in libs:
            print(f"[build] {label}: {lib.source} in "
                  f"{lib.build_seconds:.2f} s")
            for line in lib.ptxas_info:
                print(f"  {line}")

    def use(label):
        kmod.KERNEL, kmod.KERNEL_STREAM, kmod.KEY_KERNEL = trees[label]

    def scene_rays(path):
        job = cs.load_scene(path)
        scene, camera = job.scene.to(dev), job.camera.to(dev)
        inst = next(i for i in scene.instances if i.kind == "mesh")
        mesh = inst.mesh
        rays8 = cs.pool_ray_sets(scene, camera, inst, lambda o, d, a: (
            isect.coherence_key(o, d, a, mesh.bounds8, 1e30)))[
                "after one bounce"]
        perm = torch.randperm(rays8.shape[0], generator=torch.Generator()
                              .manual_seed(cs.SEED)).to(dev)
        return mesh, rays8, rays8[perm].contiguous()

    cases = []
    for name, path in (("K1 teapot", cs.SCENE), ("K2 teapot_hires",
                                                 cs.HIRES)):
        mesh, rays8, shuffled = scene_rays(path)
        tabs = (mesh.bounds8, mesh.tri_soa, mesh.cluster_id)
        for order, r8 in (("sorted", rays8), ("unsorted", shuffled)):
            cases.append((
                f"{name} K = {mesh.bounds8.shape[1]}, {order}",
                lambda r8=r8, tabs=tabs: kmod.traverse_clusters(
                    r8, *tabs, need_uv=False),
                lambda r8=r8, tabs=tabs: kmod.traverse_clusters_plain(
                    r8, *tabs, need_uv=False)))
    cases.append((
        f"K3 teapot_hires K = {mesh.bounds8.shape[1]}, sorted",
        lambda r8=rays8, b8=mesh.bounds8: kmod.coherence_keys(r8, b8),
        lambda r8=rays8, b8=mesh.bounds8: kmod.coherence_keys_plain(r8, b8)))

    order = list(trees) + list(trees)[::-1]
    for name, kernel, plain in cases:
        want = plain()
        for label in trees:
            use(label)
            got = kernel()
            torch.cuda.synchronize()
            cs.check(all(torch.equal(g, w) for g, w in zip(got, want)),
                     f"{name}: {label} differs from the plain version")
        times = {label: [] for label in trees}
        for label in order:
            use(label)
            times[label].append(cs.cuda_ms(kernel, reps=args.reps))
        print(f"[{name}] {cs.POOL} rays, every tree equals the plain "
              f"version; ms, first and second pass ({card}):")
        for label, (a, b) in times.items():
            print(f"  {label:>12}: {a:.4f} {b:.4f}")
    use("tree")
    return 0


if __name__ == "__main__":
    sys.exit(main())
