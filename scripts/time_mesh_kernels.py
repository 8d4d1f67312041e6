#!/usr/bin/env python3
"""Time the kernels K1, K2, K3 and K4 built from several source trees, in
one process on one CUDA card, on the rays chip_smoke.py uses.

    python3 scripts/time_mesh_kernels.py [--csrc LABEL=DIR ...] [--reps 20]

Each --csrc names a directory holding mesh_traverse.cuh and any of
mesh_traverse.cu, mesh_traverse_stream.cu, coherence_keys.cu and
sphere_traverse.cu: another commit's sources (git show
REV:hobbyraytracer_tpu_torch/kernels/csrc/<file> into DIR) or a variant of
the design under study; a tree is timed on the cases of the kernels it
holds. The package's own sources are always timed too, as "tree". All
trees are built at once with the package's nvcc flags (their libraries go
to build/variants/LABEL), and ptxas's registers and spills are printed for
each.

Cases, all at 196,608 rays (the mesh kernels with need_uv off):
- K1 on the teapot's tables (K = 30), the pool's after-one-bounce rays
  sorted by the coherence key, and the same rays in a seeded random order;
- K2 on teapot_hires's tables (K = 822), sorted and unsorted likewise;
- K3 on teapot_hires's sorted rays;
- K4 on scattered_balls's sphere tables (K = 4), the pool's
  after-one-bounce rays in pool order (the sphere find does not sort) and
  in a seeded random order; and on chip_smoke.py's two random sphere pools
  (5,000 spheres in 128-sphere leaves, K = 64; 3,000 in 16-sphere leaves,
  K = 256) with random rays.
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

NAMES = ("mesh_traverse", "mesh_traverse_stream", "coherence_keys",
         "sphere_traverse")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--csrc", action="append", default=[],
                    metavar="LABEL=DIR")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from hobbyraytracer_tpu_torch.kernels import mesh_traverse as kmod
    from hobbyraytracer_tpu_torch.kernels import sphere_traverse as skmod
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

    trees = {"tree": {n: KernelLibrary(n) for n in NAMES}}
    for spec in args.csrc:
        label, _, path = spec.partition("=")
        if not path or label in trees:
            raise ValueError(f"--csrc wants a new LABEL=DIR, got {spec!r}")
        path = os.path.abspath(path)
        trees[label] = {
            n: KernelLibrary(n, csrc=path, build_dir=os.path.join(
                ROOT, "build", "variants", label))
            for n in NAMES if os.path.exists(os.path.join(path, f"{n}.cu"))}
        if not trees[label]:
            raise ValueError(f"{path} holds none of the kernels' sources")
    with ThreadPoolExecutor(8) as pool:
        for fut in [pool.submit(lib.load) for libs in trees.values()
                    for lib in libs.values()]:
            fut.result()
    for label, libs in trees.items():
        for lib in libs.values():
            print(f"[build] {label}: {lib.source} in "
                  f"{lib.build_seconds:.2f} s")
            for line in lib.ptxas_info:
                print(f"  {line}")

    def use(label):
        libs = dict(trees["tree"], **trees[label])
        kmod.KERNEL, kmod.KERNEL_STREAM, kmod.KEY_KERNEL = (
            libs[n] for n in NAMES[:3])
        skmod.SPHERE_KERNEL = libs[NAMES[3]]

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
                NAMES[0] if name.startswith("K1") else NAMES[1],
                lambda r8=r8, tabs=tabs: kmod.traverse_clusters(
                    r8, *tabs, need_uv=False),
                lambda r8=r8, tabs=tabs: kmod.traverse_clusters_plain(
                    r8, *tabs, need_uv=False)))
    cases.append((
        f"K3 teapot_hires K = {mesh.bounds8.shape[1]}, sorted", NAMES[2],
        lambda r8=rays8, b8=mesh.bounds8: kmod.coherence_keys(r8, b8),
        lambda r8=rays8, b8=mesh.bounds8: kmod.coherence_keys_plain(r8, b8)))

    def sphere_case(name, r8, tabs):
        cases.append((
            name, NAMES[3],
            lambda: skmod.intersect_spheres_kernel(r8, *tabs, cs.T_MIN),
            lambda: skmod.intersect_spheres_plain(r8, *tabs, cs.T_MIN)))

    job = cs.load_scene(cs.BALLS)
    scene = job.scene.to(dev)
    sp = scene.spheres
    tabs = (sp.kernel_bounds, sp.kernel_table, sp.kernel_ids)
    rays8 = cs.pool_ray_sets(scene, job.camera.to(dev))["after one bounce"]
    perm = torch.randperm(rays8.shape[0], generator=torch.Generator()
                          .manual_seed(cs.SEED)).to(dev)
    k_balls = tabs[0].shape[1]
    sphere_case(f"K4 balls K = {k_balls}, pool order", rays8, tabs)
    sphere_case(f"K4 balls K = {k_balls}, random order",
                rays8[perm].contiguous(), tabs)
    for n_spheres, leaf in cs.SPHERE_POOLS:
        tabs = tuple(torch.from_numpy(x).to(dev) for x in
                     cs.random_sphere_tables(cs.SEED + 6, n_spheres, leaf))
        sphere_case(f"K4 random {n_spheres} spheres K = {tabs[0].shape[1]}, "
                    f"L = {leaf}",
                    cs.random_rays8(cs.SEED + 7, cs.POOL,
                                    cs.SPHERE_RAY_SPREAD).to(dev), tabs)

    for name, lib, kernel, plain in cases:
        want = plain()
        labels = [label for label in trees if lib in trees[label]]
        for label in labels:
            use(label)
            got = kernel()
            torch.cuda.synchronize()
            cs.check(all(torch.equal(g, w) for g, w in zip(got, want)),
                     f"{name}: {label} differs from the plain version")
        times = {label: [] for label in labels}
        for label in labels + labels[::-1]:
            use(label)
            times[label].append(cs.cuda_ms(kernel, reps=args.reps))
        print(f"[{name}] {want[0].shape[0]} rays, every tree equals the "
              f"plain version; ms, first and second pass ({card}):")
        for label, (a, b) in times.items():
            print(f"  {label:>12}: {a:.4f} {b:.4f}")
    use("tree")
    return 0


if __name__ == "__main__":
    sys.exit(main())
