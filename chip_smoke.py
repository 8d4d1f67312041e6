#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Drives the port's main path (hobbyraytracer_tpu_torch, never JAX) on the
card, in phases that each raise on failure (non-zero exit, no result line):

1. require CUDA; print the card's name and power limit (nvidia-smi) and
   turn TF32 off;
2. build the mesh traversal kernel from kernels/csrc and time the build;
3. hold the kernel against its plain PyTorch version on the teapot scene's
   own tables (K = 30 clusters) at the main path's shape: 196,608 rays of
   the pool's first segments (camera rays, then bounce rays), coherence-
   sorted as the main path sorts them, with need_uv off and on; time both
   versions with CUDA events;
4. render scenes/teapot_scene.yaml at 640x640, 16 spp, pool 196,608, max
   depth 50 with Russian roulette, through the function the CLI calls;
   check the image, the kernel's launch count in that render, that every
   sample retired, and the tonemapped mean against a JAX CPU render;
5. render 64x64 at 8 spp twice with one seed, through the kernel and with
   the mesh find forced to the plain version, and compare per pixel.

The second-to-last line is a JSON object with the kernel's numbers; the
last line is {"ok": true, "device": {...}}.
"""
import json
import statistics
import subprocess
import sys
import time

SCENE = "scenes/teapot_scene.yaml"
DEVICE = "cuda:0"
WIDTH = HEIGHT = 640
SPP = 16
POOL = 196_608
SEED = 0
# Tonemapped image mean of the same scene rendered by the JAX package on
# the CPU (hobbyraytracer_tpu.integrator.wavefront.render_image, 16 spp,
# max depth 50, RR on, pool 196,608), seeds 0 and 1 at 64x64 and 96x96:
# 0.34673, 0.34347, 0.34502, 0.34014; their mean is 0.3438. The band
# allows 5% for the 640x640 resolution and sampling noise.
JAX_CPU_MEAN = 0.3438
MEAN_BAND = 0.05
T_RTOL = 1e-5
T_ATOL = 1e-6


def check(ok, msg):
    if not ok:
        raise RuntimeError(msg)


def cuda_ms(fn, reps=10, warmup=3):
    """Median milliseconds of fn() over `reps` runs, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def compare(out_k, id_k, out_p, id_p, need_uv, label):
    """Kernel vs plain: hit masks equal, t within rtol, ids differing on
    < 1% of hits (ties only), normals cos > 0.999 (and uv within 1e-5 with
    need_uv) where the ids agree. Returns the max abs error over t, normal
    and uv of hits whose ids agree."""
    import torch
    hit_k = out_k[:, 0] < 1e30
    hit_p = out_p[:, 0] < 1e30
    n_hit = int(hit_p.sum())
    check(n_hit > 0, f"{label}: no ray hit the mesh")
    check(bool(torch.equal(hit_k, hit_p)),
          f"{label}: hit masks differ on {int((hit_k != hit_p).sum())} rays")
    tk, tp = out_k[hit_p, 0], out_p[hit_p, 0]
    t_ok = (tk - tp).abs() <= T_ATOL + T_RTOL * tp.abs()
    check(bool(t_ok.all()), f"{label}: t off on {int((~t_ok).sum())} hits")
    same = (id_k == id_p) & hit_p
    id_diff = 1.0 - int(same.sum()) / n_hit
    check(id_diff < 0.01, f"{label}: ids differ on {id_diff:.4%} of hits")
    nk, np_ = out_k[same, 1:4], out_p[same, 1:4]
    cos = (nk * np_).sum(1) / (nk.norm(dim=1) * np_.norm(dim=1)).clamp(
        min=1e-12)
    check(bool((cos > 0.999).all()),
          f"{label}: normals off on {int((cos <= 0.999).sum())} hits")
    err = (out_k[same, 0:6] - out_p[same, 0:6]).abs().max().item()
    if need_uv:
        uv_err = (out_k[same, 4:6] - out_p[same, 4:6]).abs().max().item()
        check(uv_err <= 1e-5, f"{label}: uv error {uv_err}")
    print(f"  {label}: {len(id_k)} rays, {n_hit} hits, masks equal, "
          f"ids differ on {id_diff:.4%} of hits, max abs err {err:.3g}")
    return err


def main():
    import torch
    # 1. the card
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: chip_smoke.py needs a GPU")
    from hobbyraytracer_tpu_torch.core.rng import Sampler
    from hobbyraytracer_tpu_torch.core.types import Rays
    from hobbyraytracer_tpu_torch.integrator import wavefront
    from hobbyraytracer_tpu_torch.ops.intersect import cheap_key_from_box
    from hobbyraytracer_tpu_torch.kernels import mesh_traverse as kmod
    from hobbyraytracer_tpu_torch.scene import build_scene, load_scene_desc

    dev = torch.device(DEVICE)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    # 2. build the kernel from the checkout's sources
    kmod.KERNEL.build()
    kmod.KERNEL.load()
    print(f"[build] {kmod.KERNEL.source} -> {kmod.KERNEL.path} in "
          f"{kmod.KERNEL.build_seconds:.2f} s")

    # 3. kernel vs plain at the main path's shape
    job = build_scene(load_scene_desc(SCENE))
    scene = job.scene.to(dev)
    camera = job.camera.to(dev)
    inst = next(i for i in scene.instances if i.kind == "mesh")
    mesh = inst.mesh
    k_clusters = mesh.bounds8.shape[1]
    print(f"[kernel] teapot tables: K = {k_clusters}, tri_soa "
          f"{tuple(mesh.tri_soa.shape)}")
    _, n_chunks, _ = wavefront._chunk_geometry(SPP, wavefront.SAMPLE_CHUNK)
    total_items = WIDTH * HEIGHT * n_chunks
    pool = min(POOL, total_items)
    sampler = Sampler(SEED, dev)
    state = wavefront.init_state(WIDTH, HEIGHT, pool, device=dev)
    # start the queue at the lower image rows, which see the teapot (the
    # first 196,608 items are the top rows, above it)
    state.counter.fill_(WIDTH * HEIGHT - pool)

    def mesh_rays(st):
        """The pool's rays in mesh space, packed and coherence-sorted as
        intersect_mesh_clustered_fused feeds the kernel."""
        active = (st.item >= 0) & (st.depth >= 0) & ~st.defer
        r = inst.transform.ray_to_object(Rays(o=st.o, d=st.d))
        rays8 = torch.cat([r.o, r.d, active.float()[:, None],
                           torch.zeros_like(r.o[:, :1])], dim=1)
        key = cheap_key_from_box(
            r.o, r.d, active, mesh.bounds8[:3].min(dim=1).values,
            mesh.bounds8[3:6].max(dim=1).values, 1e30)
        return rays8[torch.argsort(key, stable=True)].contiguous()

    wavefront._regenerate(state, camera, WIDTH, HEIGHT, total_items,
                          sampler)
    sets = {"camera rays": mesh_rays(state)}
    wavefront._segment(state, scene, WIDTH, HEIGHT, sampler, 50, SPP)
    wavefront._regenerate(state, camera, WIDTH, HEIGHT, total_items,
                          sampler)
    sets["after one bounce"] = mesh_rays(state)
    args = (mesh.bounds8, mesh.tri_soa, mesh.cluster_id)
    max_err = 0.0
    for label, rays8 in sets.items():
        check(rays8.shape[0] == POOL, f"{label}: {rays8.shape[0]} rays")
        for need_uv in (False, True):
            out_k, id_k = kmod.traverse_clusters(rays8, *args,
                                                 need_uv=need_uv)
            out_p, id_p = kmod.traverse_clusters_plain(rays8, *args,
                                                       need_uv=need_uv)
            torch.cuda.synchronize()
            max_err = max(max_err, compare(out_k, id_k, out_p, id_p, need_uv,
                                           f"{label}, need_uv={need_uv}"))
    rays8 = sets["after one bounce"]
    times = {}
    for need_uv in (False, True):
        times[need_uv] = (
            cuda_ms(lambda: kmod.traverse_clusters(rays8, *args,
                                                   need_uv=need_uv)),
            cuda_ms(lambda: kmod.traverse_clusters_plain(
                rays8, *args, need_uv=need_uv), reps=5, warmup=1))
        print(f"[kernel] need_uv={need_uv}: kernel {times[need_uv][0]:.4f} "
              f"ms, plain {times[need_uv][1]:.4f} ms "
              f"({POOL} rays, K = {k_clusters}; {card})")

    # 4. the main path: a 640x640, 16 spp render
    wavefront.render_image(scene, camera, 64, 64, 4, Sampler(SEED, dev),
                           pool=POOL)  # warm-up
    torch.cuda.synchronize()
    seen = []
    kmod.KERNEL.launches = 0
    t0 = time.perf_counter()
    img = wavefront.render_image(
        scene, camera, WIDTH, HEIGHT, SPP, Sampler(SEED, dev), max_depth=50,
        pool=POOL, progress_cb=lambda r, t: seen.append((r, t)), rr=True)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = kmod.KERNEL.launches
    check(tuple(img.shape) == (HEIGHT, WIDTH, 3), f"image {img.shape}")
    check(bool(torch.isfinite(img).all()), "render has non-finite pixels")
    check(launches > 0, "the render never launched the mesh kernel")
    retired, total = seen[-1]
    check(retired == total == WIDTH * HEIGHT * SPP,
          f"retired {retired} of {WIDTH * HEIGHT * SPP} samples")
    mean = img.mean().item()
    check(abs(mean - JAX_CPU_MEAN) <= MEAN_BAND * JAX_CPU_MEAN,
          f"image mean {mean:.5f} outside {JAX_CPU_MEAN} +- {MEAN_BAND:.0%}")
    rays_per_s = WIDTH * HEIGHT * SPP / seconds
    print(f"[render] {WIDTH}x{HEIGHT} @ {SPP} spp, pool {pool}: "
          f"{seconds:.3f} s, {rays_per_s:,.0f} primary rays/s, kernel "
          f"launches {launches}, retired {retired}/{total}, mean "
          f"{mean:.5f} (JAX CPU {JAX_CPU_MEAN}) on {card}")

    # 5. the whole render through the kernel vs through the plain version
    imgs = [wavefront.render_image(scene, camera, 64, 64, 8,
                                   Sampler(SEED + 1, dev), pool=POOL,
                                   plain_mesh=plain)
            for plain in (False, True)]
    diff = (imgs[0] - imgs[1]).abs().amax(dim=2)
    agree = (diff < 1e-3).float().mean().item()
    print(f"[agreement] 64x64 @ 8 spp, kernel vs plain mesh find: "
          f"{agree:.4%} of pixels within 1e-3, max diff "
          f"{diff.max().item():.3g}")
    check(agree >= 0.99, f"only {agree:.4%} of pixels agree")

    print(json.dumps({"kernels": [{
        "name": "mesh_traverse", "route": "cuda",
        "source": "hobbyraytracer_tpu_torch/kernels/csrc/mesh_traverse.cu",
        "replaces": "hobbyraytracer_tpu/kernels/mesh_traverse.py:298",
        "launches": launches, "max_abs_err": max_err,
        "ms": times[False][0], "plain_ms": times[False][1]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
