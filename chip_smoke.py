#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Drives the port's paths (hobbyraytracer_tpu_torch, never JAX) on the card,
in phases that each raise on failure (non-zero exit, no result line):

1. require CUDA; print the card's name and power limit (nvidia-smi) and
   turn TF32 off;
2. (and a) build the six kernels from kernels/csrc at once, one nvcc
   each -- K1 mesh_traverse, K2 mesh_traverse_stream, K3 coherence_keys,
   K4 sphere_traverse, sphere_scan (the dense sphere scan) and threefry
   (the port's draws) -- and print each build's time and ptxas's
   registers and spills (K3, K4 and sphere_scan must not spill); require
   the native cluster build (the reference's), print its library, and
   hold both scenes' cluster tables against their pinned digests;
3. hold K1 against its plain PyTorch version on the teapot scene's own
   tables (K = 30 clusters) at the main path's shape: 196,608 rays of the
   pool's first segments (camera rays, then bounce rays), coherence-sorted
   as the main path sorts them, with need_uv off and on, and the same rays
   in a seeded random order, bitwise; time both versions with CUDA events,
   the kernel on the unsorted rays too;
4. render scenes/teapot_scene.yaml at 640x640, 16 spp, pool 196,608, max
   depth 50 with Russian roulette, through the function the CLI calls
   (the first block eager, every later one replayed from a CUDA graph);
   check the image, K1's and threefry's launch counts in that render, that
   every sample retired, and the tonemapped mean against a JAX CPU render;
5. render the teapot 64x64 at 8 spp twice with one seed, through the kernel
   and with the mesh find forced to the plain version, and compare;
b. hold K2 against its plain version on teapot_hires's own 32-row tables
   (K = 822) at 196,608 camera and after-one-bounce rays, sorted by the
   corridor key as the main path sorts them, and in a seeded random order,
   need_uv off and on: hit masks, ids, t, normals and uv bitwise equal;
   time both, the kernel on the unsorted rays too;
c. K2 against K1 bitwise, and both against the plain version, on the first
   40,000 triangles of teapot_hires (K = 313, past K1's old cap of 256) in
   the 24-row and 32-row layouts;
d. hold K3 against its plain version on phase b's rays: e_min and first
   exactly equal; time both;
e. render scenes/teapot_hires.yaml at 640x640, 16 spp, pool 196,608, max
   depth 50 with Russian roulette, through the function the CLI calls:
   every sample retired, a finite image, K2 launched and K1 not, the
   tonemapped mean against a JAX CPU render; rays/s;
f. render teapot_hires 64x64 at 8 spp with HRT_KEY_MODE "auto" and then
   "pallas" (set in-process): K3 launched in the second render, and the
   two images equal per pixel;
g. hold K4 against its plain version on scenes/scattered_balls.yaml's own
   sphere tables (485 spheres, K = 4) at 196,608 camera and
   after-one-bounce rays, in pool order (the sphere find does not sort)
   and in a seeded random order: t and ids bitwise equal; time both, the
   kernel on the random order too, and the dense route beside them; then
   sphere_scan against the chunked scan it fuses on the same pool rays: t
   and winners bitwise equal; the median of 10 CUDA-event timings of the
   kernel, the plain scan's, and the dense route's with its hit records;
h. K4's route against the dense route (intersect_spheres_clustered vs
   intersect_spheres) on the same rays: hit masks and materials equal but
   for counted grazing rays, hit points and normals within tolerance;
i. render scattered_balls at 640x640, 16 spp, pool 196,608, max depth 50
   with Russian roulette, by the default route (the dense scan: sphere_scan
   once a segment, K4 never) and with SPHERE_KERNEL on (K4 launched,
   sphere_scan and K1-K3 not): every sample retired, finite images, the
   tonemapped mean against a JAX CPU render; rays/s of both;
j. render the balls 64x64 at 8 spp through K4 and with the sphere find
   forced to the plain version, and compare;
k. hold K1 and K2 against the plain version, bitwise, on a random mesh of
   20,000 triangles in 8-triangle leaves (K = 2,500, boxes read from global
   memory) and 65,536 random rays, of which a counted number (at least
   1,000) enter more clusters than the kernels' window of pending visits
   holds, so they use a full window up and scan again;
l. hold K4 against its plain version, bitwise, on two random sphere pools
   (5,000 spheres in 128-sphere leaves, 3,000 in 16-sphere leaves) whose K
   exceeds the window, with 65,536 random rays of which a counted number
   (at least 1,000) refill their window; and K3 against its plain version
   on phase b's rays with a K that is not a multiple of 4 (the first 821
   boxes) and at phase k's K = 2,500 (boxes read from global memory), with
   a counted number of rays (at least 1,000) whose smallest entry is
   shared by two or more clusters;
m. render scenes/two_teapots.yaml (two transformed instances of the
   teapot, so K1 launches twice a segment) at 640x640, 16 spp, pool
   196,608, max depth 50 with Russian roulette, by the default route (each
   mesh find sorts its rays) and with pool_sort=2 (the whole pool permuted
   every second segment, the mesh finds told cohsort=False): every sample
   retired, finite images, the tonemapped mean against a JAX CPU render,
   K1 launched exactly twice a segment and no other kernel; rays/s of both;
n. K1 on a mid-render two_teapots pool after the pool permute, each mesh
   found with cohsort=False: bitwise equal to the plain version on the same
   rays, and lane for lane to the call that sorts per mesh;
o. the lockstep find (ops/intersect.py:intersect_mesh_clustered, plain
   PyTorch by design) on the card against K1 on the teapot's
   after-one-bounce rays: hit masks equal, t within 1e-6, under 1% of ids
   differing; its time beside K1's;
p. render scenes/cornell_smoke.yaml (two box media, a glass sphere) at its
   own 256x256, 64 spp: every sample retired, finite, no traversal kernel
   launched and sphere_scan (the glass sphere's find) once a segment,
   the tonemapped mean against a JAX CPU render; then a scene built here
   with the teapot mesh as a medium's boundary, for a few segments at the
   full pool: finite, and the medium scatters a counted number of rays;
q. the batch integrator (integrator/path.py:radiance_sum, which
   render_image, render_sharded, the CLI's `--integrator batch` and `bench`
   call): the teapot at 640x640 @ 16 spp, depth 50, in the CLI's chunks of
   4 samples, by both routes in turns (eager, graph, eager, graph; eager
   runs BatchRun's steps without graphs) under deterministic algorithms:
   the radiance sums bitwise equal, K1's and threefry's launches equal,
   ceil(50 / B) + 2 graphs captured a graph render (B = BOUNCE_BLOCK), the
   tonemapped mean against a JAX CPU batch render; rays/s, ms a bounce,
   the captures' ms and the peak memory of each; then under one profiler
   a sample (ProfiledWindows) the launches the card ran against the
   counters, and the busy time and idle share by route; K1 against its
   plain version on the 409,600 rays of a batch sample's second bounce, as
   the find gives them; at 96x96 @ 3 spp graph = eager bitwise with launches
   equal for cornell_smoke (draws of five folds after the key slot), the
   balls through K4 and teapot_hires through K2, the teapot also against
   `trace`'s per-bounce loop and render_sharded over two workers on the
   card against one;
r. refresh_kernel_tables (what a vertex fit runs every step) on the card:
   the teapot's 24-row and teapot_hires's 32-row tables, refreshed at the
   build's vertices, equal the CPU refresh byte for byte; with the vertices
   moved by (0.6, -0.4, 0.5), K1 and K2 over the refreshed tables and the
   lockstep find over the moved vertices agree on 196,608 pool rays: hit
   masks, ids and t equal;
s. the fit's gradients on scenes/shiny_teapot.yaml at the CLI's size (the
   1920x1080 film / 8: 240x135) @ 4 spp, depth 6: render_loss and its
   backward through "kernel_replay" (K1 finds, the replay carries the
   gradients), timed, with K1's launches held to spp * (3 * depth - 1),
   the count predicted from the checkpoints (fit_launches); the same with
   the find forced to K1's plain version, material gradients bitwise equal;
   a vertex fit (bilinear lookups, the mesh moved) through the refreshed
   tables against "lockstep" within VERTEX_RTOL; a teapot_hires vertex-fit
   step through K2, its launches held to the same count;
t. the CLI's fit (cli/main.py:fit_demo) at its defaults, 30 Adam steps,
   by its default route (through the CUDA graph): the final loss below the
   first; the median ms a step, K1's launches and the peak memory;
u. one loss and backward at the film's full 1920x1080 @ 1 spp, depth 6:
   finite gradients; the peak memory beside the checkpoints' prediction;
v. one boundary=True vertex-fit step at 64x36: a finite, non-zero vertex
   gradient (the edge-sampled term's: nearest-neighbour lookups give the
   shading chain none);
w. checkpoint/resume on the main path (the teapot 640x640 @ 16 spp, pool
   196,608, depth 50, RR) under torch.use_deterministic_algorithms: the
   render stopped at its first checkpoint (checkpoint_cb after the first
   block), written by io/checkpoint.py:save_state, loaded onto the card
   and resumed equals the uninterrupted render bit for bit (fb, retired,
   it), K1 launched; the file's size and the save and load ms;
x. the CLI (`render --checkpoint --checkpoint-every 2`) at shiny_teapot's
   full 1920x1080 film @ 100 spp, killed once its checkpoint holds
   0 < retired < total, then `--resume`: rc 0, "Resumed checkpoint", the
   PNG's mean against a JAX CPU render;
y. parallel/shard.py:render_wavefront_sharded of the teapot (640x640 @ 16
   spp, pool 196,608) over two workers on the one card: every sample
   retired, the mean against the JAX CPU render, K1 once a segment of
   each worker and no other kernel, rays/s; a stacked mid-render
   checkpoint resumed bit for bit; two processes on the card (gloo, one
   worker each, this script run with --dist-worker) at 256x256 equal bit
   for bit to the in-process two-worker render;
z. the sharded fit at the CLI's size (240x135 @ 4 spp, depth 6) over two
   workers: render_linear_slice bitwise the rows of render_linear (the two
   halves and an unaligned slice); loss within rtol 1e-6 and material
   gradients within rtol 1e-5
   of the single-device ones, K1 launched 2 x fit_launches, three steps
   descend; ms a step beside one worker's;
aa. the long tail: a scene written here (long_tail_scene: the teapot
   scene's walls, light and environment, the teapot read from a binary
   little-endian PLY written from assets/teapot.obj, the back wall
   textured by a checker PNG written by the port's writer, the thin lens
   on at aperture 0.2) rendered at 640x640, 16 spp, pool 196,608, max
   depth 50 with Russian roulette through the function the CLI calls:
   the PLY's cluster tables equal the pinned digest (the JAX package's
   build of the same PLY), the texture's lookups on the card equal the
   host's and none is debug cyan, every sample retired, a finite image,
   K1 once a segment and no other kernel, the tonemapped mean against a
   JAX CPU render of the same files; the image written as TGA and BMP and
   read back equal;
bb. `cli/main.py bench` at its defaults (the teapot 640x640 @ 100 spp,
   three repeats) in a process of its own: its JSON line, printed on a
   line of this script's;
cc. procgen's teapot_hires and fixtures.ensure_assets written into a
   temporary directory: byte for byte the repository's assets/;
dd. (run after m) the graph route: threefry.cu against its plain version
   bit for bit (bits and uniforms; 1 to 196,608 elements at counter
   offsets, the key words as host values and in a key slot on the card,
   with and without a device iteration, with 0 to 6 folds after it), timed
   at the pool's 196,608 lanes beside torch.rand and at the batch route's
   longest draw (slot words, 5 folds, 409,600 lanes); teapot,
   teapot_hires (and again with HRT_KEY_MODE "pallas": K3), scattered_balls
   through K4 and two_teapots rendered at 640x640 @ 16 spp eagerly
   (kernels/build.py:eager) and through the CUDA graph under
   torch.use_deterministic_algorithms: framebuffers, `it` and every
   kernel's launch count equal, and over five replayed blocks, a
   profiler each, each kernel's launches as torch.profiler saw them run
   never above its counters' increase and equal to it in two blocks at
   least (CUPTI loses records now and then: ProfiledWindows); then the teapot eager and through the
   graph in turns (eager, graph, eager, graph): rays/s and wall ms a
   segment, and under torch.profiler the device's busy time and idle
   share of one render each way.
ee. (run after v) the fit through its CUDA graph (diff/fit.py:
   fit_materials on a card: step 0 eager, step 1 captured and replayed,
   every later step replayed) against eager() under
   torch.use_deterministic_algorithms: the CLI's fit at its defaults (30
   steps; losses, fitted materials and every kernel's launches equal, and
   over the replayed steps 2-11, a profiler each, each kernel's launches
   as torch.profiler saw them never above its counters' increase and
   equal to it in two steps at least), the teapot_hires vertex fit
   through K2 (3 steps) and two steps of the full 1920x1080 film @ 1 spp
   (the second replayed; the peak memory of each route), all bitwise
   equal; then the CLI's fit by each route in turns (eager, graph, eager,
   graph; 12 steps): median ms a step from step 4 on, the capture's ms,
   device busy ms and idle share under torch.profiler over steps 2-3, and
   the material gathers' backward a step by ops/shade.py:rows
   (index_select) against the table[mid] it replaced.
Beside phase c, K1 and K2 are timed on one mesh packed both ways (the
teapot, and teapot_hires's 32-row table with its first 24 rows as K1's):
bitwise equal, timed in turns.

A line `[time] phase X starts at N s` gives the command's clock as each
phase starts. A line `[fit numbers] {...}` holds phases s-u's numbers, a
line `[fit graph numbers] {...}` phase ee's, a line
`[checkpoint and workers numbers] {...}` those of phases w-z, a line
`[long tail numbers] {...}` those of phases aa-cc, a line `[graph
numbers] {...}` those of phase dd, a line `[batch numbers] {...}` those
of phase q. A render's segments are the iterations
it issued (each block's, the replayed ones included). The
second-to-last line is a JSON object with each kernel's numbers: its
launches in its path's render (K1: the two_teapots render by the default
route, K2: teapot_hires's, with their counts on the other paths, the fit's,
the two workers' and the batch integrator's among them, under
`launches_by_path`), its
time and its plain version's at 196,608 rays, and `bound_ms`, the least time the card could take for the same work
(the larger of its bytes over 3.35 TB/s and its operations over 67 TFLOP/s
of float32; the operations are those this run's rays need: one scan of the
K slab tests per ray and one leaf test for every cluster a ray enters
before its final hit), and `issue_bound_ms`, the same operations at one
an instruction over the SMs x 128 lanes x the card's maximum SM clock: what
code built without FMA contraction, as these kernels are so as to equal
their plain versions, can reach. No single PyTorch call computes any of the
five functions, so `library_ms` is null. The sphere_scan row replaces no
Pallas kernel (the JAX package leaves its dense scan to XLA): its
`launches` are the balls render's by the default route (phase i), its
plain time the chunked scan's, and its operations SCAN_OPS a ray and
sphere. The threefry row replaces no Pallas kernel (jax.random is XLA):
its `launches` are the teapot render's (phase 4), its times are device
time a call over 100 calls under
torch.profiler (CUDA events around one call of a few-microsecond kernel
time the host), its bound counts 79 integer operations a threefry2x32,
one an element and 11 more, and one for the device iteration's fold (the
key is the draw's, not the element's), at the float32 rate of 67 TFLOP/s
(no integer peak is taken), and its `library_ms` is torch.rand on the
same shape, which draws other bits; `batch_draw_ms` and
`batch_draw_bound_ms` are the same for the batch route's longest draw
(slot words and five folds, 409,600 uniforms: one threefry2x32 an element
and five for the key).
The last line is {"ok": true, "device": {...}}.
"""
import hashlib
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

SCENE = "scenes/teapot_scene.yaml"
HIRES = "scenes/teapot_hires.yaml"
BALLS = "scenes/scattered_balls.yaml"
TWO = "scenes/two_teapots.yaml"
SMOKE = "scenes/cornell_smoke.yaml"
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
# The same for scenes/teapot_hires.yaml (JAX CPU mesh find, same settings):
# seeds 0 and 1 at 64x64 and 96x96 and seeds 2 and 3 at 160x160 gave
# 0.34658, 0.34339, 0.34447, 0.33986, 0.34246, 0.34334; their mean is
# 0.3434.
JAX_CPU_MEAN_HIRES = 0.3434
# The same for scenes/scattered_balls.yaml on a square image (JAX CPU, the
# dense sphere scan, same settings). The mean falls a little as the image
# grows: seeds 0 and 1 gave 0.63269, 0.63291 at 64x64 and 0.62756, 0.62733
# at 96x96, seed 2 0.62415 at 128x128, and seeds 3, 4, 5 gave 0.62090,
# 0.61945, 0.61820 at 192x192, 256x256 and 320x320; the mean of those last
# three is 0.6195.
JAX_CPU_MEAN_BALLS = 0.6195
# The same for scenes/two_teapots.yaml (scripts/jax_cpu_means.py, JAX CPU
# mesh find, same settings): seeds 0 and 1 at 64x64 and 96x96 and seed 2 at
# 128x128 gave 0.32589, 0.32270, 0.32568, 0.32152, 0.32290; their mean is
# 0.3237.
JAX_CPU_MEAN_TWO = 0.3237
# The same for scenes/cornell_smoke.yaml at its own 64 spp (max depth 50,
# RR on, pool 196,608): seeds 0 and 1 at 64x64, seed 0 at 96x96, seed 1 at
# 128x128 and seed 2 at the scene's 256x256 gave 0.46916, 0.46627, 0.46909,
# 0.46966, 0.47167; their mean is 0.4692.
JAX_CPU_MEAN_SMOKE = 0.4692
# The same for scenes/shiny_teapot.yaml at its own 100 spp (the JAX CPU mesh
# find, max depth 50, RR on, pool 196,608; square images of the scene's
# 16:9 camera). The mean falls a little as the image grows: seeds 0-2 gave
# 0.51828, 0.51866 at 64x64 and 0.51756 at 96x96, and seeds 3, 4, 5 gave
# 0.51499, 0.51278, 0.51166 at 128x128, 192x192 and 256x256; the mean of
# those last three is 0.5131 (phase x's resumed 1920x1080 render is held
# to it).
JAX_CPU_MEAN_SHINY = 0.5131
# The same for phase aa's long-tail scene with the lens on
# (scripts/jax_cpu_means.py long-tail, which writes the scene's files with
# this script's own helpers; 16 spp, max depth 50, RR on, pool 196,608):
# seeds 0 and 1 at 64x64 and 96x96, then seeds 2, 3, 4 at 128x128, 192x192
# and 256x256 gave 0.33374, 0.33285, 0.33266, 0.32838, 0.33038, 0.33124,
# 0.32982; their mean is 0.3313.
JAX_CPU_MEAN_LONG_TAIL = 0.3313
MEAN_BAND = 0.05
# phase y: the size of the two-process render on the one card
DIST_SIZE = 256
# phase p: the mesh-boundary medium scene (the teapot room with the teapot
# as a fog's boundary), its segments, and the fewest rays the fog must
# scatter over them
FOG_SEGMENTS = 4
FOG_MIN_HITS = 1_000
FOG_SCENE = """
film: {{width: 640, height: 640, samples: 16, output: fog.png}}
camera:
    position: [0, 2.5, 8.5]
    look_at: [0, 2.5, 0]
    up: [0, 1, 0]
    fov: 45
    aperture: 0.001
    focal_distance: 8.5
    background: [0.6, 0.7, 0.9]
materials:
  - {{name: white, type: lambertian, albedo: [0.73, 0.73, 0.73]}}
  - {{name: light, type: diffuse_light, albedo: [0.93, 0.75, 0.43],
     strength: 4.5}}
objects:
  - {{type: xz_rect, x: [-2.5, 2.5], z: [-2.5, 2.5], k: 0, material: white}}
  - {{type: xz_rect, x: [-1, 1], z: [-1, 1], k: 4.99, material: light}}
  - type: constant_medium
    density: 2.0
    albedo: [0.9, 0.9, 0.9]
    boundary: {{type: mesh, path: {obj}}}
    transform:
        rotate: [0, 180, 0]
        translate: [0, 1, 0]
        scale: [0.45, 0.45, 0.45]
"""
# phase q, the batch integrator (integrator/path.py) at the main path's
# size: max depth 50, no Russian roulette, the CLI's chunks of 2,000,000 //
# (W * H) samples. Its tonemapped mean is held to the JAX package's batch
# render on the CPU (scripts/jax_cpu_means.py scenes/teapot_scene.yaml
# --integrator batch --spp 16 --runs 64:0 64:1 96:0 96:1 128:2 192:3
# 256:4): 0.35405, 0.34774, 0.34782, 0.34953, 0.34630, 0.34772, 0.34797;
# their mean is 0.3487.
BATCH_CHUNK = 2_000_000 // (WIDTH * HEIGHT)
JAX_CPU_MEAN_BATCH = 0.3487
# the reduced-size batch renders, graph against eager: size, spp, chunk
BATCH_SMALL = (96, 3, 2)
# the samples of the teapot's profiled graph render under a profiler of
# their own (samples BATCH_WINDOWS[0] .. BATCH_WINDOWS[1] - 1 of 16), and
# of its profiled eager render (which stops after them: its samples each
# take the eager route's ~0.6-1 s). Five eager windows: the profiler lost
# threefry records in 2 of 3 (~40,000 kernels and ~1 s a window), leaving
# one exact window where the rule needs two
BATCH_WINDOWS = (6, 10)
BATCH_EAGER_WINDOWS = (6, 11)
# Published peaks of one H100 SXM (NVIDIA's data sheet): HBM bytes/s and
# float32 operations/s outside the tensor cores, for `bound_ms`
# phase dd: threefry draws held against the plain version, (elements,
# counter offset) each, the last the batch route's 409,600 lanes; the
# operations of one threefry2x32 (2 xor and 2 adds of the key schedule, 20
# rounds of add, funnel-shift rotate and xor, 5 key injections of 3 adds)
# and of the rest of an element (its counter, bits and float)
TF_DRAWS = ((POOL, 0), (1, 0), (4097, 12_345), (POOL, 3 * POOL),
            (WIDTH * HEIGHT, 0))
# the folds after the iteration: none, the wavefront's scatter (3 and 4),
# the batch route's isotropic scatter from a key slot (5: split, purpose,
# bounce, in_ball's two splits) and the kernel's most (6)
TF_PATHS = ((), (6, 0, 1), (5, 3, 2, 1), (2, 3, 11, 0, 0), (2, 3, 11, 0, 0, 1))
TF_OPS = 79
TF_ELEMENT_OPS = 11
H100_BYTES_PER_S = 3.35e12
H100_F32_OPS_PER_S = 67e12
# float32 operations of one slab test (6 subtractions, 6 products, 7 min or
# max, the window compares), one Moller-Trumbore test (two cross products,
# four dot products, a reciprocal, the barycentric window) and one sphere
# quadratic (3 subtractions, two dot products, the discriminant, a square
# root, two roots, the window), counted from the kernels' sources
SLAB_OPS = 20
TRIANGLE_OPS = 45
SPHERE_OPS = 30
# float32 lanes an SM feeds in one clock, for `issue_bound_ms`
SM_LANES = 128
T_RTOL = 1e-5
T_ATOL = 1e-6
# float32 operations of one test of the dense sphere scan (3 subtractions,
# two dot products and |oc|^2 - r^2, the discriminant, its sign test and
# the running minimum; the roots only where disc >= 0), counted from
# csrc/sphere_scan.cu
SCAN_OPS = 20
# the sphere find's near end of the ray window (core/mathx.py:T_MIN)
T_MIN = 1e-3
# the 64x64 renders of phase f may differ only by the order of the
# framebuffer's atomic adds
F_ATOL = 1e-5
HIRES_PREFIX = 40_000   # triangles of the phase c mesh
# phase k: kWindow of kernels/csrc/mesh_traverse.cuh (the pending visits a
# ray keeps from one slab scan), the random mesh and the rays
WINDOW = 4
REFILL_TRIS = 20_000
REFILL_LEAF = 8
REFILL_RAYS = 65_536
REFILL_MIN = 1_000
# phase l: the random sphere pools (spheres, leaf size), their spread and
# the spread of the rays' origins
SPHERE_POOLS = ((5_000, 128), (3_000, 16))
SPHERE_SPREAD = 20.0
SPHERE_RAY_SPREAD = 25.0
# phase h, K4's route against the dense scan: the dense scan counts a ray
# with disc == 0 as a hit and the clustered find does not, and the replay
# sums its dot products in another order, so a grazing ray may hit on one
# route only (at most ROUTE_MAX_OFF of the live rays). Elsewhere the two
# hit points, |dt| * |d| apart, are compared: for the ground sphere (radius
# 1000) c = |oc|^2 - r^2 is of order 1e6 and rounds to 0.06, which moves a
# grazing bounce ray's hit by millimetres of a scene 20 units wide, so the
# points agree within ROUTE_P_ATOL on every hit and within ROUTE_P_ATOL99
# on 99% of them; the normal, that error over a radius of 0.2, agrees
# within ROUTE_N_ATOL
ROUTE_MAX_OFF = 1e-3
ROUTE_P_ATOL = 1e-2
ROUTE_P_ATOL99 = 1e-3
ROUTE_N_ATOL = 2e-2
# phases r-v, the differentiable fit: the scene and the CLI's defaults
# (cli/main.py: 4 spp, max depth 6, 30 Adam steps at the film / 8), the
# vertex move of tests/test_grad.py, the tables a refresh rebuilds, the
# tolerance of a vertex fit through refreshed tables against the lockstep
# find (the finds are expected to agree bit for bit; the gradients' sums
# are deterministic only under torch.use_deterministic_algorithms), the
# teapot_hires vertex-fit step (width, height, spp, depth) and the
# boundary step's image
FIT_SCENE = "scenes/shiny_teapot.yaml"
FIT_SPP = 4
FIT_DEPTH = 6
FIT_STEPS = 30
FIT_MOVE = (0.6, -0.4, 0.5)
REFRESHED = ("tri_soa", "bounds8", "cluster_bmin", "cluster_bmax")
VERTEX_RTOL = 1e-4
VERTEX_ATOL = 1e-6
HIRES_FIT = (64, 64, 1, 3)
# phase ee: the steps of each fit in turns, and the runs of each gather
# backward form under the profiler
TURN_STEPS = 12
# phase ee: the replayed steps of the CLI's deterministic graph fit, each
# under a profiler of its own (steps FIT_WINDOWS[0] .. FIT_WINDOWS[1] - 1)
FIT_WINDOWS = (2, 12)
GATHER_REPS = 10
# phase dd: the replayed blocks of each graph render under a profiler of
# their own (from the third block on)
PROFILED_BLOCKS = 5
# the fills each profiler window launches before its own work
WINDOW_PAD = 16
BOUNDARY_SIZE = (64, 36)
# sha256 of each scene's cluster tables (table_digest) as the native SAH
# builds them on the host, byte-identical to the JAX package's build
# (tests/test_torch_host.py::test_build_scene_native_matches_reference and
# ::test_build_scene_new_scenes_match_reference hold the port's tables
# against the JAX ones and against these digests)
TABLE_SHA256 = {
    SCENE: "9d1ca0e72fc7fef4ede9e7818b4cff9256a35bb4452ac5aab982f2675a156516",
    HIRES: "ea19e62d105d97afad20374241c39ef74b892b2fb345313bf1619e6484ad2244",
    # two instances of the teapot's mesh
    TWO: "9d1ca0e72fc7fef4ede9e7818b4cff9256a35bb4452ac5aab982f2675a156516",
    # the sphere pool's cluster tables (numpy median split, K = 4)
    BALLS: "588ceea6a76a98b7ee1ca587d74e33b0e69c06fac27ce1de00055ec61d6eecfa",
}

# phase aa, the long tail: the teapot scene with its mesh read from a
# binary little-endian PLY written here from assets/teapot.obj, its back
# wall textured by a PNG written by the port's own writer (a checker with
# a gradient), and the thin lens on at an aperture of 0.2 at the scene's
# focal distance 8.5 (the YAML's 0.001 would not blur). No YAML field turns
# the lens on, as in the JAX package, so the phase sets camera.use_lens.
LONG_TAIL_SCENE = """
film: {{width: 640, height: 640, samples: 16, output: long_tail.png}}
camera:
    position: [0, 2.5, 8.5]
    look_at: [0, 2.5, 0]
    up: [0, 1, 0]
    fov: 45
    aperture: {aperture}
    focal_distance: 8.5
    background: hall
textures:
  - {{name: hall, type: environment, path: {hall}}}
  - {{name: checker, type: image, path: checker.png}}
materials:
  - {{name: white, type: lambertian, albedo: [0.73, 0.73, 0.73]}}
  - {{name: red, type: lambertian, albedo: [0.65, 0.05, 0.05]}}
  - {{name: green, type: lambertian, albedo: [0.12, 0.45, 0.15]}}
  - {{name: board, type: lambertian, albedo: checker}}
  - {{name: light, type: diffuse_light, albedo: [0.93, 0.75, 0.43],
     strength: 4.5}}
objects:
  - {{type: yz_rect, y: [0, 5], z: [-2.5, 2.5], k: 2.5, material: red}}
  - {{type: yz_rect, y: [0, 5], z: [-2.5, 2.5], k: -2.5, material: green}}
  - {{type: xz_rect, x: [-2.5, 2.5], z: [-2.5, 2.5], k: 0, material: white}}
  - {{type: xz_rect, x: [-2.5, 2.5], z: [-2.5, 2.5], k: 5, material: white}}
  - {{type: xy_rect, x: [-2.5, 2.5], y: [0, 5], k: -2.5, material: board}}
  - {{type: xz_rect, x: [-1, 1], z: [-1, 1], k: 4.99, material: light}}
  - type: mesh
    path: teapot.ply
    material: white
    transform:
        rotate: [0, 180, 0]
        translate: [0, 1, 0]
        scale: [0.45, 0.45, 0.45]
"""
LENS_APERTURE = 0.2
# sha256 of the PLY teapot's cluster tables (table_digest), equal to the
# JAX package's build of the same PLY
# (tests/test_torch_meshload.py::test_long_tail_scene_builds_as_jax). The
# PLY stores v as a file does and the loader's FlipUVs restores the OBJ's
# value bit for bit, so the tables are the OBJ teapot's too.
PLY_TABLE_SHA256 = (
    "9d1ca0e72fc7fef4ede9e7818b4cff9256a35bb4452ac5aab982f2675a156516")
# the checker texture: its side in pixels and its cells a side
CHECKER = (64, 8)


def write_ply(path, mesh):
    """A mesh dict (verts, normals, uvs, indices) as a binary little-endian
    PLY: x y z nx ny nz u v as floats a vertex, the v coordinate as a file
    stores it (the loaders flip it, FlipUVs), and a face as a uchar count
    and three ints."""
    import numpy as np
    uvs = np.stack([mesh["uvs"][:, 0], 1.0 - mesh["uvs"][:, 1]], axis=1)
    verts = np.concatenate([mesh["verts"], mesh["normals"], uvs],
                           axis=1).astype("<f4")
    faces = np.zeros(len(mesh["indices"]),
                     dtype=[("n", "u1"), ("ids", "<i4", (3,))])
    faces["n"] = 3
    faces["ids"] = mesh["indices"]
    header = ("ply\nformat binary_little_endian 1.0\n"
              f"element vertex {len(verts)}\n"
              + "".join(f"property float {p}\n"
                        for p in ("x", "y", "z", "nx", "ny", "nz", "u", "v"))
              + f"element face {len(faces)}\n"
              "property list uchar int vertex_indices\nend_header\n")
    with open(path, "wb") as f:
        f.write(header.encode() + verts.tobytes() + faces.tobytes())


def checker_image(side, cells):
    """(side, side, 3) uint8: cells alternate a light grey and a colour
    that runs from orange at the left to blue at the right."""
    import numpy as np
    x = np.arange(side)
    cell = side // cells
    odd = ((x[:, None] // cell + x[None, :] // cell) % 2).astype(bool)
    t = np.broadcast_to(x[None, :] / (side - 1), (side, side))
    colour = np.stack([230 * (1 - t) + 30 * t, 120 + 0 * t,
                       20 * (1 - t) + 220 * t], axis=-1)
    img = np.where(odd[..., None], colour, 210.0)
    return img.astype(np.uint8)


def long_tail_scene(tmp):
    """Write the long-tail scene into the directory tmp: teapot.ply (from
    assets/teapot.obj through the port's OBJ parser), checker.png (through
    the port's PNG writer) and the YAML. -> the YAML's path."""
    from hobbyraytracer_tpu_torch.io import images
    from hobbyraytracer_tpu_torch.scene import objloader
    write_ply(os.path.join(tmp, "teapot.ply"),
              objloader.parse_obj(os.path.abspath("assets/teapot.obj")))
    images.write_png(os.path.join(tmp, "checker.png"),
                     checker_image(*CHECKER))
    path = os.path.join(tmp, "long_tail.yaml")
    with open(path, "w") as f:
        f.write(LONG_TAIL_SCENE.format(
            aperture=LENS_APERTURE, hall=os.path.abspath("assets/hall.hdr")))
    return path


def table_digest(geom):
    """sha256 of a mesh's cluster tables (cluster ids, tri_soa, bounds8) or
    of a sphere table's (kernel_ids, kernel_table, kernel_bounds)."""
    h = hashlib.sha256()
    names = (("cluster_id", "tri_soa", "bounds8") if hasattr(geom, "tri_soa")
             else ("kernel_ids", "kernel_table", "kernel_bounds"))
    for name in names:
        h.update(getattr(geom, name).detach().cpu().contiguous().numpy()
                 .tobytes())
    return h.hexdigest()


def load_scene(path):
    """build_scene on the host; its cluster tables (every mesh's, or the
    sphere pool's in a scene without a mesh) must match the pinned digest
    (the native C++ cluster build ran, as in the reference)."""
    from hobbyraytracer_tpu_torch.scene import build_scene, load_scene_desc
    job = build_scene(load_scene_desc(path))
    meshes = [i.mesh for i in job.scene.instances if i.kind == "mesh"]
    for geom in meshes or [job.scene.spheres]:
        digest = table_digest(geom)
        check(digest == TABLE_SHA256[path],
              f"{path}: cluster tables {digest} differ from the reference's")
        k_clusters = (geom.bounds8 if meshes else geom.kernel_bounds).shape[1]
        print(f"[tables] {path}: K = {k_clusters}, sha256 {digest}")
    return job


def entered_per_ray(rays8, bounds8, t_final, t_max=1e30, chunk=16_384):
    """(R,) how many clusters each ray enters before its final hit (slab
    entry below the final t): the leaf visits it needs whatever the visit
    order."""
    import torch
    from hobbyraytracer_tpu_torch.kernels.mesh_traverse import slab_entries
    counts = []
    for s in range(0, rays8.shape[0], chunk):
        r = rays8[s:s + chunk]
        entry = slab_entries(r[:, 0:3], r[:, 3:6], r[:, 6] > 0.0, bounds8,
                             t_max)
        counts.append((entry < t_final[s:s + chunk, None]).sum(dim=1))
    return torch.cat(counts)


def tied_rays(rays8, bounds8, e_min, t_max=1e30, chunk=16_384):
    """How many rays have their smallest slab entry in two or more clusters
    (K3 must then name the lowest index)."""
    import torch
    from hobbyraytracer_tpu_torch.kernels.mesh_traverse import slab_entries
    n = 0
    for s in range(0, rays8.shape[0], chunk):
        r = rays8[s:s + chunk]
        entry = slab_entries(r[:, 0:3], r[:, 3:6], r[:, 6] > 0.0, bounds8,
                             t_max)
        e = e_min[s:s + chunk]
        n += int((((entry == e[:, None]).sum(dim=1) >= 2)
                  & torch.isfinite(e)).sum())
    return n


def entered_clusters(rays8, bounds8, t_final):
    """The leaf visits all these rays need together."""
    return int(entered_per_ray(rays8, bounds8, t_final).sum())


def random_leaf_tables(seed, n_tris, leaf, spread=3.0):
    """A random triangle soup in a box of half-size `spread`, clustered
    into leaves of `leaf` triangles: numpy (bounds8, tri_soa (K, 24, L),
    tri_id (K, L), stream table (K, 32, L))."""
    import numpy as np
    from hobbyraytracer_tpu_torch.kernels import mesh_traverse as kmod
    from hobbyraytracer_tpu_torch.scene.bvh import build_clusters
    rng = np.random.default_rng(seed)
    base = rng.uniform(-spread, spread, (n_tris, 3))
    verts = np.concatenate([base, base + rng.normal(0, 0.3, (n_tris, 3)),
                            base + rng.normal(0, 0.3, (n_tris, 3))]).astype(
                                np.float32)
    idx = np.arange(3 * n_tris, dtype=np.int32).reshape(3, n_tris).T.copy()
    normals = rng.normal(0, 1, verts.shape).astype(np.float32)
    uvs = rng.uniform(0, 1, (len(verts), 2)).astype(np.float32)
    cl = build_clusters(verts, idx, leaf_size=leaf)
    corner = idx[cl["tri_id"].clip(min=0)]
    soa = kmod.pack_mesh_soa(cl["tri_verts"], normals[corner], uvs[corner])
    return (kmod.pack_bounds(cl["bmin"], cl["bmax"]), soa, cl["tri_id"],
            kmod.pack_mesh_stream(soa, cl["tri_id"]))


def random_sphere_tables(seed, n_spheres, leaf, spread=SPHERE_SPREAD):
    """A random sphere pool (centers in a box of half-size `spread`, radii
    0.2-1.5) clustered into leaves of `leaf` spheres: numpy (bounds8 (8, K),
    table (K, 8, L), ids (K, L))."""
    import numpy as np
    from hobbyraytracer_tpu_torch.scene.bvh import build_sphere_clusters
    rng = np.random.default_rng(seed)
    center = rng.uniform(-spread, spread, (n_spheres, 3)).astype(np.float32)
    radius = rng.uniform(0.2, 1.5, (n_spheres,)).astype(np.float32)
    sc = build_sphere_clusters(center, radius, leaf_size=leaf)
    return sc["bounds8"], sc["table"], sc["ids"]


def random_rays8(seed, n, spread):
    """(n, 8) valid rays: origins uniform in a box of half-size `spread`,
    normal directions."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    return torch.from_numpy(np.concatenate(
        [rng.uniform(-spread, spread, (n, 3)), rng.normal(0, 1, (n, 3)),
         np.ones((n, 1)), np.zeros((n, 1))], axis=1).astype(np.float32))


def issue_bound(n_ops, sm_count, sm_clock_mhz):
    """issue_bound_ms: the operations at one an instruction over every
    SM's lanes at the card's maximum SM clock."""
    return n_ops / (sm_count * SM_LANES * sm_clock_mhz * 1e6) * 1e3


def bound(n_bytes, n_ops):
    """(bound_ms, bound_by): the larger of the bytes over the card's memory
    rate and the float32 operations over its peak rate."""
    bytes_ms = n_bytes / H100_BYTES_PER_S * 1e3
    ops_ms = n_ops / H100_F32_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def under(switch, on, fn, *args, **kwargs):
    """fn(*args, **kwargs), under kernels/build.py's comparison switch
    `switch` ("plain_versions" or "eager") when `on`."""
    import contextlib

    from hobbyraytracer_tpu_torch.kernels import build as kbuild
    with getattr(kbuild, switch)() if on else contextlib.nullcontext():
        return fn(*args, **kwargs)


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


def compare_exact(out_a, id_a, out_b, id_b, label):
    """Two traversals bitwise equal: hit masks, ids and every output float
    (t, normal, uv). Returns the max abs difference (0)."""
    import torch
    hit_a, hit_b = out_a[:, 0] < 1e30, out_b[:, 0] < 1e30
    n_hit = int(hit_b.sum())
    check(n_hit > 0, f"{label}: no ray hit the mesh")
    check(bool(torch.equal(hit_a, hit_b)),
          f"{label}: hit masks differ on {int((hit_a != hit_b).sum())} rays")
    check(bool(torch.equal(id_a, id_b)),
          f"{label}: ids differ on {int((id_a != id_b).sum())} rays")
    check(bool(torch.equal(out_a, out_b)),
          f"{label}: outputs differ on "
          f"{int((out_a != out_b).any(dim=1).sum())} rays")
    err = (out_a - out_b).abs().max().item()
    print(f"  {label}: {len(id_a)} rays, {n_hit} hits, masks, ids, t, "
          f"normal and uv bitwise equal")
    return err


def pool_ray_sets(scene, camera, mesh_inst=None, sort_key=None):
    """The pool's first two segments' rays: camera rays, then the rays
    after one bounce (the queue starts at the lower image rows, which see
    the teapot), packed as rays8. With a mesh instance they are moved into
    its space and sorted by sort_key(o, d, active) as
    intersect_mesh_clustered_fused sorts them; without one they stay in
    world space and pool order, as the sphere find gets them."""
    import torch
    from hobbyraytracer_tpu_torch.core.rng import Sampler
    from hobbyraytracer_tpu_torch.core.types import Rays
    from hobbyraytracer_tpu_torch.integrator import wavefront
    dev = camera.origin.device
    _, n_chunks, _ = wavefront._chunk_geometry(SPP, wavefront.SAMPLE_CHUNK)
    total_items = WIDTH * HEIGHT * n_chunks
    pool = min(POOL, total_items)
    sampler = Sampler(SEED, dev)
    state = wavefront.init_state(WIDTH, HEIGHT, pool, device=dev)
    state.counter.fill_(WIDTH * HEIGHT - pool)

    def mesh_rays(st):
        active = (st.item >= 0) & (st.depth >= 0) & ~st.defer
        r = Rays(o=st.o, d=st.d)
        if mesh_inst is not None:
            r = mesh_inst.transform.ray_to_object(r)
        rays8 = torch.cat([r.o, r.d, active.float()[:, None],
                           torch.zeros_like(r.o[:, :1])], dim=1)
        if sort_key is not None:
            rays8 = rays8[torch.argsort(sort_key(r.o, r.d, active),
                                        stable=True)]
        return rays8.contiguous()

    wavefront._regenerate(state, camera, WIDTH, HEIGHT, total_items,
                          sampler)
    sets = {"camera rays": mesh_rays(state)}
    wavefront._segment(state, scene, WIDTH, HEIGHT, sampler, 50, SPP)
    wavefront._regenerate(state, camera, WIDTH, HEIGHT, total_items,
                          sampler)
    sets["after one bounce"] = mesh_rays(state)
    for label, rays8 in sets.items():
        check(rays8.shape[0] == POOL, f"{label}: {rays8.shape[0]} rays")
    return sets


def counted_iterations(wavefront):
    """Wrap wavefront._pool_run to count the iterations that a render
    issues, eager or replayed from its graph (one retired count an
    iteration); -> (counter list, restore function)."""
    iterations = [0]
    pool_run = wavefront._pool_run

    def counted(*args, **kwargs):
        counts = pool_run(*args, **kwargs)
        iterations[0] += len(counts)
        return counts

    wavefront._pool_run = counted

    def restore():
        wavefront._pool_run = pool_run
    return iterations, restore


def render(scene, camera, libs, label, jax_mean, width=WIDTH, height=HEIGHT,
           spp=SPP, pool_sort=None, keep=None, draws=None):
    """A main-path render (640x640 @ 16 spp unless told otherwise) through
    wavefront.render_image (what the CLI calls) with every kernel count set
    to 0 just before it and read just after. The segments are the
    iterations it issued (counted_iterations). Returns (launches by kernel
    name, seconds, mean, rays/s, (retired, total), segments); the image is
    appended to the list `keep` when one is given, and the threefry
    kernel's launches to the list `draws`."""
    import torch
    from hobbyraytracer_tpu_torch.core.rng import Sampler
    from hobbyraytracer_tpu_torch.integrator import wavefront
    from hobbyraytracer_tpu_torch.kernels import threefry
    dev = camera.origin.device
    wavefront.render_image(scene, camera, 64, 64, 4, Sampler(SEED, dev),
                           pool=POOL, pool_sort=pool_sort)  # warm-up
    torch.cuda.synchronize()
    seen = []
    for lib in (*libs, threefry.THREEFRY):
        lib.launches = 0
    segments, restore = counted_iterations(wavefront)
    try:
        t0 = time.perf_counter()
        img = wavefront.render_image(
            scene, camera, width, height, spp, Sampler(SEED, dev),
            max_depth=50, pool=POOL,
            progress_cb=lambda r, t: seen.append((r, t)), rr=True,
            pool_sort=pool_sort)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        restore()
    launches = {lib.name: lib.launches for lib in libs}
    if draws is not None:
        draws.append(threefry.THREEFRY.launches)
    check(tuple(img.shape) == (height, width, 3), f"image {img.shape}")
    check(bool(torch.isfinite(img).all()), f"{label}: non-finite pixels")
    retired, total = seen[-1]
    check(retired == total == width * height * spp,
          f"{label}: retired {retired} of {width * height * spp} samples")
    mean = img.mean().item()
    check(abs(mean - jax_mean) <= MEAN_BAND * jax_mean,
          f"{label}: image mean {mean:.5f} outside {jax_mean} +- "
          f"{MEAN_BAND:.0%}")
    rays_per_s = width * height * spp / seconds
    if keep is not None:
        keep.append(img)
    return launches, seconds, mean, rays_per_s, (retired, total), segments[0]


def fit_launches(spp, depth):
    """K1 (or K2) launches of one render_loss and its backward on a scene
    with one kernel mesh, counted from diff/fit.py and integrator/path.py:
    the forward finds once a bounce of each sample (spp * depth); the
    backward recomputes each sample under its checkpoint up to the last
    bounce's checkpoint, whose inputs are the last thing the sample saved
    (depth - 1 finds, torch's early stop), then each bounce under its own
    checkpoint (depth finds): spp * (3 * depth - 1)."""
    return spp * (3 * depth - 1)


def table_bytes(mesh):
    """The bytes of a mesh's four refreshed tables, one bytes object."""
    return b"".join(getattr(mesh, f).detach().cpu().contiguous().numpy()
                    .tobytes() for f in REFRESHED)


def phase_refresh(dev, meshes):
    """r. For each mesh (label -> (host mesh, the same mesh on dev, rays8
    in its space, its kernel library)): refresh_kernel_tables on dev at the
    build's vertices equals the CPU refresh byte for byte; with the
    vertices moved by FIT_MOVE, the kernel over the refreshed tables and
    the lockstep find over the moved vertices find the same hits and ids."""
    import torch
    from hobbyraytracer_tpu_torch.core.types import Rays
    from hobbyraytracer_tpu_torch.kernels import mesh_traverse as kmod
    from hobbyraytracer_tpu_torch.ops import intersect as isect
    from hobbyraytracer_tpu_torch.scene import ir as scene_ir
    move = torch.tensor(FIT_MOVE, device=dev)
    for label, (host, mesh, rays8, lib) in meshes.items():
        cpu = scene_ir.refresh_kernel_tables(host)
        card = scene_ir.refresh_kernel_tables(mesh)
        check(table_bytes(cpu) == table_bytes(card),
              f"{label}: the tables refreshed on {dev} differ from the CPU's")
        rows = card.tri_soa.shape[1]
        check(rows == mesh.tri_soa.shape[1], f"{label}: layout not kept")
        moved = scene_ir.replace(mesh, verts=mesh.verts + move)
        ref = scene_ir.refresh_kernel_tables(moved)
        lib.launches = 0
        t0 = time.perf_counter()
        out_k, id_k = kmod.traverse_clusters(rays8, ref.bounds8, ref.tri_soa,
                                             ref.cluster_id, need_uv=False)
        check(lib.launches == (1 if dev.type == "cuda" else 0),
              f"{label}: {lib.name} launched {lib.launches} times")
        tri_verts, bmin, bmax = scene_ir._live_clusters(moved)
        r = Rays(o=rays8[:, 0:3].contiguous(), d=rays8[:, 3:6].contiguous())
        t_l, id_l, hit_l = isect.intersect_mesh_clustered(
            r, tri_verts, mesh.cluster_id, bmin, bmax, 1e30,
            ray_valid=rays8[:, 6] > 0.0)
        sync(dev)
        hit_k = out_k[:, 0] < 1e30
        n_hit = int(hit_k.sum())
        check(n_hit > 0, f"{label}: no ray hit the moved mesh")
        check(bool(torch.equal(hit_k, hit_l)),
              f"{label}: hit masks differ on {int((hit_k != hit_l).sum())}")
        check(bool(torch.equal(id_k, id_l)),
              f"{label}: ids differ on {int((id_k != id_l).sum())} rays")
        check(bool(torch.equal(out_k[:, 0], t_l)), f"{label}: t differs")
        print(f"[refresh] {label} ({rows}-row table): refreshed on {dev} = "
              f"CPU refresh byte for byte; vertices moved by {FIT_MOVE}: "
              f"{lib.name} over the refreshed tables vs the lockstep find on "
              f"{rays8.shape[0]} rays, {n_hit} hits, masks, ids and t equal "
              f"({time.perf_counter() - t0:.2f} s)")


def sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def with_bilinear(scene):
    """The scene with bilinear texture lookups (a copy; the original
    keeps its nearest-neighbour ones)."""
    from hobbyraytracer_tpu_torch.scene import ir as scene_ir
    out = scene_ir.replace(scene, textures=scene_ir.replace(scene.textures))
    out.textures.bilinear = True
    return out


def loss_grads(scene, camera, width, height, sampler, spp, depth, target,
               fit_vertices=False, move=None, backend="kernel_replay"):
    """One render_loss and its backward from the scene's own parameters
    (the vertices moved by `move` for a vertex fit) -> (loss, {name:
    gradient}), the gradients of unused parameters zeros."""
    import torch
    from hobbyraytracer_tpu_torch.diff import fit as fit_mod
    params, rebuild = fit_mod.select_params(scene, fit_vertices)
    if move is not None:
        with torch.no_grad():
            for v in params["verts"]:
                v += move
    loss = fit_mod.render_loss(params, rebuild, camera, width, height,
                               sampler, spp, target, depth,
                               mesh_backend=backend)
    loss.backward()
    leaves = dict(params["materials"])
    leaves.update({f"verts{i}": v for i, v in
                   enumerate(params.get("verts", []))})
    return loss.detach(), {k: (torch.zeros_like(v) if v.grad is None
                               else v.grad) for k, v in leaves.items()}


def phase_fit_grads(dev, card, scene, camera, width, height, k1, hires,
                    k2):
    """s. render_loss and its backward through "kernel_replay": timed, K1's
    launches held to fit_launches; the same with the find forced to K1's
    plain version (material gradients bitwise equal, both under
    torch.use_deterministic_algorithms, which makes the index backward's
    sums deterministic); a vertex fit with bilinear lookups and the mesh
    moved, through the refreshed tables against "lockstep"; and a vertex
    fit step of the 32-row hires mesh (hires = (scene, camera)) through K2,
    its launches held to fit_launches. -> (ms, K1 launches, K2 launches)."""
    import torch
    from hobbyraytracer_tpu_torch.cli.main import perturb_materials
    from hobbyraytracer_tpu_torch.core.rng import Sampler
    from hobbyraytracer_tpu_torch.diff import fit as fit_mod
    spp, depth = FIT_SPP, FIT_DEPTH
    sampler = Sampler(SEED, dev)
    with torch.no_grad():
        target = fit_mod.render_linear(scene, camera, width, height, sampler,
                                       spp, depth)
    start = perturb_materials(scene)
    want = fit_launches(spp, depth)
    k1.launches = 0
    sync(dev)
    t0 = time.perf_counter()
    loss, grads = loss_grads(start, camera, width, height, sampler, spp,
                             depth, target)
    sync(dev)
    ms = (time.perf_counter() - t0) * 1e3
    k1_step = k1.launches
    check(dev.type != "cuda" or k1_step == want,
          f"a fit step launched K1 {k1_step} times, predicted {want}")
    check(bool(torch.isfinite(loss)) and float(loss) > 0, f"loss {loss}")
    for name, g in grads.items():
        check(bool(torch.isfinite(g).all()), f"non-finite gradient {name}")
    check(bool((grads["albedo"] != 0).any()), "no albedo gradient")
    print(f"[fit grads] shiny_teapot {width}x{height} @ {spp} spp, depth "
          f"{depth}, kernel_replay: loss {float(loss):.6f}, loss + backward "
          f"{ms:.1f} ms, K1 launches {k1_step} (predicted {want}) on {card}")

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        runs = {}
        for label in ("K1", "K1's plain version"):
            k1.launches = 0
            runs[label] = under("plain_versions", label != "K1", loss_grads,
                                start, camera, width, height, sampler, spp,
                                depth, target)
            sync(dev)
            print(f"  {label}: loss {float(runs[label][0]):.8f}, K1 "
                  f"launches {k1.launches}")
        (la, ga), (lb, gb) = runs.values()
        check(bool(torch.equal(la, lb)), f"kernel vs plain: loss {la} {lb}")
        for name in ga:
            check(bool(torch.equal(ga[name], gb[name])),
                  f"kernel vs plain: {name} gradients differ")
        print(f"  K1 vs its plain version: loss and the gradients of "
              f"{sorted(ga)} bitwise equal")

        bil = with_bilinear(scene)
        with torch.no_grad():
            btarget = fit_mod.render_linear(bil, camera, width, height,
                                            sampler, spp, depth)
        move = torch.tensor(FIT_MOVE, device=dev)
        vruns = {backend: loss_grads(bil, camera, width, height, sampler,
                                     spp, depth, btarget, True, move,
                                     backend)
                 for backend in ("kernel_replay", "lockstep")}
        (la, ga), (lb, gb) = vruns.values()
        gv, gl = ga["verts0"], gb["verts0"]
        check(bool((gv != 0).any()), "the vertex fit has no vertex gradient")
        err = (gv - gl).abs().max().item()
        scale = gl.abs().max().item()
        check(bool(torch.allclose(gv, gl, rtol=VERTEX_RTOL,
                                  atol=VERTEX_ATOL * scale)),
              f"vertex fit: kernel_replay vs lockstep gradients {err} apart")
        check(abs(float(la) - float(lb)) <= VERTEX_RTOL * abs(float(lb)),
              f"vertex fit: losses {float(la)} {float(lb)}")
        print(f"  vertex fit (bilinear, mesh moved by {FIT_MOVE}): "
              f"kernel_replay over the refreshed tables vs lockstep: losses "
              f"{float(la):.8f} / {float(lb):.8f}, vertex gradients max "
              f"|diff| {err:.3g} of max {scale:.3g} (bitwise: "
              f"{bool(torch.equal(gv, gl))}; tolerance rtol {VERTEX_RTOL}, "
              f"atol {VERTEX_ATOL} x max)")
    finally:
        torch.use_deterministic_algorithms(False)

    hscene, hcamera = hires
    hw, hh, hspp, hdepth = HIRES_FIT
    with torch.no_grad():
        htarget = fit_mod.render_linear(hscene, hcamera, hw, hh, sampler,
                                        hspp, hdepth)
    k1.launches = k2.launches = 0
    hloss, hgrads = loss_grads(hscene, hcamera, hw, hh, sampler, hspp,
                               hdepth, htarget * 0.5, True, move)
    sync(dev)
    k2_step = k2.launches
    hwant = fit_launches(hspp, hdepth)
    check(dev.type != "cuda" or (k2_step, k1.launches) == (hwant, 0),
          f"a teapot_hires vertex fit step launched K2 {k2_step} and K1 "
          f"{k1.launches} times, predicted {hwant} and 0")
    check(bool(torch.isfinite(hgrads["verts0"]).all()),
          "teapot_hires: non-finite vertex gradients")
    print(f"  teapot_hires vertex fit step {hw}x{hh} @ {hspp} spp, depth "
          f"{hdepth}, mesh moved, 32-row tables refreshed: loss "
          f"{float(hloss):.6f}, K2 launches {k2_step} (predicted {hwant})")
    return ms, k1_step, k2_step


class timed_steps:
    """Inside, every step of diff/fit.py:fit_materials, eager or replayed,
    is timed on the host clock from its start to its loss's host read
    (fit_mod._run_step wrapped; the fit's loop reads the loss right after
    it): `ms` holds each step's ms. hooks: {step index: fn()} run just
    before that step (a profiler window's start and end)."""

    def __init__(self, hooks=None):
        self.ms, self.hooks = [], hooks or {}

    def __enter__(self):
        from hobbyraytracer_tpu_torch.diff import fit as fit_mod
        self.real = fit_mod._run_step

        def timed(step, graph):
            hook = self.hooks.get(len(self.ms))
            if hook is not None:
                hook()
            t0 = time.perf_counter()
            loss = self.real(step, graph)
            float(loss)
            self.ms.append((time.perf_counter() - t0) * 1e3)
            return loss

        fit_mod._run_step = timed
        return self

    def __exit__(self, *exc):
        from hobbyraytracer_tpu_torch.diff import fit as fit_mod
        fit_mod._run_step = self.real


def phase_fit(dev, card, k1, steps=None, width=None, height=None):
    """t. The CLI's fit (cli/main.py:fit_demo) on FIT_SCENE at its defaults,
    by its default route (through the CUDA graph on the card): the final
    loss below the first; the median ms a step (timed_steps), K1's
    launches a step, and the peak memory. -> dict."""
    import numpy as np
    import torch
    from hobbyraytracer_tpu_torch.cli.main import fit_demo
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    k1.launches = 0
    t0 = time.perf_counter()
    with timed_steps() as timer:
        res = fit_demo(FIT_SCENE, dev, width, height, steps=steps or FIT_STEPS)
    sync(dev)
    n = len(res.losses)
    step_ms = timer.ms
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else None)
    want = FIT_SPP * FIT_DEPTH + n * fit_launches(FIT_SPP, FIT_DEPTH)
    check(dev.type != "cuda" or k1.launches == want,
          f"the fit launched K1 {k1.launches} times, predicted {want}")
    check(bool(np.isfinite(res.losses).all()), "non-finite fit losses")
    check(res.losses[-1] < res.losses[0],
          f"the fit's final loss {res.losses[-1]} is not below its first "
          f"{res.losses[0]}")
    out = {"steps": n, "median_step_ms": statistics.median(step_ms),
           "k1_launches": k1.launches,
           "k1_launches_per_step": fit_launches(FIT_SPP, FIT_DEPTH),
           "peak_bytes": peak, "first_loss": float(res.losses[0]),
           "final_loss": float(res.losses[-1]),
           "seconds": time.perf_counter() - t0}
    print(f"[fit] {FIT_SCENE} at the CLI's defaults ({n} Adam steps, "
          f"{FIT_SPP} spp, depth {FIT_DEPTH}): loss {out['first_loss']:.6f} "
          f"-> {out['final_loss']:.6f}, median {out['median_step_ms']:.1f} ms "
          f"a step (min {min(step_ms):.1f}, max {max(step_ms):.1f}), K1 "
          f"launches {k1.launches} ({FIT_SPP * FIT_DEPTH} for the target + "
          f"{fit_launches(FIT_SPP, FIT_DEPTH)} a step), peak memory "
          f"{peak if peak is None else f'{peak / 2**30:.3f} GiB'}, "
          f"{out['seconds']:.1f} s in all, on {card}")
    return out


def bounce_saved_bytes(scene, camera, sampler, n_rays):
    """The bytes autograd saves for one bounce of trace_diff without its
    checkpoint, at n_rays camera rays that carry gradients (as every bounce
    after the first does): what a bounce's recompute holds in the backward
    pass."""
    import torch
    from hobbyraytracer_tpu_torch.diff import fit as fit_mod
    from hobbyraytracer_tpu_torch.integrator import path as path_mod
    from hobbyraytracer_tpu_torch.ops.camera import get_rays
    params, rebuild = fit_mod.select_params(scene)
    g = torch.Generator(device=sampler.device).manual_seed(SEED)
    st = torch.rand((2, n_rays), generator=g, device=sampler.device)
    cam = get_rays(camera, st[0], st[1])
    rays = type(cam)(o=cam.o.clone().requires_grad_(True),
                     d=cam.d.clone().requires_grad_(True))
    seen = {}

    def pack(t):
        seen[t.untyped_storage().data_ptr()] = t.untyped_storage().nbytes()
        return t

    real = path_mod.checkpoint
    path_mod.checkpoint = lambda fn, *args, **kwargs: fn(*args)
    try:
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            path_mod.trace_diff(rebuild(params), rays, sampler, 1)
    finally:
        path_mod.checkpoint = real
    return sum(seen.values())


def phase_full_film(dev, card, scene, camera, width, height):
    """u. One render_loss and its backward at the scene's full film, 1 spp,
    depth FIT_DEPTH: the gradients finite; the peak memory beside what the
    checkpoints predict: what was allocated before, the depth's saved
    carries (o, d, result, throughput: 4 x 12 bytes, active 1 byte, a ray
    and bounce) and one bounce's saved tensors (measured at 65,536 rays,
    scaled to the film)."""
    import torch
    from hobbyraytracer_tpu_torch.cli.main import perturb_materials
    from hobbyraytracer_tpu_torch.core.rng import Sampler
    from hobbyraytracer_tpu_torch.diff import fit as fit_mod
    n = width * height
    sampler = Sampler(SEED, dev)
    per_ray = bounce_saved_bytes(scene, camera, sampler, 65_536) / 65_536
    with torch.no_grad():
        target = fit_mod.render_linear(scene, camera, width, height, sampler,
                                       1, FIT_DEPTH)
    sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_allocated(dev)
    else:
        before = 0
    t0 = time.perf_counter()
    loss, grads = loss_grads(perturb_materials(scene), camera, width, height,
                             sampler, 1, FIT_DEPTH, target)
    sync(dev)
    seconds = time.perf_counter() - t0
    for name, g in grads.items():
        check(bool(torch.isfinite(g).all()), f"full film: non-finite {name}")
    check(bool((grads["albedo"] != 0).any()), "full film: no albedo gradient")
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else None)
    predicted = before + FIT_DEPTH * 49 * n + per_ray * n
    print(f"[full film] shiny_teapot {width}x{height} @ 1 spp, depth "
          f"{FIT_DEPTH}: loss {float(loss):.6f}, loss + backward "
          f"{seconds:.2f} s, gradients finite; peak memory "
          f"{peak if peak is None else f'{peak / 2**30:.3f} GiB'} against "
          f"{predicted / 2**30:.3f} GiB predicted by the checkpoints "
          f"({before / 2**30:.3f} allocated before + {FIT_DEPTH} x 49 B "
          f"carry + {per_ray:.0f} B of one bounce's saved tensors, a ray) "
          f"on {card}")
    return {"peak_bytes": peak, "predicted_bytes": predicted,
            "seconds": seconds}


def phase_boundary(dev, card):
    """v. One Adam step of a boundary=True vertex fit on FIT_SCENE at
    BOUNDARY_SIZE: the vertex gradient finite and non-zero. With
    nearest-neighbour lookups the shading chain gives the vertices no
    gradient, so a non-zero one is the edge-sampled term's."""
    import torch
    from hobbyraytracer_tpu_torch.cli.main import fit_demo
    w, h = BOUNDARY_SIZE
    t0 = time.perf_counter()
    res = fit_demo(FIT_SCENE, dev, w, h, steps=1, fit_vertices=True,
                   boundary=True, verbose=False)
    sync(dev)
    g = res.params["verts"][0].grad
    check(g is not None and bool(torch.isfinite(g).all()),
          "boundary step: non-finite vertex gradient")
    check(bool((g != 0).any()), "boundary step: zero vertex gradient")
    print(f"[boundary] {FIT_SCENE} {w}x{h}, one boundary=True vertex-fit "
          f"step: loss {res.losses[0]:.6f}, vertex gradient finite, "
          f"{int((g != 0).any(dim=1).sum())} of {g.shape[0]} vertices moved "
          f"by it, max |g| {g.abs().max().item():.4g} "
          f"({time.perf_counter() - t0:.2f} s) on {card}")


def gather_backward_ms(scene, camera, width, height, sampler, spp, depth,
                       target):
    """The device ms a fit step spends in the backward of its material-row
    gathers, by ops/shade.py:rows (index_select: an index_add_) and by the
    form it replaced, table[mid] (a sorted index_put_ with accumulate),
    written out here: the gathers of one render_loss forward from the
    perturbed materials (each backpropagated once a step) are recorded,
    then every backward is run by each form, summed device time under
    torch.profiler over GATHER_REPS runs. -> (new ms, old ms, gathers,
    lanes a gather)."""
    import torch
    from hobbyraytracer_tpu_torch.cli.main import perturb_materials
    from hobbyraytracer_tpu_torch.diff import fit as fit_mod
    from hobbyraytracer_tpu_torch.ops import shade
    recorded = []
    rows = shade.rows

    def recording(table, mid):
        if table.requires_grad:
            recorded.append((table.detach().clone(), mid.clone()))
        return rows(table, mid)

    params, rebuild = fit_mod.select_params(perturb_materials(scene))
    shade.rows = recording
    try:
        with torch.no_grad():
            fit_mod.render_loss(params, rebuild, camera, width, height,
                                sampler, spp, target, depth)
    finally:
        shade.rows = rows
    check(len(recorded) > 0, "no material gather carried a gradient")

    def backward(gather):
        tables = [t.clone().requires_grad_(True) for t, _ in recorded]
        outs = [gather(t, m) for t, (_, m) in zip(tables, recorded)]
        grads = [torch.full_like(o, 0.5) for o in outs]
        return lambda: torch.autograd.grad(outs, tables, grads,
                                           retain_graph=True)

    new, old = backward(shade.rows), backward(lambda t, m: t[m])
    for a, b in zip(new(), old()):
        check(bool(torch.allclose(a, b, rtol=1e-5)),
              "the gathers' gradients differ between the two forms")
    return (profiled_ms(new, GATHER_REPS), profiled_ms(old, GATHER_REPS),
            len(recorded), recorded[0][1].numel())


def phase_fit_graph(dev, card, libs, scene, camera, width, height, hires,
                    full):
    """ee. The fit through its CUDA graph against the eager fit. Under
    deterministic algorithms: the CLI's fit at its defaults (FIT_STEPS
    steps), eager and graph: losses, fitted materials and every kernel's
    launches equal, and over the replayed FIT_WINDOWS steps each kernel's
    launches as torch.profiler saw them held to its counters' increase
    (ProfiledWindows.agree); the
    teapot_hires vertex fit through K2 (HIRES_FIT, to half the scene's
    radiance, 3 steps) each way, bitwise equal; two steps of the full film @ 1 spp each way
    (the second replayed), bitwise equal, with the peak memory of each.
    Then, without them, the CLI's fit by each route in turns (eager,
    graph, eager, graph; TURN_STEPS steps): the median ms a step over
    steps 4 on (replays on the graph route), the capture's ms, and under
    torch.profiler over steps 2-3 the device's busy ms and idle share
    (ProfiledWindows); and the material
    gathers' backward a step, the new form against the old. hires =
    (scene, camera), full = (width, height). -> numbers."""
    import numpy as np
    import torch
    from hobbyraytracer_tpu_torch.cli.main import fit_demo, perturb_materials
    from hobbyraytracer_tpu_torch.core.rng import Sampler
    from hobbyraytracer_tpu_torch.diff import fit as fit_mod
    from hobbyraytracer_tpu_torch.kernels import build as kbuild

    capture_ms = []
    graph_cls = kbuild.GraphReplay

    class Timed(graph_cls):
        def capture(self, fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            super().capture(fn)
            torch.cuda.synchronize()
            capture_ms.append((time.perf_counter() - t0) * 1e3)

    def run(fit, window=None):
        """fit() with every counter at 0 and the peak memory reset -> (its
        result, {library: launches}, graphs captured, each step's ms, the
        peak memory, and the ProfiledWindows of the steps window[0] ..
        window[1] - 1, one window a step (None without `window`))."""
        for lib in libs:
            lib.launches = 0
        capture_ms.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        hooks, windows = {}, None
        if window is not None:
            windows = ProfiledWindows(libs, cpu=True)
            hooks = {i: windows.next for i in range(*window)}
            hooks[window[1]] = windows.stop
        with timed_steps(hooks) as timer:
            res = fit()
        torch.cuda.synchronize()
        launches = {lib.name: lib.launches for lib in libs}
        return (res, launches, len(capture_ms), timer.ms,
                torch.cuda.max_memory_allocated(dev), windows)

    def same(label, a, b):
        """Two fits' losses and parameters bit for bit."""
        check(np.array_equal(a.losses, b.losses),
              f"{label}: losses eager {a.losses} graph {b.losses}")
        for name in fit_mod.MAT_FIELDS:
            check(bool(torch.equal(a.params["materials"][name],
                                   b.params["materials"][name])),
                  f"{label}: fitted {name} differs")
        for va, vb in zip(a.params.get("verts", []),
                          b.params.get("verts", [])):
            check(bool(torch.equal(va, vb)), f"{label}: vertices differ")

    def cli_fit(eager, steps=FIT_STEPS):
        return lambda: under("eager", eager, fit_demo, FIT_SCENE, dev,
                             steps=steps, verbose=False)

    out = {"card": card}
    kbuild.GraphReplay = Timed
    deterministic(True)
    try:
        ea = run(cli_fit(True))
        gr = run(cli_fit(False), FIT_WINDOWS)
        check(fit_mod.fit_route(scene, dev), "the CLI's fit is not on the "
              "graph route")
        check((ea[2], gr[2]) == (0, 1),
              f"graphs captured: eager {ea[2]}, graph {gr[2]}")
        same("the CLI's fit", ea[0], gr[0])
        want = FIT_SPP * FIT_DEPTH + FIT_STEPS * fit_launches(FIT_SPP,
                                                              FIT_DEPTH)
        check(ea[1] == gr[1] and gr[1]["mesh_traverse"] == want,
              f"launches eager {ea[1]}, graph {gr[1]} (K1 predicted {want})")
        ran = gr[5]
        check(ran.agree() and ran.profiled["traverse_kernel"] > 0
              and ran.profiled["threefry_kernel"] > 0,
              f"over the replayed steps {FIT_WINDOWS[0]}-"
              f"{FIT_WINDOWS[1] - 1}, {ran.describe()}")
        print(f"[fit graph] the CLI's fit ({FIT_STEPS} steps, {width}x"
              f"{height} @ {FIT_SPP} spp, depth {FIT_DEPTH}; deterministic): "
              f"eager and graph losses and fitted materials bitwise equal "
              f"(final loss {gr[0].losses[-1]:.8f}), launches equal "
              f"{gr[1]}; over the replayed steps {FIT_WINDOWS[0]}-"
              f"{FIT_WINDOWS[1] - 1}, {ran.describe()}, each kernel seen "
              f"in full in two steps at least; capture "
              f"{sum(capture_ms):.1f} ms")
        out["cli_fit"] = {"launches": gr[1], "profiled_launches":
                          ran.profiled, "counted_launches": ran.counted,
                          "steps_short_of_records": ran.short,
                          "final_loss":
                          float(gr[0].losses[-1]),
                          "peak_bytes": {"eager": ea[4], "graph": gr[4]}}

        hscene, hcamera = hires
        hw, hh, hspp, hdepth = HIRES_FIT
        sampler = Sampler(SEED, dev)
        with torch.no_grad():
            htarget = fit_mod.render_linear(hscene, hcamera, hw, hh, sampler,
                                            hspp, hdepth) * 0.5
        hruns = [run(lambda: under(
            "eager", eager, fit_mod.fit_materials, hscene, hcamera, htarget,
            hw, hh, steps=3, n_samples=hspp, max_depth=hdepth,
            sampler=sampler, fit_vertices=True, verbose=False))
            for eager in (True, False)]
        same("teapot_hires vertex fit", hruns[0][0], hruns[1][0])
        check(hruns[0][1] == hruns[1][1]
              and hruns[1][1]["mesh_traverse_stream"] == (
                  3 * fit_launches(hspp, hdepth))
              and hruns[1][1]["mesh_traverse"] == 0
              and (hruns[0][2], hruns[1][2]) == (0, 1),
              f"teapot_hires vertex fit: launches {hruns[0][1]} / "
              f"{hruns[1][1]}, graphs {hruns[0][2]} / {hruns[1][2]}")
        print(f"  teapot_hires vertex fit ({hw}x{hh} @ {hspp} spp, depth "
              f"{hdepth}, 3 steps, 32-row tables refreshed in every step): "
              f"eager and graph losses, materials and vertices bitwise "
              f"equal, K2 launches {hruns[1][1]['mesh_traverse_stream']} "
              f"each way")
        out["hires_vertex_fit"] = {"launches": hruns[1][1],
                                   "losses": hruns[1][0].losses.tolist()}

        fw, fh = full
        with torch.no_grad():
            ftarget = fit_mod.render_linear(scene, camera, fw, fh, sampler,
                                            1, FIT_DEPTH)
        start = perturb_materials(scene)
        fruns = [run(lambda: under(
            "eager", eager, fit_mod.fit_materials, start, camera, ftarget,
            fw, fh, steps=2, n_samples=1, max_depth=FIT_DEPTH,
            sampler=sampler, verbose=False)) for eager in (True, False)]
        same("full film", fruns[0][0], fruns[1][0])
        check(fruns[0][1] == fruns[1][1] and fruns[1][2] == 1,
              f"full film: launches {fruns[0][1]} / {fruns[1][1]}")
        peaks = {"eager": fruns[0][4], "graph": fruns[1][4]}
        print(f"  full film {fw}x{fh} @ 1 spp, depth {FIT_DEPTH}, 2 steps "
              f"(the second replayed): eager and graph bitwise equal; peak "
              f"memory eager {peaks['eager'] / 2**30:.3f} GiB, graph "
              f"{peaks['graph'] / 2**30:.3f} GiB; step ms eager "
              f"{[round(x, 1) for x in fruns[0][3]]}, graph "
              f"{[round(x, 1) for x in fruns[1][3]]} (the capture "
              f"{sum(capture_ms):.1f} ms)")
        out["full_film"] = {"peak_bytes": peaks,
                            "step_ms": {"eager": fruns[0][3],
                                        "graph": fruns[1][3]},
                            "capture_ms": sum(capture_ms)}
    finally:
        deterministic(False)

    try:
        turns = []
        for eager in (True, False, True, False):
            r = run(cli_fit(eager, TURN_STEPS), (2, 4))
            prof = r[5]
            route = "eager" if eager else "graph"
            turns.append({
                "route": route, "step_ms": r[3],
                "median_step_ms": statistics.median(r[3][4:]),
                "capture_ms": sum(capture_ms),
                "window_ms": prof.window_ms, "busy_ms": prof.busy_ms,
                "kernels": prof.kernels, "steps_short_of_records": prof.lossy,
                "idle_share": 1.0 - prof.busy_ms / (prof.window_ms
                                                    or float("nan")),
                "peak_bytes": r[4]})
            t = turns[-1]
            print(f"[fit graph] the CLI's fit, {route}: median "
                  f"{t['median_step_ms']:.2f} ms a step over steps 4-"
                  f"{TURN_STEPS - 1} (step 0 {r[3][0]:.1f}, step 1 "
                  f"{r[3][1]:.1f}; the capture {t['capture_ms']:.1f} ms); "
                  f"steps 2-3, each under a torch.profiler "
                  f"({prof.lossy} short of records, left out): "
                  f"{t['window_ms']:.1f} ms, device busy "
                  f"{t['busy_ms']:.1f} ms in {t['kernels']} kernels, idle "
                  f"share {t['idle_share']:.1%}; peak memory "
                  f"{t['peak_bytes'] / 2**30:.3f} GiB on {card}")
        out["turns"] = turns
    finally:
        kbuild.GraphReplay = graph_cls

    sampler = Sampler(SEED, dev)
    with torch.no_grad():
        target = fit_mod.render_linear(scene, camera, width, height, sampler,
                                       FIT_SPP, FIT_DEPTH)
    new_ms, old_ms, n_gathers, lanes = gather_backward_ms(
        scene, camera, width, height, sampler, FIT_SPP, FIT_DEPTH, target)
    print(f"[fit graph] the material gathers' backward a step ({n_gathers} "
          f"gathers of {lanes} lanes): index_select (index_add_) "
          f"{new_ms:.3f} ms, table[mid] (sorted index_put_) {old_ms:.3f} ms "
          f"of device time on {card}")
    out["gather_backward_ms"] = {"index_select": new_ms, "indexing": old_ms,
                                 "gathers": n_gathers, "lanes": lanes}
    return out


class _Stop(Exception):
    """Ends a render at its first checkpoint."""


def deterministic(on):
    """torch.use_deterministic_algorithms for a phase that compares renders
    bit for bit: the framebuffer's index_add_ then sums in a fixed order
    instead of the order its atomics land in."""
    import torch
    torch.use_deterministic_algorithms(on, warn_only=on)


def counted_segments(wavefront):
    """Wrap wavefront._segment to count the segments that run; -> (counter
    list, restore function)."""
    segments = [0]
    segment = wavefront._segment

    def counted(*args, **kwargs):
        segments[0] += 1
        return segment(*args, **kwargs)

    wavefront._segment = counted

    def restore():
        wavefront._segment = segment
    return segments, restore


def interrupted(render, path, meta):
    """Run render(checkpoint_cb=...) to its first checkpoint, write that
    state to `path` with save_state (timed) and stop -> save ms."""
    import torch
    from hobbyraytracer_tpu_torch.io import checkpoint as ckpt
    ms = []

    def save_once(state):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ckpt.save_state(path, state, meta=meta)
        ms.append((time.perf_counter() - t0) * 1e3)
        raise _Stop

    try:
        render(checkpoint_cb=save_once)
    except _Stop:
        return ms[0]
    raise RuntimeError("the render never reached a checkpoint")


def load_timed(path, meta, dev):
    """load_state onto dev -> (state, ms)."""
    import torch
    from hobbyraytracer_tpu_torch.io import checkpoint as ckpt
    t0 = time.perf_counter()
    state = ckpt.load_state(path, expect=meta, device=dev)
    torch.cuda.synchronize()
    return state, (time.perf_counter() - t0) * 1e3


def phase_resume(dev, card, scene, camera, k1):
    """w. The main path (the teapot at 640x640 @ 16 spp, pool 196,608,
    depth 50, RR) under deterministic algorithms: uninterrupted; then
    stopped at its first checkpoint (after the first block), written with
    save_state, loaded onto the card with load_state and resumed: fb
    bitwise equal, retired and `it` equal, K1 launched by the resumed part.
    -> dict of the file size, save and load ms, K1 launches."""
    import torch
    from hobbyraytracer_tpu_torch.core.rng import Sampler
    from hobbyraytracer_tpu_torch.integrator import wavefront
    from hobbyraytracer_tpu_torch.io import checkpoint as ckpt
    meta = ckpt.render_meta(WIDTH, HEIGHT, SPP, wavefront.SAMPLE_CHUNK)

    def render(**kw):
        return wavefront.render_state(scene, camera, WIDTH, HEIGHT, SPP,
                                      Sampler(SEED, dev), max_depth=50,
                                      pool=POOL, rr=True, **kw)

    deterministic(True)
    try:
        ref = render()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "teapot.npz")
            save_ms = interrupted(render, path, meta)
            size = os.path.getsize(path)
            state, load_ms = load_timed(path, meta, dev)
        mid, mid_it = int(state.retired), state.it
        check(0 < mid < WIDTH * HEIGHT * SPP, f"resume: {mid} samples done")
        k1.launches = 0
        out = render(state=state)
        torch.cuda.synchronize()
    finally:
        deterministic(False)
    check(k1.launches > 0, "the resumed render never launched K1")
    check(bool(torch.equal(out.fb, ref.fb)),
          f"resumed fb differs from the uninterrupted one on "
          f"{int((out.fb != ref.fb).sum())} values")
    check(int(out.retired) == int(ref.retired) == WIDTH * HEIGHT * SPP
          and out.it == ref.it,
          f"resumed: retired {int(out.retired)}, it {out.it}; uninterrupted "
          f"{int(ref.retired)}, {ref.it}")
    print(f"[resume] teapot {WIDTH}x{HEIGHT} @ {SPP} spp, pool {POOL}, "
          f"deterministic algorithms: stopped after the first block "
          f"({mid} samples, it {mid_it}), checkpoint {size:,} bytes, "
          f"save_state {save_ms:.1f} ms, load_state onto {dev} "
          f"{load_ms:.1f} ms; resumed to the end (it {out.it}, K1 launched "
          f"{k1.launches} times): fb bitwise equal to the uninterrupted "
          f"render's on {card}")
    return {"bytes": size, "save_ms": save_ms, "load_ms": load_ms,
            "k1_resumed": k1.launches}


def phase_cli_resume(card, width=1920, height=1080, spp=100, every=2):
    """x. The CLI at shiny_teapot's full film (1920x1080 @ 100 spp) with
    --checkpoint and --checkpoint-every 2: the process is killed once its
    checkpoint holds 0 < retired < total, then `--resume` finishes it: rc
    0, "Resumed checkpoint", the PNG written, its mean within MEAN_BAND of
    the JAX CPU render's. -> dict."""
    import numpy as np

    from hobbyraytracer_tpu_torch.io import images
    total = width * height * spp
    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "shiny.npz")
        out = os.path.join(tmp, "shiny.png")
        cmd = [sys.executable, "-m", "hobbyraytracer_tpu_torch.cli.main",
               "render", FIT_SCENE, "-o", out, "--device", DEVICE,
               "--checkpoint", ck, "--checkpoint-every", str(every),
               "--width", str(width), "--height", str(height), "--spp",
               str(spp)]
        t0 = time.perf_counter()
        with open(os.path.join(tmp, "first.log"), "w") as log:
            proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
            done = 0
            try:
                while proc.poll() is None and time.perf_counter() - t0 < 600:
                    if os.path.exists(ck):
                        with np.load(ck) as z:
                            done = int(z["retired"])
                        if 0 < done < total:
                            break
                    time.sleep(0.2)
            finally:
                proc.kill()
                proc.wait()
        first_s = time.perf_counter() - t0
        check(0 < done < total, f"the CLI wrote no mid-render checkpoint "
              f"(retired {done} of {total}, rc {proc.returncode}): "
              + open(os.path.join(tmp, "first.log")).read()[-2000:])
        check(not os.path.exists(out), "the killed render wrote its PNG")
        size = os.path.getsize(ck)
        t0 = time.perf_counter()
        res = subprocess.run(cmd + ["--resume"], capture_output=True,
                             text=True, timeout=900)
        resume_s = time.perf_counter() - t0
        check(res.returncode == 0, f"--resume: rc {res.returncode}\n"
              f"{res.stdout[-2000:]}\n{res.stderr[-2000:]}")
        check(f"Resumed checkpoint: {ck} ({done} samples done)" in res.stdout,
              f"--resume did not report the checkpoint: {res.stdout[-2000:]}")
        img = images.read_png(out)
    check(img.shape == (height, width, 3), f"PNG {img.shape}")
    mean = float(((img.astype(np.float64) + 0.5) / 256.0).mean())
    check(abs(mean - JAX_CPU_MEAN_SHINY) <= MEAN_BAND * JAX_CPU_MEAN_SHINY,
          f"resumed shiny_teapot mean {mean:.5f} outside "
          f"{JAX_CPU_MEAN_SHINY} +- {MEAN_BAND:.0%}")
    rate = [ln for ln in res.stdout.splitlines() if "primary rays/s" in ln]
    print(f"[cli resume] {FIT_SCENE} {width}x{height} @ {spp} spp, "
          f"--checkpoint-every {every}: killed after {first_s:.1f} s at {done:,} of {total:,} samples "
          f"(checkpoint {size:,} bytes); --resume: rc 0 in {resume_s:.1f} s, "
          f"PNG mean {mean:.5f} (JAX CPU {JAX_CPU_MEAN_SHINY}); "
          f"{rate[-1].strip() if rate else ''} on {card}")
    return {"bytes": size, "killed_at": done, "first_s": first_s,
            "resume_s": resume_s, "mean": mean}


def dist_worker(rank, port, out, device, size, spp, pool):
    """One process of phase y's two-process render (chip_smoke.py
    --dist-worker RANK PORT OUT DEVICE SIZE SPP POOL): one worker on
    `device`, gloo, the teapot at SIZE x SIZE, deterministic algorithms;
    rank 0 saves the image to OUT (.npy)."""
    import numpy as np
    import torch
    from hobbyraytracer_tpu_torch.core.rng import Sampler
    from hobbyraytracer_tpu_torch.parallel import shard
    shard.init_multihost(f"localhost:{port}", 2, rank, backend="gloo")
    job = load_scene(SCENE)
    dev = torch.device(device)
    deterministic(True)
    img = shard.render_wavefront_sharded(
        job.scene.to(dev), job.camera.to(dev), size, size, spp,
        Sampler(SEED, dev), [dev], max_depth=50, pool=pool)
    if rank == 0:
        np.save(out, img.cpu().numpy())
    torch.distributed.destroy_process_group()
    return 0


def phase_sharded_render(dev, card, scene, camera, libs, single):
    """y. render_wavefront_sharded of the teapot (640x640 @ 16 spp, pool
    196,608) over [cuda:0, cuda:0]: every sample retired, the mean against
    the JAX CPU render's, K1 once a segment of each worker and no other
    kernel; a stacked mid-render checkpoint resumed bit for bit
    (deterministic algorithms); two processes on the card (gloo, one worker
    each) at DIST_SIZE equal bit for bit to the in-process two-worker
    render. single: (K1 launches, rays/s) of phase 4. -> dict."""
    import socket

    import numpy as np
    import torch
    from hobbyraytracer_tpu_torch.core.rng import Sampler
    from hobbyraytracer_tpu_torch.integrator import wavefront
    from hobbyraytracer_tpu_torch.io import checkpoint as ckpt
    from hobbyraytracer_tpu_torch.parallel import shard
    mesh = [dev, dev]
    k1 = libs[0]

    def render(size=WIDTH, **kw):
        return shard.render_wavefront_sharded(
            scene, camera, size, size, SPP, Sampler(SEED, dev), mesh,
            max_depth=50, pool=POOL, **kw)

    render(64)   # warm-up
    torch.cuda.synchronize()
    seen = []
    for lib in libs:
        lib.launches = 0
    segments, restore = counted_segments(wavefront)
    try:
        t0 = time.perf_counter()
        img = render(progress_cb=lambda r, t: seen.append((r, t)))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        restore()
    launches = {lib.name: lib.launches for lib in libs}
    total = WIDTH * HEIGHT * SPP
    check(seen[-1] == (total, total), f"two workers: retired {seen[-1]}")
    check(bool(torch.isfinite(img).all()), "two workers: non-finite pixels")
    mean = img.mean().item()
    check(abs(mean - JAX_CPU_MEAN) <= MEAN_BAND * JAX_CPU_MEAN,
          f"two workers: mean {mean:.5f} outside {JAX_CPU_MEAN} +- "
          f"{MEAN_BAND:.0%}")
    check(launches[k1.name] == segments[0] > 0,
          f"two workers: K1 launched {launches[k1.name]} times in "
          f"{segments[0]} segments")
    check(sum(launches.values()) == launches[k1.name],
          f"two workers launched {launches}")
    rays = total / seconds
    print(f"[sharded render] teapot {WIDTH}x{HEIGHT} @ {SPP} spp over "
          f"{len(mesh)} workers on {dev} (pool {POOL // len(mesh)} each): "
          f"{seconds:.3f} s, {rays:,.0f} primary rays/s (one worker, phase "
          f"4: {single[1]:,.0f}), {segments[0]} segments, K1 launches "
          f"{launches[k1.name]} (one worker: {single[0]}), mean {mean:.5f} "
          f"(JAX CPU {JAX_CPU_MEAN}) on {card}")

    meta = ckpt.render_meta(WIDTH, HEIGHT, SPP, wavefront.SAMPLE_CHUNK,
                            n_workers=len(mesh))
    deterministic(True)
    try:
        ref = render()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "stacked.npz")
            save_ms = interrupted(render, path, meta)
            size = os.path.getsize(path)
            state, load_ms = load_timed(path, meta, dev)
        mid = int(state.retired.sum())
        check(0 < mid < total and tuple(state.retired.shape) == (2,),
              f"stacked checkpoint: {mid} samples, {state.retired.shape}")
        out = render(state=state)
        check(bool(torch.equal(out, ref)), "the resumed two-worker render "
              "differs from the uninterrupted one")
        print(f"  stacked checkpoint after the first block ({mid} samples, "
              f"{size:,} bytes, save {save_ms:.1f} ms, load {load_ms:.1f} "
              f"ms) resumed: image bitwise equal")
        one = render(DIST_SIZE).cpu().numpy()
    finally:
        deterministic(False)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = str(sock.getsockname()[1])
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "img.npy")
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--dist-worker",
             str(r), port, out, str(dev), str(DIST_SIZE), str(SPP),
             str(POOL)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(2)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=600)[0])
        finally:
            for p in procs:
                p.kill()
                p.wait()
        for r, (p, log) in enumerate(zip(procs, logs)):
            check(p.returncode == 0,
                  f"two processes: rank {r} rc {p.returncode}\n{log[-3000:]}")
        two = np.load(out)
        dist_s = time.perf_counter() - t0
    check(two.shape == one.shape and np.array_equal(two, one),
          "two processes on the card differ from the in-process two-worker "
          "render")
    print(f"  two processes on {dev} (gloo, one worker each) at "
          f"{DIST_SIZE}x{DIST_SIZE}: image bitwise equal to the in-process "
          f"two-worker render ({dist_s:.1f} s with their start-up)")
    return {"seconds": seconds, "rays_per_s": rays, "k1": launches[k1.name],
            "segments": segments[0], "mean": mean, "stacked_bytes": size,
            "stacked_save_ms": save_ms, "stacked_load_ms": load_ms}


def phase_sharded_fit(dev, card, scene, camera, width, height, k1):
    """z. The sharded fit at the CLI's size (FIT_SPP, FIT_DEPTH) over
    [cuda:0, cuda:0]: render_linear_slice bitwise equal to the rows of
    render_linear; loss rtol 1e-6 and material gradients rtol 1e-5 /
    atol 1e-8 against single-device render_loss; K1 launched 2 x
    fit_launches; three make_sharded_fit_step steps descend; ms a step
    beside a single-device step's (loss, backward, Adam). -> dict."""
    import numpy as np
    import torch
    from hobbyraytracer_tpu_torch.cli.main import perturb_materials
    from hobbyraytracer_tpu_torch.core.rng import Sampler
    from hobbyraytracer_tpu_torch.diff import fit as fit_mod
    from hobbyraytracer_tpu_torch.parallel import shard
    mesh = [dev, dev]
    spp, depth = FIT_SPP, FIT_DEPTH
    sampler = Sampler(SEED, dev)
    with torch.no_grad():
        target = fit_mod.render_linear(scene, camera, width, height, sampler,
                                       spp, depth)
    # a worker's pixel slice is the rows of the whole image, bit for bit,
    # at any offset on the card (target is the whole image's render)
    wh = width * height
    with torch.no_grad():
        for a, n in ((0, wh // 2), (wh // 2, wh - wh // 2),
                     (wh // 7, wh // 3)):
            part = fit_mod.render_linear_slice(scene, camera, width, height,
                                               sampler, spp, a, n, depth)
            check(bool(torch.equal(part, target[a:a + n])),
                  f"render_linear_slice({a}, {n}) differs from those rows "
                  f"of render_linear")
    print(f"[sharded fit] render_linear_slice at (pixel, count) (0, "
          f"{wh // 2}), ({wh // 2}, {wh - wh // 2}) and ({wh // 7}, {wh // 3}) "
          f"of {width}x{height}: bitwise the rows of render_linear")
    start = perturb_materials(scene)
    runs = {}
    for label in ("single", "sharded"):
        params, rebuild = fit_mod.select_params(start)
        k1.launches = 0
        if label == "single":
            loss = fit_mod.render_loss(params, rebuild, camera, width, height,
                                       sampler, spp, target, depth)
        else:
            loss = shard.sharded_render_loss(params, rebuild, camera, width,
                                             height, sampler, spp, target,
                                             mesh, depth)
        loss.backward()
        torch.cuda.synchronize()
        runs[label] = (float(loss.detach()), {
            f: None if t.grad is None else t.grad.cpu().numpy()
            for f, t in params["materials"].items()}, k1.launches)
    (l1, g1, n1), (l2, g2, n2) = runs["single"], runs["sharded"]
    want = len(mesh) * fit_launches(spp, depth)
    check(n2 == want, f"sharded loss + backward launched K1 {n2} times, "
          f"predicted {want}")
    check(abs(l2 - l1) <= 1e-6 * abs(l1), f"sharded loss {l2} vs {l1}")
    some = sorted(f for f in g1 if g1[f] is not None)
    check("albedo" in some and some == sorted(
        f for f in g2 if g2[f] is not None),
          f"gradients of {some} vs {sorted(f for f in g2 if g2[f] is not None)}")
    for f in some:
        check(np.allclose(g2[f], g1[f], rtol=1e-5, atol=1e-8),
              f"sharded {f} gradient {np.abs(g2[f] - g1[f]).max()} apart")
    print(f"[sharded fit] {FIT_SCENE} {width}x{height} @ {spp} spp, depth "
          f"{depth}, over {len(mesh)} workers: loss {l2:.8f} vs single "
          f"{l1:.8f}, gradients of {some} within rtol 1e-5 (the other "
          f"parameters get none in either); K1 "
          f"launches {n2} (single {n1}, predicted {want})")

    steps = {}
    for label in ("single", "sharded"):
        params, rebuild = fit_mod.select_params(start)
        opt = torch.optim.Adam(shard._leaves(params), lr=2e-2,
                               betas=(0.9, 0.999), eps=1e-8)
        if label == "sharded":
            step = shard.make_sharded_fit_step(rebuild, camera, width, height,
                                               spp, target, mesh, opt,
                                               max_depth=depth)
        else:
            step = shard.make_sharded_fit_step(rebuild, camera, width, height,
                                               spp, target, [dev], opt,
                                               max_depth=depth)
        losses, ms = [], []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(step(params, sampler))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        steps[label] = (losses, ms)
    losses, ms = steps["sharded"]
    check(losses[-1] < losses[0], f"three sharded steps: losses {losses}")
    print(f"  three steps: sharded losses {[f'{x:.6f}' for x in losses]}, "
          f"ms a step {[f'{x:.1f}' for x in ms]} (median "
          f"{statistics.median(ms):.1f}); one worker "
          f"{[f'{x:.1f}' for x in steps['single'][1]]} (median "
          f"{statistics.median(steps['single'][1]):.1f}) on {card}")
    return {"loss": l2, "single_loss": l1, "k1": n2,
            "step_ms": statistics.median(ms),
            "single_step_ms": statistics.median(steps["single"][1])}


def phase_long_tail(dev, card, libs, k1):
    """aa. The long-tail scene (long_tail_scene: the teapot read from a
    binary PLY, the back wall textured by a PNG, the lens on) through the
    function the CLI calls at 640x640 @ 16 spp, pool 196,608, depth 50, RR
    on: the PLY's cluster tables equal the pinned digest; the checker
    loaded (its lookups on the card equal the host's, none debug cyan);
    every sample retired, a finite image, K1 once a segment and no other
    kernel, the mean against the JAX CPU render of the same files; the
    image written as TGA and BMP (ops/film.py:output_film) and read back
    equal. -> dict."""
    import numpy as np
    import torch
    from hobbyraytracer_tpu_torch.io import images
    from hobbyraytracer_tpu_torch.ops import film
    from hobbyraytracer_tpu_torch.ops import texture as ptex
    from hobbyraytracer_tpu_torch.scene import build_scene, load_scene_desc
    with tempfile.TemporaryDirectory() as tmp:
        job = build_scene(load_scene_desc(long_tail_scene(tmp)))
        mesh = next(i.mesh for i in job.scene.instances if i.kind == "mesh")
        digest = table_digest(mesh)
        check(digest == PLY_TABLE_SHA256,
              f"PLY teapot: cluster tables {digest} differ from the JAX "
              "package's build of the same PLY")
        job.camera.use_lens = True   # no YAML field turns it on
        tex = job.scene.textures
        tid = int((tex.ttype == ptex.TEX_IMAGE).nonzero()[0])
        check(int(tex.width[tid]) == CHECKER[0],
              f"the checker texture did not load (width "
              f"{int(tex.width[tid])})")
        g = torch.Generator().manual_seed(SEED)
        u, v = torch.rand((2, 4096), generator=g)
        p = torch.zeros((4096, 3))
        ids = torch.full((4096,), tid, dtype=torch.int32)
        host = ptex.colour_value(tex, ids, u, v, p)
        # Module.to moves the tables in place: the host lookup comes first
        scene, camera = job.scene.to(dev), job.camera.to(dev)
        card_c = ptex.colour_value(scene.textures, ids.to(dev), u.to(dev),
                                   v.to(dev), p.to(dev)).cpu()
        cyan = torch.tensor(ptex.DEBUG_CYAN)
        check(torch.equal(card_c, host)
              and not bool((card_c == cyan).all(dim=1).any())
              and len(torch.unique(card_c, dim=0)) > 2,
              "the checker's lookups on the card are not the texture's")
        keep = []
        launches, seconds, mean, rays_per_s, (retired, total), segs = render(
            scene, camera, libs, "long tail", JAX_CPU_MEAN_LONG_TAIL,
            keep=keep)
        check(launches[k1.name] == segs and sum(launches.values()) == segs,
              f"long tail: launches {launches} in {segs} segments")
        u8 = film.quantize(keep[0].cpu().numpy())
        back = {}
        for ext in ("tga", "bmp"):
            out = os.path.join(tmp, f"long_tail.{ext}")
            check(bool(film.output_film(u8, out)), f"output_film .{ext}")
            back[ext] = images.read_image(out)
            check(np.array_equal(back[ext], u8),
                  f"long tail: the .{ext} reads back otherwise")
    print(f"[render] long tail (PLY teapot, checker texture, lens radius "
          f"{LENS_APERTURE / 2}) {WIDTH}x{HEIGHT} @ {SPP} spp, pool {POOL}: "
          f"{seconds:.3f} s, {rays_per_s:,.0f} primary rays/s, {segs} "
          f"segments, K1 launches {launches[k1.name]}, retired "
          f"{retired}/{total}, mean {mean:.5f} (JAX CPU "
          f"{JAX_CPU_MEAN_LONG_TAIL}); TGA and BMP read back equal on {card}")
    return {"seconds": seconds, "rays_per_s": rays_per_s, "mean": mean,
            "segments": segs, "k1": launches[k1.name],
            "ply_tables_sha256": digest}


def phase_bench(card):
    """bb. `cli/main.py bench` at its defaults (the teapot 640x640 @ 100
    spp, wavefront, pool DEFAULT_POOL, 3 repeats; no BENCH_* variable set)
    on the card, in a process of its own: rc 0 and its JSON line, whose
    keys and metric are root bench.py's. -> the line's dict."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("BENCH_")}
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "hobbyraytracer_tpu_torch.cli.main", "bench",
         "--device", DEVICE], capture_output=True, text=True, env=env,
        timeout=600)
    seconds = time.perf_counter() - t0
    check(res.returncode == 0, f"bench: rc {res.returncode}\n"
          f"{res.stdout[-2000:]}\n{res.stderr[-2000:]}")
    lines = res.stdout.strip().splitlines()
    line = json.loads(lines[-1])
    check(list(line) == ["metric", "value", "unit", "vs_baseline",
                         "repeats", "min", "max"]
          and line["metric"] == "primary_rays_per_s_teapot_640x640@100spp"
          and line["repeats"] == 3
          and 0 < line["min"] <= line["value"] <= line["max"],
          f"bench printed {lines[-1]}")
    check(any(ln.startswith("[bench] on ") for ln in lines),
          "bench named no device")
    print(f"[bench] {json.dumps(line)} ({seconds:.1f} s for the process) "
          f"on {card}")
    return line


def phase_assets(card):
    """cc. procgen's teapot_hires and fixtures.ensure_assets written into a
    temporary directory: byte for byte the repository's assets/. -> the
    seconds it took."""
    import filecmp

    from hobbyraytracer_tpu_torch.scene import fixtures, procgen
    names = ("teapot.obj", "teapot_hires.obj", "hall.hdr", "sky.hdr",
             ".fixture_version")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        hires = os.path.join(tmp, "hires", "teapot_hires.obj")
        procgen.ensure_asset_obj(hires, "teapot_hires")
        fixtures.ensure_assets(os.path.join(tmp, "assets"))
        seconds = time.perf_counter() - t0
        check(filecmp.cmp(hires, "assets/teapot_hires.obj", shallow=False),
              "procgen.teapot_hires differs from assets/teapot_hires.obj")
        for name in names:
            check(filecmp.cmp(os.path.join(tmp, "assets", name),
                              os.path.join("assets", name), shallow=False),
                  f"ensure_assets wrote another {name} than assets/")
    print(f"[assets] teapot_hires and ensure_assets in {seconds:.2f} s: "
          f"byte for byte the repository's assets/ ({', '.join(names)})")
    return seconds


def same_mesh_k1_k2(dev, label, rays8, bounds8, soa, ids, stream):
    """K1 over a mesh's 24-row table against K2 over the same mesh's
    32-row table: bitwise equal, then timed in turns (K1 K2 K2 K1) by CUDA
    events. -> (K1 ms, K2 ms)."""
    import torch
    from hobbyraytracer_tpu_torch.kernels import mesh_traverse as kmod
    out_1, id_1 = kmod.traverse_clusters(rays8, bounds8, soa, ids,
                                         need_uv=False)
    out_2, id_2 = kmod.traverse_clusters(rays8, bounds8, stream, None,
                                         need_uv=False)
    torch.cuda.synchronize()
    compare_exact(out_2, id_2, out_1, id_1, f"K2 vs K1 on {label}")
    t = {"K1": [], "K2": []}
    for name in ("K1", "K2", "K2", "K1"):
        if name == "K1":
            t[name].append(cuda_ms(lambda: kmod.traverse_clusters(
                rays8, bounds8, soa, ids, need_uv=False)))
        else:
            t[name].append(cuda_ms(lambda: kmod.traverse_clusters(
                rays8, bounds8, stream, None, need_uv=False)))
    k1_ms, k2_ms = (statistics.mean(t["K1"]), statistics.mean(t["K2"]))
    print(f"[same mesh] {label}, K = {bounds8.shape[1]}, {rays8.shape[0]} "
          f"rays: K1 (24 rows) {k1_ms:.4f} ms, K2 (32 rows) {k2_ms:.4f} ms "
          f"(each the mean of two turns of 10, K1 K2 K2 K1: "
          f"{t['K1'][0]:.4f} {t['K2'][0]:.4f} {t['K2'][1]:.4f} "
          f"{t['K1'][1]:.4f})")
    return k1_ms, k2_ms


def phase_threefry(dev, card, tfk):
    """dd, first part: threefry.cu against its plain version on the card,
    bit for bit (bits and uniforms), on TF_DRAWS with the key words as host
    values and in a KeySlot on the card (a word past 2**31), with no device
    iteration and with four, and with 0, 3, 4, 5 and 6 folds after it;
    then the kernel, the plain version and torch.rand timed at the pool's
    196,608 lanes as the graph launches a draw (a device iteration, no fold
    after it), and the kernel as the batch route launches its longest
    draw (slot words, 5 folds, 409,600 lanes), held against the plain
    version and timed -> (max abs err, (ms, plain ms, torch.rand ms),
    bound, operations, (the batch draw's ms, its bound ms))."""
    import torch
    from hobbyraytracer_tpu_torch.core.rng import Key, KeySlot
    from hobbyraytracer_tpu_torch.kernels import threefry as tf
    host = (3_000_000_000, SEED + 42)
    slot = KeySlot(dev)
    slot.fill(Key(host))
    err, n_draws = 0.0, 0
    tfk.launches = 0
    for n, offset in TF_DRAWS:
        for words, its in ((host, (None, 0, 7, 123_456, -3)),
                           (slot.words, (None, -3))):
            for it in its:
                it_t = (None if it is None else
                        torch.tensor(it, dtype=torch.int32, device=dev))
                for path in TF_PATHS:
                    for floats in (True, False):
                        k = tf.threefry_draw(words, it_t, path, n, offset,
                                             floats, dev)
                        p = tf.threefry_plain(words, it_t, path, n, offset,
                                              floats, dev)
                        torch.cuda.synchronize()
                        check(bool(torch.equal(k, p)),
                              f"threefry, {n} elements from {offset}, "
                              f"slot {words is not host}, it {it}, path "
                              f"{path}, floats {floats}: "
                              f"{int((k != p).sum())} elements differ")
                        if floats:
                            err = max(err, (k - p).abs().max().item())
                        n_draws += 1
    check(tfk.launches == n_draws,
          f"threefry launched {tfk.launches} times for {n_draws} draws")
    print(f"  threefry vs plain: {n_draws} draws (1 to "
          f"{max(n for n, _ in TF_DRAWS)} elements, "
          f"offsets up to {3 * POOL}, host and slot words, device "
          f"iterations, 0-6 folds after them, bits and uniforms) bitwise "
          f"equal")
    lanes, folds = WIDTH * HEIGHT, len(TF_PATHS[3])

    def batch_draw():
        return tf.threefry_draw(slot.words, None, TF_PATHS[3], lanes, 0,
                                True, dev)
    k = batch_draw()
    p = tf.threefry_plain(slot.words, None, TF_PATHS[3], lanes, 0, True, dev)
    check(bool(torch.equal(k, p)),
          f"threefry, the batch route's draw: {int((k != p).sum())} of "
          f"{lanes} uniforms differ from the plain version")
    batch_ms = profiled_ms(batch_draw)
    # the key's folds are the draw's, once, not once an element
    batch_bnd = bound(4 * lanes + 8,
                      lanes * (TF_OPS + TF_ELEMENT_OPS) + folds * TF_OPS)
    print(f"[threefry] the batch route's longest draw (slot words, {folds} "
          f"folds, {lanes} uniforms): = plain bitwise, {batch_ms:.5f} ms "
          f"device time a call, bound {batch_bnd[0]:.5f} ms by "
          f"{batch_bnd[1]} on {card}")
    it_t = torch.tensor(5, dtype=torch.int32, device=dev)
    fns = (lambda: tf.threefry_draw(words, it_t, (), POOL, 0, True, dev),
           lambda: tf.threefry_plain(words, it_t, (), POOL, 0, True, dev),
           lambda: torch.rand((POOL,), device=dev))
    times = tuple(profiled_ms(fn) for fn in fns)
    events = tuple(cuda_ms(fn, reps=20, warmup=3) for fn in fns)
    ops = POOL * (TF_OPS + TF_ELEMENT_OPS) + TF_OPS
    bnd = bound(4 * POOL + 4, ops)
    print(f"[threefry] {POOL} uniforms with a device iteration, device ms "
          f"a call (profiler): kernel {times[0]:.5f}, plain {times[1]:.4f}, "
          f"torch.rand {times[2]:.5f} (other bits); CUDA events around one "
          f"call (the host's enqueue included): {events[0]:.4f} / "
          f"{events[1]:.4f} / {events[2]:.4f}; bound {bnd[0]:.5f} ms by "
          f"{bnd[1]} on {card}")
    return err, times, bnd, ops, (batch_ms, batch_bnd[0])


def profiled_ms(fn, n=100):
    """The device time of one fn() call: the summed kernel time of n calls
    under torch.profiler, over n. (CUDA events around one call of a
    few-microsecond kernel time the host's enqueue.)"""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return device_busy_ms(prof)[0] / n


# each kernel's name in the profiler's records, and the libraries whose
# launch counters count it (K1 and K2 are one template, traverse_kernel)
GRAPH_KERNELS = {"traverse_kernel": ("mesh_traverse", "mesh_traverse_stream"),
                 "coherence_keys_kernel": ("coherence_keys",),
                 "sphere_traverse_kernel": ("sphere_traverse",),
                 "threefry_kernel": ("threefry",)}


def kernel_counts(prof):
    """{name: launches} of each GRAPH_KERNELS kernel that the card ran in
    a torch.profiler window (kernels replayed from a CUDA graph included),
    by the kernel's own name in its record."""
    counts = dict.fromkeys(GRAPH_KERNELS, 0)
    for evt in prof.key_averages():
        if not str(evt.device_type).endswith("CUDA"):
            continue
        m = re.search(r"(?<![A-Za-z0-9_])(" + "|".join(GRAPH_KERNELS)
                      + r")\b", evt.key)
        if m:
            counts[m.group(1)] += evt.count
    return counts


def device_busy_ms(prof):
    """The summed device time of the kernels a torch.profiler window saw,
    and their count."""
    busy, n = 0.0, 0
    for evt in prof.key_averages():
        if not str(evt.device_type).endswith("CUDA"):
            continue
        dt = getattr(evt, "self_device_time_total", None)
        if dt is None:
            dt = getattr(evt, "self_cuda_time_total", 0.0)
        if dt > 0:
            busy += dt / 1e3
            n += evt.count
    return busy, n


class ProfiledWindows:
    """torch.profiler over a few windows that replay one CUDA graph each (a
    block of a render, a step of a fit), one profiler a window. CUPTI loses
    activity records now and then, as a rule a few of a window's ~40,000
    (scripts/profiler_record_loss.py counts them on a card), at times a
    whole buffer (1,342 of a block's 5,237 kernels). A loss can only make
    the profiler see fewer launches than ran, so the launch check
    (`agree`) holds each GRAPH_KERNELS kernel to its counters' increase
    window by window: the profiler never saw more than was counted, and it
    saw exactly the counted launches in two windows at least. A fault of
    the counters repeats in every window, which replay the same graph; a
    loss does not. `profiled` {kernel: launches the card ran} and `counted`
    {kernel: its counters' increase} sum all windows; `short` counts the
    windows that saw fewer launches of some kernel than were counted. The
    device numbers, `window_ms` (host clock, synchronized), `busy_ms` and
    `kernels`, sum the windows whose kernel total is the run's largest (the
    others, `lossy` of them, are left out). A window in which nothing ran
    counts as none. Each window opens with WINDOW_PAD fills (in its kernel
    count and busy time, some microseconds) ahead of its own work. A
    profiler costs seconds to start and stop, so a phase opens a few
    windows, not one a block."""

    def __init__(self, libs, cpu=False):
        self.libs, self.cpu = libs, cpu
        self.windows = []
        self.prof = None

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self.before = {lib.name: lib.launches for lib in self.libs}
        acts = [ProfilerActivity.CUDA]
        if self.cpu:
            acts.append(ProfilerActivity.CPU)
        self.prof = profile(activities=acts)
        self.prof.start()
        # a burst of fills, none of them a GRAPH_KERNELS kernel, ahead of
        # the window's own work: records lost as tracing starts fall on
        # them
        pad = torch.zeros((WINDOW_PAD,), device=DEVICE)
        for i in range(WINDOW_PAD):
            pad[i].fill_(i)
        torch.cuda.synchronize()
        self.t0 = time.perf_counter()

    def stop(self):
        import torch
        torch.cuda.synchronize()
        ms = (time.perf_counter() - self.t0) * 1e3
        prof, self.prof = self.prof, None
        prof.stop()
        counted = {kernel: sum(lib.launches - self.before[lib.name]
                               for lib in self.libs
                               if lib.name in GRAPH_KERNELS[kernel])
                   for kernel in GRAPH_KERNELS}
        busy, n = device_busy_ms(prof)
        if n or any(counted.values()):
            self.windows.append((kernel_counts(prof), counted, ms, busy, n))

    def next(self):
        """Close the open window, if any, and open the next."""
        if self.prof is not None:
            self.stop()
        self.start()

    def _complete(self):
        most = max((w[4] for w in self.windows), default=0)
        return [w for w in self.windows if w[4] == most]

    def _sum(self, i, windows):
        return {k: sum(w[i][k] for w in windows) for k in GRAPH_KERNELS}

    @property
    def profiled(self):
        return self._sum(0, self.windows)

    @property
    def counted(self):
        return self._sum(1, self.windows)

    @property
    def short(self):
        return sum(any(w[0][k] < w[1][k] for k in GRAPH_KERNELS)
                   for w in self.windows)

    @property
    def window_ms(self):
        return sum(w[2] for w in self._complete())

    @property
    def busy_ms(self):
        return sum(w[3] for w in self._complete())

    @property
    def kernels(self):
        return sum(w[4] for w in self._complete())

    @property
    def lossy(self):
        return len(self.windows) - len(self._complete())

    def agree(self) -> bool:
        """No window saw more launches of a kernel than were counted, and
        two windows at least saw exactly the counted launches of each."""
        return all(
            all(w[0][k] <= w[1][k] for w in self.windows)
            and sum(w[0][k] == w[1][k] for w in self.windows) >= 2
            for k in GRAPH_KERNELS)

    def describe(self) -> str:
        """The launch check's evidence, for a log line."""
        missing = {k: [w[1][k] - w[0][k] for w in self.windows]
                   for k in GRAPH_KERNELS
                   if any(w[0][k] != w[1][k] for w in self.windows)}
        return (f"the profiler saw {self.profiled}, the counters grew by "
                f"{self.counted} ({self.short} of {len(self.windows)} "
                f"windows short of some kernel's records; missing by "
                f"window: {missing})")


def phase_graph(dev, card, libs, scenes):
    """dd, second part: each scene {label: (scene, camera, sphere kernel
    on, HRT_KEY_MODE)} rendered at 640x640 @ 16 spp eagerly and through the
    graph under deterministic algorithms: framebuffer, `it`, retired and
    every kernel's launches equal, one graph captured by the graph render
    and none by the eager one. Over PROFILED_BLOCKS replayed blocks of the
    graph render (from the third on, a profiler each: ProfiledWindows),
    each kernel's launches as torch.profiler saw the card run them
    (GRAPH_KERNELS) are held to its counters' increase
    (ProfiledWindows.agree). Then
    the teapot in turns (eager, graph, eager, graph) as the CLI renders
    it, and under torch.profiler once each way. -> numbers."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from hobbyraytracer_tpu_torch.core.rng import Sampler
    from hobbyraytracer_tpu_torch.integrator import wavefront
    from hobbyraytracer_tpu_torch.ops import intersect as isect

    captured, capture_ms = [0], []
    block_graph = wavefront._BlockGraph

    class Counted(block_graph):
        def capture(self, fn):
            captured[0] += 1
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            super().capture(fn)
            torch.cuda.synchronize()
            capture_ms.append((time.perf_counter() - t0) * 1e3)

    def run(scene, camera, eager):
        """-> the state, the launch counters, the graphs captured, and the
        ProfiledWindows of PROFILED_BLOCKS blocks after the second
        (replays; none on the eager route)."""
        for lib in libs:
            lib.launches = 0
        captured[0] = 0
        wavefront.RENDER_GRAPHS.clear()   # the graph render captures its own
        windows = ProfiledWindows(libs)
        blocks = [0]

        def block_done(state):
            blocks[0] += 1
            if not eager and 2 <= blocks[0] < 2 + PROFILED_BLOCKS:
                windows.next()
            elif not eager and blocks[0] == 2 + PROFILED_BLOCKS:
                windows.stop()

        st = under("eager", eager, wavefront.render_state, scene, camera,
                   WIDTH, HEIGHT, SPP, Sampler(SEED, dev), max_depth=50,
                   pool=POOL, pool_sort=0, checkpoint_cb=block_done)
        if windows.prof is not None:
            windows.stop()
        launches = {lib.name: lib.launches for lib in libs}
        return st, launches, captured[0], windows

    out = {"renders": {}, "threefry_launches": {}}
    wavefront._BlockGraph = Counted
    deterministic(True)
    try:
        for label, (scene, camera, sphere_kernel, key_mode) in (
                scenes.items()):
            isect.SPHERE_KERNEL = sphere_kernel
            isect.KEY_MODE = key_mode
            check(wavefront.graph_route(scene, dev, pool_sort=0),
                  f"{label}: not on the graph route")
            ea, ea_l, ea_c, _ = run(scene, camera, True)
            gr, gr_l, gr_c, ran = run(scene, camera, False)
            check((ea_c, gr_c) == (0, 1),
                  f"{label}: graphs captured eager {ea_c}, graph {gr_c}")
            check(bool(torch.equal(ea.fb, gr.fb)),
                  f"{label}: the graph's fb differs from the eager one's on "
                  f"{int((ea.fb != gr.fb).sum())} values")
            check(ea.it == gr.it and int(ea.retired) == int(gr.retired)
                  == WIDTH * HEIGHT * SPP,
                  f"{label}: it {ea.it} / {gr.it}, retired "
                  f"{int(ea.retired)} / {int(gr.retired)}")
            check(ea_l == gr_l, f"{label}: launches eager {ea_l}, graph "
                  f"{gr_l}")
            check(sum(gr_l.values()) > gr_l["threefry"] > 0,
                  f"{label}: launches {gr_l}")
            check((gr_l["coherence_keys"] > 0) == (key_mode == "pallas"),
                  f"{label}: K3 launched {gr_l['coherence_keys']} times "
                  f"with HRT_KEY_MODE {key_mode}")
            check(ran.agree() and ran.profiled["threefry_kernel"] > 0,
                  f"{label}: over the replayed blocks, {ran.describe()}")
            print(f"  graph vs eager, {label} {WIDTH}x{HEIGHT} @ {SPP} spp "
                  f"(deterministic): fb bitwise equal, it {gr.it}, launches "
                  f"equal {gr_l}; over the replayed blocks, "
                  f"{ran.describe()}, each kernel seen in full in two "
                  f"blocks at least")
            out["renders"][label] = {"it": gr.it, "launches": gr_l,
                                     "profiled_launches": ran.profiled,
                                     "counted_launches": ran.counted,
                                     "blocks_short_of_records": ran.short}
            out["threefry_launches"][f"{label} (graph)"] = gr_l["threefry"]
    finally:
        deterministic(False)
        isect.SPHERE_KERNEL = False
        isect.KEY_MODE = "auto"

    scene, camera, _, _ = scenes["teapot"]
    iterations, restore = counted_iterations(wavefront)
    turns, prof_out = [], {}

    def render_teapot(eager, checkpoint_cb=None):
        iterations[0] = 0
        t0 = time.perf_counter()
        under("eager", eager, wavefront.render_state, scene, camera, WIDTH,
              HEIGHT, SPP, Sampler(SEED, dev), max_depth=50, pool=POOL,
              checkpoint_cb=checkpoint_cb)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, iterations[0]

    try:
        for _ in range(2):
            for eager in (True, False):
                capture_ms.clear()
                ms, segs = render_teapot(eager)
                turns.append({"route": "eager" if eager else "graph",
                              "ms": ms, "segments": segs,
                              "rays_per_s": WIDTH * HEIGHT * SPP / ms * 1e3,
                              "segment_ms": ms / segs,
                              "capture_ms": sum(capture_ms)})
                print(f"[graph] teapot {WIDTH}x{HEIGHT} @ {SPP} spp, "
                      f"{turns[-1]['route']}: {ms:.1f} ms (the capture "
                      f"{sum(capture_ms):.1f}), "
                      f"{turns[-1]['rays_per_s']:,.0f} primary rays/s, "
                      f"{segs} segments, {ms / segs:.3f} ms a segment on "
                      f"{card}")
        # the steady state: the profiler from the third block on (the
        # warm-up block and the first replay with its capture done)
        for eager in (True, False):
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            blocks, mark = [0], {}

            def start(state):
                blocks[0] += 1
                if blocks[0] == 2:
                    torch.cuda.synchronize()
                    prof.start()
                    mark["segments"] = iterations[0]
                    mark["t0"] = time.perf_counter()

            _, segs = render_teapot(eager, start)
            ms = (time.perf_counter() - mark["t0"]) * 1e3
            prof.stop()
            segs -= mark["segments"]
            busy, n_kernels = device_busy_ms(prof)
            route = "eager" if eager else "graph"
            prof_out[route] = {
                "window_ms": ms, "device_busy_ms": busy,
                "kernels": n_kernels, "segments": segs,
                "idle_share": 1.0 - busy / ms, "segment_ms": ms / segs,
                "busy_segment_ms": busy / segs}
            print(f"[graph] teapot, {route}, profiled from the third block "
                  f"on: {segs} segments in {ms:.1f} ms, device busy "
                  f"{busy:.1f} ms in {n_kernels} kernels, idle share "
                  f"{1.0 - busy / ms:.1%}, {ms / segs:.3f} ms a segment "
                  f"({busy / segs:.3f} ms busy) on {card}")
            check(n_kernels > 0 and busy > 0,
                  f"the profiler saw no device time in the {route} render")
    finally:
        restore()
        wavefront._BlockGraph = block_graph
    out["teapot_turns"] = turns
    out["teapot_profile"] = prof_out
    return out


def phase_batch(dev, card, libs, scenes):
    """q: the batch integrator by both routes (integrator/path.py:
    radiance_sum, what render_image, render_sharded, the CLI's
    `--integrator batch` and `bench` call; under kernels/build.py:eager()
    BatchRun's steps run without graphs). scenes {label: (scene,
    camera)}: the teapot, then cornell_smoke, scattered_balls (through K4)
    and teapot_hires.

    First K1 against its plain version on the 409,600 rays of a teapot
    sample's second bounce, as the batch route's find passes them. Then
    the teapot at 640x640 @ 16 spp, depth 50, in the CLI's chunks
    (BATCH_CHUNK), four renders in turns (eager, graph, eager, graph)
    under deterministic algorithms: the radiance sums bitwise equal, every
    kernel's launches equal (those of the first graph render reported),
    ceil(50 / B) + 2 graphs captured by each graph render and none by the
    eager ones, the tonemapped mean against a JAX CPU batch render; rays/s,
    ms a bounce, the captures' ms and the peak memory of each. Then a
    graph render with one profiler a sample over samples BATCH_WINDOWS
    (ProfiledWindows: K1's and threefry's launches as the card ran them
    never above the counted, equal in two windows at least; busy and idle
    share) and an eager render of BATCH_EAGER_WINDOWS[1] samples likewise
    over BATCH_EAGER_WINDOWS. At BATCH_SMALL, graph against eager bitwise
    with launches equal: cornell_smoke (its isotropic scatter draws with
    five folds after the slot), the balls through K4, teapot_hires through
    K2, the teapot also against `trace`'s per-bounce loop, and
    render_sharded over two workers on the card against one. -> numbers."""
    import torch

    from hobbyraytracer_tpu_torch.core.rng import Sampler
    from hobbyraytracer_tpu_torch.integrator import path as path_mod
    from hobbyraytracer_tpu_torch.kernels import build as kbuild
    from hobbyraytracer_tpu_torch.kernels import mesh_traverse as kmod
    from hobbyraytracer_tpu_torch.kernels import threefry as tf
    from hobbyraytracer_tpu_torch.ops import film as film_ops
    from hobbyraytracer_tpu_torch.ops import intersect as isect
    from hobbyraytracer_tpu_torch.parallel import shard

    capture_ms, runs, hook = [], [], [None]
    replay_cls, run_cls, route = (kbuild.GraphReplay, path_mod.BatchRun,
                                  path_mod.batch_route)
    slot_paths = set()
    draw = tf.threefry_draw

    class Timed(replay_cls):
        def capture(self, fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            super().capture(fn)
            torch.cuda.synchronize()
            capture_ms.append((time.perf_counter() - t0) * 1e3)

    class Hooked(run_cls):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            runs.append(self)

        def sample(self, key):
            if hook[0] is not None:
                hook[0](self.samples)
            super().sample(key)

    def spied(words, it, path, *args):
        if isinstance(words, torch.Tensor):
            slot_paths.add(len(path))
        return draw(words, it, path, *args)

    def batch(scene, camera, size, spp, chunk, eager, seed=SEED,
              windows=None, loop=False):
        """One radiance_sum with the counters, captures and peak memory
        reset just before it -> (sum, launches {lib: n}, ms, bounces,
        captures, capture ms, peak GiB: the most allocated during it above
        what was allocated before it)."""
        for lib in libs:
            lib.launches = 0
        capture_ms.clear()
        runs.clear()
        path_mod.batch_route = (lambda *a, **k: False) if loop else route
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        held = torch.cuda.memory_allocated(dev)
        if windows is not None:
            w0, w1 = windows[1]

            def at(sample):
                if w0 <= sample < w1:
                    windows[0].next()
                elif sample == w1:
                    windows[0].stop()
            hook[0] = at
        t0 = time.perf_counter()
        try:
            total = under("eager", eager, path_mod.radiance_sum, scene,
                          camera, size, size, spp, Sampler(seed, dev),
                          max_depth=50, sample_chunk=chunk)
            torch.cuda.synchronize()
        finally:
            hook[0] = None
            path_mod.batch_route = route
        ms = (time.perf_counter() - t0) * 1e3
        if windows is not None and windows[0].prof is not None:
            windows[0].stop()
        check(bool(torch.isfinite(total).all()) and total.max() > 0,
              "batch: non-finite or black radiance")
        return (total, {lib.name: lib.launches for lib in libs}, ms,
                sum(r.bounces for r in runs), len(capture_ms),
                sum(capture_ms),
                (torch.cuda.max_memory_allocated(dev) - held) / 2**30)

    def k1_at_batch_bounce(scene, camera):
        """K1 against its plain version on the rays of the teapot's second
        batch bounce (one sample's 409,600 lanes as the find passes them:
        in its coherence order, the lanes that ended traced along) -> the
        max abs err."""
        seen, find = [], kmod.traverse_clusters

        def spy(*args, **kwargs):
            seen.append((args, kwargs))
            return find(*args, **kwargs)

        kmod.traverse_clusters = spy
        try:
            run_cls(scene, camera, WIDTH, HEIGHT, Sampler(SEED, dev),
                    2).sample_sum(Sampler(SEED, dev), 1)
        finally:
            kmod.traverse_clusters = find
        check(len(seen) == 2, f"K1 ran {len(seen)} times in two bounces")
        args, kwargs = seen[1]
        check(args[0].shape[0] == WIDTH * HEIGHT and args[2].shape[1] == 24,
              f"the batch bounce gave K1 {tuple(args[0].shape)} rays and "
              f"a {args[2].shape[1]}-row table")
        out_k, id_k = find(*args, **kwargs)
        out_p, id_p = kmod.traverse_clusters_plain(*args, **kwargs)
        torch.cuda.synchronize()
        return compare_exact(out_k, id_k, out_p, id_p,
                             "K1 vs plain, the teapot's second batch bounce")

    kbuild.GraphReplay, path_mod.BatchRun = Timed, Hooked
    tf.threefry_draw = spied
    deterministic(True)
    out = {"teapot_turns": []}
    per_render = -(-50 // path_mod.BOUNCE_BLOCK) + 2
    try:
        scene, camera = scenes["teapot"]
        out["k1_err"] = k1_at_batch_bounce(scene, camera)
        check(all(route(sc, dev) for sc, _ in scenes.values()),
              "a batch scene is not on the graph route")
        first = None
        for turn, eager in enumerate((True, False, True, False)):
            total, launches, ms, bounces, n_graphs, cap, peak = batch(
                scene, camera, WIDTH, SPP, BATCH_CHUNK, eager)
            name = "eager" if eager else "graph"
            check(n_graphs == (0 if eager else per_render),
                  f"batch {name}: {n_graphs} graphs captured")
            check(launches["mesh_traverse"] > 0 and launches["threefry"] > 0,
                  f"batch {name}: launches {launches}")
            if not eager and "launches" not in out:
                out["launches"] = launches    # the first graph render's
            if first is None:
                first = (total, launches)
                img = film_ops.tonemap(total / float(SPP))
                mean = img.mean().item()
                check(abs(mean - JAX_CPU_MEAN_BATCH)
                      <= MEAN_BAND * JAX_CPU_MEAN_BATCH,
                      f"batch mean {mean:.5f} outside {JAX_CPU_MEAN_BATCH} "
                      f"+- {MEAN_BAND:.0%}")
            check(bool(torch.equal(total, first[0])),
                  f"batch turn {turn} ({name}): the sum differs on "
                  f"{int((total != first[0]).sum())} values")
            check(launches == first[1],
                  f"batch turn {turn} ({name}): launches {launches}, first "
                  f"{first[1]}")
            rays = WIDTH * HEIGHT * SPP / ms * 1e3
            out["teapot_turns"].append({
                "route": name, "ms": ms, "rays_per_s": rays,
                "bounces": bounces, "bounce_ms": ms / bounces,
                "captures": n_graphs, "capture_ms": cap, "peak_gib": peak})
            print(f"[batch] teapot {WIDTH}x{HEIGHT} @ {SPP} spp, depth 50, "
                  f"chunks of {BATCH_CHUNK}, {name}: {ms:.1f} ms (captures "
                  f"{cap:.1f}), {rays:,.0f} primary rays/s, {bounces} "
                  f"bounces, {ms / bounces:.3f} ms a bounce, peak "
                  f"{peak:.3f} GiB above the memory held before it on "
                  f"{card}")
        out["mean"] = mean
        print(f"  batch teapot: four renders bitwise equal (deterministic), "
              f"launches {first[1]} each, mean {mean:.5f} (JAX CPU batch "
              f"{JAX_CPU_MEAN_BATCH})")
        for eager, span in ((False, BATCH_WINDOWS),
                            (True, BATCH_EAGER_WINDOWS)):
            windows = ProfiledWindows(libs)
            total, launches, ms, _, _, _, _ = batch(
                scene, camera, WIDTH, span[1] if eager else SPP,
                BATCH_CHUNK, eager, windows=(windows, span))
            name = "eager" if eager else "graph"
            check(eager or (bool(torch.equal(total, first[0]))
                            and launches == first[1]),
                  f"batch {name} under the profiler differs")
            check(windows.agree(),
                  f"batch {name}: over the profiled samples, "
                  f"{windows.describe()}")
            busy, wall = windows.busy_ms, windows.window_ms
            check(busy > 0, f"batch {name}: the profiler saw no device time")
            out[f"profile_{name}"] = {
                "windows": len(windows.windows), "kept": len(
                    windows.windows) - windows.lossy, "window_ms": wall,
                "busy_ms": busy, "kernels": windows.kernels,
                "idle_share": 1.0 - busy / wall,
                "profiled_launches": windows.profiled,
                "counted_launches": windows.counted,
                "short": windows.short}
            print(f"[batch] teapot, {name}, one profiler a sample over "
                  f"samples {span[0]}-{span[1] - 1}: {windows.describe()}; "
                  f"the fullest windows {wall:.1f} ms, device busy "
                  f"{busy:.1f} ms in {windows.kernels} kernels, idle share "
                  f"{1.0 - busy / wall:.1%} on {card}")

        size, spp, chunk = BATCH_SMALL
        out["small"] = {}
        for label, (sc, cam) in scenes.items():
            isect.SPHERE_KERNEL = "K4" in label
            slot_paths.clear()
            ea = batch(sc, cam, size, spp, chunk, True)
            gr = batch(sc, cam, size, spp, chunk, False)
            check(bool(torch.equal(ea[0], gr[0])) and ea[1] == gr[1]
                  and gr[4] == per_render,
                  f"batch {label} {size}x{size}: graph differs from eager "
                  f"(launches {ea[1]} / {gr[1]}, graphs {gr[4]})")
            row = {"launches": gr[1], "slot_paths": sorted(slot_paths),
                   "eager_ms": ea[2], "graph_ms": gr[2]}
            if label == "teapot":
                lp = batch(sc, cam, size, spp, chunk, True, loop=True)
                check(bool(torch.equal(lp[0], gr[0])),
                      "batch teapot: the per-bounce loop differs from the "
                      "graphs")
                row["loop_ms"] = lp[2]
                mesh = [torch.device(DEVICE)] * 2
                imgs = []
                for eager in (False, True):
                    runs.clear()
                    capture_ms.clear()
                    imgs.append(under(
                        "eager", eager, shard.render_sharded, sc, cam, size,
                        size, spp, Sampler(SEED, dev), mesh, max_depth=50,
                        sample_chunk=chunk))
                    check(len(runs) == 2 and len(capture_ms) == (
                        0 if eager else 2 * per_render),
                          f"render_sharded: {len(runs)} runs, "
                          f"{len(capture_ms)} captures")
                single = film_ops.tonemap(gr[0] / float(spp)).reshape(
                    size, size, 3)
                check(bool(torch.equal(imgs[0], single))
                      and bool(torch.equal(imgs[1], single)),
                      "render_sharded over two workers differs from one")
            if label == "cornell_smoke":
                check(5 in slot_paths, f"cornell_smoke drew no 5-fold path "
                      f"from the slot: {sorted(slot_paths)}")
            out["small"][label] = row
            print(f"  batch {label} {size}x{size} @ {spp} spp (chunks of "
                  f"{chunk}): graph = eager bitwise, launches {gr[1]}, slot "
                  f"paths {sorted(slot_paths)}"
                  + (", = the per-bounce loop, and two workers on the card "
                     "= one" if label == "teapot" else ""))
    finally:
        deterministic(False)
        isect.SPHERE_KERNEL = False
        kbuild.GraphReplay, path_mod.BatchRun = replay_cls, run_cls
        tf.threefry_draw = draw
        path_mod.batch_route = route
    return out


def main():
    import torch
    t_start = time.perf_counter()

    def stamp(phase):
        """The command's clock at the start of a phase (the smoke has 1,200
        s in all)."""
        print(f"[time] phase {phase} starts at "
              f"{time.perf_counter() - t_start:.1f} s")

    # 1. the card
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: chip_smoke.py needs a GPU")
    from concurrent.futures import ThreadPoolExecutor

    from hobbyraytracer_tpu_torch import native
    from hobbyraytracer_tpu_torch.core.rng import Sampler
    from hobbyraytracer_tpu_torch.integrator import wavefront
    from hobbyraytracer_tpu_torch.core.types import Rays
    from hobbyraytracer_tpu_torch.kernels import mesh_traverse as kmod
    from hobbyraytracer_tpu_torch.kernels import sphere_scan
    from hobbyraytracer_tpu_torch.kernels import sphere_traverse as skmod
    from hobbyraytracer_tpu_torch.kernels import threefry
    from hobbyraytracer_tpu_torch.ops import intersect as isect
    from hobbyraytracer_tpu_torch.scene import objloader
    from hobbyraytracer_tpu_torch.scene.bvh import build_clusters

    dev = torch.device(DEVICE)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(card)
    sm_clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0])
    sm_count = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"{sm_count} SMs, maximum SM clock {sm_clock_mhz:.0f} MHz")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    check(isect.KEY_MODE == "auto", f"HRT_KEY_MODE is {isect.KEY_MODE!r}; "
          "the smoke test drives the default 'auto'")
    check(not isect.SPHERE_KERNEL, "HRT_SPHERE_KERNEL is set; the smoke "
          "test drives the default route first and switches it in-process")
    k1, k2, k3 = kmod.KERNEL, kmod.KERNEL_STREAM, kmod.KEY_KERNEL
    k4 = skmod.SPHERE_KERNEL
    libs = (k1, k2, k3, k4)        # the traversal kernels
    ks = sphere_scan.SCAN_KERNEL   # the dense sphere scan
    tfk = threefry.THREEFRY        # the draws

    stamp("2 and a")
    # 2 and a. build the kernels from the checkout's sources, all at once
    # (one thread, so one nvcc, each; a library left by an earlier run is
    # built again, so that ptxas reports on these sources), and load them
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libs) + 2) as pool:
        for fut in [pool.submit(lib.build) for lib in (*libs, ks, tfk)]:
            fut.result()
    for lib in (*libs, ks, tfk):
        lib.load()
    for lib in (*libs, ks, tfk):
        print(f"[build] {lib.source} -> {lib.path} in "
              f"{lib.build_seconds:.2f} s")
        for line in lib.ptxas_info:
            print(f"  {line}")
    print(f"[build] all six in {time.perf_counter() - t0:.2f} s")
    for lib in (k3, k4, ks):
        spills = [ln for ln in lib.ptxas_info if "spill" in ln]
        check(spills and all("0 bytes spill stores, 0 bytes spill loads" in ln
                             for ln in spills),
              f"{lib.name} spills registers: {spills}")
    check(native.lib() is not None, "the native cluster builder did not "
          "build: the scenes' tables would not be the reference's")
    print(f"[native] cluster builder {native.library_path()}")

    stamp("3")
    # 3. K1 vs plain at the main path's shape
    job = load_scene(SCENE)
    scene = job.scene.to(dev)
    camera = job.camera.to(dev)
    inst = next(i for i in scene.instances if i.kind == "mesh")
    mesh = inst.mesh
    k_clusters = mesh.bounds8.shape[1]
    print(f"[K1] teapot tables: K = {k_clusters}, tri_soa "
          f"{tuple(mesh.tri_soa.shape)}")
    check(mesh.tri_soa.shape[1] == kmod.SOA_ROWS, "teapot: not 24 rows")
    sets = pool_ray_sets(scene, camera, inst, lambda o, d, a: (
        isect.coherence_key(o, d, a, mesh.bounds8, 1e30)))
    args = (mesh.bounds8, mesh.tri_soa, mesh.cluster_id)
    err_k1 = 0.0
    for label, rays8 in sets.items():
        for need_uv in (False, True):
            out_k, id_k = kmod.traverse_clusters(rays8, *args,
                                                 need_uv=need_uv)
            out_p, id_p = kmod.traverse_clusters_plain(rays8, *args,
                                                       need_uv=need_uv)
            torch.cuda.synchronize()
            err_k1 = max(err_k1, compare(out_k, id_k, out_p, id_p, need_uv,
                                         f"{label}, need_uv={need_uv}"))
    shuffle = torch.randperm(POOL, generator=torch.Generator().manual_seed(
        SEED)).to(dev)
    for label, rays8 in sets.items():
        unsorted = rays8[shuffle].contiguous()
        for need_uv in (False, True):
            out_k, id_k = kmod.traverse_clusters(unsorted, *args,
                                                 need_uv=need_uv)
            out_p, id_p = kmod.traverse_clusters_plain(unsorted, *args,
                                                       need_uv=need_uv)
            torch.cuda.synchronize()
            err_k1 = max(err_k1, compare_exact(
                out_k, id_k, out_p, id_p,
                f"K1 vs plain, {label} unsorted, need_uv={need_uv}"))
    rays8 = sets["after one bounce"]
    times_k1 = {}
    for need_uv in (False, True):
        times_k1[need_uv] = (
            cuda_ms(lambda: kmod.traverse_clusters(rays8, *args,
                                                   need_uv=need_uv)),
            cuda_ms(lambda: kmod.traverse_clusters_plain(
                rays8, *args, need_uv=need_uv), reps=5, warmup=1))
        ms_unsorted = cuda_ms(lambda: kmod.traverse_clusters(
            unsorted, *args, need_uv=need_uv))
        print(f"[K1] need_uv={need_uv}: kernel {times_k1[need_uv][0]:.4f} "
              f"ms (the same rays unsorted {ms_unsorted:.4f} ms), plain "
              f"{times_k1[need_uv][1]:.4f} ms "
              f"({POOL} rays, K = {k_clusters}; {card})")
    out_k, id_k = kmod.traverse_clusters(rays8, *args, need_uv=False)
    visits = entered_clusters(rays8, mesh.bounds8, out_k[:, 0])
    ops_k1 = (POOL * k_clusters * SLAB_OPS
              + visits * mesh.tri_soa.shape[2] * TRIANGLE_OPS)
    bound_k1 = bound(nbytes(rays8, *args, out_k, id_k), ops_k1)
    print(f"[K1] bound {bound_k1[0]:.4f} ms by {bound_k1[1]} "
          f"({visits / POOL:.3f} leaf visits a ray)")

    stamp("4")
    # 4. the main path: a 640x640, 16 spp teapot render
    draws = []
    launches, seconds, mean, rays_per_s, (retired, total), _ = render(
        scene, camera, libs, "teapot", JAX_CPU_MEAN, draws=draws)
    check(launches[k1.name] > 0, "the render never launched K1")
    check(launches[k2.name] == 0, "the teapot render launched K2")
    check(draws[0] > 0, "the render never launched the threefry kernel")
    k1_launches = launches[k1.name]
    tf_launches = draws[0]
    rays_teapot = rays_per_s
    print(f"[render] teapot {WIDTH}x{HEIGHT} @ {SPP} spp, pool {POOL}: "
          f"{seconds:.3f} s, {rays_per_s:,.0f} primary rays/s, launches "
          f"{launches}, threefry {tf_launches}, retired {retired}/{total}, "
          f"mean {mean:.5f} (JAX CPU {JAX_CPU_MEAN}) on {card}")

    stamp("5")
    # 5. the whole render through the kernel vs through the plain version
    imgs = [under("plain_versions", plain, wavefront.render_image, scene,
                  camera, 64, 64, 8, Sampler(SEED + 1, dev), pool=POOL)
            for plain in (False, True)]
    diff = (imgs[0] - imgs[1]).abs().amax(dim=2)
    agree = (diff < 1e-3).float().mean().item()
    print(f"[agreement] teapot 64x64 @ 8 spp, kernel vs plain mesh find: "
          f"{agree:.4%} of pixels within 1e-3, max diff "
          f"{diff.max().item():.3g}")
    check(agree >= 0.99, f"only {agree:.4%} of pixels agree")

    stamp("b")
    # b. K2 vs plain on teapot_hires's own tables
    hjob = load_scene(HIRES)
    hscene = hjob.scene.to(dev)
    hcamera = hjob.camera.to(dev)
    hinst = next(i for i in hscene.instances if i.kind == "mesh")
    hmesh = hinst.mesh
    hk = hmesh.bounds8.shape[1]
    print(f"[K2] teapot_hires tables: K = {hk}, tri_soa "
          f"{tuple(hmesh.tri_soa.shape)}")
    check(hmesh.tri_soa.shape[1] == kmod.STREAM_ROWS,
          "teapot_hires: not the 32-row streaming table")
    check(hk >= isect.CORRIDOR_MIN_K, "teapot_hires: not corridor-keyed")
    hsets = pool_ray_sets(hscene, hcamera, hinst, lambda o, d, a: (
        isect.coherence_key(o, d, a, hmesh.bounds8, 1e30)))
    hargs = (hmesh.bounds8, hmesh.tri_soa, hmesh.cluster_id)
    err_k2 = 0.0
    for label, rays8 in hsets.items():
        for need_uv in (False, True):
            out_k, id_k = kmod.traverse_clusters(rays8, *hargs,
                                                 need_uv=need_uv)
            out_p, id_p = kmod.traverse_clusters_plain(rays8, *hargs,
                                                       need_uv=need_uv)
            torch.cuda.synchronize()
            err_k2 = max(err_k2, compare_exact(
                out_k, id_k, out_p, id_p,
                f"K2 vs plain, {label}, need_uv={need_uv}"))
    for label, rays8 in hsets.items():
        unsorted = rays8[shuffle].contiguous()
        for need_uv in (False, True):
            out_k, id_k = kmod.traverse_clusters(unsorted, *hargs,
                                                 need_uv=need_uv)
            out_p, id_p = kmod.traverse_clusters_plain(unsorted, *hargs,
                                                       need_uv=need_uv)
            torch.cuda.synchronize()
            err_k2 = max(err_k2, compare_exact(
                out_k, id_k, out_p, id_p,
                f"K2 vs plain, {label} unsorted, need_uv={need_uv}"))
    rays8 = hsets["after one bounce"]
    times_k2 = {}
    for need_uv in (False, True):
        times_k2[need_uv] = (
            cuda_ms(lambda: kmod.traverse_clusters(rays8, *hargs,
                                                   need_uv=need_uv)),
            cuda_ms(lambda: kmod.traverse_clusters_plain(
                rays8, *hargs, need_uv=need_uv), reps=3, warmup=1))
        ms_unsorted = cuda_ms(lambda: kmod.traverse_clusters(
            unsorted, *hargs, need_uv=need_uv))
        print(f"[K2] need_uv={need_uv}: kernel {times_k2[need_uv][0]:.4f} "
              f"ms (the same rays unsorted {ms_unsorted:.4f} ms), plain "
              f"{times_k2[need_uv][1]:.4f} ms "
              f"({POOL} rays, K = {hk}; {card})")
    out_k, id_k = kmod.traverse_clusters(rays8, *hargs, need_uv=False)
    visits = entered_clusters(rays8, hmesh.bounds8, out_k[:, 0])
    ops_k2 = (POOL * hk * SLAB_OPS
              + visits * hmesh.tri_soa.shape[2] * TRIANGLE_OPS)
    bound_k2 = bound(nbytes(rays8, hmesh.bounds8, hmesh.tri_soa, out_k, id_k),
                     ops_k2)
    print(f"[K2] bound {bound_k2[0]:.4f} ms by {bound_k2[1]} "
          f"({visits / POOL:.3f} leaf visits a ray)")

    stamp("c")
    # c. K2 vs K1 bitwise past K1's old cap, both vs plain
    m = objloader.parse_obj("assets/teapot_hires.obj")
    idx = m["indices"][:HIRES_PREFIX]
    cl = build_clusters(m["verts"], idx, leaf_size=hmesh.tri_soa.shape[2])
    corner = idx[cl["tri_id"].clip(min=0)]
    soa = kmod.pack_mesh_soa(cl["tri_verts"], m["normals"][corner],
                             m["uvs"][corner])
    stream = kmod.pack_mesh_stream(soa, cl["tri_id"])
    c_b8, c_soa, c_ids, c_stream = (torch.from_numpy(x).to(dev) for x in (
        kmod.pack_bounds(cl["bmin"], cl["bmax"]), soa, cl["tri_id"],
        stream))
    ck = c_b8.shape[1]
    check(ck > 256, f"phase c mesh has only {ck} clusters")
    print(f"[K2 vs K1] first {HIRES_PREFIX} triangles of teapot_hires: "
          f"K = {ck}, tables {tuple(c_soa.shape)} and "
          f"{tuple(c_stream.shape)}")
    for label, rays8 in hsets.items():
        for need_uv in (False, True):
            out_2, id_2 = kmod.traverse_clusters(rays8, c_b8, c_stream,
                                                 None, need_uv=need_uv)
            out_1, id_1 = kmod.traverse_clusters(rays8, c_b8, c_soa, c_ids,
                                                 need_uv=need_uv)
            out_p, id_p = kmod.traverse_clusters_plain(
                rays8, c_b8, c_soa, c_ids, need_uv=need_uv)
            torch.cuda.synchronize()
            tag = f"{label}, need_uv={need_uv}"
            err_k2 = max(err_k2, compare_exact(out_2, id_2, out_1, id_1,
                                               f"K2 vs K1, {tag}"))
            err_k1 = max(err_k1, compare_exact(out_1, id_1, out_p, id_p,
                                               f"K1 vs plain, {tag}"))

    # the resident-vs-stream rule: K1 and K2 on one mesh, packed both ways
    same_mesh = {
        "teapot": same_mesh_k1_k2(
            dev, "the teapot", sets["after one bounce"], mesh.bounds8,
            mesh.tri_soa, mesh.cluster_id,
            kmod.pack_mesh_stream_torch(mesh.tri_soa, mesh.cluster_id)),
        "teapot_hires": same_mesh_k1_k2(
            dev, "teapot_hires", hsets["after one bounce"], hmesh.bounds8,
            hmesh.tri_soa[:, :kmod.SOA_ROWS].contiguous(), hmesh.cluster_id,
            hmesh.tri_soa)}

    stamp("d")
    # d. K3 vs plain on phase b's rays
    err_k3 = 0.0
    for label, rays8 in hsets.items():
        e_k, f_k = kmod.coherence_keys(rays8, hmesh.bounds8)
        e_p, f_p = kmod.coherence_keys_plain(rays8, hmesh.bounds8)
        torch.cuda.synchronize()
        finite = torch.isfinite(e_p)
        check(bool(finite.any()), f"K3, {label}: every ray missed")
        check(bool(torch.equal(e_k, e_p)),
              f"K3, {label}: e_min differs on {int((e_k != e_p).sum())} rays")
        check(bool(torch.equal(f_k, f_p)),
              f"K3, {label}: first differs on {int((f_k != f_p).sum())} rays")
        err_k3 = max(err_k3, (e_k[finite] - e_p[finite]).abs().max().item())
        print(f"  K3 vs plain, {label}: {len(e_k)} rays, "
              f"{int(finite.sum())} enter a cluster, e_min and first equal")
    rays8 = hsets["after one bounce"]
    times_k3 = (cuda_ms(lambda: kmod.coherence_keys(rays8, hmesh.bounds8)),
                cuda_ms(lambda: kmod.coherence_keys_plain(rays8,
                                                          hmesh.bounds8),
                        reps=5, warmup=1))
    print(f"[K3] kernel {times_k3[0]:.4f} ms, plain {times_k3[1]:.4f} ms "
          f"({POOL} rays, K = {hk}; {card})")
    ops_k3 = POOL * hk * SLAB_OPS
    bound_k3 = bound(nbytes(rays8, hmesh.bounds8, e_k, f_k), ops_k3)
    print(f"[K3] bound {bound_k3[0]:.4f} ms by {bound_k3[1]}")

    stamp("e")
    # e. the large-mesh path: a 640x640, 16 spp teapot_hires render
    launches, seconds, mean, rays_per_s, (retired, total), _ = render(
        hscene, hcamera, libs, "teapot_hires", JAX_CPU_MEAN_HIRES)
    check(launches[k2.name] > 0, "the teapot_hires render never launched K2")
    check(launches[k1.name] == 0, "the teapot_hires render launched K1")
    k2_launches = launches[k2.name]
    print(f"[render] teapot_hires {WIDTH}x{HEIGHT} @ {SPP} spp, pool "
          f"{POOL}: {seconds:.3f} s, {rays_per_s:,.0f} primary rays/s, "
          f"launches {launches}, retired {retired}/{total}, mean "
          f"{mean:.5f} (JAX CPU {JAX_CPU_MEAN_HIRES}) on {card}")

    stamp("f")
    # f. HRT_KEY_MODE auto vs pallas (K3) on the same render
    imgs = {}
    for mode in ("auto", "pallas"):
        isect.KEY_MODE = mode
        for lib in libs:
            lib.launches = 0
        imgs[mode] = wavefront.render_image(hscene, hcamera, 64, 64, 8,
                                            Sampler(SEED + 2, dev),
                                            pool=POOL)
        torch.cuda.synchronize()
        launches = {lib.name: lib.launches for lib in libs}
        print(f"[key mode] {mode}: launches {launches}")
        check(launches[k2.name] > 0, f"{mode}: K2 never launched")
        check((launches[k3.name] > 0) == (mode == "pallas"),
              f"{mode}: K3 launched {launches[k3.name]} times")
    isect.KEY_MODE = "auto"
    k3_launches = launches[k3.name]
    diff = (imgs["auto"] - imgs["pallas"]).abs().max().item()
    print(f"[key mode] teapot_hires 64x64 @ 8 spp, auto vs pallas keys: "
          f"max pixel diff {diff:.3g} (tolerance {F_ATOL})")
    check(diff <= F_ATOL, f"auto and pallas keys give images {diff} apart")

    stamp("g")
    # g. K4 vs plain on the balls scene's own sphere tables
    bjob = load_scene(BALLS)
    bscene = bjob.scene.to(dev)
    # the scene's camera (built for its 16:9 film) on a square image, as
    # in the JAX CPU renders behind JAX_CPU_MEAN_BALLS
    bcamera = bjob.camera.to(dev)
    sp = bscene.spheres
    bk = sp.kernel_bounds.shape[1]
    print(f"[K4] scattered_balls tables: {sp.center.shape[0]} spheres, "
          f"K = {bk}, table {tuple(sp.kernel_table.shape)}")
    check(set(bscene.materials.present) == {0, 1, 2},
          f"balls materials {bscene.materials.present}")
    bsets = pool_ray_sets(bscene, bcamera)
    sargs = (sp.kernel_bounds, sp.kernel_table, sp.kernel_ids)
    t_min = T_MIN
    ordered = dict(bsets)
    ordered.update({f"{label}, random order": rays8[shuffle].contiguous()
                    for label, rays8 in bsets.items()})
    for label, rays8 in ordered.items():
        t_k, id_k = skmod.intersect_spheres_kernel(rays8, *sargs, t_min)
        t_p, id_p = skmod.intersect_spheres_plain(rays8, *sargs, t_min)
        torch.cuda.synchronize()
        n_hit = int((id_p >= 0).sum())
        check(n_hit > 0, f"K4, {label}: no ray hit a sphere")
        check(bool(torch.equal(id_k, id_p)),
              f"K4, {label}: ids differ on {int((id_k != id_p).sum())} rays")
        check(bool(torch.equal(t_k, t_p)),
              f"K4, {label}: t differs on {int((t_k != t_p).sum())} rays")
        print(f"  K4 vs plain, {label}: {len(id_k)} rays, {n_hit} hits, "
              f"hit masks, ids and t bitwise equal")
    err_k4 = (t_k - t_p).abs().max().item()
    rays8 = bsets["after one bounce"]
    brays = Rays(o=rays8[:, 0:3].contiguous(), d=rays8[:, 3:6].contiguous())
    times_k4 = (
        cuda_ms(lambda: skmod.intersect_spheres_kernel(rays8, *sargs, t_min)),
        cuda_ms(lambda: skmod.intersect_spheres_plain(rays8, *sargs, t_min),
                reps=5, warmup=1),
        cuda_ms(lambda: isect.intersect_spheres(
            brays, sp.center, sp.radius, sp.mat_id, t_min, 1e30),
            reps=5, warmup=1))
    unsorted = ordered["after one bounce, random order"]
    ms_unsorted = cuda_ms(lambda: skmod.intersect_spheres_kernel(
        unsorted, *sargs, t_min))
    print(f"[K4] kernel {times_k4[0]:.4f} ms (the same rays in random order "
          f"{ms_unsorted:.4f} ms), plain {times_k4[1]:.4f} ms, "
          f"dense route (sphere_scan and its hit records) {times_k4[2]:.4f} "
          f"ms ({POOL} rays, K = {bk}; {card})")
    t_k, id_k = skmod.intersect_spheres_kernel(rays8, *sargs, t_min)
    visits = entered_clusters(rays8, sp.kernel_bounds, t_k)
    ops_k4 = (POOL * bk * SLAB_OPS
              + visits * sp.kernel_table.shape[2] * SPHERE_OPS)
    bound_k4 = bound(nbytes(rays8, *sargs, t_k, id_k), ops_k4)
    print(f"[K4] bound {bound_k4[0]:.4f} ms by {bound_k4[1]} "
          f"({visits / POOL:.3f} cluster visits a ray)")

    # sphere_scan vs the chunked scan it fuses, on the same pool rays
    n_sph = sp.center.shape[0]
    scan_args = (sp.center, sp.radius, t_min, 1e30)
    for label, rays8 in bsets.items():
        r = Rays(o=rays8[:, 0:3].contiguous(), d=rays8[:, 3:6].contiguous())
        t_s, id_s = sphere_scan.scan_spheres(r, *scan_args)
        t_q, id_q = sphere_scan.scan_spheres_plain(r, *scan_args)
        torch.cuda.synchronize()
        check(bool(torch.equal(id_s, id_q)),
              f"sphere_scan, {label}: winners differ on "
              f"{int((id_s != id_q).sum())} rays")
        check(bool(torch.equal(t_s, t_q)),
              f"sphere_scan, {label}: t differs on {int((t_s != t_q).sum())} "
              "rays")
        print(f"  sphere_scan vs the chunked scan, {label}: {POOL} rays, "
              f"{int((id_s >= 0).sum())} hits, t and winners bitwise equal")
    err_scan = (t_s - t_q).abs().max().item()
    times_scan = (
        cuda_ms(lambda: sphere_scan.scan_spheres(brays, *scan_args)),
        cuda_ms(lambda: sphere_scan.scan_spheres_plain(brays, *scan_args),
                reps=5, warmup=1))
    t_s, id_s = sphere_scan.scan_spheres(brays, *scan_args)
    ops_scan = POOL * n_sph * SCAN_OPS
    bound_scan = bound(nbytes(brays.o, brays.d, sp.center, sp.radius, t_s,
                              id_s), ops_scan)
    print(f"[sphere_scan] kernel {times_scan[0]:.4f} ms, plain (the chunked "
          f"scan) {times_scan[1]:.4f} ms, dense route with its hit records "
          f"{times_k4[2]:.4f} ms ({POOL} rays, {n_sph} spheres; {card}); "
          f"bound {bound_scan[0]:.4f} ms by {bound_scan[1]}, issue bound "
          f"{issue_bound(ops_scan, sm_count, sm_clock_mhz):.4f} ms")

    stamp("h")
    # h. K4's route vs the dense route on the same rays
    for label, rays8 in bsets.items():
        r = Rays(o=rays8[:, 0:3].contiguous(), d=rays8[:, 3:6].contiguous())
        valid = rays8[:, 6] > 0.0
        h_c = isect.intersect_spheres_clustered(
            r, sp.center, sp.radius, sp.mat_id, sp.kernel_table,
            sp.kernel_bounds, sp.kernel_ids, t_min, 1e30, ray_valid=valid)
        h_d = isect.intersect_spheres(r, sp.center, sp.radius, sp.mat_id,
                                      t_min, 1e30)
        torch.cuda.synchronize()
        check(not bool(h_c.hit[~valid].any()), f"{label}: a dead lane hit")
        off = valid & ((h_c.hit != h_d.hit) | (h_c.mat_id != h_d.mat_id))
        n_off = int(off.sum())
        check(n_off <= ROUTE_MAX_OFF * int(valid.sum()),
              f"{label}: routes differ on {n_off} rays")
        m = valid & h_d.hit & ~off
        dp = (h_c.t[m] - h_d.t[m]).abs() * r.d[m].norm(dim=1)
        check(bool((dp <= ROUTE_P_ATOL).all()),
              f"{label}: hit points up to {dp.max().item()} apart")
        near = (dp <= ROUTE_P_ATOL99).float().mean().item()
        check(near >= 0.99, f"{label}: only {near:.4%} of hit points within "
              f"{ROUTE_P_ATOL99}")
        n_err = (h_c.normal[m] - h_d.normal[m]).abs().max().item()
        check(n_err <= ROUTE_N_ATOL, f"{label}: normals {n_err} apart")
        print(f"  clustered vs dense route, {label}: {int(valid.sum())} live "
              f"rays, {int(m.sum())} hits, {n_off} grazing rays differ, hit "
              f"points at most {dp.max().item():.3g} apart ({near:.4%} "
              f"within {ROUTE_P_ATOL99}), max normal err {n_err:.3g}")

    stamp("i")
    # i. the sphere path: 640x640, 16 spp balls renders by both routes
    k4_launches = scan_launches = 0
    for on in (False, True):
        isect.SPHERE_KERNEL = on
        launches, seconds, mean, rays_per_s, (retired, total), segs = render(
            bscene, bcamera, (*libs, ks), "scattered_balls",
            JAX_CPU_MEAN_BALLS)
        route = "K4 (SPHERE_KERNEL on)" if on else "dense scan (default)"
        check((launches[k4.name] > 0) == on,
              f"{route}: K4 launched {launches[k4.name]} times")
        check(launches[ks.name] == (0 if on else segs) and segs > 0,
              f"{route}: sphere_scan launched {launches[ks.name]} times in "
              f"{segs} segments")
        check(launches[k1.name] == launches[k2.name] == launches[k3.name] == 0,
              f"the balls render launched a mesh kernel: {launches}")
        k4_launches = launches[k4.name] or k4_launches
        scan_launches = launches[ks.name] or scan_launches
        print(f"[render] scattered_balls {WIDTH}x{HEIGHT} @ {SPP} spp, pool "
              f"{POOL}, {route}: {seconds:.3f} s, {rays_per_s:,.0f} primary "
              f"rays/s, launches {launches}, retired {retired}/{total}, "
              f"mean {mean:.5f} (JAX CPU {JAX_CPU_MEAN_BALLS}) on {card}")

    stamp("j")
    # j. the whole render through K4 vs through its plain version
    imgs = [under("plain_versions", plain, wavefront.render_image, bscene,
                  bcamera, 64, 64, 8, Sampler(SEED + 3, dev), pool=POOL)
            for plain in (False, True)]
    isect.SPHERE_KERNEL = False
    diff = (imgs[0] - imgs[1]).abs().amax(dim=2)
    agree = (diff < 1e-3).float().mean().item()
    print(f"[agreement] scattered_balls 64x64 @ 8 spp, K4 vs plain sphere "
          f"find: {agree:.4%} of pixels within 1e-3, max diff "
          f"{diff.max().item():.3g}")
    check(agree >= 0.99, f"only {agree:.4%} of pixels agree")

    stamp("k")
    # k. K1 and K2 vs plain on rays that outrun the window and scan again
    r_b8, r_soa, r_ids, r_stream = (
        torch.from_numpy(x).to(dev) for x in random_leaf_tables(
            SEED + 4, REFILL_TRIS, REFILL_LEAF))
    rk = r_b8.shape[1]
    check(rk > 2048, f"phase k mesh has only {rk} clusters")
    rays8 = random_rays8(SEED + 5, REFILL_RAYS, 6.0).to(dev)
    for need_uv in (False, True):
        out_p, id_p = kmod.traverse_clusters_plain(rays8, r_b8, r_soa, r_ids,
                                                   need_uv=need_uv)
        out_1, id_1 = kmod.traverse_clusters(rays8, r_b8, r_soa, r_ids,
                                             need_uv=need_uv)
        out_2, id_2 = kmod.traverse_clusters(rays8, r_b8, r_stream, None,
                                             need_uv=need_uv)
        torch.cuda.synchronize()
        tag = f"K = {rk}, {REFILL_LEAF}-triangle leaves, need_uv={need_uv}"
        err_k1 = max(err_k1, compare_exact(out_1, id_1, out_p, id_p,
                                           f"K1 vs plain, {tag}"))
        err_k2 = max(err_k2, compare_exact(out_2, id_2, out_p, id_p,
                                           f"K2 vs plain, {tag}"))
    # a ray that enters more clusters than the window holds uses a full
    # window of pending visits up and scans the boxes again
    n_refill = int((entered_per_ray(rays8, r_b8, out_p[:, 0]) > WINDOW).sum())
    print(f"[refill] {n_refill} of {REFILL_RAYS} rays enter more than "
          f"{WINDOW} clusters before their final hit and scan again")
    check(n_refill >= REFILL_MIN, f"only {n_refill} rays refill their window")

    stamp("l")
    # l. K4 on pools whose K exceeds the window, K3 at K % 4 != 0 and with
    # the boxes in global memory, refilling and tied rays counted
    srays = random_rays8(SEED + 7, REFILL_RAYS, SPHERE_RAY_SPREAD).to(dev)
    for n_spheres, leaf in SPHERE_POOLS:
        l_b8, l_tab, l_ids = (torch.from_numpy(x).to(dev) for x in
                              random_sphere_tables(SEED + 6, n_spheres, leaf))
        lk = l_b8.shape[1]
        check(lk >= 40, f"phase l pool has only {lk} clusters")
        t_k, id_k = skmod.intersect_spheres_kernel(srays, l_b8, l_tab, l_ids,
                                                   t_min)
        t_p, id_p = skmod.intersect_spheres_plain(srays, l_b8, l_tab, l_ids,
                                                  t_min)
        torch.cuda.synchronize()
        n_hit = int((id_p >= 0).sum())
        check(n_hit > 0, f"K4, K = {lk}: no ray hit a sphere")
        check(bool(torch.equal(id_k, id_p)),
              f"K4, K = {lk}: ids differ on {int((id_k != id_p).sum())} rays")
        check(bool(torch.equal(t_k, t_p)),
              f"K4, K = {lk}: t differs on {int((t_k != t_p).sum())} rays")
        n_refill = int((entered_per_ray(srays, l_b8, t_p) > WINDOW).sum())
        print(f"  K4 vs plain, {n_spheres} random spheres, K = {lk}, L = "
              f"{leaf}: {REFILL_RAYS} rays, {n_hit} hits, ids and t bitwise "
              f"equal; {n_refill} rays enter more than {WINDOW} clusters and "
              f"scan again")
        check(n_refill >= REFILL_MIN,
              f"K4, K = {lk}: only {n_refill} rays refill their window")
    for label, r8, b8 in (
            ("teapot_hires's first boxes", hsets["after one bounce"],
             hmesh.bounds8[:, :hk - 1 if (hk - 1) % 4 else hk - 2]
             .contiguous()),
            ("the random mesh, boxes in global memory", rays8, r_b8)):
        kk = b8.shape[1]
        check(kk % 4 != 0 or kk > 2048, f"K3, {label}: K = {kk}")
        e_k, f_k = kmod.coherence_keys(r8, b8)
        e_p, f_p = kmod.coherence_keys_plain(r8, b8)
        torch.cuda.synchronize()
        check(bool(torch.equal(e_k, e_p)),
              f"K3, {label}: e_min differs on {int((e_k != e_p).sum())} rays")
        check(bool(torch.equal(f_k, f_p)),
              f"K3, {label}: first differs on {int((f_k != f_p).sum())} rays")
        n_tied = tied_rays(r8, b8, e_p)
        print(f"  K3 vs plain, {label}: K = {kk}, {len(e_k)} rays, e_min and "
              f"first equal; {n_tied} rays share their smallest entry "
              f"between clusters")
        check(n_tied >= REFILL_MIN, f"K3, {label}: only {n_tied} tied rays")

    stamp("m")
    # m. the two-mesh path: 640x640, 16 spp two_teapots renders by the
    # default route and with the pool sorted every second segment
    tjob = load_scene(TWO)
    tscene = tjob.scene.to(dev)
    tcamera = tjob.camera.to(dev)
    n_meshes = sum(i.kind == "mesh" for i in tscene.instances)
    check(n_meshes == 2, f"two_teapots has {n_meshes} meshes")
    k1_by_path = {"teapot": k1_launches}
    two_imgs = []
    for pool_sort in (0, 2):
        launches, seconds, mean, rays_per_s, (retired, total), segs = render(
            tscene, tcamera, libs, "two_teapots", JAX_CPU_MEAN_TWO,
            pool_sort=pool_sort, keep=two_imgs)
        route = (f"pool_sort={pool_sort} (cohsort=False)" if pool_sort
                 else "default route (per-mesh sort)")
        check(launches[k1.name] == n_meshes * segs,
              f"{route}: K1 launched {launches[k1.name]} times in {segs} "
              f"segments")
        check(launches[k2.name] == launches[k3.name] == launches[k4.name]
              == 0, f"the two_teapots render launched {launches}")
        k1_by_path[f"two_teapots pool_sort={pool_sort}"] = launches[k1.name]
        print(f"[render] two_teapots {WIDTH}x{HEIGHT} @ {SPP} spp, pool "
              f"{POOL}, {route}: {seconds:.3f} s, {rays_per_s:,.0f} primary "
              f"rays/s, {segs} segments, launches {launches} "
              f"({launches[k1.name] / segs:g} K1 a segment), retired "
              f"{retired}/{total}, mean {mean:.5f} (JAX CPU "
              f"{JAX_CPU_MEAN_TWO}) on {card}")
    moved = (two_imgs[0] - two_imgs[1]).abs().amax(dim=2)
    print(f"  two_teapots, pool_sort=2 against the per-mesh sort: "
          f"{(moved > 0).float().mean().item():.2%} of pixels differ (a "
          f"permuted lane draws other numbers), max diff "
          f"{moved.max().item():.3g}")

    stamp("dd")
    # dd. the graph route: threefry.cu vs plain, graph vs eager renders, the
    # teapot's rays/s, segment ms and idle share both ways
    err_tf, times_tf, bound_tf, ops_tf, batch_draw = phase_threefry(
        dev, card, tfk)
    graph = phase_graph(dev, card, (*libs, tfk), {
        "teapot": (scene, camera, False, "auto"),
        "teapot_hires": (hscene, hcamera, False, "auto"),
        "teapot_hires (K3)": (hscene, hcamera, False, "pallas"),
        "scattered_balls (K4)": (bscene, bcamera, True, "auto"),
        "two_teapots": (tscene, tcamera, False, "auto")})
    print("[graph numbers] " + json.dumps({
        "card": card, "threefry_ms": times_tf, **graph}))

    stamp("n")
    # n. K1 with cohsort=False on a pool the pool sort permuted
    _, n_chunks, _ = wavefront._chunk_geometry(SPP, wavefront.SAMPLE_CHUNK)
    total_items = WIDTH * HEIGHT * n_chunks
    sampler = Sampler(SEED, dev)
    state = wavefront.init_state(WIDTH, HEIGHT, POOL, device=dev)
    # start the queue at the lower image rows, which see the teapots
    state.counter.fill_(WIDTH * HEIGHT - POOL)
    for _ in range(3):
        wavefront._regenerate(state, tcamera, WIDTH, HEIGHT, total_items,
                              sampler)
        wavefront._segment(state, tscene, WIDTH, HEIGHT, sampler, 50, SPP)
    wavefront._regenerate(state, tcamera, WIDTH, HEIGHT, total_items, sampler)
    wavefront._pool_permute(state, tscene)
    active = wavefront._active(state)
    for n, tinst in enumerate(i for i in tscene.instances
                              if i.kind == "mesh"):
        tm = tinst.mesh
        r = tinst.transform.ray_to_object(Rays(o=state.o, d=state.d))
        find = dict(rays=r, tri_id=tm.cluster_id, tri_soa=tm.tri_soa,
                    bounds8=tm.bounds8, t_max=1e30, ray_valid=active)
        k1.launches = k3.launches = 0
        got = isect.intersect_mesh_clustered_fused(**find, cohsort=False)
        check((k1.launches, k3.launches) == (1, 0),
              f"cohsort=False launched K1 {k1.launches} and K3 "
              f"{k3.launches} times")
        plain = under("plain_versions", True,
                      isect.intersect_mesh_clustered_fused, **find,
                      cohsort=False)
        by_mesh = isect.intersect_mesh_clustered_fused(**find, cohsort=True)
        torch.cuda.synchronize()
        n_hit = int(got[2].sum())
        check(n_hit > 0, f"mesh {n}: no ray of the permuted pool hit it")
        for name, a, b, c in zip(("t", "id", "hit", "normal", "uv"), got,
                                 plain, by_mesh):
            check(bool(torch.equal(a, b)),
                  f"mesh {n}, cohsort=False: {name} differs from the plain "
                  f"version")
            check(bool(torch.equal(a, c)),
                  f"mesh {n}: {name} differs between cohsort=False and the "
                  f"per-mesh sort")
        print(f"  K1 cohsort=False vs plain, two_teapots mesh {n} on the "
              f"permuted pool: {POOL} lanes ({int(active.sum())} live), "
              f"{n_hit} hits, bitwise equal, and lane for lane equal to the "
              f"per-mesh-sorted call")

    stamp("o")
    # o. the lockstep find on the card against K1
    from hobbyraytracer_tpu_torch.scene import ir as scene_ir
    rays8 = sets["after one bounce"]
    r = Rays(o=rays8[:, 0:3].contiguous(), d=rays8[:, 3:6].contiguous())
    valid = rays8[:, 6] > 0.0
    tri_verts, bmin, bmax = scene_ir._live_clusters(mesh)
    k1.launches = 0
    t_l, id_l, hit_l = isect.intersect_mesh_clustered(
        r, tri_verts, mesh.cluster_id, bmin, bmax, 1e30, ray_valid=valid)
    check(k1.launches == 0, "the lockstep find launched K1")
    out_k, id_k = kmod.traverse_clusters(rays8, *args, need_uv=False)
    torch.cuda.synchronize()
    hit_k = out_k[:, 0] < 1e30
    check(bool(torch.equal(hit_l, hit_k)),
          f"lockstep find: hit masks differ on {int((hit_l != hit_k).sum())}")
    dt = (t_l[hit_k] - out_k[hit_k, 0]).abs()
    check(bool((dt <= 1e-6 + 1e-6 * out_k[hit_k, 0].abs()).all()),
          f"lockstep find: t off by up to {dt.max().item()}")
    id_diff = ((id_l != id_k) & hit_k).float().mean().item()
    check(id_diff < 0.01, f"lockstep find: ids differ on {id_diff:.4%}")
    ms_lock = cuda_ms(lambda: isect.intersect_mesh_clustered(
        r, tri_verts, mesh.cluster_id, bmin, bmax, 1e30, ray_valid=valid),
        reps=3, warmup=1)
    print(f"[lockstep] teapot, after one bounce: {POOL} rays, "
          f"{int(hit_k.sum())} hits, masks equal, max |dt| "
          f"{dt.max().item():.3g}, ids differ on {id_diff:.4%}; lockstep "
          f"find {ms_lock:.3f} ms (one host read a round) beside K1 "
          f"{times_k1[False][0]:.4f} ms on {card}")

    stamp("p")
    # p. media: cornell_smoke at its own size, then a mesh-boundary fog
    from hobbyraytracer_tpu_torch.scene import build_scene, load_scene_desc
    sjob = build_scene(load_scene_desc(SMOKE))
    sscene, scamera = sjob.scene.to(dev), sjob.camera.to(dev)
    check(len(sscene.media) == 2, f"cornell_smoke media {len(sscene.media)}")
    launches, seconds, mean, rays_per_s, (retired, total), segs = render(
        sscene, scamera, (*libs, ks), "cornell_smoke", JAX_CPU_MEAN_SMOKE,
        width=sjob.width, height=sjob.height, spp=sjob.samples)
    smoke_scans = launches.pop(ks.name)
    check(not any(launches.values()) and smoke_scans == segs,
          f"the cornell_smoke render launched {launches}, sphere_scan "
          f"{smoke_scans} times in {segs} segments")
    print(f"[render] cornell_smoke {sjob.width}x{sjob.height} @ "
          f"{sjob.samples} spp, pool {POOL}: {seconds:.3f} s, "
          f"{rays_per_s:,.0f} primary rays/s, {segs} segments, retired "
          f"{retired}/{total}, mean {mean:.5f} (JAX CPU "
          f"{JAX_CPU_MEAN_SMOKE}) on {card}")
    with tempfile.TemporaryDirectory() as tmp:
        fog_path = os.path.join(tmp, "fog.yaml")
        with open(fog_path, "w") as f:
            f.write(FOG_SCENE.format(obj=os.path.abspath(
                "assets/teapot.obj")))
        fjob = build_scene(load_scene_desc(fog_path))
    fscene, fcamera = fjob.scene.to(dev), fjob.camera.to(dev)
    fog = fscene.media[0]
    check(fog.btype == "mesh" and fog.mesh.use_bvh,
          "the fog's boundary is not a clustered mesh")
    state = wavefront.init_state(WIDTH, HEIGHT, POOL, device=dev)
    # start the queue at the lower image rows, which see the teapot
    state.counter.fill_(WIDTH * HEIGHT - POOL)
    fog_hits = 0
    for lib in libs:
        lib.launches = 0
    for _ in range(FOG_SEGMENTS):
        wavefront._regenerate(state, fcamera, WIDTH, HEIGHT, total_items,
                              sampler)
        # the segment's own hits: the same rays, sampler and stream index
        hits = scene_ir.intersect_scene(
            fscene, Rays(o=state.o, d=state.d), sampler=sampler,
            bounce=state.it, ray_valid=wavefront._active(state))
        fog_hits += int((wavefront._active(state)
                         & (hits.mat_id == fog.mat_id)).sum())
        wavefront._segment(state, fscene, WIDTH, HEIGHT, sampler, 50, SPP)
    torch.cuda.synchronize()
    for f in ("o", "d", "thr", "rad", "fb"):
        check(bool(torch.isfinite(getattr(state, f)).all()),
              f"mesh-boundary fog: non-finite {f}")
    check(fog_hits >= FOG_MIN_HITS,
          f"mesh-boundary fog: only {fog_hits} rays scattered in it")
    check(not any(lib.launches for lib in libs),
          "the mesh-boundary medium launched a kernel")
    print(f"[media] teapot-bounded fog, {FOG_SEGMENTS} segments at pool "
          f"{POOL}: finite, {fog_hits} rays scattered in the medium (its "
          f"boundary found by the lockstep find, no kernel)")

    stamp("q")
    # q. the batch integrator by both routes
    batch = phase_batch(dev, card, (*libs, tfk), {
        "teapot": (scene, camera), "cornell_smoke": (sscene, scamera),
        "scattered_balls (K4)": (bscene, bcamera),
        "teapot_hires": (hscene, hcamera)})
    print("[batch numbers] " + json.dumps({"card": card, **batch}))
    err_k1 = max(err_k1, batch["k1_err"])
    k1_by_path[f"teapot by the batch integrator ({WIDTH}x{HEIGHT} @ {SPP} "
               "spp, depth 50; graph and eager alike)"] = (
        batch["launches"][k1.name])

    stamp("r")
    # r. the tables a vertex fit refreshes, on the card, and the kernels'
    # finds over them
    host = {path: next(i.mesh for i in load_scene(path).scene.instances
                       if i.kind == "mesh") for path in (SCENE, HIRES)}
    phase_refresh(dev, {
        "teapot": (host[SCENE], mesh, sets["after one bounce"], k1),
        "teapot_hires": (host[HIRES], hmesh, hsets["after one bounce"], k2)})

    stamp("s-v")
    # s-v. the differentiable fit on shiny_teapot
    fjob = build_scene(load_scene_desc(FIT_SCENE))
    fscene, fcamera = fjob.scene.to(dev), fjob.camera.to(dev)
    fw, fh = max(16, fjob.width // 8), max(16, fjob.height // 8)
    fit_ms, k1_step, k2_step = phase_fit_grads(
        dev, card, fscene, fcamera, fw, fh, k1, (hscene, hcamera), k2)
    stamp("t")
    fit = phase_fit(dev, card, k1)
    stamp("u")
    full = phase_full_film(dev, card, fscene, fcamera, fjob.width,
                           fjob.height)
    stamp("v")
    phase_boundary(dev, card)
    print("[fit numbers] " + json.dumps({
        "card": card, "scene": FIT_SCENE, "size": [fw, fh], "spp": FIT_SPP,
        "depth": FIT_DEPTH, "loss_backward_ms": fit_ms, **fit,
        "full_film": dict(full, size=[fjob.width, fjob.height])}))
    k1_by_path[f"fit step ({fw}x{fh} @ {FIT_SPP} spp, depth {FIT_DEPTH})"] = (
        k1_step)
    k1_by_path[f"fit ({fit['steps']} steps and the target)"] = (
        fit["k1_launches"])

    stamp("ee")
    # ee. the fit through its CUDA graph against the eager fit
    fgraph = phase_fit_graph(dev, card, (*libs, tfk), fscene, fcamera, fw, fh,
                             (hscene, hcamera), (fjob.width, fjob.height))
    print("[fit graph numbers] " + json.dumps(fgraph))
    k1_by_path[f"fit through the graph ({FIT_STEPS} steps and the target; "
               "eager the same)"] = fgraph["cli_fit"]["launches"][k1.name]

    stamp("w-z")
    # w-z. checkpoint/resume, the CLI's resume, two workers, the sharded fit
    resume = phase_resume(dev, card, scene, camera, k1)
    stamp("x")
    cli = phase_cli_resume(card)
    stamp("y")
    two = phase_sharded_render(dev, card, scene, camera, libs,
                               (k1_launches, rays_teapot))
    stamp("z")
    sfit = phase_sharded_fit(dev, card, fscene, fcamera, fw, fh, k1)
    print("[checkpoint and workers numbers] " + json.dumps({
        "card": card, "resume": resume, "cli_resume": cli,
        "two_workers": two, "sharded_fit": sfit,
        "same_mesh_ms": same_mesh}))
    k1_by_path["teapot, resumed after its first block"] = resume["k1_resumed"]
    k1_by_path["teapot over two workers"] = two["k1"]
    k1_by_path[f"sharded loss + backward, two workers ({fw}x{fh} @ "
               f"{FIT_SPP} spp, depth {FIT_DEPTH})"] = sfit["k1"]

    stamp("aa-cc")
    # aa-cc. the long tail: the PLY + image texture + lens render, bench on
    # the card, the generated assets
    tail = phase_long_tail(dev, card, libs, k1)
    stamp("bb")
    tail["bench"] = phase_bench(card)
    stamp("cc")
    tail["assets_seconds"] = phase_assets(card)
    print("[long tail numbers] " + json.dumps({"card": card, **tail}))
    k1_by_path["long tail (PLY teapot, image texture, lens)"] = tail["k1"]

    stamp("the kernels' line")
    csrc = "hobbyraytracer_tpu_torch/kernels/csrc"
    ref = "hobbyraytracer_tpu/kernels/mesh_traverse.py"

    def row(lib, source, replaces, launches, err, ms, plain_ms, bnd, ops,
            library_ms=None, **more):
        return {"name": lib.name, "route": "cuda",
                "source": f"{csrc}/{source}", "replaces": replaces,
                "launches": launches, "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bnd[0], "bound_by": bnd[1],
                "issue_bound_ms": issue_bound(ops, sm_count, sm_clock_mhz),
                "library_ms": library_ms, **more}

    def small_label(label):
        size, spp, _ = BATCH_SMALL
        return (f"{label} by the batch integrator ({size}x{size} @ {spp} "
                "spp; graph and eager alike)")

    # K1's `launches` is its count in the two_teapots render by the default
    # route; its counts in each render that drives it are listed beside it
    print(json.dumps({"kernels": [
        row(k1, "mesh_traverse.cu", f"{ref}:298",
            k1_by_path["two_teapots pool_sort=0"], err_k1,
            *times_k1[False], bound_k1, ops_k1, launches_by_path=k1_by_path),
        row(k2, "mesh_traverse_stream.cu", f"{ref}:357", k2_launches,
            err_k2, *times_k2[False], bound_k2, ops_k2,
            same_mesh_k1_k2_ms=same_mesh,
            launches_by_path={
                "teapot_hires": k2_launches,
                small_label("teapot_hires"):
                batch["small"]["teapot_hires"]["launches"][k2.name],
                "vertex fit step (teapot_hires {}x{} @ {} spp, depth {})"
                .format(*HIRES_FIT): k2_step,
                "vertex fit, 3 steps through the graph (eager the same)":
                fgraph["hires_vertex_fit"]["launches"][k2.name]}),
        row(k3, "coherence_keys.cu", f"{ref}:583", k3_launches, err_k3,
            *times_k3, bound_k3, ops_k3),
        row(k4, "sphere_traverse.cu",
            "hobbyraytracer_tpu/kernels/sphere_traverse.py:51", k4_launches,
            err_k4, *times_k4[:2], bound_k4, ops_k4, launches_by_path={
                "scattered_balls (K4)": k4_launches,
                small_label("scattered_balls (K4)"): batch["small"][
                    "scattered_balls (K4)"]["launches"][k4.name]}),
        row(ks, "sphere_scan.cu",
            "hobbyraytracer_tpu/ops/intersect.py:intersect_spheres (the "
            "dense scan, XLA: no Pallas kernel)", scan_launches, err_scan,
            *times_scan, bound_scan, ops_scan,
            dense_route_ms=times_k4[2], launches_by_path={
                "scattered_balls (dense route)": scan_launches,
                "cornell_smoke": smoke_scans}),
        row(tfk, "threefry.cu",
            "hobbyraytracer_tpu/core/rng.py:43 (jax.random's threefry, "
            "XLA: no Pallas kernel)", tf_launches, err_tf, *times_tf[:2],
            bound_tf, ops_tf, library_ms=times_tf[2],
            batch_draw_ms=batch_draw[0], batch_draw_bound_ms=batch_draw[1],
            launches_by_path={"teapot": tf_launches,
                              **graph["threefry_launches"],
                              "teapot by the batch integrator (graph and "
                              "eager alike)": batch["launches"][tfk.name]})]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dist-worker"]:
        rank, port, out, device, size, spp, pool = sys.argv[2:9]
        sys.exit(dist_worker(int(rank), port, out, device, int(size),
                             int(spp), int(pool)))
    sys.exit(main())
