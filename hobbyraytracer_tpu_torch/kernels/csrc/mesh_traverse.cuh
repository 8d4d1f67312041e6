// Fused cluster-BVH traversal + Moller-Trumbore + attribute interpolation
// for NVIDIA Hopper (sm_90a): the device code shared by the resident-table
// kernel K1 (mesh_traverse.cu) and the streaming-table kernel K2
// (mesh_traverse_stream.cu); the key kernel K3 (coherence_keys.cu) and the
// sphere kernel K4 (sphere_traverse.cu) share its rays, slab test, staged
// boxes and window scan.
//
// Contract (the reference's, hobbyraytracer_tpu/kernels/mesh_traverse.py):
//   rays8   (N, 8)        f32 [ox oy oz dx dy dz valid 0]
//   bounds8 (8, K)        f32 [bmin.xyz bmax.xyz 0 0]
//   table   (K, ROWS, L)  f32 [v0 e1 e2 n0 n1 n2 uv0 uv1 uv2 | id pad]:
//           ROWS = 24 with ids in a separate (K, L) i32 array (K1), or
//           ROWS = 32 with the ids bit-cast into row 24 (K2)
//   -> out  (N, 8)        f32 [t nx ny nz u v 0 0], t = 1e30 on a miss
//      id   (N,)          i32, -1 on a miss
//
// Visit rule. A ray visits its clusters in strictly increasing order of
// (slab entry, cluster index) while the entry is below its own best t, and
// takes a visit's hit only if it is strictly better; inside a leaf the
// lowest triangle slot among those with the smallest t wins. The TPU
// kernels visit the union of a 128- or 256-ray block's needs (K2 even one
// update stale); a ray's own sequence is a subset of that union, so the
// nearest hit is the same except on exact t-ties.
//
// Design. A warp owns 32 rays and alternates between two phases.
//
// 1. Scan. A ray runs the K slab tests once and keeps the kWindow smallest
//    (entry, index) pairs above its last visited pair in statically
//    indexed registers (an insertion into a sorted window; no per-ray
//    array of K entries, which would be 3.3 KB of local memory a thread at
//    K = 822). It then consumes the window in order, checking entry < best
//    t at the time of each visit. The slab test is a pure function of
//    (ray, box) and best t only falls, so the sequence of visits is the one
//    a rescan per visit would give. A window that was not full after its
//    scan proves that nothing is left; only a ray that consumes a full
//    window and still wants more scans again, from its last pair.
//    When more than kWarpScanMax lanes want a scan (the first scan of a
//    warp), every lane scans for itself: the boxes (rows 0-5 of bounds8,
//    19,728 B at K = 822) are staged in shared memory per block when they
//    fit the default 48 KB (K <= 2048), their rows padded to a multiple of
//    4, and a lane reads the boxes of 4 clusters with six 16-byte
//    broadcast loads (with one 4-byte load a row the scan is bound by
//    the rate of shared-memory loads, not arithmetic). When few lanes want
//    one (a refill), the warp scans for each of them together, lanes over
//    clusters, and kWindow pairs of integer warp reductions hand the
//    smallest pairs to the ray's lane: a refill then costs K / 32 slab
//    tests a lane, not K tests on one lane with the other 31 idle. Past
//    K = 2048 both scans read the boxes from global memory.
//
// 2. Visit, lanes over triangles. Each round every unfinished lane names
//    the cluster at the head of its window. The warp takes the distinct
//    clusters one by one (ballots): the 32 lanes load the leaf's nine
//    vertex rows once, coalesced, lane j holding triangle slots j, j + 32,
//    j + 64, j + 96 in registers (a leaf of more than 128 triangles takes
//    several such passes). Then, for each ray that wants this cluster, the
//    ray is broadcast by shuffles, every lane tests its slots, and two
//    integer warp reductions (redux.sync on the bits of t > 0, then on the
//    slot among the lanes at that t) pick the smallest t and the lowest
//    slot at it; the winner's u and v come by shuffle. Back in its own
//    lane, a ray whose visit is strictly better reads the winner's normals
//    and uvs and interpolates them. So the leaf work follows the number
//    of visits, not 32 x the busiest lane of a round; the leaf is read
//    once per (warp, round, cluster), coalesced; and rays in any order are
//    handled, a warp of unsorted rays just has more distinct clusters a
//    round. Lanes past N and finished rays stay in the loop as idle lanes
//    until the whole warp is done: every ballot, shuffle and reduction
//    runs under warp-uniform control flow.
//
// What bounds it on the card. Operations, not bytes: a ray costs one scan
// of K slab tests (~20 operations each) and every visit 128 triangle tests
// (~45 operations each) spread over the warp. The tables (teapot_hires:
// 822 x 32 x 128 x 4 B = 13.5 MB) sit in the 50 MB L2, so the TPU stream
// kernel's HBM->VMEM double buffer has no counterpart: staging the next
// leaf in shared memory by an asynchronous bulk copy (cp.async.bulk with an
// mbarrier, two buffers a warp) was built and timed against the register
// leaf and bought nothing at K = 30 or K = 822 (PERF.md has both times),
// so the leaf goes straight to registers. The first scan is a
// thread-per-ray loop: at K = 822 it runs ~16k operations for every
// lane, the larger part of the kernel's time, and keeps it above the
// operation bound whatever the visits cost.
//
// Tensor cores are not used: the kernel has no matrix product whose
// float32 rounding could stay op for op with the plain version (a TF32 or
// split-float32 product rounds differently), and the reference's own
// matrix-unit winner pick was a measured loss that its roadmap dropped.
//
// Built with -fmad=false and IEEE division (no --use_fast_math), so each
// product and sum rounds on its own, op for op as in the plain PyTorch
// versions in kernels/mesh_traverse.py; the kernels and the plain versions
// agree bit for bit.
#pragma once

#include <cuda_runtime.h>

namespace hrt {

constexpr int kSoaRows = 24;
constexpr int kStreamRows = 32;
constexpr int kIdRow = 24;
constexpr int kThreads = 128;
// rows 0-5 of bounds8 in shared memory up to the default 48 KB per block
constexpr int kSmemMaxK = 2048;
constexpr float kBig = 1e30f;

struct Ray {
  float o[3];
  float d[3];
  float inv[3];
  bool valid;
};

__device__ __forceinline__ Ray load_ray(const float* __restrict__ rays8,
                                        int r) {
  Ray ray;
  const float* p = rays8 + (size_t)r * 8;
  for (int ax = 0; ax < 3; ++ax) {
    ray.o[ax] = p[ax];
    ray.d[ax] = p[3 + ax];
    const float da = ray.d[ax];
    ray.inv[ax] = 1.0f / (fabsf(da) < 1e-30f ? 1e-30f : da);
  }
  ray.valid = p[6] > 0.0f;
  return ray;
}

// Slab entry of a box (aabb.h:26-39): >= 0, +inf where missed, beyond
// t_max or the ray is invalid. `box` is [bmin.xyz bmax.xyz].
__device__ __forceinline__ float slab_entry_box(const float (&box)[6],
                                                const Ray& ray, float t_max) {
  float lo = 0.0f, hi = 0.0f;
  for (int ax = 0; ax < 3; ++ax) {
    const float t0 = (box[ax] - ray.o[ax]) * ray.inv[ax];
    const float t1 = (box[3 + ax] - ray.o[ax]) * ray.inv[ax];
    const float lo_ax = fminf(t0, t1);
    const float hi_ax = fmaxf(t0, t1);
    lo = ax == 0 ? lo_ax : fmaxf(lo, lo_ax);
    hi = ax == 0 ? hi_ax : fminf(hi, hi_ax);
  }
  const float e = fmaxf(lo, 0.0f);
  return (hi > e && e < t_max && ray.valid) ? e : __int_as_float(0x7f800000);
}

// Slab entry of cluster k. `bnd` holds rows [bmin.xyz bmax.xyz] of stride
// `stride` floats.
__device__ __forceinline__ float slab_entry(const float* bnd, int stride,
                                            int k, const Ray& ray,
                                            float t_max) {
  float box[6];
  for (int row = 0; row < 6; ++row) box[row] = bnd[row * stride + k];
  return slab_entry_box(box, ray, t_max);
}

// Pending visits of one ray: the kWindow smallest (entry, index) pairs
// above its last visited pair, ascending; k < 0 marks an empty slot.
constexpr int kWindow = 4;
// triangle slots a lane holds in one pass over a leaf: 32 x 4 = 128
constexpr int kLaneSlots = 4;
// up to this many lanes of a warp wanting a scan, the warp scans for each
// of them together; above it every lane scans for itself
constexpr int kWarpScanMax = 16;
constexpr unsigned kFullMask = 0xffffffffu;

struct Window {
  float e[kWindow];
  int k[kWindow];
};

// Drops the window's first pair.
__device__ __forceinline__ void pop_front(Window& w) {
#pragma unroll
  for (int i = 0; i + 1 < kWindow; ++i) {
    w.e[i] = w.e[i + 1];
    w.k[i] = w.k[i + 1];
  }
  w.k[kWindow - 1] = -1;
}

// The traversal's staging: rows 0-5 of bounds8 in shared memory with the
// row stride padded to a multiple of 4 floats, so that a scan reads the
// boxes of 4 clusters with six 16-byte loads. The padding boxes (bmin =
// bmax = 1e30) are missed by every ray. Every thread of the block must
// call it.
__device__ __forceinline__ int padded_stride(int k_clusters) {
  return (k_clusters + 3) & ~3;
}
__device__ __forceinline__ void stage_bounds_padded(
    const float* __restrict__ bounds8, int k_clusters, float* smem) {
  const int stride = padded_stride(k_clusters);
  for (int i = threadIdx.x; i < 6 * stride; i += blockDim.x) {
    const int row = i / stride, k = i - row * stride;
    smem[i] = k < k_clusters ? bounds8[row * k_clusters + k] : kBig;
  }
  __syncthreads();
}

// Offers the pair (e, c) to the window: clusters come in index order, so a
// strict < places a pair after every pair of equal entry.
__device__ __forceinline__ void offer(Window& w, float e, int c, float last_e,
                                      int last_k) {
  const bool after = e > last_e || (e == last_e && c > last_k);
  if (after && e < w.e[kWindow - 1]) {
#pragma unroll
    for (int i = kWindow - 1; i >= 0; --i) {
      if (e < w.e[i]) {  // slot i takes its left neighbour or the pair
        const int left = i > 0 ? i - 1 : 0;
        const bool shift = i > 0 && e < w.e[left];
        w.e[i] = shift ? w.e[left] : e;
        w.k[i] = shift ? w.k[left] : c;
      }
    }
  }
}

// One scan of the K slab tests by the ray's own lane: fills `w` with the
// smallest pairs above (last_e, last_k) whose entry is below best_t. With
// SMEM `bnd` is the padded staging (`stride` a multiple of 4), else bounds8
// in global memory.
template <bool SMEM>
__device__ __forceinline__ void scan_window(const float* bnd, int stride,
                                            int k_clusters, const Ray& ray,
                                            float t_max, float last_e,
                                            int last_k, float best_t,
                                            Window& w) {
#pragma unroll
  for (int i = 0; i < kWindow; ++i) {
    w.e[i] = best_t;
    w.k[i] = -1;
  }
  if (SMEM) {
    for (int c = 0; c < stride; c += 4) {
      float4 rows[6];
#pragma unroll
      for (int row = 0; row < 6; ++row)
        rows[row] = *reinterpret_cast<const float4*>(bnd + row * stride + c);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float box[6];
#pragma unroll
        for (int row = 0; row < 6; ++row)
          box[row] = j == 0   ? rows[row].x
                     : j == 1 ? rows[row].y
                     : j == 2 ? rows[row].z
                              : rows[row].w;
        offer(w, slab_entry_box(box, ray, t_max), c + j, last_e, last_k);
      }
    }
  } else {
    for (int c = 0; c < k_clusters; ++c)
      offer(w, slab_entry(bnd, stride, c, ray, t_max), c, last_e, last_k);
  }
}

// The same scan for the ray of lane `src`, by the whole warp: lanes over
// clusters (lane j tests clusters j, j + 32, ... into a window of its own),
// then kWindow rounds that each take the smallest (entry, index) pair left
// in any lane (two integer warp reductions: entries are >= 0, so their bits
// order as unsigned integers once -0 is made +0) and hand it to lane
// `src`'s window. Every lane of the warp must call it. `stride` is the
// row stride of `bnd`.
__device__ __forceinline__ void scan_window_warp(
    const float* bnd, int stride, int k_clusters, int src, int lane,
    const Ray& ray, float t_max, float last_e, int last_k, float best_t,
    Window& w) {
  Ray rb;
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    rb.o[ax] = __shfl_sync(kFullMask, ray.o[ax], src);
    rb.d[ax] = 0.0f;
    rb.inv[ax] = __shfl_sync(kFullMask, ray.inv[ax], src);
  }
  rb.valid = true;
  const float le = __shfl_sync(kFullMask, last_e, src);
  const int lk = __shfl_sync(kFullMask, last_k, src);
  const float bt = __shfl_sync(kFullMask, best_t, src);
  Window mine;
#pragma unroll
  for (int i = 0; i < kWindow; ++i) {
    mine.e[i] = bt;
    mine.k[i] = -1;
  }
  for (int c = lane; c < k_clusters; c += 32)
    offer(mine, slab_entry(bnd, stride, c, rb, t_max), c, le, lk);
#pragma unroll
  for (int i = 0; i < kWindow; ++i) {
    const unsigned none = 0xffffffffu;
    const unsigned key =
        mine.k[0] < 0 ? none : __float_as_uint(mine.e[0] + 0.0f);
    const unsigned e_min = __reduce_min_sync(kFullMask, key);
    const unsigned k_min = __reduce_min_sync(
        kFullMask, key == e_min ? (unsigned)mine.k[0] : none);
    if (lane == src) {
      w.e[i] = e_min == none ? bt : __uint_as_float(e_min);
      w.k[i] = (int)k_min;
    }
    if (key == e_min && (unsigned)mine.k[0] == k_min && key != none)
      pop_front(mine);
  }
}

// The scan phase of a warp's round, shared by the mesh kernels and the
// sphere kernel K4: every lane with `scan` set (its window ran empty and a
// scan may still find pairs) gets its window refilled, by its own lane when
// more than kWarpScanMax lanes want that, else by the warp for each of them
// in turn; `more` says whether another scan could find anything (the window
// came back full and there are more clusters than it holds). Every lane of
// the warp must call it.
template <bool SMEM>
__device__ __forceinline__ void refill_windows(
    bool scan, const float* bnd, int stride, int k_clusters, int lane,
    const Ray& ray, float t_max, float last_e, int last_k, float best_t,
    Window& w, bool& more) {
  const unsigned scanning = __ballot_sync(kFullMask, scan);
  if (__popc(scanning) > kWarpScanMax) {
    if (scan)
      scan_window<SMEM>(bnd, stride, k_clusters, ray, t_max, last_e, last_k,
                        best_t, w);
  } else {
    for (unsigned todo = scanning; todo; todo &= todo - 1)
      scan_window_warp(bnd, stride, k_clusters, __ffs(todo) - 1, lane, ray,
                       t_max, last_e, last_k, best_t, w);
  }
  if (scan) more = w.k[kWindow - 1] >= 0 && k_clusters > kWindow;
}

template <int ROWS, bool SMEM>
__global__ void __launch_bounds__(kThreads) traverse_kernel(
    const float* __restrict__ rays8, int n,
    const float* __restrict__ bounds8, int k_clusters,
    const float* __restrict__ table, const int* __restrict__ tri_id,
    int leaf, float t_max, int need_uv, float* __restrict__ out,
    int* __restrict__ out_id) {
  extern __shared__ __align__(16) float s_boxes[];
  if (SMEM) stage_bounds_padded(bounds8, k_clusters, s_boxes);
  const float* bnd = SMEM ? s_boxes : bounds8;
  const int stride = SMEM ? padded_stride(k_clusters) : k_clusters;
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const bool live = r < n;
  Ray ray = {};
  if (live) ray = load_ray(rays8, r);

  float best_t = kBig, bnx = 0.0f, bny = 0.0f, bnz = 0.0f;
  float bu = 0.0f, bv = 0.0f;
  int best_id = -1;
  // last visited (entry, index); entries are >= 0, so (-1, -1) is below all
  float last_e = -1.0f;
  int last_k = -1;
  Window w;
#pragma unroll
  for (int i = 0; i < kWindow; ++i) {
    w.e[i] = kBig;
    w.k[i] = -1;
  }
  bool more = true;  // a scan may still find pairs above the last one
  bool done = !(live && ray.valid);
  while (true) {
    refill_windows<SMEM>(!done && w.k[0] < 0 && more, bnd, stride, k_clusters,
                         lane, ray, t_max, last_e, last_k, best_t, w, more);
    if (!done && w.k[0] < 0) done = true;
    // entries ascend and best_t only falls: nothing later can pass either
    if (!done && !(w.e[0] < best_t)) done = true;
    const int want = done ? -1 : w.k[0];
    unsigned pending = __ballot_sync(kFullMask, want >= 0);
    if (pending == 0) break;

    // this lane's own visit: smallest t, lowest slot at it, its u and v
    float tc = kBig, uc = 0.0f, vc = 0.0f;
    int lc = -1;
    while (pending) {  // one distinct cluster of this round at a time
      const int k = __shfl_sync(kFullMask, want, __ffs(pending) - 1);
      const unsigned group = __ballot_sync(kFullMask, want == k);
      pending &= ~group;
      const float* blk = table + (size_t)k * ROWS * leaf;
      const int* ids = ROWS == kSoaRows ? tri_id + (size_t)k * leaf : nullptr;
      for (int base = 0; base < leaf; base += 32 * kLaneSlots) {
        float tri[kLaneSlots][9];
        unsigned real = 0;  // bit s: slot s holds a triangle (id >= 0)
#pragma unroll
        for (int s = 0; s < kLaneSlots; ++s) {
          const int l = base + 32 * s + lane;
          const bool in = l < leaf;
#pragma unroll
          for (int row = 0; row < 9; ++row)
            tri[s][row] = in ? blk[row * leaf + l] : 0.0f;
          const int id = !in ? -1
                         : ROWS == kSoaRows
                             ? ids[l]
                             : __float_as_int(blk[kIdRow * leaf + l]);
          real |= (id >= 0 ? 1u : 0u) << s;
        }
        for (unsigned todo = group; todo; todo &= todo - 1) {
          const int src = __ffs(todo) - 1;
          const float ox = __shfl_sync(kFullMask, ray.o[0], src);
          const float oy = __shfl_sync(kFullMask, ray.o[1], src);
          const float oz = __shfl_sync(kFullMask, ray.o[2], src);
          const float dx = __shfl_sync(kFullMask, ray.d[0], src);
          const float dy = __shfl_sync(kFullMask, ray.d[1], src);
          const float dz = __shfl_sync(kFullMask, ray.d[2], src);
          float t_l = kBig, u_l = 0.0f, v_l = 0.0f;
          unsigned slot_l = 0xffffffffu;
#pragma unroll
          for (int s = 0; s < kLaneSlots; ++s) {
            const float v0x = tri[s][0], v0y = tri[s][1], v0z = tri[s][2];
            const float e1x = tri[s][3], e1y = tri[s][4], e1z = tri[s][5];
            const float e2x = tri[s][6], e2y = tri[s][7], e2z = tri[s][8];
            const float px = dy * e2z - dz * e2y;
            const float py = dz * e2x - dx * e2z;
            const float pz = dx * e2y - dy * e2x;
            const float det = e1x * px + e1y * py + e1z * pz;
            const float inv_det = 1.0f / (det == 0.0f ? 1.0f : det);
            const float tx = ox - v0x;
            const float ty = oy - v0y;
            const float tz = oz - v0z;
            const float u = (tx * px + ty * py + tz * pz) * inv_det;
            const float qx = ty * e1z - tz * e1y;
            const float qy = tz * e1x - tx * e1z;
            const float qz = tx * e1y - ty * e1x;
            const float v = (dx * qx + dy * qy + dz * qz) * inv_det;
            const float t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
            const bool good = det != 0.0f && u >= 0.0f && v >= 0.0f &&
                              u + v <= 1.0f && t > 0.0f && t <= t_max &&
                              ((real >> s) & 1u);
            if (good && t < t_l) {  // slots ascend: the lowest wins ties
              t_l = t;
              slot_l = (unsigned)(base + 32 * s + lane);
              u_l = u;
              v_l = v;
            }
          }
          // t_l > 0 (or kBig), so its bits order as unsigned integers
          const unsigned t_bits = __float_as_uint(t_l);
          const unsigned t_min = __reduce_min_sync(kFullMask, t_bits);
          const unsigned slot = __reduce_min_sync(
              kFullMask, t_bits == t_min ? slot_l : 0xffffffffu);
          const float u_w = __shfl_sync(kFullMask, u_l, slot & 31u);
          const float v_w = __shfl_sync(kFullMask, v_l, slot & 31u);
          // a later pass of the same leaf must be strictly better
          if (lane == src && __uint_as_float(t_min) < tc) {
            tc = __uint_as_float(t_min);
            lc = (int)slot;
            uc = u_w;
            vc = v_w;
          }
        }
      }
    }

    if (want >= 0) {
      last_e = w.e[0];
      last_k = want;
      pop_front(w);
      if (tc < best_t) {  // strictly better than every earlier visit
        const float* blk = table + (size_t)want * ROWS * leaf;
        const float w0 = 1.0f - uc - vc;
        best_t = tc;
        best_id = ROWS == kSoaRows
                      ? tri_id[(size_t)want * leaf + lc]
                      : __float_as_int(blk[kIdRow * leaf + lc]);
        bnx = w0 * blk[9 * leaf + lc] + uc * blk[12 * leaf + lc] +
              vc * blk[15 * leaf + lc];
        bny = w0 * blk[10 * leaf + lc] + uc * blk[13 * leaf + lc] +
              vc * blk[16 * leaf + lc];
        bnz = w0 * blk[11 * leaf + lc] + uc * blk[14 * leaf + lc] +
              vc * blk[17 * leaf + lc];
        if (need_uv) {
          bu = w0 * blk[18 * leaf + lc] + uc * blk[20 * leaf + lc] +
               vc * blk[22 * leaf + lc];
          bv = w0 * blk[19 * leaf + lc] + uc * blk[21 * leaf + lc] +
               vc * blk[23 * leaf + lc];
        }
      }
    }
  }

  if (!live) return;
  float* o8 = out + (size_t)r * 8;
  o8[0] = best_t;
  o8[1] = bnx;
  o8[2] = bny;
  o8[3] = bnz;
  o8[4] = bu;
  o8[5] = bv;
  o8[6] = 0.0f;
  o8[7] = 0.0f;
  out_id[r] = best_id;
}

// Launches the traversal for a ROWS-row table on `stream` (PyTorch's
// current stream), allocates nothing, and returns cudaGetLastError() so the
// caller can raise on a refused launch.
template <int ROWS>
int launch_traverse(const float* rays8, int n, const float* bounds8,
                    int k_clusters, const float* table, const int* tri_id,
                    int leaf, float t_max, int need_uv, float* out,
                    int* out_id, void* stream) {
  if (k_clusters <= 0 || leaf <= 0 || n < 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  const int blocks = (n + kThreads - 1) / kThreads;
  cudaStream_t s = (cudaStream_t)stream;
  if (k_clusters <= kSmemMaxK) {
    const size_t smem =
        (size_t)6 * ((k_clusters + 3) & ~3) * sizeof(float);
    traverse_kernel<ROWS, true><<<blocks, kThreads, smem, s>>>(
        rays8, n, bounds8, k_clusters, table, tri_id, leaf, t_max, need_uv,
        out, out_id);
  } else {
    traverse_kernel<ROWS, false><<<blocks, kThreads, 0, s>>>(
        rays8, n, bounds8, k_clusters, table, tri_id, leaf, t_max, need_uv,
        out, out_id);
  }
  return (int)cudaGetLastError();
}

}  // namespace hrt
