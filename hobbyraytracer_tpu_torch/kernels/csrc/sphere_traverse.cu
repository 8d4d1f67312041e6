// Kernel K4: nearest sphere of a clustered sphere pool, with a plain C
// interface for ctypes.
//
// Replaces the TPU kernel hobbyraytracer_tpu/kernels/sphere_traverse.py:
// _kernel (launched by intersect_spheres_pallas). Contract:
//   rays8   (N, 8)     f32 [ox oy oz dx dy dz valid 0]
//   bounds8 (8, K)     f32 [bmin.xyz bmax.xyz 0 0]
//   table   (K, 8, L)  f32 rows [cx cy cz r2 0 0 0 0], pad spheres r2 = -1
//   ids     (K, L)     i32 indices into the sphere table, -1 for padding
//   -> t    (N,)       f32 nearest root in [t_min, t_max], 1e30 on a miss
//      id   (N,)       i32 the winner's index, -1 on a miss
// Rays with valid <= 0 give 1e30 / -1.
//
// Visit rule (the mesh kernels', mesh_traverse.cuh). A ray visits its
// clusters in strictly increasing order of (slab entry, cluster index) while
// the entry is below its own best t. The TPU kernel folds the nearest cluster
// that any ray of a 1024-ray block still needs into every ray of the block; a
// ray's own sequence is a subset of that, and with the strict < fold the
// nearest hit is the same except on exact t-ties between spheres of
// different clusters.
//
// A visit is the half-b quadratic of sphere.cpp:20-49 over the cluster's L
// spheres, op for op as the TPU kernel writes it: disc = hb*hb - a*c, the
// near root (-hb - sqrt(disc)) / a if it lies in [t_min, t_max], else the
// far root if that does, a hit only where disc > 0; the lowest slot at the
// cluster's minimum wins, and it replaces the ray's best only when strictly
// nearer. r2 comes from the table as the host squared it.
//
// Design. A warp owns 32 rays and works in rounds: every unfinished ray
// names its next cluster, and the round's visits are made in one of two
// ways, whichever costs the warp fewer instructions.
// - One slab scan a ray, not one a visit: the mesh kernels' window of the
//   kWindow nearest pending (entry, index) pairs over boxes staged in shared
//   memory and read 16 bytes at a time (mesh_traverse.cuh: refill_windows).
//   With K <= kWindow the one scan holds every cluster; a larger pool's ray
//   scans again only after it used a full window up.
// - No square root on a miss: t is 1e30 wherever disc <= 0, so the root,
//   its twin and the window tests run only under disc > 0 (a ray hits a few
//   of a cluster's spheres; the pad spheres' r2 = -1 gives disc < 0). The
//   skipped values were never selected, so the bits are the same. A miss is
//   ~17 operations.
// - A visit by the ray's own lane, when many lanes have one. A block stages
//   the table once, repacked to one 16-byte word [cx cy cz r2] a sphere
//   (rows 4-7 of the table are never read), so a quadratic costs one 16-byte
//   shared-memory load, not four 4-byte ones. The sphere find gets its rays
//   in pool order, so lanes of a warp sit in different clusters in the same
//   iteration: the staged clusters lie an odd number of 16-byte words apart,
//   which puts the same slot of different clusters in different banks.
//   (Walking the warp's distinct clusters one at a time instead, every load
//   a broadcast, was measured slower: it pays the leaf loop once per
//   distinct cluster, not once a round.)
// - A visit by the warp, lanes over spheres (the mesh kernels' scheme), when
//   few lanes have one: the warp takes the round's distinct clusters one by
//   one, lane j holding spheres j, j + 32, j + 64, j + 96 in registers, and
//   for each ray that wants this cluster the ray is broadcast by shuffles,
//   every lane tests its slots, and two integer warp reductions (on the bits
//   of t made to order as unsigned integers, then on the slot among the
//   lanes at that t) pick the lowest slot at the smallest t. The work then
//   follows the number of visits, not 32 x the busiest lane of a round.
// - A pool whose staged boxes and table fit the default 48 KB of shared
//   memory (the 485-ball scene, K = 4, L = 128: 8,352 B) chooses between the
//   two each round; a larger pool reads the table's rows from global memory
//   (L2/L1), coalesced, and every visit is the warp's, so nothing limits K.
// - Lanes past N and finished rays stay in the loop to its warp-uniform end;
//   every ballot, shuffle and reduction has the full mask.
//
// What bounds it on the card. Operations, not bytes: per ray 32 B in and 8 B
// out, the table once (7.9 MB at 196,608 rays). The work is one scan of K
// slab tests a ray plus L quadratics per visited cluster; the scattered-balls
// ground sphere makes one cluster's box span the scene, so every ray visits
// that cluster (2.5 of 4 clusters a ray). Built with -fmad=false, IEEE
// division and square root, so each op rounds as in the plain PyTorch
// version (kernels/sphere_traverse.py:intersect_spheres_plain); the two
// agree bit for bit, and an operation is an instruction: the card starts at
// most 132 SMs x 128 of them a clock. Tensor cores are not used: there is no
// product here whose float32 rounding could stay op for op with the plain
// version (mesh_traverse.cuh).
#include "mesh_traverse.cuh"

namespace hrt {

constexpr int kSphereRows = 8;
// the default shared memory of a block: up to it the kernel stages the boxes
// and the whole table
constexpr size_t kSphereSmemBytes = 48 * 1024;

// 16-byte words between the staged spheres of consecutive clusters: odd, so
// that one slot of different clusters lies in different banks
__host__ __device__ inline int sphere_stride(int leaf) { return leaf | 1; }

struct SphereRay {
  float ox, oy, oz, dx, dy, dz;
  float a, inv_a;  // |d|^2 and its reciprocal, once a ray
};

// One sphere [cx cy cz r2] at slot l against one ray: folds its root into
// (tc, lc) when strictly nearer, so the lowest slot wins among equal roots
// when slots come in ascending order.
__device__ __forceinline__ void sphere_test(const float4 sph, int l,
                                            const SphereRay& q, float t_min,
                                            float t_max, float& tc, int& lc) {
  const float ocx = q.ox - sph.x;
  const float ocy = q.oy - sph.y;
  const float ocz = q.oz - sph.z;
  const float half_b = ocx * q.dx + ocy * q.dy + ocz * q.dz;
  const float c = ocx * ocx + ocy * ocy + ocz * ocz - sph.w;
  const float disc = half_b * half_b - q.a * c;
  if (disc > 0.0f) {
    const float sq = sqrtf(disc);
    const float r1 = (-half_b - sq) * q.inv_a;
    const float r2 = (-half_b + sq) * q.inv_a;
    const bool in1 = r1 >= t_min && r1 <= t_max;
    const bool in2 = r2 >= t_min && r2 <= t_max;
    const float root = in1 ? r1 : (in2 ? r2 : kBig);
    if (root < tc) {
      tc = root;
      lc = l;
    }
  }
}

// A ray's traversal state.
struct SphereWalk {
  Ray ray;
  SphereRay q;
  float best_t, last_e;
  int best_id, last_k;
  Window w;
  bool more, done;
};

__device__ __forceinline__ void start_walk(SphereWalk& s,
                                           const float* __restrict__ rays8,
                                           int r, bool live) {
  s.ray = Ray{};
  if (live) s.ray = load_ray(rays8, r);
  s.q.ox = s.ray.o[0];
  s.q.oy = s.ray.o[1];
  s.q.oz = s.ray.o[2];
  s.q.dx = s.ray.d[0];
  s.q.dy = s.ray.d[1];
  s.q.dz = s.ray.d[2];
  s.q.a = s.q.dx * s.q.dx + s.q.dy * s.q.dy + s.q.dz * s.q.dz;
  s.q.inv_a = 1.0f / s.q.a;
  s.best_t = kBig;
  s.best_id = -1;
  // last visited (entry, index); entries are >= 0, so (-1, -1) is below all
  s.last_e = -1.0f;
  s.last_k = -1;
#pragma unroll
  for (int i = 0; i < kWindow; ++i) {
    s.w.e[i] = kBig;
    s.w.k[i] = -1;
  }
  s.more = true;  // a scan may still find pairs above the last one
  s.done = !(live && s.ray.valid);
}

// The head of a round: refills empty windows and returns the cluster this
// lane visits now, or -1. Every lane of the warp must call it.
template <bool BOXES>
__device__ __forceinline__ int next_cluster(SphereWalk& s, const float* bnd,
                                            int stride, int k_clusters,
                                            int lane, float t_max) {
  refill_windows<BOXES>(!s.done && s.w.k[0] < 0 && s.more, bnd, stride,
                        k_clusters, lane, s.ray, t_max, s.last_e, s.last_k,
                        s.best_t, s.w, s.more);
  if (!s.done && s.w.k[0] < 0) s.done = true;
  // entries ascend and best_t only falls: nothing later can pass either
  if (!s.done && !(s.w.e[0] < s.best_t)) s.done = true;
  return s.done ? -1 : s.w.k[0];
}

// The tail of a round for a lane that visited cluster `want` and found
// (tc, lc) there.
__device__ __forceinline__ void end_visit(SphereWalk& s, int want, float tc,
                                          int lc, const int* __restrict__ ids,
                                          int leaf) {
  s.last_e = s.w.e[0];
  s.last_k = want;
  pop_front(s.w);
  if (tc < s.best_t) {  // strictly nearer than every earlier visit
    s.best_t = tc;
    s.best_id = ids[(size_t)want * leaf + lc];
  }
}

// The bits of x as an unsigned integer that orders as x does.
__device__ __forceinline__ unsigned ordered_bits(float x) {
  const unsigned b = __float_as_uint(x);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// Where a visit reads sphere l of cluster k as [cx cy cz r2]: the block's
// staging, or the table's rows in global memory.
struct StagedLeaves {
  const float4* sph;
  int stride;
  __device__ __forceinline__ float4 operator()(int k, int l, int) const {
    return sph[k * stride + l];
  }
};
struct TableLeaves {
  const float* table;
  __device__ __forceinline__ float4 operator()(int k, int l, int leaf) const {
    const float* blk = table + (size_t)k * kSphereRows * leaf;
    return make_float4(blk[l], blk[leaf + l], blk[2 * leaf + l],
                       blk[3 * leaf + l]);
  }
};

// A round's visits by the whole warp, lanes over spheres: `pending` are the
// lanes with a cluster to visit (`want`), taken one distinct cluster at a
// time; each lane comes back with its own visit's (tc, lc). Every lane of
// the warp must call it.
template <class Leaves>
__device__ __forceinline__ void visit_by_warp(unsigned pending, int want,
                                              int lane, const SphereRay& mine,
                                              const Leaves& leaves, int leaf,
                                              float t_min, float t_max,
                                              float& tc, int& lc) {
  while (pending) {
    const int k = __shfl_sync(kFullMask, want, __ffs(pending) - 1);
    const unsigned group = __ballot_sync(kFullMask, want == k);
    pending &= ~group;
    for (int base = 0; base < leaf; base += 32 * kLaneSlots) {
      float4 sp[kLaneSlots];
      unsigned real = 0;  // bit i: slot i lies inside the leaf
#pragma unroll
      for (int i = 0; i < kLaneSlots; ++i) {
        const int l = base + 32 * i + lane;
        const bool in = l < leaf;
        sp[i] = in ? leaves(k, l, leaf) : make_float4(0.0f, 0.0f, 0.0f, -1.0f);
        real |= (in ? 1u : 0u) << i;
      }
      for (unsigned todo = group; todo; todo &= todo - 1) {
        const int src = __ffs(todo) - 1;
        SphereRay q;
        q.ox = __shfl_sync(kFullMask, mine.ox, src);
        q.oy = __shfl_sync(kFullMask, mine.oy, src);
        q.oz = __shfl_sync(kFullMask, mine.oz, src);
        q.dx = __shfl_sync(kFullMask, mine.dx, src);
        q.dy = __shfl_sync(kFullMask, mine.dy, src);
        q.dz = __shfl_sync(kFullMask, mine.dz, src);
        q.a = __shfl_sync(kFullMask, mine.a, src);
        q.inv_a = __shfl_sync(kFullMask, mine.inv_a, src);
        float t_l = kBig;
        int slot_l = -1;
#pragma unroll
        for (int i = 0; i < kLaneSlots; ++i) {  // slots ascend
          if ((real >> i) & 1u)
            sphere_test(sp[i], base + 32 * i + lane, q, t_min, t_max, t_l,
                        slot_l);
        }
        const unsigned t_bits = ordered_bits(t_l);
        const unsigned t_best = __reduce_min_sync(kFullMask, t_bits);
        const unsigned slot = __reduce_min_sync(
            kFullMask, t_bits == t_best ? (unsigned)slot_l : 0xffffffffu);
        // the winner's lane is its slot's low bits (lane 31 on a miss,
        // where every lane holds 1e30)
        const float t_w = __shfl_sync(kFullMask, t_l, slot & 31u);
        // a later pass of the same leaf must be strictly nearer
        if (lane == src && t_w < tc) {
          tc = t_w;
          lc = (int)slot;
        }
      }
    }
  }
}

// Instructions of a miss, and of a ray's broadcast and reductions in a visit
// by the warp: what the choice between the two kinds of visit weighs
constexpr int kMissOps = 19;
constexpr int kBroadcastOps = 24;

// The kernel. STAGED: the boxes and the table (one 16-byte word a sphere)
// are in shared memory, and a round's visits are made by each lane for
// itself when enough lanes have one, else by the warp. Not STAGED: the
// table's rows are read from global memory, every visit is made by the
// warp, and the boxes are staged up to K = kSmemMaxK (BOXES).
// (With a minimum of one block an SM the compiler keeps every value in
// registers; without it, it holds the kernel to 72 and spills a few bytes.)
template <bool STAGED, bool BOXES>
__global__ void __launch_bounds__(kThreads, 1) sphere_traverse_kernel(
    const float* __restrict__ rays8, int n,
    const float* __restrict__ bounds8, int k_clusters,
    const float* __restrict__ table, const int* __restrict__ ids, int leaf,
    float t_min, float t_max, float* __restrict__ out_t,
    int* __restrict__ out_id) {
  extern __shared__ __align__(16) float s_mem[];
  const int bstride = BOXES ? padded_stride(k_clusters) : k_clusters;
  const float* bnd = BOXES ? s_mem : bounds8;
  // the padded box rows are a multiple of 16 bytes
  float4* s_sph = reinterpret_cast<float4*>(s_mem + 6 * bstride);
  const int sstride = sphere_stride(leaf);
  if (STAGED) {
    const TableLeaves rows = {table};
    for (int i = threadIdx.x; i < k_clusters * leaf; i += blockDim.x) {
      const int k = i / leaf, l = i - k * leaf;
      s_sph[k * sstride + l] = rows(k, l, leaf);
    }
  }
  if (BOXES) stage_bounds_padded(bounds8, k_clusters, s_mem);  // and a sync
  // a lane's own visit costs the warp `leaf` misses whoever else is idle, a
  // visit by the warp a broadcast and a pass of misses per 32 slots for each
  // visiting ray: above this many visiting lanes the first is cheaper
  const int warp_visit_max =
      kMissOps * leaf / (kBroadcastOps + kMissOps * ((leaf + 31) / 32));
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  SphereWalk s;
  start_walk(s, rays8, r, r < n);
  while (true) {
    const int want =
        next_cluster<BOXES>(s, bnd, bstride, k_clusters, lane, t_max);
    const unsigned pending = __ballot_sync(kFullMask, want >= 0);
    if (pending == 0) break;
    // this lane's own visit: smallest t and the lowest slot at it
    float tc = kBig;
    int lc = -1;
    if (STAGED && __popc(pending) > warp_visit_max) {
      if (want >= 0) {
        const float4* blk = s_sph + want * sstride;
#pragma unroll 4
        for (int l = 0; l < leaf; ++l)
          sphere_test(blk[l], l, s.q, t_min, t_max, tc, lc);
      }
    } else if (STAGED) {
      visit_by_warp(pending, want, lane, s.q, StagedLeaves{s_sph, sstride},
                    leaf, t_min, t_max, tc, lc);
    } else {
      visit_by_warp(pending, want, lane, s.q, TableLeaves{table}, leaf, t_min,
                    t_max, tc, lc);
    }
    if (want >= 0) end_visit(s, want, tc, lc, ids, leaf);
  }
  if (r >= n) return;
  out_t[r] = s.best_t;
  out_id[r] = s.best_id;
}

}  // namespace hrt

// Launches K4 on `stream` (PyTorch's current stream), allocates nothing, and
// returns cudaGetLastError() so the caller can raise on a refused launch. A
// pool whose boxes and staged table fit the default shared memory is staged.
extern "C" int hrt_sphere_traverse(const float* rays8, int n,
                                   const float* bounds8, int k_clusters,
                                   const float* table, const int* ids,
                                   int leaf, float t_min, float t_max,
                                   float* out_t, int* out_id, void* stream) {
  if (k_clusters <= 0 || leaf <= 0 || n < 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  const int blocks = (n + hrt::kThreads - 1) / hrt::kThreads;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t box_bytes =
      (size_t)6 * ((k_clusters + 3) & ~3) * sizeof(float);
  const size_t staged_bytes =
      box_bytes +
      sizeof(float4) * (size_t)k_clusters * hrt::sphere_stride(leaf);
  using Kernel = void (*)(const float*, int, const float*, int, const float*,
                          const int*, int, float, float, float*, int*);
  Kernel kernel = hrt::sphere_traverse_kernel<false, false>;
  size_t smem = 0;
  if (staged_bytes <= hrt::kSphereSmemBytes) {
    kernel = hrt::sphere_traverse_kernel<true, true>;
    smem = staged_bytes;
  } else if (k_clusters <= hrt::kSmemMaxK) {
    kernel = hrt::sphere_traverse_kernel<false, true>;
    smem = box_bytes;
  }
  kernel<<<blocks, hrt::kThreads, smem, s>>>(rays8, n, bounds8, k_clusters,
                                             table, ids, leaf, t_min, t_max,
                                             out_t, out_id);
  return (int)cudaGetLastError();
}
