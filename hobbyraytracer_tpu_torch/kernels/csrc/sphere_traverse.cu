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
// near root (-hb - sqrt(max(disc, 0))) / a if it lies in [t_min, t_max],
// else the far root if that does, a hit only where disc > 0; the lowest lane
// at the cluster's minimum wins, and it replaces the ray's best only when
// strictly nearer. r2 comes from the table as the host squared it.
//
// Design. One thread per ray, no padding of the wavefront (the TPU wrapper
// pads it to whole blocks only for its grid). The next cluster is found by
// rescanning the K slab tests for the smallest (entry, index) above the last
// visited pair, so no per-ray array is kept and no K is too large. A sphere
// pool is small: bounds, cx cy cz r2 and ids are 6K + 5KL words, 10,336 B
// for the 485-ball scene (K = 4, L = 128). While that fits the default
// 48 KB of shared memory (K <= 19 at L = 128) each block stages it once and
// every lane test reads shared memory, all threads of a warp the same word
// (a broadcast); past that the kernel reads the same words from global
// memory through L1/L2.
//
// What bounds it on the card. Per ray 32 B in and 8 B out, the table once:
// at 196,608 rays 7.9 MB, microseconds of HBM time. The work is K slab tests
// per scan plus L quadratics (~30 flops and one sqrt each) per visited
// cluster, so the kernel is bound by operations, and within that by
// divergence: the scattered-balls ground sphere makes one cluster's box span
// the scene, so every ray visits that cluster and rays of one warp differ in
// how many more they need.
//
// Built with -fmad=false, IEEE division and square root, so each op rounds
// as in the plain PyTorch version (kernels/sphere_traverse.py:
// intersect_spheres_plain); the two agree bit for bit.
#include "mesh_traverse.cuh"

namespace hrt {

constexpr int kSphereRows = 8;
// the default shared memory of a block: the tables are staged while
// (6K + 5KL) words fit it
constexpr size_t kSphereSmemBytes = 48 * 1024;

__host__ __device__ inline size_t sphere_smem_bytes(int k_clusters,
                                                    int leaf) {
  return ((size_t)6 * k_clusters + (size_t)5 * k_clusters * leaf) *
         sizeof(float);
}

template <bool SMEM>
__global__ void __launch_bounds__(kThreads) sphere_traverse_kernel(
    const float* __restrict__ rays8, int n,
    const float* __restrict__ bounds8, int k_clusters,
    const float* __restrict__ table, const int* __restrict__ ids, int leaf,
    float t_min, float t_max, float* __restrict__ out_t,
    int* __restrict__ out_id) {
  extern __shared__ float s_mem[];
  // where the kernel reads the boxes, the rows [cx cy cz r2] of cluster k
  // (at sph + k * stride, 4 rows of `leaf`) and the ids
  const float* bnd = bounds8;
  const float* sph = table;
  const int* sid = ids;
  size_t stride = (size_t)kSphereRows * leaf;
  if (SMEM) {
    float* s_bnd = s_mem;
    float* s_sph = s_bnd + 6 * k_clusters;
    int* s_ids = reinterpret_cast<int*>(s_sph + 4 * k_clusters * leaf);
    const int rows4 = 4 * leaf;
    for (int i = threadIdx.x; i < 6 * k_clusters; i += blockDim.x)
      s_bnd[i] = bounds8[i];
    for (int i = threadIdx.x; i < k_clusters * rows4; i += blockDim.x)
      s_sph[i] = table[(size_t)(i / rows4) * kSphereRows * leaf + i % rows4];
    for (int i = threadIdx.x; i < k_clusters * leaf; i += blockDim.x)
      s_ids[i] = ids[i];
    __syncthreads();
    bnd = s_bnd;
    sph = s_sph;
    sid = s_ids;
    stride = (size_t)rows4;
  }
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const Ray ray = load_ray(rays8, r);
  const float ox = ray.o[0], oy = ray.o[1], oz = ray.o[2];
  const float dx = ray.d[0], dy = ray.d[1], dz = ray.d[2];
  const float a = dx * dx + dy * dy + dz * dz;
  const float inv_a = 1.0f / a;

  float best_t = kBig;
  int best_id = -1;
  // last visited (entry, index); entries are >= 0, so (-1, -1) is below all
  float last_e = -1.0f;
  int last_k = -1;
  while (true) {
    // the smallest (entry, index) above the last visited pair whose entry
    // is below best_t; strict < keeps the lowest index among equal entries
    float e_min = best_t;
    int k = -1;
    for (int c = 0; c < k_clusters; ++c) {
      const float e = slab_entry(bnd, k_clusters, c, ray, t_max);
      const bool after = e > last_e || (e == last_e && c > last_k);
      if (after && e < e_min) {
        e_min = e;
        k = c;
      }
    }
    if (k < 0) break;
    last_e = e_min;
    last_k = k;

    const float* blk = sph + (size_t)k * stride;
    float tc = kBig;
    int lc = -1;
    for (int l = 0; l < leaf; ++l) {
      const float ocx = ox - blk[l];
      const float ocy = oy - blk[leaf + l];
      const float ocz = oz - blk[2 * leaf + l];
      const float half_b = ocx * dx + ocy * dy + ocz * dz;
      const float c = ocx * ocx + ocy * ocy + ocz * ocz - blk[3 * leaf + l];
      const float disc = half_b * half_b - a * c;
      const float sq = sqrtf(fmaxf(disc, 0.0f));
      const float r1 = (-half_b - sq) * inv_a;
      const float r2 = (-half_b + sq) * inv_a;
      const bool in1 = r1 >= t_min && r1 <= t_max;
      const bool in2 = r2 >= t_min && r2 <= t_max;
      const float root = in1 ? r1 : (in2 ? r2 : kBig);
      const float t = disc > 0.0f ? root : kBig;
      if (t < tc) {  // the lowest lane at the cluster's minimum
        tc = t;
        lc = l;
      }
    }
    if (tc < best_t) {  // strictly nearer than every earlier visit
      best_t = tc;
      best_id = sid[(size_t)k * leaf + lc];
    }
  }
  out_t[r] = best_t;
  out_id[r] = best_id;
}

}  // namespace hrt

// Launches K4 on `stream` (PyTorch's current stream), allocates nothing, and
// returns cudaGetLastError() so the caller can raise on a refused launch.
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
  const size_t smem = hrt::sphere_smem_bytes(k_clusters, leaf);
  if (smem <= hrt::kSphereSmemBytes) {
    hrt::sphere_traverse_kernel<true><<<blocks, hrt::kThreads, smem, s>>>(
        rays8, n, bounds8, k_clusters, table, ids, leaf, t_min, t_max, out_t,
        out_id);
  } else {
    hrt::sphere_traverse_kernel<false><<<blocks, hrt::kThreads, 0, s>>>(
        rays8, n, bounds8, k_clusters, table, ids, leaf, t_min, t_max, out_t,
        out_id);
  }
  return (int)cudaGetLastError();
}
