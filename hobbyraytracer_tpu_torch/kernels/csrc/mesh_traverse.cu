// Fused cluster-BVH traversal + Moller-Trumbore + attribute interpolation
// for NVIDIA Hopper (sm_90a), with a plain C interface for ctypes.
//
// Replaces the TPU kernel hobbyraytracer_tpu/kernels/mesh_traverse.py:_kernel
// (launched by traverse_clusters_pallas), with the same output contract:
//   rays8   (N, 8)     f32 [ox oy oz dx dy dz valid 0]
//   bounds8 (8, K)     f32 [bmin.xyz bmax.xyz 0 0]
//   tri_soa (K, 24, L) f32 [v0 e1 e2 n0 n1 n2 uv0 uv1 uv2], triangles last
//   tri_id  (K, L)     i32 global triangle id, -1 for padding
//   -> out  (N, 8)     f32 [t nx ny nz u v 0 0], t = 1e30 on a miss
//      id   (N,)       i32, -1 on a miss
//
// Design. One thread per ray. The TPU kernel holds a (B, K) entry matrix
// for a block of 256 rays in VMEM and visits the union of the block's
// needed clusters; here each thread keeps its own K slab entries in a
// local array (cap MAX_K) and visits its own clusters near to far, by
// (entry, lowest cluster index), while the entry is below its own best t.
// That per-ray set is a subset of the TPU block's set, so the nearest hit
// is the same except on exact t-ties. A visit runs Moller-Trumbore over
// the cluster's L triangles (t > 0, no t_min, as the reference), keeps the
// strictly better hit with the first minimum lane on ties, and
// interpolates the smooth normal (and the UV when need_uv) from the
// winner's barycentrics.
//
// What bounds it on the card. The teapot's tables are 30 x 24 x 128 x 4 B
// = 368,640 B: more than the 227 KB of shared memory a block may use, so
// they stay in global memory and are served from the 50 MB L2 (and L1).
// A visit reads 9 rows x L floats of one cluster; rays of a warp that
// visit the same cluster (the wavefront is coherence-sorted before the
// launch) read the same addresses. Per visit a ray does ~40 flops per
// triangle, so the kernel is latency- and divergence-bound rather than
// bandwidth-bound: warps whose rays need different numbers of visits
// idle lanes. Making that fast (staging hot clusters in shared memory,
// warp-cooperative visits) is later work; this version is simple and
// right first.
//
// Built with -fmad=false and IEEE division (no --use_fast_math), so each
// product and sum rounds on its own as in the plain PyTorch version
// (kernels/mesh_traverse.py:traverse_clusters_plain), op for op.
#include <cuda_runtime.h>

#define MAX_K 256
#define SOA_ROWS 24
#define THREADS 128

__global__ void mesh_traverse_kernel(
    const float* __restrict__ rays8, int n,
    const float* __restrict__ bounds8, int k_clusters,
    const float* __restrict__ tri_soa, const int* __restrict__ tri_id,
    int leaf, float t_max, int need_uv,
    float* __restrict__ out, int* __restrict__ out_id) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const float INF = __int_as_float(0x7f800000);
  const float BIG = 1e30f;
  const float* ray = rays8 + (size_t)r * 8;
  const float o[3] = {ray[0], ray[1], ray[2]};
  const float d[3] = {ray[3], ray[4], ray[5]};
  const bool valid = ray[6] > 0.0f;

  // slab entries of every cluster (aabb.h:26-39)
  float inv[3];
  for (int ax = 0; ax < 3; ++ax) {
    const float da = d[ax];
    inv[ax] = 1.0f / (fabsf(da) < 1e-30f ? 1e-30f : da);
  }
  float entry[MAX_K];
  for (int k = 0; k < k_clusters; ++k) {
    float lo = 0.0f, hi = 0.0f;
    for (int ax = 0; ax < 3; ++ax) {
      const float t0 = (bounds8[ax * k_clusters + k] - o[ax]) * inv[ax];
      const float t1 = (bounds8[(3 + ax) * k_clusters + k] - o[ax]) * inv[ax];
      const float lo_ax = fminf(t0, t1);
      const float hi_ax = fmaxf(t0, t1);
      lo = ax == 0 ? lo_ax : fmaxf(lo, lo_ax);
      hi = ax == 0 ? hi_ax : fminf(hi, hi_ax);
    }
    const float e = fmaxf(lo, 0.0f);
    entry[k] = (hi > e && e < t_max && valid) ? e : INF;
  }

  const float ox = o[0], oy = o[1], oz = o[2];
  const float dx = d[0], dy = d[1], dz = d[2];
  float best_t = BIG, bnx = 0.0f, bny = 0.0f, bnz = 0.0f;
  float bu = 0.0f, bv = 0.0f;
  int best_id = -1;
  while (true) {
    // nearest unvisited cluster; strict < keeps the lowest index on ties
    float e_min = INF;
    int k = -1;
    for (int c = 0; c < k_clusters; ++c) {
      if (entry[c] < e_min) {
        e_min = entry[c];
        k = c;
      }
    }
    if (!(e_min < best_t)) break;  // also ends when every entry is +inf
    entry[k] = INF;

    const float* blk = tri_soa + (size_t)k * SOA_ROWS * leaf;
    const int* ids = tri_id + (size_t)k * leaf;
    float tc = BIG, uc = 0.0f, vc = 0.0f;
    int lc = -1;
    for (int l = 0; l < leaf; ++l) {
      const float v0x = blk[0 * leaf + l], v0y = blk[1 * leaf + l],
                  v0z = blk[2 * leaf + l];
      const float e1x = blk[3 * leaf + l], e1y = blk[4 * leaf + l],
                  e1z = blk[5 * leaf + l];
      const float e2x = blk[6 * leaf + l], e2y = blk[7 * leaf + l],
                  e2z = blk[8 * leaf + l];
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
                        ids[l] >= 0;
      if (good && t < tc) {
        tc = t;
        lc = l;
        uc = u;
        vc = v;
      }
    }
    if (tc < best_t) {  // strictly better than every earlier visit
      const float w0 = 1.0f - uc - vc;
      best_t = tc;
      best_id = ids[lc];
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

// Launches on `stream` (PyTorch's current stream), allocates nothing, and
// returns cudaGetLastError() so the caller can raise on a refused launch.
extern "C" int hrt_mesh_traverse(const float* rays8, int n,
                                 const float* bounds8, int k_clusters,
                                 const float* tri_soa, const int* tri_id,
                                 int leaf, float t_max, int need_uv,
                                 float* out, int* out_id, void* stream) {
  if (k_clusters < 0 || k_clusters > MAX_K || leaf <= 0 || n < 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  const int blocks = (n + THREADS - 1) / THREADS;
  mesh_traverse_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      rays8, n, bounds8, k_clusters, tri_soa, tri_id, leaf, t_max, need_uv,
      out, out_id);
  return (int)cudaGetLastError();
}
