// sphere_scan: the nearest pooled sphere of each ray by the dense scan, with
// a plain C interface for ctypes.
//
// Replaces no Pallas kernel. The JAX package leaves its dense sphere scan
// (hobbyraytracer_tpu/ops/intersect.py:intersect_spheres, the default route
// for pooled spheres) to XLA, which fuses it; in PyTorch the same scan is
// some 30 elementwise and reduction kernels a chunk of 128 spheres, each
// writing a (rays x 128) float32 intermediate to device memory. This kernel
// is that scan fused. Contract:
//   o      (N, 3)  f32 ray origins
//   d      (N, 3)  f32 ray directions
//   center (S, 3)  f32 sphere centers
//   radius (S,)    f32 sphere radii
//   -> t   (N,)    f32 nearest root in [t_min, t_max], 1e30 on a miss
//      id  (N,)    i64 the nearest sphere's index, -1 on a miss
//
// Arithmetic: op for op the plain version's (kernels/sphere_scan.py:
// sphere_t), which is the reference's dense scan. a = |d|^2 and 1 / a once
// a ray; per sphere oc = o - c, half_b = (ocx dx + ocy dy) + ocz dz,
// c = ((ocx^2 + ocy^2) + ocz^2) - r*r, disc = half_b^2 - a c, the root of 1
// where disc == 0 (the plain version's guard), the near root if it lies in
// [t_min, t_max], else the far root if that does, a hit only where
// disc >= 0. Built with -fmad=false and IEEE division and square root
// (kernels/build.py), so every operation rounds as the PyTorch kernel that
// the plain version runs for it, and the two agree bit for bit. The spheres
// are folded in index order with a strict <, which picks the lowest index at
// the smallest t, as the plain version's chunk minimum (lowest lane at it)
// and strict < across chunks do. The plain version's pad spheres never hit
// and are not visited here. Nothing may cull a sphere by a bound or the
// running best t, or reorder a sum: one changed bit parts a path.
//
// What bounds it on the card. Operations, not bytes: per ray 24 B in and
// 12 B out, the pool once a block from L2; per ray and sphere ~20 float32
// operations (about 1.9 G for 196,608 rays and 485 spheres, ~57 us at one
// an instruction on 132 SMs), with the roots only where disc >= 0 (most
// tests miss; a warp takes that branch when any lane hits).
//
// Design. One thread a ray; every intermediate stays in registers, and a
// ray is read once and its (t, id) written once. A block stages the pool in
// shared memory in tiles of kTile spheres, one 16-byte word [cx cy cz r*r]
// a sphere (r*r squared here, as the plain version squares it), so a test
// costs one 16-byte load that every lane of the warp reads at the same
// address (a broadcast). A pool larger than a tile is scanned tile by tile
// in index order. Lanes past N load nothing and store nothing but stay for
// the block's barriers.
#include <cuda_runtime.h>

namespace hrt {

constexpr int kScanThreads = 128;
constexpr int kTile = 1024;        // spheres a tile: 16 KB of shared memory
constexpr float kBig = 1e30f;

__global__ void __launch_bounds__(kScanThreads)
sphere_scan_kernel(const float* __restrict__ o, const float* __restrict__ d,
                   int n, const float* __restrict__ center,
                   const float* __restrict__ radius, int n_spheres,
                   float t_min, float t_max, float* __restrict__ out_t,
                   long long* __restrict__ out_id) {
  __shared__ float4 tile[kTile];
  const int i = blockIdx.x * kScanThreads + threadIdx.x;
  const bool live = i < n;
  float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 0.0f;
  if (live) {
    ox = o[3 * i];
    oy = o[3 * i + 1];
    oz = o[3 * i + 2];
    dx = d[3 * i];
    dy = d[3 * i + 1];
    dz = d[3 * i + 2];
  }
  const float a = dx * dx + dy * dy + dz * dz;
  const float inv_a = 1.0f / a;
  float best_t = kBig;
  long long best_id = -1;
  for (int base = 0; base < n_spheres; base += kTile) {
    const int m = min(kTile, n_spheres - base);
    __syncthreads();  // the previous tile is read by every lane
    for (int j = threadIdx.x; j < m; j += kScanThreads) {
      const int k = base + j;
      const float r = radius[k];
      tile[j] = make_float4(center[3 * k], center[3 * k + 1],
                            center[3 * k + 2], r * r);
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < m; ++j) {
      const float4 s = tile[j];
      const float ocx = ox - s.x;
      const float ocy = oy - s.y;
      const float ocz = oz - s.z;
      const float half_b = ocx * dx + ocy * dy + ocz * dz;
      const float c = ocx * ocx + ocy * ocy + ocz * ocz - s.w;
      const float disc = half_b * half_b - a * c;
      if (disc >= 0.0f) {
        const float sqrtd = disc > 0.0f ? sqrtf(disc) : 1.0f;
        const float r1 = (-half_b - sqrtd) * inv_a;
        const float r2 = (-half_b + sqrtd) * inv_a;
        float t = kBig;
        if (r1 >= t_min && r1 <= t_max) {
          t = r1;
        } else if (r2 >= t_min && r2 <= t_max) {
          t = r2;
        }
        if (t < best_t) {
          best_t = t;
          best_id = base + j;
        }
      }
    }
  }
  if (live) {
    out_t[i] = best_t;
    out_id[i] = best_id;
  }
}

}  // namespace hrt

extern "C" int hrt_sphere_scan(const float* o, const float* d, int n,
                               const float* center, const float* radius,
                               int n_spheres, float t_min, float t_max,
                               float* out_t, long long* out_id,
                               void* stream) {
  if (n_spheres <= 0 || n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  const int blocks = (n + hrt::kScanThreads - 1) / hrt::kScanThreads;
  hrt::sphere_scan_kernel<<<blocks, hrt::kScanThreads, 0,
                            (cudaStream_t)stream>>>(
      o, d, n, center, radius, n_spheres, t_min, t_max, out_t, out_id);
  return (int)cudaGetLastError();
}
