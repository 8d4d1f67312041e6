// Kernel K3: per-ray nearest cluster entry and the first cluster at it, for
// the wavefront coherence sort (HRT_KEY_MODE=pallas), with a plain C
// interface for ctypes.
//
// Replaces the TPU kernel hobbyraytracer_tpu/kernels/mesh_traverse.py:
// _key_kernel (launched by coherence_keys_pallas). Contract:
//   rays8   (N, 8) f32 [ox oy oz dx dy dz valid 0]
//   bounds8 (8, K) f32 [bmin.xyz bmax.xyz 0 0]
//   -> e_min (N,) f32 the smallest slab entry over the K clusters, +inf when
//      the ray misses them all or is invalid
//      first (N,) i32 the lowest cluster index at e_min, 0 on a miss
//
// Design. One thread a ray: a min and argmin over the K slab tests of
// mesh_traverse.cuh (slab_entry_box), rearranged without changing a bit of
// the result so that the loop does less of what the card does slowly. Float
// minimum, maximum and compare run at half the rate of add and multiply,
// and the plain slab test spends 11 min/max and 3 compares on 12 adds and
// multiplies; that pipe, not the rate of loads, bounds the loop (16-byte
// box loads with 2 or 4 rays a thread over each loaded box took 5% off at
// K = 822 on an NVIDIA H100 80GB HBM3 at 700 W; the two parts below 30%).
// - The near bound by the ray's direction. min(t0, t1) and max(t0, t1) of
//   an axis are (bmin - o) * inv and (bmax - o) * inv in the order the sign
//   of inv gives (multiplying by inv >= 0 keeps bmin <= bmax in order, by
//   inv < 0 reverses it, also after rounding). A ray fixes per axis, once,
//   which of the two rows it reads as near and as far, and the six
//   min/max of the axes go: 5 are left.
// - One running limit. A box becomes the new minimum iff hi > e, e < t_max,
//   the ray is valid and e < e_min: the last three are e < lim with lim =
//   min(e_min, t_max), or 0 for an invalid ray (entries are >= 0); once a
//   box was taken the limit is e_min itself, so it is the only float kept.
//   The test is strict and boxes come in index order, so the lowest index
//   wins among equal entries (the common case: a bounce ray inside several
//   boxes has entry 0 for all of them); a ray that takes no box gives
//   (+inf, 0).
// - The boxes are staged once a block in shared memory, rows padded to a
//   multiple of 4 with boxes at 1e30 that every ray misses
//   (stage_bounds_padded, the traversal kernels' staging), and a thread
//   reads 4 boxes with six 16-byte loads from its own near and far rows
//   (two addresses a warp-wide load, served as broadcasts). Past K = 2048
//   the boxes are read from global memory.
// The TPU kernel works on (2048, K) tiles and its wrapper pads the wavefront
// to whole tiles; here nothing is padded.
//
// What bounds it on the card. Operations: 8 floats read and 8 bytes written
// per ray, ~20 operations per (ray, cluster). Built with -fmad=false (each
// product and sum rounds on its own, as in the plain PyTorch version
// kernels/mesh_traverse.py:coherence_keys_plain, which it equals bit for
// bit), so an operation is an instruction and the card starts at most 132
// SMs x 128 of them a clock, half of that for min, max and compare. Tensor
// cores are not used: there is no product here whose float32 rounding could
// stay op for op with the plain version.
#include "mesh_traverse.cuh"

namespace hrt {

// A ray's minimum so far. `first` is -1 until a box was taken; from then on
// the limit is the smallest entry.
struct KeyMin {
  float lim;
  int first;
  // Offers box c, given per axis the bound the ray meets first and the one
  // it meets last: the box takes the minimum over when the ray enters it
  // strictly below the limit.
  __device__ __forceinline__ void offer(const float (&b_near)[3],
                                        const float (&b_far)[3],
                                        const Ray& ray, int c) {
    float lo = 0.0f, hi = 0.0f;
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      const float lo_ax = (b_near[ax] - ray.o[ax]) * ray.inv[ax];
      const float hi_ax = (b_far[ax] - ray.o[ax]) * ray.inv[ax];
      lo = ax == 0 ? lo_ax : fmaxf(lo, lo_ax);
      hi = ax == 0 ? hi_ax : fminf(hi, hi_ax);
    }
    const float e = fmaxf(lo, 0.0f);
    if (hi > e && e < lim) {
      lim = e;
      first = c;
    }
  }
};

template <bool SMEM>
__global__ void __launch_bounds__(kThreads) coherence_keys_kernel(
    const float* __restrict__ rays8, int n,
    const float* __restrict__ bounds8, int k_clusters, float t_max,
    float* __restrict__ e_out, int* __restrict__ first_out) {
  extern __shared__ __align__(16) float s_boxes[];
  const int stride = SMEM ? padded_stride(k_clusters) : k_clusters;
  const float* bnd = SMEM ? s_boxes : bounds8;
  if (SMEM) stage_bounds_padded(bounds8, k_clusters, s_boxes);
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const Ray ray = load_ray(rays8, r);
  // per axis the rows of the bound the ray meets first and last
  const float* row_near[3];
  const float* row_far[3];
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    const bool neg = ray.inv[ax] < 0.0f;
    row_near[ax] = bnd + (neg ? ax + 3 : ax) * stride;
    row_far[ax] = bnd + (neg ? ax : ax + 3) * stride;
  }
  KeyMin best = {ray.valid ? t_max : 0.0f, -1};
  if (SMEM) {
    for (int c = 0; c < stride; c += 4) {
      float4 near4[3], far4[3];
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) {
        near4[ax] = *reinterpret_cast<const float4*>(row_near[ax] + c);
        far4[ax] = *reinterpret_cast<const float4*>(row_far[ax] + c);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float b_near[3], b_far[3];
#pragma unroll
        for (int ax = 0; ax < 3; ++ax) {
          b_near[ax] = i == 0   ? near4[ax].x
                       : i == 1 ? near4[ax].y
                       : i == 2 ? near4[ax].z
                                : near4[ax].w;
          b_far[ax] = i == 0   ? far4[ax].x
                      : i == 1 ? far4[ax].y
                      : i == 2 ? far4[ax].z
                               : far4[ax].w;
        }
        best.offer(b_near, b_far, ray, c + i);
      }
    }
  } else {
    for (int c = 0; c < k_clusters; ++c) {
      float b_near[3], b_far[3];
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) {
        b_near[ax] = row_near[ax][c];
        b_far[ax] = row_far[ax][c];
      }
      best.offer(b_near, b_far, ray, c);
    }
  }
  e_out[r] = best.first < 0 ? __int_as_float(0x7f800000) : best.lim;
  first_out[r] = max(best.first, 0);
}

}  // namespace hrt

// Launches K3 on `stream` (PyTorch's current stream), allocates nothing, and
// returns cudaGetLastError() so the caller can raise on a refused launch.
extern "C" int hrt_coherence_keys(const float* rays8, int n,
                                  const float* bounds8, int k_clusters,
                                  float t_max, float* e_min, int* first,
                                  void* stream) {
  if (k_clusters <= 0 || n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  const int blocks = (n + hrt::kThreads - 1) / hrt::kThreads;
  cudaStream_t s = (cudaStream_t)stream;
  if (k_clusters <= hrt::kSmemMaxK) {
    const size_t smem =
        (size_t)6 * ((k_clusters + 3) & ~3) * sizeof(float);
    hrt::coherence_keys_kernel<true><<<blocks, hrt::kThreads, smem, s>>>(
        rays8, n, bounds8, k_clusters, t_max, e_min, first);
  } else {
    hrt::coherence_keys_kernel<false><<<blocks, hrt::kThreads, 0, s>>>(
        rays8, n, bounds8, k_clusters, t_max, e_min, first);
  }
  return (int)cudaGetLastError();
}
