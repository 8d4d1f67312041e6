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
// Design. One thread per ray: a min and argmin over the K slab tests
// (mesh_traverse.cuh:slab_entry), the boxes staged in shared memory when
// they fit the default 48 KB (13-18% faster than L1 reads at K = 822 on
// an H100 80GB HBM3 at 700 W). The TPU kernel works on (2048, K) tiles and
// its wrapper pads the wavefront to whole tiles; here a thread per ray needs
// no padding. Bound: ~20 flops per (ray, cluster) from shared memory, 8
// floats read and 8 bytes written per ray; at K = 822 it is compute-bound.
#include "mesh_traverse.cuh"

namespace hrt {

template <bool SMEM>
__global__ void __launch_bounds__(kThreads) coherence_keys_kernel(
    const float* __restrict__ rays8, int n,
    const float* __restrict__ bounds8, int k_clusters, float t_max,
    float* __restrict__ e_out, int* __restrict__ first_out) {
  extern __shared__ float s_bounds[];
  const float* bnd = stage_bounds<SMEM>(bounds8, k_clusters, s_bounds);
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const Ray ray = load_ray(rays8, r);
  float e_min = __int_as_float(0x7f800000);
  int first = 0;
  for (int c = 0; c < k_clusters; ++c) {
    const float e = slab_entry(bnd, k_clusters, c, ray, t_max);
    if (e < e_min) {  // strict: the lowest index among equal entries
      e_min = e;
      first = c;
    }
  }
  e_out[r] = e_min;
  first_out[r] = first;
}

}  // namespace hrt

extern "C" int hrt_coherence_keys(const float* rays8, int n,
                                  const float* bounds8, int k_clusters,
                                  float t_max, float* e_min, int* first,
                                  void* stream) {
  if (k_clusters <= 0 || n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  const int blocks = (n + hrt::kThreads - 1) / hrt::kThreads;
  cudaStream_t s = (cudaStream_t)stream;
  if (k_clusters <= hrt::kSmemMaxK) {
    const size_t smem = (size_t)6 * k_clusters * sizeof(float);
    hrt::coherence_keys_kernel<true><<<blocks, hrt::kThreads, smem, s>>>(
        rays8, n, bounds8, k_clusters, t_max, e_min, first);
  } else {
    hrt::coherence_keys_kernel<false><<<blocks, hrt::kThreads, 0, s>>>(
        rays8, n, bounds8, k_clusters, t_max, e_min, first);
  }
  return (int)cudaGetLastError();
}
