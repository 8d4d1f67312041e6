// Threefry-2x32 draws: jax.random's counter-based bits and float32
// uniforms, with a plain C interface for ctypes.
//
// A port-only kernel: the JAX package draws through jax.random, which XLA
// compiles (no Pallas kernel to replace). It reproduces what jax.random does
// with jax_threefry_partitionable on, bit for bit:
//   fold_in(key, d)      = threefry2x32(key, (0, d))
//   split(key, n)[i]     = threefry2x32(key, (0, i))   (the same as fold_in)
//   bits of element i    = x0 ^ x1 of threefry2x32(key, (hi(i), lo(i))), i
//                          the element's flat index in the whole draw
//   uniform float32      = bitcast((bits >> 9) | 0x3F800000) - 1, max 0
// Contract:
//   k0, k1   the key words, host values, or
//   words    two int32 in device memory that hold them (k0, k1 are then
//            not read) -- the key slot whose words the host writes before
//            each replay of a CUDA graph
//   it       nullptr, or one int32 in device memory: the key is then
//            fold_in(key, *it) -- the iteration a replayed CUDA graph reads
//   path     n_path (<= 6) more folds applied after it, host values
//   offset   the counter of element 0 (a span's first row times the row
//            size), n the elements
//   -> out   (n,) uint32 bits, or float32 uniforms with as_float
//
// Design. One thread an element. The key (the slot's words, folded by the
// iteration and the n_path folds: 1 + n_path threefry2x32 evaluations, the
// same for every element) is derived once a block, by its first thread,
// into shared memory; then every thread evaluates its counter. 20 rounds
// of add, rotate and xor on 32-bit integers, no memory but the 4-byte
// store and, with `words` and `it`, 8 and 4 bytes of loads a block. Six
// folds after the iteration hold the longest path the port draws (the
// batch integrator's isotropic scatter from a slot key: split, purpose,
// bounce and in_ball's two splits, five) and one more. Integer operations
// are exact, so the plain PyTorch version (kernels/threefry.py:
// threefry_plain, int64 arithmetic masked to 32 bits) equals it bit for
// bit.
//
// What bounds it on the card: the store, 4 B an element, over the memory
// rate, against one threefry2x32 (~80 integer operations) and ~11 more an
// element at the SMs' integer rate; the key's serial chain of up to seven
// threefry2x32 adds its latency once a block.
#include <cuda_runtime.h>

#include <cstdint>

namespace hrt {

constexpr int kTfThreads = 256;
constexpr int kTfMaxPath = 6;

struct TfPath {
  uint32_t v[kTfMaxPath];
};

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// four rounds of the Threefry-2x32 mix with rotations r0..r3
#define HRT_TF_ROUNDS(r0, r1, r2, r3)     \
  x0 += x1; x1 = rotl32(x1, r0); x1 ^= x0; \
  x0 += x1; x1 = rotl32(x1, r1); x1 ^= x0; \
  x0 += x1; x1 = rotl32(x1, r2); x1 ^= x0; \
  x0 += x1; x1 = rotl32(x1, r3); x1 ^= x0;

// threefry2x32 of the counter (c0, c1) under the key (k0, k1): 20 rounds,
// a key injection after every four, as jax's threefry2x32 lowering
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t c0, uint32_t c1,
                                             uint32_t* o0, uint32_t* o1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  uint32_t x0 = c0 + k0;
  uint32_t x1 = c1 + k1;
  HRT_TF_ROUNDS(13, 15, 26, 6)
  x0 += k1; x1 += k2 + 1u;
  HRT_TF_ROUNDS(17, 29, 16, 24)
  x0 += k2; x1 += k0 + 2u;
  HRT_TF_ROUNDS(13, 15, 26, 6)
  x0 += k0; x1 += k1 + 3u;
  HRT_TF_ROUNDS(17, 29, 16, 24)
  x0 += k1; x1 += k2 + 4u;
  HRT_TF_ROUNDS(13, 15, 26, 6)
  x0 += k2; x1 += k0 + 5u;
  *o0 = x0;
  *o1 = x1;
}

#undef HRT_TF_ROUNDS

template <bool kFloat>
__global__ void __launch_bounds__(kTfThreads)
    threefry_kernel(uint32_t k0, uint32_t k1, const int* __restrict__ words,
                    const int* __restrict__ it, TfPath path, int n_path,
                    unsigned long long offset, int n,
                    void* __restrict__ out) {
  __shared__ uint32_t key[2];
  if (threadIdx.x == 0) {
    if (words != nullptr) {
      k0 = (uint32_t)__ldg(words);
      k1 = (uint32_t)__ldg(words + 1);
    }
    if (it != nullptr)
      threefry2x32(k0, k1, 0u, (uint32_t)__ldg(it), &k0, &k1);
    for (int j = 0; j < n_path; ++j)
      threefry2x32(k0, k1, 0u, path.v[j], &k0, &k1);
    key[0] = k0;
    key[1] = k1;
  }
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  k0 = key[0];
  k1 = key[1];
  const unsigned long long c = offset + (unsigned long long)i;
  uint32_t a, b;
  threefry2x32(k0, k1, (uint32_t)(c >> 32), (uint32_t)c, &a, &b);
  const uint32_t bits = a ^ b;
  if (kFloat) {
    const float f = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
    static_cast<float*>(out)[i] = fmaxf(0.0f, f);
  } else {
    static_cast<uint32_t*>(out)[i] = bits;
  }
}

}  // namespace hrt

// Launches the draw on `stream` (PyTorch's current stream), allocates
// nothing, and returns cudaGetLastError() so the caller can raise on a
// refused launch.
extern "C" int hrt_threefry(unsigned k0, unsigned k1, const int* words,
                            const int* it, int n_path, const unsigned* path,
                            long long offset, int n, int as_float, void* out,
                            void* stream) {
  if (n < 0 || offset < 0 || n_path < 0 || n_path > hrt::kTfMaxPath)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  hrt::TfPath p = {};
  for (int j = 0; j < n_path; ++j) p.v[j] = path[j];
  const int blocks = (n + hrt::kTfThreads - 1) / hrt::kTfThreads;
  cudaStream_t s = (cudaStream_t)stream;
  if (as_float) {
    hrt::threefry_kernel<true><<<blocks, hrt::kTfThreads, 0, s>>>(
        k0, k1, words, it, p, n_path, (unsigned long long)offset, n, out);
  } else {
    hrt::threefry_kernel<false><<<blocks, hrt::kTfThreads, 0, s>>>(
        k0, k1, words, it, p, n_path, (unsigned long long)offset, n, out);
  }
  return (int)cudaGetLastError();
}
