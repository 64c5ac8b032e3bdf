// Small helpers shared by the port's kernels.
#pragma once

#include <cmath>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace tec {

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Attention dropout. A weight is kept iff its bits >= threshold (threshold =
// p * 2^32, the JAX rule) and then scaled by 1/(1-p). The bits of absolute
// index i are mix32(mix32(key ^ lo32(i)) ^ hi32(i)) with key = dropout_key(seed),
// a counter-based hash, so every kernel and the plain PyTorch version
// (ops/short_attention.py:dropout_bits) draw the same mask whatever the launch
// shape.
__host__ __device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

__host__ __forceinline__ uint32_t dropout_key(uint32_t seed) { return mix32(seed ^ 0x9E3779B9u); }

struct Dropout {
  uint32_t key;
  uint32_t threshold;
  float inv_keep;
  int on;

  __device__ __forceinline__ bool keep(uint64_t idx) const {
    const uint32_t bits = mix32(mix32(key ^ static_cast<uint32_t>(idx)) ^ static_cast<uint32_t>(idx >> 32));
    return bits >= threshold;
  }
};

}  // namespace tec
