// Short causal attention, forward: the Hopper port of the Pallas kernel
// tec_mollm_tpu/ops/short_attention.py:_call_fwd (_fwd_kernel).
//
// out[m, tq, h] = sum_{s <= tq} softmax_s(q[m,tq,h] . k[m,s,h] / sqrt(Dh)) * v[m,s,h]
// for T <= 8 tokens and head-major D = H * Dh. Scores, softmax and the weighted
// sum are fp32; the output is written in the input type.
//
// Design: one warp per (row m, head h). Each lane holds EPL = Dh / 32 elements of
// every token's q, k and v in registers; the dot products are warp-shuffle
// reductions. q, k and v are read from device memory once and the output written
// once, so the bound is bytes (4 x M*T*D elements). q, k and v may be strided
// views of one (M, T, 3D) projection: the kernel takes the row and token strides.
#include <cmath>
#include <cstdint>

#include "common.cuh"

namespace {

template <typename T, int TLEN, int EPL>
__global__ void short_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                       const T* __restrict__ v, T* __restrict__ out,
                                       int64_t rows, int heads, int64_t stride_m,
                                       int64_t stride_t, float scale) {
  const int64_t warp = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= rows * heads) return;  // whole warps exit together
  const int64_t m = warp / heads;
  const int h = static_cast<int>(warp % heads);
  constexpr int kDh = 32 * EPL;
  const int64_t d_model = static_cast<int64_t>(heads) * kDh;
  const int64_t in_off = m * stride_m + h * kDh + lane * EPL;

  float kf[TLEN][EPL], vf[TLEN][EPL];
#pragma unroll
  for (int s = 0; s < TLEN; ++s) {
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      kf[s][e] = tec::to_float(k[in_off + s * stride_t + e]);
      vf[s][e] = tec::to_float(v[in_off + s * stride_t + e]);
    }
  }

#pragma unroll
  for (int tq = 0; tq < TLEN; ++tq) {
    float qf[EPL];
#pragma unroll
    for (int e = 0; e < EPL; ++e) qf[e] = tec::to_float(q[in_off + tq * stride_t + e]);
    float sc[TLEN];
    float mx = -INFINITY;
#pragma unroll
    for (int s = 0; s <= tq; ++s) {
      float part = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) part = fmaf(qf[e], kf[s][e], part);
      sc[s] = tec::warp_sum(part) * scale;
      mx = fmaxf(mx, sc[s]);
    }
    float den = 0.f;
#pragma unroll
    for (int s = 0; s <= tq; ++s) {
      sc[s] = expf(sc[s] - mx);
      den += sc[s];
    }
    float o[EPL];
#pragma unroll
    for (int e = 0; e < EPL; ++e) o[e] = 0.f;
#pragma unroll
    for (int s = 0; s <= tq; ++s) {
      const float alpha = sc[s] / den;
#pragma unroll
      for (int e = 0; e < EPL; ++e) o[e] = fmaf(alpha, vf[s][e], o[e]);
    }
    T* dst = out + (m * TLEN + tq) * d_model + h * kDh + lane * EPL;
#pragma unroll
    for (int e = 0; e < EPL; ++e) dst[e] = tec::from_float<T>(o[e]);
  }
}

template <typename T, int TLEN>
cudaError_t launch_t(const void* q, const void* k, const void* v, void* out, int64_t rows,
                     int heads, int head_dim, int64_t stride_m, int64_t stride_t,
                     cudaStream_t stream) {
  constexpr int kThreads = 256;
  const int64_t warps = rows * heads;
  const int64_t blocks = (warps * 32 + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const float scale = 1.f / std::sqrt(static_cast<float>(head_dim));
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  T* op = static_cast<T*>(out);
  if (head_dim == 64)
    short_attention_kernel<T, TLEN, 2><<<blocks, kThreads, 0, stream>>>(
        qp, kp, vp, op, rows, heads, stride_m, stride_t, scale);
  else if (head_dim == 32)
    short_attention_kernel<T, TLEN, 1><<<blocks, kThreads, 0, stream>>>(
        qp, kp, vp, op, rows, heads, stride_m, stride_t, scale);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int64_t rows,
                   int t, int heads, int head_dim, int64_t stride_m, int64_t stride_t,
                   cudaStream_t s) {
  switch (t) {
    case 1: return launch_t<T, 1>(q, k, v, out, rows, heads, head_dim, stride_m, stride_t, s);
    case 2: return launch_t<T, 2>(q, k, v, out, rows, heads, head_dim, stride_m, stride_t, s);
    case 3: return launch_t<T, 3>(q, k, v, out, rows, heads, head_dim, stride_m, stride_t, s);
    case 4: return launch_t<T, 4>(q, k, v, out, rows, heads, head_dim, stride_m, stride_t, s);
    case 5: return launch_t<T, 5>(q, k, v, out, rows, heads, head_dim, stride_m, stride_t, s);
    case 6: return launch_t<T, 6>(q, k, v, out, rows, heads, head_dim, stride_m, stride_t, s);
    case 7: return launch_t<T, 7>(q, k, v, out, rows, heads, head_dim, stride_m, stride_t, s);
    case 8: return launch_t<T, 8>(q, k, v, out, rows, heads, head_dim, stride_m, stride_t, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v: (rows, t, heads*head_dim) with unit stride on the last axis and the
// given row / token strides (in elements); out: contiguous (rows, t, heads*head_dim).
// t in [1, 8]; head_dim 32 or 64.
extern "C" int short_attention_forward(const void* q, const void* k, const void* v,
                                       void* out, int64_t rows, int t, int heads,
                                       int head_dim, int64_t stride_m, int64_t stride_t,
                                       int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(q, k, v, out, rows, t, heads, head_dim, stride_m, stride_t, s)
              : launch<float>(q, k, v, out, rows, t, heads, head_dim, stride_m, stride_t, s);
  return static_cast<int>(err);
}
