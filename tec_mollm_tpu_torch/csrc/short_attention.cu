// Short causal attention, forward and backward: the Hopper port of the Pallas
// kernels tec_mollm_tpu/ops/short_attention.py:_call_fwd (_fwd_kernel) and
// :_call_bwd (_bwd_kernel).
//
// out[m, tq, h] = sum_{s <= tq} drop(softmax_s(q[m,tq,h] . k[m,s,h] / sqrt(Dh))) * v[m,s,h]
// for T <= 8 tokens and head-major D = H * Dh. Scores, softmax and the weighted
// sum are fp32; the output is written in the input type. Attention dropout keeps
// a weight iff bits >= threshold (threshold = p * 2^32, the JAX rule) and scales
// it by 1/(1-p). The bits are a counter-based hash of (seed, absolute index
// ((m*H + h)*T + tq)*T + s) (tec::Dropout, common.cuh), so the forward, the
// backward and the plain PyTorch version draw the same mask whatever the launch
// shape.
//
// Design: one warp per (row m, head h). Each lane holds EPL = Dh / 32 elements of
// every token's q, k, v (and g in the backward) in registers; the dot products
// are warp-shuffle reductions. Every input is read from device memory once and
// every output written once, so both kernels are bound by bytes: 4 x M*T*D
// elements forward, 7 x M*T*D backward. q, k and v may be strided views of one
// (M, T, 3D) projection: the kernels take the row and token strides. The
// backward recomputes the softmax and the mask, accumulates dk and dv over tq in
// registers, and writes dq, dk and dv into one contiguous (M, T, 3D) tensor in
// the projection's layout, so the projection's backward takes it as it is.
#include <cmath>
#include <cstdint>

#include "common.cuh"

namespace {

// fp32 softmax over s <= tq of the scaled scores q[tq] . k[s], into sc[0..tq].
template <int TLEN, int EPL>
__device__ __forceinline__ void causal_softmax(const float (&qf)[EPL], const float (&kf)[TLEN][EPL],
                                               int tq, float scale, float (&sc)[TLEN]) {
  float mx = -INFINITY;
#pragma unroll
  for (int s = 0; s < TLEN; ++s) {
    if (s > tq) break;
    float part = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) part = fmaf(qf[e], kf[s][e], part);
    sc[s] = tec::warp_sum(part) * scale;
    mx = fmaxf(mx, sc[s]);
  }
  float den = 0.f;
#pragma unroll
  for (int s = 0; s < TLEN; ++s) {
    if (s > tq) break;
    sc[s] = expf(sc[s] - mx);
    den += sc[s];
  }
#pragma unroll
  for (int s = 0; s < TLEN; ++s) {
    if (s > tq) break;
    sc[s] /= den;
  }
}

template <typename T, int TLEN, int EPL>
__global__ void short_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                       const T* __restrict__ v, T* __restrict__ out,
                                       int64_t rows, int heads, int64_t stride_m,
                                       int64_t stride_t, float scale, tec::Dropout drop) {
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
    float alpha[TLEN];
    causal_softmax<TLEN, EPL>(qf, kf, tq, scale, alpha);
    const uint64_t row_idx = (static_cast<uint64_t>(warp) * TLEN + tq) * TLEN;
    float o[EPL];
#pragma unroll
    for (int e = 0; e < EPL; ++e) o[e] = 0.f;
#pragma unroll
    for (int s = 0; s <= tq; ++s) {
      float a = alpha[s];
      if (drop.on) a = drop.keep(row_idx + s) ? a * drop.inv_keep : 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) o[e] = fmaf(a, vf[s][e], o[e]);
    }
    T* dst = out + (m * TLEN + tq) * d_model + h * kDh + lane * EPL;
#pragma unroll
    for (int e = 0; e < EPL; ++e) dst[e] = tec::from_float<T>(o[e]);
  }
}

template <typename T, int TLEN, int EPL>
__global__ void short_attention_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                           const T* __restrict__ v, const T* __restrict__ g,
                                           T* __restrict__ dqkv, int64_t rows, int heads,
                                           int64_t stride_m, int64_t stride_t, float scale,
                                           tec::Dropout drop) {
  const int64_t warp = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= rows * heads) return;
  const int64_t m = warp / heads;
  const int h = static_cast<int>(warp % heads);
  constexpr int kDh = 32 * EPL;
  const int64_t d_model = static_cast<int64_t>(heads) * kDh;
  const int64_t in_off = m * stride_m + h * kDh + lane * EPL;
  const int64_t g_off = m * TLEN * d_model + h * kDh + lane * EPL;

  float qf[TLEN][EPL], kf[TLEN][EPL], vf[TLEN][EPL], gf[TLEN][EPL];
  float dk[TLEN][EPL], dv[TLEN][EPL];
#pragma unroll
  for (int s = 0; s < TLEN; ++s) {
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      qf[s][e] = tec::to_float(q[in_off + s * stride_t + e]);
      kf[s][e] = tec::to_float(k[in_off + s * stride_t + e]);
      vf[s][e] = tec::to_float(v[in_off + s * stride_t + e]);
      gf[s][e] = tec::to_float(g[g_off + s * d_model + e]);
      dk[s][e] = 0.f;
      dv[s][e] = 0.f;
    }
  }

  T* out_row = dqkv + m * TLEN * 3 * d_model + h * kDh + lane * EPL;
#pragma unroll
  for (int tq = 0; tq < TLEN; ++tq) {
    float alpha[TLEN];  // the pre-dropout softmax
    causal_softmax<TLEN, EPL>(qf[tq], kf, tq, scale, alpha);
    const uint64_t row_idx = (static_cast<uint64_t>(warp) * TLEN + tq) * TLEN;
    float dalpha[TLEN];
    float dot = 0.f;
#pragma unroll
    for (int s = 0; s <= tq; ++s) {
      float part = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) part = fmaf(gf[tq][e], vf[s][e], part);
      const float dused = tec::warp_sum(part);  // d(used weight) = g . v_s
      float used = alpha[s];
      dalpha[s] = dused;
      if (drop.on) {
        const bool kept = drop.keep(row_idx + s);
        used = kept ? alpha[s] * drop.inv_keep : 0.f;
        dalpha[s] = kept ? dused * drop.inv_keep : 0.f;
      }
#pragma unroll
      for (int e = 0; e < EPL; ++e) dv[s][e] = fmaf(used, gf[tq][e], dv[s][e]);
      dot = fmaf(alpha[s], dalpha[s], dot);
    }
    float dq[EPL];
#pragma unroll
    for (int e = 0; e < EPL; ++e) dq[e] = 0.f;
#pragma unroll
    for (int s = 0; s <= tq; ++s) {
      // softmax Jacobian with the pre-dropout weights, then the 1/sqrt(Dh) scale
      const float ds = alpha[s] * (dalpha[s] - dot) * scale;
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        dq[e] = fmaf(ds, kf[s][e], dq[e]);
        dk[s][e] = fmaf(ds, qf[tq][e], dk[s][e]);
      }
    }
    T* dst = out_row + tq * 3 * d_model;
#pragma unroll
    for (int e = 0; e < EPL; ++e) dst[e] = tec::from_float<T>(dq[e]);
  }
#pragma unroll
  for (int s = 0; s < TLEN; ++s) {
    T* dst = out_row + s * 3 * d_model;
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      dst[d_model + e] = tec::from_float<T>(dk[s][e]);
      dst[2 * d_model + e] = tec::from_float<T>(dv[s][e]);
    }
  }
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* g;  // backward only
  void* out;      // forward: (rows, t, D); backward: (rows, t, 3D)
  int64_t rows;
  int heads;
  int64_t stride_m;
  int64_t stride_t;
  float scale;
  tec::Dropout drop;
};

template <typename T, int TLEN, int EPL>
cudaError_t launch_te(const Args& a, bool backward, cudaStream_t stream) {
  constexpr int kThreads = 256;
  const int64_t blocks = (a.rows * a.heads * 32 + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  T* out = static_cast<T*>(a.out);
  if (backward)
    short_attention_bwd_kernel<T, TLEN, EPL><<<blocks, kThreads, 0, stream>>>(
        q, k, v, static_cast<const T*>(a.g), out, a.rows, a.heads, a.stride_m, a.stride_t,
        a.scale, a.drop);
  else
    short_attention_kernel<T, TLEN, EPL><<<blocks, kThreads, 0, stream>>>(
        q, k, v, out, a.rows, a.heads, a.stride_m, a.stride_t, a.scale, a.drop);
  return cudaGetLastError();
}

template <typename T, int TLEN>
cudaError_t launch_t(const Args& a, int head_dim, bool backward, cudaStream_t s) {
  if (head_dim == 64) return launch_te<T, TLEN, 2>(a, backward, s);
  if (head_dim == 32) return launch_te<T, TLEN, 1>(a, backward, s);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch(const Args& a, int t, int head_dim, bool backward, cudaStream_t s) {
  switch (t) {
    case 1: return launch_t<T, 1>(a, head_dim, backward, s);
    case 2: return launch_t<T, 2>(a, head_dim, backward, s);
    case 3: return launch_t<T, 3>(a, head_dim, backward, s);
    case 4: return launch_t<T, 4>(a, head_dim, backward, s);
    case 5: return launch_t<T, 5>(a, head_dim, backward, s);
    case 6: return launch_t<T, 6>(a, head_dim, backward, s);
    case 7: return launch_t<T, 7>(a, head_dim, backward, s);
    case 8: return launch_t<T, 8>(a, head_dim, backward, s);
    default: return cudaErrorInvalidValue;
  }
}

int run(const void* q, const void* k, const void* v, const void* g, void* out, int64_t rows,
        int t, int heads, int head_dim, int64_t stride_m, int64_t stride_t, int is_bf16,
        int dropout, uint32_t seed, uint32_t threshold, float inv_keep, bool backward,
        void* stream) {
  Args a{q, k, v, g, out, rows, heads, stride_m, stride_t,
         1.f / std::sqrt(static_cast<float>(head_dim)),
         tec::Dropout{tec::dropout_key(seed), threshold, dropout ? inv_keep : 1.f, dropout}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = is_bf16 ? launch<__nv_bfloat16>(a, t, head_dim, backward, s)
                                  : launch<float>(a, t, head_dim, backward, s);
  return static_cast<int>(err);
}

}  // namespace

// q, k, v: (rows, t, heads*head_dim) with unit stride on the last axis and the
// given row / token strides (in elements); out: contiguous (rows, t, heads*head_dim).
// t in [1, 8]; head_dim 32 or 64. dropout != 0 drops with the given seed,
// threshold and 1/(1-p).
extern "C" int short_attention_forward(const void* q, const void* k, const void* v, void* out,
                                       int64_t rows, int t, int heads, int head_dim,
                                       int64_t stride_m, int64_t stride_t, int is_bf16,
                                       int dropout, uint32_t seed, uint32_t threshold,
                                       float inv_keep, void* stream) {
  return run(q, k, v, nullptr, out, rows, t, heads, head_dim, stride_m, stride_t, is_bf16,
             dropout, seed, threshold, inv_keep, false, stream);
}

// q, k, v as above; g: contiguous (rows, t, heads*head_dim), the output's
// gradient; dqkv: contiguous (rows, t, 3*heads*head_dim) <- [dq | dk | dv].
extern "C" int short_attention_backward(const void* q, const void* k, const void* v,
                                        const void* g, void* dqkv, int64_t rows, int t,
                                        int heads, int head_dim, int64_t stride_m,
                                        int64_t stride_t, int is_bf16, int dropout,
                                        uint32_t seed, uint32_t threshold, float inv_keep,
                                        void* stream) {
  return run(q, k, v, g, dqkv, rows, t, heads, head_dim, stride_m, stride_t, is_bf16, dropout,
             seed, threshold, inv_keep, true, stream);
}
