// Stencil GATv2 attention, forward: the Hopper port of the Pallas kernel
// tec_mollm_tpu/ops/gat_stencil.py:gat_stencil_attention (_kernel).
//
// For each graph slice m and node n, over the O static lane shifts:
//   score_h = sum_c att[h,c] * leaky_relu(xl[m, h*C+c, n+shift] + xr[m, h*C+c, n])
//   masked by valid[o, n]; softmax over the offsets; out = sum_o alpha * xl[.., n+shift].
//
// Design: one thread per (m, n) with all H*C channels in registers and an online
// (running-max) softmax, so xl and xr are read from device memory once and the
// output written once. Neighbouring threads take neighbouring n, so every read
// of xl[m, c, n+shift] is coalesced. The bound is bytes (3 x M*H*C*N elements):
// the 11 shifted re-reads of xl hit L1/L2, not device memory. `shifts` travel in
// the kernel's arguments; `att` stays on the device (fp32), so a launch needs no
// host copy of a parameter.
// Unlike the Pallas roll, which wraps around modulo N and relies on `valid`,
// this kernel never reads outside [0, N). The denominator is floored at
// FLT_MIN like models/gat.py's XLA path, so a lane with no valid offset (the
// padded nodes) gives 0 and not NaN.
#include <cfloat>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kMaxOffsets = 64;

struct StencilShifts {
  int shifts[kMaxOffsets];
};

template <typename T, int H, int C>
__global__ void gat_stencil_kernel(const T* __restrict__ xl, const T* __restrict__ xr,
                                   const uint8_t* __restrict__ valid,
                                   const float* __restrict__ att, T* __restrict__ out,
                                   int n_nodes, int n_offsets, float slope,
                                   const StencilShifts p) {
  constexpr int HC = H * C;
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= n_nodes) return;
  const int64_t base = static_cast<int64_t>(blockIdx.y) * HC * n_nodes;
  const T* xl_m = xl + base;
  const T* xr_m = xr + base;

  float r[HC], acc[HC], a[HC], mx[H], den[H];
#pragma unroll
  for (int c = 0; c < HC; ++c) {
    r[c] = tec::to_float(xr_m[static_cast<int64_t>(c) * n_nodes + n]);
    a[c] = __ldg(att + c);
    acc[c] = 0.f;
  }
#pragma unroll
  for (int h = 0; h < H; ++h) {
    mx[h] = -INFINITY;
    den[h] = 0.f;
  }

  for (int o = 0; o < n_offsets; ++o) {
    const int j = n + p.shifts[o];
    if (j < 0 || j >= n_nodes || !valid[static_cast<int64_t>(o) * n_nodes + n]) continue;
    float l[HC];
#pragma unroll
    for (int c = 0; c < HC; ++c) l[c] = tec::to_float(xl_m[static_cast<int64_t>(c) * n_nodes + j]);
#pragma unroll
    for (int h = 0; h < H; ++h) {
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        float e = l[h * C + c] + r[h * C + c];
        e = e >= 0.f ? e : slope * e;
        s = fmaf(e, a[h * C + c], s);
      }
      const float m_new = fmaxf(mx[h], s);
      const float corr = expf(mx[h] - m_new);
      const float w = expf(s - m_new);
      den[h] = fmaf(den[h], corr, w);
#pragma unroll
      for (int c = 0; c < C; ++c) acc[h * C + c] = fmaf(acc[h * C + c], corr, w * l[h * C + c]);
      mx[h] = m_new;
    }
  }

  T* out_m = out + base;
#pragma unroll
  for (int h = 0; h < H; ++h) {
    const float inv = 1.f / fmaxf(den[h], FLT_MIN);
#pragma unroll
    for (int c = 0; c < C; ++c)
      out_m[static_cast<int64_t>(h * C + c) * n_nodes + n] = tec::from_float<T>(acc[h * C + c] * inv);
  }
}

template <typename T>
cudaError_t launch(const void* xl, const void* xr, const void* valid, const float* att,
                   void* out, int m, int n, int n_offsets, float slope,
                   const StencilShifts& p, cudaStream_t stream) {
  constexpr int kThreads = 128;
  const dim3 grid((n + kThreads - 1) / kThreads, m);
  gat_stencil_kernel<T, 2, 11><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(xl), static_cast<const T*>(xr),
      static_cast<const uint8_t*>(valid), att, static_cast<T*>(out), n, n_offsets, slope, p);
  return cudaGetLastError();
}

}  // namespace

// xl, xr, out: (m, heads*channels, n) contiguous; valid: (n_offsets, n) uint8
// (torch.bool); att: heads*channels fp32 on the device; shifts: a host array of
// n_offsets ints. Only heads=2, channels=11 (the model's GAT) is instantiated.
extern "C" int gat_stencil_forward(const void* xl, const void* xr, const void* valid,
                                   const int* shifts, const void* att, void* out, int m,
                                   int heads, int channels, int n, int n_offsets,
                                   float slope, int is_bf16, void* stream) {
  if (heads != 2 || channels != 11 || n_offsets > kMaxOffsets || m > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  StencilShifts p;
  for (int o = 0; o < n_offsets; ++o) p.shifts[o] = shifts[o];
  const float* a = static_cast<const float*>(att);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(xl, xr, valid, a, out, m, n, n_offsets, slope, p, s)
              : launch<float>(xl, xr, valid, a, out, m, n, n_offsets, slope, p, s);
  return static_cast<int>(err);
}
