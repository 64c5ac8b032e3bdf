// Batched SARIMA(1,1,1)x(1,1,1,s) baseline: the conditional-sum-of-squares
// (CSS) innovations recursion, its reverse-mode pass and the per-window
// forecast. This is no TPU kernel's port: the JAX package runs the recursion
// as a lax.scan over time inside one jitted program
// (tec_mollm_tpu/models/sarima.py:_innovations, fit_sarima, _forecast_jit).
// Run eagerly in PyTorch, a fit of 400 Adam steps over ~2000 differenced steps
// would be millions of launches; here each pass is one launch.
//
// With the coefficients c = (phi, Phi, theta, Theta) of node n and the
// differenced series y (T, N), lags zero-padded:
//   a_t = y_t - phi y_{t-1} - Phi y_{t-s} + phi Phi y_{t-s-1}
//   e_t = a_t - theta e_{t-1} - Theta e_{t-s} - theta Theta e_{t-s-1}
// The loss is sum over t >= s+1 of e_t^2 (a per-node partial; the caller sums
// and divides). Its adjoint, backwards in t:
//   g_t = scale e_t [t >= s+1] - theta g_{t+1} - Theta g_{t+s} - theta Theta g_{t+s+1}
// and dc = -sum_t g_t * (y_{t-1} - Phi y_{t-s-1}, y_{t-s} - phi y_{t-s-1},
//                         e_{t-1} + Theta e_{t-s-1}, e_{t-s} + theta e_{t-s-1}).
//
// Bound on this card: bytes. A fit step reads y twice and writes and reads e:
// 4 * T * N * 4 bytes, 92.6 MB at T = 1987, N = 2911, 27.6 us at 3.35 TB/s.
// What holds the kernels far above that is latency: one thread per node walks a
// serial chain of T dependent steps, and 2911 threads fill about 91 warps of the
// card's 132 SMs. The design keeps the chain short: the lags of the recursed
// value (e, or g) live in a ring of s+1 slots in shared memory, one column per
// thread (no bank conflicts), the lag t-1 in a register; the lags of y (and, in
// the reverse pass, of e) are read-only loads from device memory that do not
// depend on the chain, coalesced across a warp's consecutive nodes.
//
// The forecast runs one thread per (window, node): the same recursion over the
// window's L differenced steps (y computed from the window on the fly), then
// L_out steps ahead with future innovations 0, inverting (1-B)(1-B^s) through a
// ring of the last s+1 levels. It keeps three rings (y, e, x).
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;

// A ring of `len` floats for one thread: slot k at base[k * stride].
struct Ring {
  float* base;
  int stride;
  __device__ __forceinline__ float& operator[](int k) const { return base[k * stride]; }
};

__device__ __forceinline__ Ring ring_of(float* smem, int which, int len) {
  return Ring{smem + which * len * blockDim.x + threadIdx.x, static_cast<int>(blockDim.x)};
}

__global__ void css_forward_kernel(const float* __restrict__ y, const float* __restrict__ coeffs,
                                   float* __restrict__ e, float* __restrict__ partial, int steps, int n,
                                   int season) {
  extern __shared__ float smem[];
  const int node = blockIdx.x * blockDim.x + threadIdx.x;
  if (node >= n) return;
  const int len = season + 1;
  const Ring ring = ring_of(smem, 0, len);
  for (int k = 0; k < len; ++k) ring[k] = 0.0f;
  const float phi = coeffs[node], sphi = coeffs[n + node];
  const float theta = coeffs[2 * n + node], stheta = coeffs[3 * n + node];
  const float ps = phi * sphi, ts = theta * stheta;
  float e1 = 0.0f, sum = 0.0f;
  // slot of time t is t % len: e_{t-s-1} sits in the slot e_t takes, e_{t-s} in the next
  int slot = 0;
  for (int t = 0; t < steps; ++t) {
    const float yt = y[static_cast<int64_t>(t) * n + node];
    const float y1 = t >= 1 ? y[static_cast<int64_t>(t - 1) * n + node] : 0.0f;
    const float ys = t >= season ? y[static_cast<int64_t>(t - season) * n + node] : 0.0f;
    const float ys1 = t >= season + 1 ? y[static_cast<int64_t>(t - season - 1) * n + node] : 0.0f;
    const float a = yt - phi * y1 - sphi * ys + ps * ys1;
    const int next = slot + 1 == len ? 0 : slot + 1;
    const float et = a - theta * e1 - stheta * ring[next] - ts * ring[slot];
    ring[slot] = et;
    e[static_cast<int64_t>(t) * n + node] = et;
    if (t >= season + 1) sum += et * et;
    e1 = et;
    slot = next;
  }
  partial[node] = sum;
}

__global__ void css_backward_kernel(const float* __restrict__ y, const float* __restrict__ e,
                                    const float* __restrict__ coeffs, float* __restrict__ grad, float scale,
                                    int steps, int n, int season) {
  extern __shared__ float smem[];
  const int node = blockIdx.x * blockDim.x + threadIdx.x;
  if (node >= n) return;
  const int len = season + 1;
  const Ring ring = ring_of(smem, 0, len);
  for (int k = 0; k < len; ++k) ring[k] = 0.0f;
  const float phi = coeffs[node], sphi = coeffs[n + node];
  const float theta = coeffs[2 * n + node], stheta = coeffs[3 * n + node];
  const float ts = theta * stheta;
  float g1 = 0.0f;
  float d_phi = 0.0f, d_sphi = 0.0f, d_theta = 0.0f, d_stheta = 0.0f;
  // slot of time t is t % len: g_{t+s+1} sits in the slot g_t takes, g_{t+s} in the one before
  int slot = (steps - 1) % len;
  auto at = [&](const float* a, int t) { return t >= 0 ? a[static_cast<int64_t>(t) * n + node] : 0.0f; };
  for (int t = steps - 1; t >= 0; --t) {
    const int prev = slot == 0 ? len - 1 : slot - 1;
    const float et = e[static_cast<int64_t>(t) * n + node];
    const float gt = (t >= season + 1 ? scale * et : 0.0f) - theta * g1 - stheta * ring[prev] - ts * ring[slot];
    ring[slot] = gt;
    g1 = gt;
    slot = prev;
    const float ys1 = at(y, t - season - 1), es1 = at(e, t - season - 1);
    d_phi -= gt * (at(y, t - 1) - sphi * ys1);
    d_sphi -= gt * (at(y, t - season) - phi * ys1);
    d_theta -= gt * (at(e, t - 1) + stheta * es1);
    d_stheta -= gt * (at(e, t - season) + theta * es1);
  }
  grad[node] = d_phi;
  grad[n + node] = d_sphi;
  grad[2 * n + node] = d_theta;
  grad[3 * n + node] = d_stheta;
}

__global__ void forecast_kernel(const float* __restrict__ x, const float* __restrict__ coeffs,
                                float* __restrict__ out, int windows, int length, int n, int season, int horizon) {
  extern __shared__ float smem[];
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<int64_t>(windows) * n) return;
  const int node = static_cast<int>(i % n);
  const int64_t b = i / n;
  const int len = season + 1;
  const Ring yr = ring_of(smem, 0, len), er = ring_of(smem, 1, len), xr = ring_of(smem, 2, len);
  for (int k = 0; k < len; ++k) yr[k] = er[k] = 0.0f;
  const float* xb = x + b * length * n + node;
  const float phi = coeffs[node], sphi = coeffs[n + node];
  const float theta = coeffs[2 * n + node], stheta = coeffs[3 * n + node];
  const float ps = phi * sphi, ts = theta * stheta;

  // the window's differenced steps: y_t = (x_{t+s+1} - x_{t+s}) - (x_{t+1} - x_t)
  const int m = length - season - 1;
  float y1 = 0.0f, e1 = 0.0f;
  int slot = 0;  // of y time t: t % len
  for (int t = 0; t < m; ++t) {
    const float yt = (xb[static_cast<int64_t>(t + season + 1) * n] - xb[static_cast<int64_t>(t + season) * n]) -
                     (xb[static_cast<int64_t>(t + 1) * n] - xb[static_cast<int64_t>(t) * n]);
    const int next = slot + 1 == len ? 0 : slot + 1;
    const float a = yt - phi * y1 - sphi * yr[next] + ps * yr[slot];
    const float et = a - theta * e1 - stheta * er[next] - ts * er[slot];
    yr[slot] = yt;
    er[slot] = et;
    y1 = yt;
    e1 = et;
    slot = next;
  }
  // the last s+1 levels; x time u = y time t + s + 1, so u % len == slot as well
  for (int u = length - len; u < length; ++u) xr[u % len] = xb[static_cast<int64_t>(u) * n];
  float x1 = xb[static_cast<int64_t>(length - 1) * n];
  float* ob = out + b * horizon * n + node;
  for (int k = 0; k < horizon; ++k) {
    const int next = slot + 1 == len ? 0 : slot + 1;
    const float yt = phi * y1 + sphi * yr[next] - ps * yr[slot] + theta * e1 + stheta * er[next] + ts * er[slot];
    const float xt = yt + x1 + xr[next] - xr[slot];
    yr[slot] = yt;
    er[slot] = 0.0f;
    xr[slot] = xt;
    y1 = yt;
    e1 = 0.0f;
    x1 = xt;
    slot = next;
    ob[static_cast<int64_t>(k) * n] = xt;
  }
}

// Shared memory for `rings` rings of season + 1 floats a thread; above the
// default 48 KB the kernel is opted in to what it needs.
template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0, max_optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&max_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (bytes > static_cast<size_t>(max_optin)) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
}

size_t ring_bytes(int rings, int season) { return static_cast<size_t>(rings) * (season + 1) * kThreads * sizeof(float); }

}  // namespace

extern "C" int sarima_css_forward(const void* y, const void* coeffs, void* e, void* partial, int steps, int n,
                                  int season, void* stream) {
  if (steps < 1 || n < 1 || season < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = ring_bytes(1, season);
  cudaError_t err = set_smem(css_forward_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  css_forward_kernel<<<(n + kThreads - 1) / kThreads, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(y), static_cast<const float*>(coeffs), static_cast<float*>(e),
      static_cast<float*>(partial), steps, n, season);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sarima_css_backward(const void* y, const void* e, const void* coeffs, void* grad, float scale,
                                   int steps, int n, int season, void* stream) {
  if (steps < 1 || n < 1 || season < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = ring_bytes(1, season);
  cudaError_t err = set_smem(css_backward_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  css_backward_kernel<<<(n + kThreads - 1) / kThreads, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(y), static_cast<const float*>(e), static_cast<const float*>(coeffs),
      static_cast<float*>(grad), scale, steps, n, season);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sarima_forecast(const void* x, const void* coeffs, void* out, int windows, int length, int n,
                               int season, int horizon, void* stream) {
  if (windows < 1 || n < 1 || season < 1 || horizon < 1 || length < 2 * (season + 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = ring_bytes(3, season);
  cudaError_t err = set_smem(forecast_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t threads = static_cast<int64_t>(windows) * n;
  forecast_kernel<<<static_cast<unsigned>((threads + kThreads - 1) / kThreads), kThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(static_cast<const float*>(x),
                                                         static_cast<const float*>(coeffs),
                                                         static_cast<float*>(out), windows, length, n, season,
                                                         horizon);
  return static_cast<int>(cudaGetLastError());
}
