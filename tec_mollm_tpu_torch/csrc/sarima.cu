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
// The fit's two kernels: a time-chunked scan of the factored recursion.
// (1 + theta B)(1 + Theta B^s) e = a splits into two first-order recursions
// with constant coefficients, w_t = a_t - theta w_{t-1} (lag 1), then
// e_t = w_t - Theta e_{t-s} (lag s: s independent chains, one for each residue
// of t mod s); the adjoint is the same in reversed time,
// (1 + theta F)(1 + Theta F^s) g = h with h_t = scale e_t [t >= s+1]. Each
// stage is a complete chunked scan of x_i = b_i - c x_{i-k} (ops/sarima.py:
// chunked_lag_solve is its plain mirror), one stage after the other: a carry
// of the lag-1 stage does not reach e as a plain power of theta.
//   1. each thread solves its chunk of kLen steps from a zero start, in
//      registers (the lag-s stage through solve_chunk's compile-time lags);
//   2. for each residue class of i mod k, one thread walks the chunks in
//      order: the class's last row in a chunk gains (-c)^cnt times the class's
//      true value before the chunk (cnt = its rows in the chunk: kLen / k or
//      one more). A chunk whose length is not a multiple of k holds the
//      classes at shifted offsets, so the class, not the offset, keys the
//      carry. The lag-1 stage keeps only each chunk's last value in shared
//      memory, the lag-s stage its whole chunk;
//   3. every row of a chunk gains (-c)^m times the true value of its class in
//      the k rows before the chunk (m = its place in the class within the
//      chunk), in registers; those rows are step 2's, and a class's last row
//      comes out with the bits step 2 gave it.
// |c| <= 0.99 (ops/sarima.py:_loss_and_grad), so the carries decay and
// rounding does not grow.
//
// The grid: a block owns kNodes = 8 consecutive nodes, 364 blocks at N = 2911:
// with 3 blocks an SM (by registers) they fit the card's 132 SMs in one wave,
// on every SM (16-node tiles give 183 blocks, at most 2 an SM: the busiest
// SMs then hold 32 nodes instead of 24, and ran slower on the card). A block runs
// kChunks = 16 chunks of kLen = 33 steps, a thread each (128 threads): lanes
// run across nodes, so a row of the time-major (T, N) arrays is one 32-byte
// access, and the chunks split time. The block walks T in segments of kSeg =
// 528 steps; the true values of the last rows of each stage carry in shared
// memory into the next segment (the carries before chunk 0), so any T takes
// the same shared memory. A segment's tile of y (and e in the adjoint), with
// its s + 1 lag rows, comes into shared memory by cp.async ahead of use; the
// forward issues the next segment's y as soon as the current tile is
// consumed, under the rest of the segment. A chain's steps then read
// registers only, and the phases meet at 6 barriers a segment. kLen is odd, so
// the 4 chunks of a warp (kLen rows apart) fall on different banks. Partial
// sums are kept per thread and added over the chunks in chunk order, with no
// atomics: two launches give the same bits.
//
// Bound on this card: bytes. A fit step reads y twice and writes and reads e:
// 4 * T * N * 4 bytes, 92.6 MB at T = 1987, N = 2911, 27.6 us at 3.35 TB/s.
// What remains above it is latency: the chains of a phase (33 steps in
// registers, 16 carries) between barriers, with about 11 warps an SM.
//
// The largest season: kSeg = 528 (the carry rows of a segment lie in the
// segment). Shared memory grows with s: at s = 12 35 KB for the forward and
// 52 KB for the adjoint, 102 KB for the adjoint at s = 528. A season above
// that, or above what the card opts a block in to, is refused with
// cudaErrorInvalidValue before any launch.
//
// The forecast runs one thread per (window, node): the same recursion over the
// window's differenced steps, then L_out steps ahead with future innovations
// 0, inverting (1-B)(1-B^s). Its bound on this card is bytes: the windows in
// and the forecasts out, 44.7 MB at 64 windows of (48, 2911) -> 12 steps,
// 13.4 us at 3.35 TB/s. One thread's work is a dependent chain of ~50 steps,
// so the kernel is bound by latency unless every row it needs is in flight
// before the chain reaches it. Both forms read each element of x from device
// memory once, in rows that are whole warps' 128-byte runs along the node axis
// (N = 2911 rows are 4-byte aligned only, so 4-byte loads):
//   * the compile-time form (forecast_fixed_kernel<L, S, H>) issues all L
//     loads of its window first, then runs the recursion and the steps ahead
//     unrolled; the rings are register arrays at compile-time indices. It is
//     instantiated for the shipped shape alone (L_in 48, season 12, L_out 12:
//     the flagship config and the CLI's default season), the one shape the
//     shipped configs launch; each other shape would add its own unrolled
//     copy to the build for a launch that costs tens of microseconds;
//   * the ring form (forecast_ring_kernel) takes every other shape: any
//     length >= 2 (s + 1), every season the fit takes (up to kSeg = 528) and
//     any horizon. A register queue keeps the next kAhead = 16 rows in flight
//     ahead of the step that takes them; the level, y and e rings (s + 1
//     slots each) lie in shared memory, slot k of thread j at k * blockDim +
//     j (no bank conflicts). forecast_plan gives a block as many whole warps
//     (up to 128 threads) as their rings fit in the card's 232,448-byte
//     opt-in limit: one warp at s = 528 (203 KB).
// No atomics and no reductions across threads: two launches give the same bits.
#include <algorithm>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

// the forecast: threads a block (the ring form's at most), rows in flight
// ahead of the ring form's step, the shape of the compile-time form, and the
// ring form's shared-memory budget (the H100's opt-in limit a block)
constexpr int kThreads = 128, kAhead = 16;
constexpr int kFixedL = 48, kFixedS = 12, kFixedH = 12;
constexpr size_t kForecastSmem = 232448;

// A ring of `len` floats for one thread: slot k at base[k * stride].
struct Ring {
  float* base;
  int stride;
  __device__ __forceinline__ float& operator[](int k) const { return base[k * stride]; }
};

__device__ __forceinline__ Ring ring_of(float* smem, int which, int len) {
  return Ring{smem + which * len * blockDim.x + threadIdx.x, static_cast<int>(blockDim.x)};
}

// the fit's kernels: nodes a block, chunks a segment, steps a chunk, and the
// blocks an SM holds (registers: at most 170 a thread)
constexpr int kNodes = 8, kChunks = 16, kLen = 33, kSeg = kChunks * kLen, kScanThreads = kNodes * kChunks;
constexpr int kBlocksPerSM = 3;

// Element (row r, lane j) of a tile of kNodes lanes a row. The chunks of a warp
// lie kLen rows apart: kLen is odd, so their rows fall on other banks.
__device__ __forceinline__ float& at(float* tile, int r, int j) { return tile[r * kNodes + j]; }

// 4 bytes from device to shared memory, zero-filled where `ok` is false.
__device__ __forceinline__ void copy_async(float* dst, const float* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void wait_copies() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// A segment's per-row constants (the powers, the classes' offsets) are the
// same in every segment: left alone, the compiler hoists them all out of the
// segment loop and holds them in registers (near the limit of 255 a thread,
// one block an SM). A value passed through opaque() at the top of each
// segment is unknown to it there, so what derives from it is formed anew in
// each segment.
__device__ __forceinline__ int opaque(int v) {
  asm volatile("" : "+r"(v));
  return v;
}

__device__ __forceinline__ float opaque(float v) {
  asm volatile("" : "+f"(v));
  return v;
}

// Rows [first, first + rows) of the time-major (steps, n) array x for the
// block's nodes into a tile; rows outside [0, steps) and nodes past n read 0.
__device__ void load_tile(float* tile, const float* x, int first, int rows, int steps, int n, int n0) {
  for (int k = threadIdx.x; k < rows * kNodes; k += kScanThreads) {
    const int r = k / kNodes, j = k % kNodes, t = first + r, node = n0 + j;
    const bool ok = t >= 0 && t < steps && node < n;
    copy_async(&at(tile, r, j), ok ? x + static_cast<int64_t>(t) * n + node : x, ok);
  }
}

// x_i = b_i - coef x_{i-k}: a chunk of kLen rows holds q or q + 1 rows of each
// residue class (q + 1 for the offsets below rem); pq = (-coef)^q,
// pq1 = (-coef)^(q+1), each a product in the order fix_up forms its powers, so
// that a row's carry and its fix-up give the same bits.
struct Lag {
  int k, q, rem;
  float coef, pq, pq1;
};

__device__ Lag make_lag(float coef, int k) {
  Lag l{k, kLen / k, kLen % k, coef, 1.0f, 0.0f};
  for (int i = 0; i < l.q; ++i) l.pq *= -coef;
  l.pq1 = l.pq * -coef;
  return l;
}

// Step 1, the chunk from a zero start in registers: lag K at compile time...
template <int K>
__device__ __forceinline__ void solve_lag(float (&x)[kLen], float coef) {
#pragma unroll
  for (int i = K; i < kLen; ++i) x[i] = fmaf(-coef, x[i - K], x[i]);
}

// ... picked for the run-time lag k (uniform over the grid); for k >= kLen no
// two rows of a class share a chunk.
template <int K = 1>
__device__ __forceinline__ void solve_chunk(float (&x)[kLen], int k, float coef) {
  if (k == K) {
    solve_lag<K>(x, coef);
  } else if constexpr (K + 1 < kLen) {
    solve_chunk<K + 1>(x, k, coef);
  }
}

// Step 2 of the lag-1 stage (thread c == 0 of lane j): wl[0] is the true value
// before the segment and wl[c + 1] chunk c's last value from a zero start; on
// return wl[c + 1] is its true value.
__device__ void carry_lag1(float* wl, float pq, int j) {
  float v[kChunks];
#pragma unroll
  for (int cc = 0; cc < kChunks; ++cc) v[cc] = wl[(cc + 1) * kNodes + j];
  float carry = wl[j];
#pragma unroll
  for (int cc = 0; cc < kChunks; ++cc) v[cc] = carry = fmaf(pq, carry, v[cc]);
#pragma unroll
  for (int cc = 0; cc < kChunks; ++cc) wl[(cc + 1) * kNodes + j] = v[cc];
}

// Step 2 of the lag-k stage: thread (c, j) walks the classes c, c + kChunks,
// ... < k through the chunks of buf, in place on each class's last row in a
// chunk; prev[r * kNodes + j] is the true value at row r - k (the segment
// before, or 0).
__device__ void carry_chunks(float* buf, const float* prev, const Lag& l, int c, int j) {
  for (int cls = c; cls < l.k; cls += kChunks) {
    float carry = prev[cls * kNodes + j];
    float v[kChunks];
    int off = cls;  // (cls - chunk start) mod k
#pragma unroll
    for (int cc = 0; cc < kChunks; ++cc) {
      const bool more = off < l.rem;
      if (off < kLen) carry = fmaf(more ? l.pq1 : l.pq, carry, at(buf, cc * kLen + off + (l.q + more - 1) * l.k, j));
      v[cc] = carry;
      off -= l.rem;
      if (off < 0) off += l.k;
    }
    off = cls;
#pragma unroll
    for (int cc = 0; cc < kChunks; ++cc) {
      if (off < kLen) at(buf, cc * kLen + off + (l.q + (off < l.rem) - 1) * l.k, j) = v[cc];
      off -= l.rem;
      if (off < 0) off += l.k;
    }
  }
}

// Step 3 of the lag-1 stage, in registers: row i gains (-coef)^(i+1) carry.
__device__ __forceinline__ void fix_up_lag1(float (&x)[kLen], float carry, float coef) {
  float p = 1.0f;
#pragma unroll
  for (int i = 0; i < kLen; ++i) {
    p *= -coef;
    x[i] = fmaf(p, carry, x[i]);
  }
}

// Step 3 of the lag-k stage, in registers: row i of the chunk at c0 gains
// (-coef)^(i / k + 1) times the true value of its class in the k rows before
// the chunk (rows of buf that step 2 wrote, or prev before the segment). A
// class's last row comes out as step 2 stored it.
__device__ __forceinline__ void fix_up(float (&x)[kLen], float* buf, const float* prev, const Lag& l, int c0, int j) {
  float p = 1.0f;
  int cls = 0;  // i mod k
#pragma unroll
  for (int i = 0; i < kLen; ++i) {
    if (cls == 0) p *= -l.coef;
    const int src = c0 + cls - l.k;
    x[i] = fmaf(p, src >= 0 ? at(buf, src, j) : prev[(src + l.k) * kNodes + j], x[i]);
    if (++cls == l.k) cls = 0;
  }
}

// The last s rows of the segment (true values, step 2's) become the carries
// before the next segment.
__device__ __forceinline__ void save_carries(float* buf, float* prev, int k, int c, int j) {
  for (int r = c; r < k; r += kChunks) prev[r * kNodes + j] = at(buf, kSeg - k + r, j);
}

// Shared memory of each kernel at season s: its tiles (s + 1 lag rows and a
// segment), the segment buffer, the carry rows of the lag-s stage (s) and of
// the lag-1 stage (kChunks + 1).
size_t forward_smem(int s) { return static_cast<size_t>(2 * kSeg + 2 * s + 2 + kChunks) * kNodes * sizeof(float); }
size_t backward_smem(int s) { return static_cast<size_t>(3 * kSeg + 3 * s + 3 + kChunks) * kNodes * sizeof(float); }

__global__ void __launch_bounds__(kScanThreads, kBlocksPerSM)
    css_forward_kernel(const float* __restrict__ y, const float* __restrict__ coeffs, float* __restrict__ e,
                       float* __restrict__ partial, int steps, int n, int season) {
  extern __shared__ float smem[];
  const int s = season, tile_rows = kSeg + s + 1;
  float* ys = smem;                       // y at rows t0 - s - 1 .. t0 + kSeg - 1
  float* buf = ys + tile_rows * kNodes;   // the lag-s stage's rows
  float* eprev = buf + kSeg * kNodes;     // true e at rows t0 - s .. t0 - 1
  float* wl = eprev + s * kNodes;         // w before the segment, then at each chunk's end
  const int j = threadIdx.x % kNodes, c = threadIdx.x / kNodes, c0 = c * kLen;
  const int n0 = blockIdx.x * kNodes, node = n0 + j;
  const bool live = node < n;
  const float phi = live ? coeffs[node] : 0.0f, sphi = live ? coeffs[n + node] : 0.0f;
  const float theta = live ? coeffs[2 * n + node] : 0.0f, stheta = live ? coeffs[3 * n + node] : 0.0f;
  const float ps = phi * sphi;
  for (int k = threadIdx.x; k < (s + 1) * kNodes; k += kScanThreads) eprev[k] = 0.0f;  // and wl[0]
  load_tile(ys, y, -(s + 1), tile_rows, steps, n, n0);
  float sum = 0.0f;
  const int segments = (steps + kSeg - 1) / kSeg;
  for (int g = 0; g < segments; ++g) {
    const int t0 = g * kSeg;
    const float th = opaque(theta);
    const Lag lags = make_lag(opaque(stheta), opaque(s));
    const float pq1 = make_lag(th, 1).pq;
    wait_copies();
    __syncthreads();
    // a, and the lag-1 stage's chunk from a zero start
    float x[kLen];
    float w = 0.0f;
#pragma unroll
    for (int i = 0; i < kLen; ++i) {
      const int r = c0 + i + s + 1;
      const float a = at(ys, r, j) - phi * at(ys, r - 1, j) - sphi * at(ys, r - s, j) + ps * at(ys, r - s - 1, j);
      x[i] = w = fmaf(-theta, w, a);
    }
    wl[(c + 1) * kNodes + j] = w;
    __syncthreads();
    if (g + 1 < segments) load_tile(ys, y, t0 + kSeg - s - 1, tile_rows, steps, n, n0);  // under the rest
    if (c == 0) carry_lag1(wl, pq1, j);
    __syncthreads();
    fix_up_lag1(x, wl[c * kNodes + j], th);
    solve_chunk(x, lags.k, lags.coef);
#pragma unroll
    for (int i = 0; i < kLen; ++i) at(buf, c0 + i, j) = x[i];
    __syncthreads();
    carry_chunks(buf, eprev, lags, c, j);
    if (c == 0) wl[j] = wl[kChunks * kNodes + j];
    __syncthreads();
    fix_up(x, buf, eprev, lags, c0, j);
    // e out and the loss terms
#pragma unroll
    for (int i = 0; i < kLen; ++i) {
      const int t = t0 + c0 + i;
      if (live && t < steps) {
        e[static_cast<int64_t>(t) * n + node] = x[i];
        if (t >= s + 1) sum = fmaf(x[i], x[i], sum);
      }
    }
    __syncthreads();
    save_carries(buf, eprev, s, c, j);
  }
  float* red = ys;  // the tile is no longer read
  red[threadIdx.x] = sum;
  __syncthreads();
  if (c == 0 && live) {
    float total = 0.0f;
    for (int cc = 0; cc < kChunks; ++cc) total += red[cc * kNodes + j];
    partial[node] = total;
  }
}

__global__ void __launch_bounds__(kScanThreads, kBlocksPerSM)
    css_backward_kernel(const float* __restrict__ y, const float* __restrict__ e, const float* __restrict__ coeffs,
                        float* __restrict__ grad, float scale, int steps, int n, int season) {
  extern __shared__ float smem[];
  const int s = season, tile_rows = kSeg + s + 1;
  float* ytile = smem;  // tile row r is time t_hi - kSeg - s + r
  float* etile = ytile + tile_rows * kNodes;
  float* buf = etile + tile_rows * kNodes;  // row i is time t_hi - i
  float* gprev = buf + kSeg * kNodes;
  float* ul = gprev + s * kNodes;
  const int j = threadIdx.x % kNodes, c = threadIdx.x / kNodes, c0 = c * kLen;
  const int n0 = blockIdx.x * kNodes, node = n0 + j;
  const bool live = node < n;
  const float phi = live ? coeffs[node] : 0.0f, sphi = live ? coeffs[n + node] : 0.0f;
  const float theta = live ? coeffs[2 * n + node] : 0.0f, stheta = live ? coeffs[3 * n + node] : 0.0f;
  for (int k = threadIdx.x; k < (s + 1) * kNodes; k += kScanThreads) gprev[k] = 0.0f;  // and ul[0]
  float d_phi = 0.0f, d_sphi = 0.0f, d_theta = 0.0f, d_stheta = 0.0f;
  const int segments = (steps + kSeg - 1) / kSeg;
  for (int g = 0; g < segments; ++g) {
    const int t_hi = steps - 1 - g * kSeg;
    const float th = opaque(theta);
    const Lag lags = make_lag(opaque(stheta), opaque(s));
    const float pq1 = make_lag(th, 1).pq;
    load_tile(ytile, y, t_hi - kSeg - s, tile_rows, steps, n, n0);
    load_tile(etile, e, t_hi - kSeg - s, tile_rows, steps, n, n0);
    wait_copies();
    __syncthreads();
    // h, and the lag-1 stage's chunk (reversed time) from a zero start
    float x[kLen];
    float u = 0.0f;
#pragma unroll
    for (int i = 0; i < kLen; ++i) {
      const float h = t_hi - c0 - i >= s + 1 ? scale * at(etile, kSeg + s - c0 - i, j) : 0.0f;
      x[i] = u = fmaf(-theta, u, h);
    }
    ul[(c + 1) * kNodes + j] = u;
    __syncthreads();
    if (c == 0) carry_lag1(ul, pq1, j);
    __syncthreads();
    fix_up_lag1(x, ul[c * kNodes + j], th);
    solve_chunk(x, lags.k, lags.coef);
#pragma unroll
    for (int i = 0; i < kLen; ++i) at(buf, c0 + i, j) = x[i];
    __syncthreads();
    carry_chunks(buf, gprev, lags, c, j);
    if (c == 0) ul[j] = ul[kChunks * kNodes + j];
    __syncthreads();
    fix_up(x, buf, gprev, lags, c0, j);
    // the four sums over the chunk's g
#pragma unroll
    for (int i = 0; i < kLen; ++i) {
      if (t_hi - c0 - i >= 0) {
        const int r = kSeg + s - c0 - i;
        const float ys1 = at(ytile, r - s - 1, j), es1 = at(etile, r - s - 1, j);
        d_phi = fmaf(-x[i], at(ytile, r - 1, j) - sphi * ys1, d_phi);
        d_sphi = fmaf(-x[i], at(ytile, r - s, j) - phi * ys1, d_sphi);
        d_theta = fmaf(-x[i], at(etile, r - 1, j) + stheta * es1, d_theta);
        d_stheta = fmaf(-x[i], at(etile, r - s, j) + theta * es1, d_stheta);
      }
    }
    __syncthreads();
    save_carries(buf, gprev, s, c, j);
  }
  float* red = ytile;  // the tiles are no longer read
  red[threadIdx.x] = d_phi;
  red[kScanThreads + threadIdx.x] = d_sphi;
  red[2 * kScanThreads + threadIdx.x] = d_theta;
  red[3 * kScanThreads + threadIdx.x] = d_stheta;
  __syncthreads();
  if (c == 0 && live) {
    for (int q = 0; q < 4; ++q) {
      float total = 0.0f;
      for (int cc = 0; cc < kChunks; ++cc) total += red[q * kScanThreads + cc * kNodes + j];
      grad[q * n + node] = total;
    }
  }
}

// x_u of a thread's window (u its row), through the read-only path.
__device__ __forceinline__ float row_of(const float* xb, int u, int n) { return __ldg(xb + static_cast<int64_t>(u) * n); }

// The forecast's compile-time form: L rows in, season S, H steps out. The
// steps are unrolled, so every array below is indexed at compile time and
// lives in registers: the window's L levels (all L loads issued before the
// recursion starts), then the levels ahead; y and e of every step.
template <int L, int S, int H>
__global__ void __launch_bounds__(kThreads)
    forecast_fixed_kernel(const float* __restrict__ x, const float* __restrict__ coeffs, float* __restrict__ out,
                          int windows, int n) {
  static_assert(L >= 2 * (S + 1) && H >= 1, "a window conditions the recursion on s + 1 differenced steps");
  constexpr int M = L - S - 1;  // the window's differenced steps
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<int64_t>(windows) * n) return;
  const int node = static_cast<int>(i % n);
  const int64_t b = i / n;
  const float* xb = x + b * L * n + node;
  float xs[L + H];  // the levels: the window's, then the forecast's
#pragma unroll
  for (int u = 0; u < L; ++u) xs[u] = row_of(xb, u, n);
  const float phi = coeffs[node], sphi = coeffs[n + node];
  const float theta = coeffs[2 * n + node], stheta = coeffs[3 * n + node];
  const float ps = phi * sphi, ts = theta * stheta;
  float ys[M + H], es[M];
#pragma unroll
  for (int t = 0; t < M; ++t) {
    ys[t] = (xs[t + S + 1] - xs[t + S]) - (xs[t + 1] - xs[t]);
    const float y1 = t >= 1 ? ys[t - 1] : 0.0f, y_s = t >= S ? ys[t - S] : 0.0f, y_s1 = t >= S + 1 ? ys[t - S - 1] : 0.0f;
    const float e1 = t >= 1 ? es[t - 1] : 0.0f, e_s = t >= S ? es[t - S] : 0.0f, e_s1 = t >= S + 1 ? es[t - S - 1] : 0.0f;
    const float a = ys[t] - phi * y1 - sphi * y_s + ps * y_s1;
    es[t] = a - theta * e1 - stheta * e_s - ts * e_s1;
  }
  float* ob = out + b * H * n + node;
#pragma unroll
  for (int k = 0; k < H; ++k) {
    const int t = M + k, u = L + k;  // M >= S + 1: every lag lies in the arrays
    const float e1 = t - 1 < M ? es[t - 1] : 0.0f, e_s = t - S < M ? es[t - S] : 0.0f;
    const float e_s1 = t - S - 1 < M ? es[t - S - 1] : 0.0f;
    ys[t] = phi * ys[t - 1] + sphi * ys[t - S] - ps * ys[t - S - 1] + theta * e1 + stheta * e_s + ts * e_s1;
    xs[u] = ys[t] + xs[u - 1] + xs[u - S] - xs[u - S - 1];
    ob[static_cast<int64_t>(k) * n] = xs[u];
  }
}

// The forecast's run-time form, for every other shape: the window's rows are
// read once, in time order, kAhead rows ahead of the step that takes them
// (a register queue at compile-time slots: the step loop is unrolled by
// kAhead). The last s + 1 levels, y and e are three rings of s + 1 slots in
// shared memory; level u, and y and e of time t = u - s - 1, share slot
// u % (s + 1).
__global__ void __launch_bounds__(kThreads)
    forecast_ring_kernel(const float* __restrict__ x, const float* __restrict__ coeffs, float* __restrict__ out,
                         int windows, int length, int n, int season, int horizon) {
  extern __shared__ float smem[];
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<int64_t>(windows) * n) return;
  const int node = static_cast<int>(i % n);
  const int64_t b = i / n;
  const int len = season + 1;
  const Ring xr = ring_of(smem, 0, len), yr = ring_of(smem, 1, len), er = ring_of(smem, 2, len);
  for (int k = 0; k < len; ++k) yr[k] = er[k] = 0.0f;
  const float* xb = x + b * length * n + node;
  float ahead[kAhead];
#pragma unroll
  for (int k = 0; k < kAhead; ++k) ahead[k] = k < length ? row_of(xb, k, n) : 0.0f;
  const float phi = coeffs[node], sphi = coeffs[n + node];
  const float theta = coeffs[2 * n + node], stheta = coeffs[3 * n + node];
  const float ps = phi * sphi, ts = theta * stheta;

  // the window: y_t = (x_u - x_{u-1}) - (x_{u-s} - x_{u-s-1}) for u = t + s + 1;
  // x_{u-s} lies in the next slot, x_{u-s-1} in this one
  float x1 = 0.0f, y1 = 0.0f, e1 = 0.0f;
  int slot = 0;
  for (int u0 = 0; u0 < length; u0 += kAhead) {
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const int u = u0 + k;
      if (u < length) {
        const float xu = ahead[k];
        if (u + kAhead < length) ahead[k] = row_of(xb, u + kAhead, n);
        const int next = slot + 1 == len ? 0 : slot + 1;
        if (u >= len) {
          const float yt = (xu - x1) - (xr[next] - xr[slot]);
          const float a = yt - phi * y1 - sphi * yr[next] + ps * yr[slot];
          const float et = a - theta * e1 - stheta * er[next] - ts * er[slot];
          yr[slot] = yt;
          er[slot] = et;
          y1 = yt;
          e1 = et;
        }
        xr[slot] = xu;
        x1 = xu;
        slot = next;
      }
    }
  }
  // the steps ahead, future innovations 0: x_u = y_t + x_{u-1} + x_{u-s} - x_{u-s-1}
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

// What forecast_plan sets at launch for one call: the compile-time form (1)
// or the ring form (0), threads a block, dynamic shared memory.
struct ForecastPlan {
  int fixed, threads;
  size_t smem;
};

// The compile-time form for the shipped shape; the ring form, at most
// kThreads a block and whole warps, as many as their rings fit
// kForecastSmem (one warp's at the largest season).
ForecastPlan forecast_plan(int length, int season, int horizon) {
  if (length == kFixedL && season == kFixedS && horizon == kFixedH) return {1, kThreads, 0};
  const size_t per_thread = 3 * static_cast<size_t>(season + 1) * sizeof(float);
  const int threads = static_cast<int>(std::min<size_t>(kThreads, kForecastSmem / per_thread / 32 * 32));
  return {0, threads, threads * per_thread};
}

// A kernel's dynamic shared memory: above the default 48 KB the kernel is
// opted in to what it needs; more than a block may have is refused.
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

}  // namespace

extern "C" int sarima_css_forward(const void* y, const void* coeffs, void* e, void* partial, int steps, int n,
                                  int season, void* stream) {
  if (steps < 1 || n < 1 || season < 1 || season > kSeg) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = forward_smem(season);
  cudaError_t err = set_smem(css_forward_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  css_forward_kernel<<<(n + kNodes - 1) / kNodes, kScanThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(y), static_cast<const float*>(coeffs), static_cast<float*>(e),
      static_cast<float*>(partial), steps, n, season);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sarima_css_backward(const void* y, const void* e, const void* coeffs, void* grad, float scale,
                                   int steps, int n, int season, void* stream) {
  if (steps < 1 || n < 1 || season < 1 || season > kSeg) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = backward_smem(season);
  cudaError_t err = set_smem(css_backward_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  css_backward_kernel<<<(n + kNodes - 1) / kNodes, kScanThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(y), static_cast<const float*>(e), static_cast<const float*>(coeffs),
      static_cast<float*>(grad), scale, steps, n, season);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sarima_forecast(const void* x, const void* coeffs, void* out, int windows, int length, int n,
                               int season, int horizon, void* stream) {
  if (windows < 1 || n < 1 || season < 1 || season > kSeg || horizon < 1 || length < 2 * (season + 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const ForecastPlan p = forecast_plan(length, season, horizon);
  const int64_t threads = static_cast<int64_t>(windows) * n;
  const unsigned blocks = static_cast<unsigned>((threads + p.threads - 1) / p.threads);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* cf = static_cast<const float*>(coeffs);
  float* of = static_cast<float*>(out);
  if (p.fixed) {
    forecast_fixed_kernel<kFixedL, kFixedS, kFixedH><<<blocks, p.threads, 0, st>>>(xf, cf, of, windows, n);
  } else {
    const cudaError_t err = set_smem(forecast_ring_kernel, p.smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    forecast_ring_kernel<<<blocks, p.threads, p.smem, st>>>(xf, cf, of, windows, length, n, season, horizon);
  }
  return static_cast<int>(cudaGetLastError());
}

// The forecast's plan for a call (forecast_plan), for checks from the host:
// out = (fixed, threads, shared memory bytes).
extern "C" int sarima_forecast_plan(int length, int season, int horizon, void* out) {
  if (season < 1 || season > kSeg || horizon < 1 || length < 2 * (season + 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const ForecastPlan p = forecast_plan(length, season, horizon);
  long long* o = static_cast<long long*>(out);
  o[0] = p.fixed;
  o[1] = p.threads;
  o[2] = static_cast<long long>(p.smem);
  return 0;
}
