// Stencil GATv2 attention, forward: the Hopper port of the Pallas kernel
// tec_mollm_tpu/ops/gat_stencil.py:gat_stencil_attention (_kernel).
//
// For each graph slice m and node n, over the O static lane shifts:
//   score_h[o] = sum_c att[h,c] * leaky_relu(xl[m, h*C+c, n+shift_o] + xr[m, h*C+c, n])
//   masked by valid[o, n]; softmax over the offsets; out = sum_o alpha * xl[.., n+shift_o].
// fp32 arithmetic, the output in xl's type.
//
// Bound on this card: bytes. xl and xr read once and the output written once
// is 3 * M*H*C*N elements, 149 MB in bf16 at the flagship eval batch (M = 384,
// N = 2944): 0.0446 ms at 3.35 TB/s. The kernel takes nearly three times that,
// and not for its bytes: its offset loop, which per (slice, node, head, valid
// offset) reads a 48-byte record and spends an add and a multiply-add per
// channel on the score and a multiply-add per channel on the sum, and each
// slice's conversion, barriers and stores issue at a fraction of the card's
// instruction rate (PERF.md); the count of shared-memory load instructions is
// the one lever measured so far to move it.
//
// Design:
// - A block owns a tile of kTile nodes and walks consecutive slices m, so many
//   that the grid is one wave of the blocks resident on the current device
//   (grid.x holds node tiles x slice chunks, so any M launches). For each
//   slice it stages xl[m, :, n0 - R : n0 + kTile + R] (R the halo capacity, 72
//   or 144 nodes: the default stencil's largest |shift| and the 300 km one's)
//   and the tile's xr in shared memory with 16-byte cp.async copies, issued
//   while the slice before is computed. The capacity is a template argument:
//   a window stride known at compile time measured faster than one sized at
//   launch. Chunks outside [0, N) are zero-filled, so out-of-range neighbours
//   are never read; rows that are not whole 16-byte chunks (or pointers not
//   16-byte aligned) take element copies in the same kernel.
// - The staged window is converted once to fp32, node-major: a 48-byte
//   record per (head, element) of its 11 channels and the head's projection
//   P[j] = k1 * att_h . l[j]. With leaky_relu(e) = k1 e + k2 |e|, a score is
//   P[n + shift] + k2 * att_h . |l + r| plus a term that is the same for every
//   offset of a node and cancels in the softmax; |.| is an operand modifier
//   of the multiply-add, so a channel costs one add and one multiply-add.
// - A thread takes one node and one head, and reads a neighbour's record in
//   three 16-byte shared loads (lanes 48 bytes apart: no bank conflicts). The
//   shared-load instruction count is what the record layout cut: eleven
//   4-byte loads per neighbour from channel-major rows were slower.
// - The validity columns are read once per block and kept as a 64-bit mask
//   per node (O <= 64), with the neighbour's range check folded in; a warp
//   walks only the offsets that one of its 32 nodes needs (68% of them at the
//   default stencil, about as many as there are valid pairs).
// - The softmax is online, kPerStep offsets a step: the scores, one rescale of
//   the running sums, one ex2 per offset and the weighted sums of the same
//   window values, so each record is read once. (A two-pass form, scores
//   first and a second read of the window for the sums as the Pallas body
//   does, measured no faster in an earlier layout and must hold every
//   offset's score; more offsets a step measure no faster either.) Scores are
//   kept in log2 units.
// Unlike the Pallas body, the denominator is floored at FLT_MIN, as
// models/gat.py's XLA path is: a lane with no valid offset (the padded nodes)
// gives 0 and not NaN; and a neighbour outside [0, N) counts as invalid where
// the Pallas roll would wrap around (the graph builder never marks one valid).
//
// The tiled kernel above is built for the model's 2 heads x 11 channels, at
// most 64 offsets and |shift| <= 144. Every other layout and stencil the Pallas
// kernel takes (any heads x channels, any shift, any number of offsets) runs
// gat_stencil_general_kernel: a thread per (slice, head, node) reads its
// neighbours straight from device memory (coalesced along the node axis), a
// first pass over the offsets makes the online max and denominator, and a
// second pass per kGeneralChunk channels recomputes each score and sums the
// weighted neighbours. Same masking, floor and out-of-range rule; its shifts
// come from device memory, so their number has no limit.
#include <algorithm>
#include <cfloat>
#include <climits>
#include <cstdint>
#include <cstdlib>

#include "common.cuh"

namespace {

constexpr int kHeads = 2, kChannels = 11, kHC = kHeads * kChannels;
constexpr int kMaxOffsets = 64;  // a node's validity bits are one uint64
constexpr int kMaxShift = 144;   // the largest halo capacity
constexpr int kTile = 256;                 // nodes a block owns
constexpr int kThreads = kTile * kHeads;   // one (node, head) a thread: warps 0-7 head 0, 8-15 head 1
constexpr int kPerStep = 1;                // offsets a step of the softmax takes
constexpr float kLog2e = 1.4426950408889634f;

struct StencilShifts {
  int shifts[kMaxOffsets];
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in_range) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(in_range ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

// 2^x on the special function unit; a result below 2^-126 flushes to 0, which
// only drops weights that no sum of them could notice
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// v ? x : y as a select instruction, never a branch: the scores of a step are
// then computed on every lane, and their chains overlap
__device__ __forceinline__ float select(bool v, float x, float y) {
  float out;
  asm("{\n .reg .pred p;\n setp.ne.u32 p, %1, 0;\n selp.f32 %0, %2, %3, p;\n}"
      : "=f"(out) : "r"(static_cast<unsigned>(v)), "f"(x), "f"(y));
  return out;
}

// Two adjacent staged values as fp32: a bf16 pair is one 32-bit word (the
// lower element in the low half).
__device__ __forceinline__ float2 staged_pair(const __nv_bfloat16* p) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
  return make_float2(__uint_as_float(w << 16), __uint_as_float(w & 0xffff0000u));
}
__device__ __forceinline__ float2 staged_pair(const float* p) { return *reinterpret_cast<const float2*>(p); }

// Shared memory of a block, for a halo up to kPadMax (window element 0 is node
// n0 - kPadMax, kStride elements in all): the fp32 window W, node-major, a
// record of kRecord floats per (head, element): the head's 11 channels and the
// projection P[j] = k1 * att_h . W[h, j, :], so that three 16-byte loads bring
// a neighbour; then the staging buffers in xl's type for the next window
// (kHC x kStride, channel-major as in device memory) and the next xr tile
// (kHC x kTile).
constexpr int kRecord = kChannels + 1;
template <typename T, int kPadMax>
struct Layout {
  static constexpr int kStride = kTile + 2 * kPadMax;
  static constexpr int kWin = kHeads * kStride * kRecord;
  static constexpr int kStage = kHC * kStride;
  static constexpr int kBytes = kWin * 4 + (kStage + kHC * kTile) * static_cast<int>(sizeof(T));
};

template <typename T, int kPadMax>
__global__ void __launch_bounds__(kThreads, 1)
gat_stencil_kernel(const T* __restrict__ xl, const T* __restrict__ xr,
                   const uint8_t* __restrict__ valid, const float* __restrict__ att,
                   T* __restrict__ out, int m_total, int n_nodes, int n_offsets, int slices,
                   int n_tiles, int aligned, float slope, const StencilShifts p) {
  using L = Layout<T, kPadMax>;
  constexpr int S = L::kStride;
  constexpr int E = 16 / sizeof(T);  // elements in a 16-byte copy
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_off[kMaxOffsets];  // offset o's neighbour of node n0: W element kPadMax + shift
  float* const win = reinterpret_cast<float*>(smem);
  T* const stage_xl = reinterpret_cast<T*>(win + L::kWin);
  T* const stage_xr = stage_xl + L::kStage;

  const int tile = blockIdx.x % n_tiles;
  const int m_begin = (blockIdx.x / n_tiles) * slices;
  const int m_end = min(m_begin + slices, m_total);
  const int n0 = tile * kTile;
  const int w0 = n0 - kPadMax;  // node of window element 0; a multiple of 8
  const int tid = threadIdx.x;
  const int h = tid / kTile;
  const int t = tid % kTile;
  const int n = n0 + t;         // this thread's node
  const bool in = n < n_nodes;
  for (int o = tid; o < n_offsets; o += kThreads) s_off[o] = kPadMax + p.shifts[o];

  // slice m's window and xr tile into the staging buffers: 16-byte copies in
  // flight, or element copies where rows are not whole 16-byte chunks
  auto stage = [&](int m) {
    const int64_t slice = static_cast<int64_t>(m) * kHC * n_nodes;
    const T* src_xl = xl + slice;
    const T* src_xr = xr + slice;
    if (aligned) {
      constexpr int kRowChunks = S / E, kTileChunks = kTile / E;
      // chunks never straddle 0 or N, both multiples of E
      for (int i = tid; i < kHC * kRowChunks; i += kThreads) {
        const int c = i / kRowChunks, q = i - c * kRowChunks;
        const int j = w0 + q * E;
        const bool ok = static_cast<unsigned>(j) < static_cast<unsigned>(n_nodes);
        cp_async16(stage_xl + c * S + q * E, src_xl + c * n_nodes + (ok ? j : 0), ok);
      }
      for (int i = tid; i < kHC * kTileChunks; i += kThreads) {
        const int c = i / kTileChunks, q = i - c * kTileChunks;
        const int j = n0 + q * E;
        const bool ok = j < n_nodes;
        cp_async16(stage_xr + c * kTile + q * E, src_xr + c * n_nodes + (ok ? j : 0), ok);
      }
    } else {
#pragma unroll 8
      for (int i = tid; i < kHC * S; i += kThreads) {
        const int c = i / S, q = i - c * S;
        const int j = w0 + q;
        stage_xl[i] = static_cast<unsigned>(j) < static_cast<unsigned>(n_nodes) ? src_xl[c * n_nodes + j]
                                                                                 : tec::from_float<T>(0.f);
      }
#pragma unroll 8
      for (int i = tid; i < kHC * kTile; i += kThreads) {
        const int c = i / kTile, q = i - c * kTile;
        stage_xr[i] = n0 + q < n_nodes ? src_xr[c * n_nodes + n0 + q] : tec::from_float<T>(0.f);
      }
    }
    cp_async_commit();
  };
  stage(m_begin);

  // The tile's validity columns, read once into shared memory (W is free until
  // the first slice lands), then as this node's bits (bit o: offset o valid and
  // its neighbour in range), and the offsets any node of the warp needs.
  uint8_t* const vbytes = reinterpret_cast<uint8_t*>(win);
#pragma unroll 4
  for (int o = h; o < n_offsets; o += kHeads)
    vbytes[o * kTile + t] = in ? valid[static_cast<int64_t>(o) * n_nodes + n] : 0;
  __syncthreads();
  uint64_t vb = 0;
  for (int o = 0; o < n_offsets; ++o) {
    const int j = n + p.shifts[o];
    if (j >= 0 && j < n_nodes && vbytes[o * kTile + t]) vb |= 1ull << o;
  }
  const uint64_t warp_any =
      (static_cast<uint64_t>(__reduce_or_sync(0xffffffffu, static_cast<uint32_t>(vb >> 32))) << 32) |
      __reduce_or_sync(0xffffffffu, static_cast<uint32_t>(vb));

  // leaky_relu(e) = k1 * e + k2 * |e|, so score = k1 * att.l + k1 * att.r +
  // k2 * att.|l + r|. The middle term is the same for every offset of a node
  // and leaves the softmax unchanged: it is dropped. The first is the
  // projection P of the neighbour, made once per window element; the last
  // costs an add and a multiply-add per channel (|.| is an operand modifier).
  // Scores are kept in log2 units (times log2 e), so a weight is one ex2.
  const float k1 = 0.5f * (1.f + slope) * kLog2e, k2 = 0.5f * (1.f - slope) * kLog2e;
  float a[kChannels];
#pragma unroll
  for (int c = 0; c < kChannels; ++c) a[c] = __ldg(att + h * kChannels + c);
  const float lowest = -FLT_MAX;
  const float* const win_h = win + (h * S + t) * kRecord;

  for (int m = m_begin; m < m_end; ++m) {
    // The slice has landed (and every thread is done with the last one's W).
    // Convert head h's rows of the window to node-major fp32 records with their
    // projection; take this node's xr values.
    cp_async_wait_all();
    __syncthreads();
    for (int j = 2 * t; j < S; j += 2 * kTile) {  // two elements a thread
      float rec[2][kRecord];
      float p0 = 0.f, p1 = 0.f;
#pragma unroll
      for (int c = 0; c < kChannels; ++c) {
        const float2 v = staged_pair(stage_xl + (h * kChannels + c) * S + j);
        rec[0][c] = v.x;
        rec[1][c] = v.y;
        p0 = fmaf(a[c], v.x, p0);
        p1 = fmaf(a[c], v.y, p1);
      }
      rec[0][kChannels] = k1 * p0;
      rec[1][kChannels] = k1 * p1;
      float4* dst = reinterpret_cast<float4*>(win + (h * S + j) * kRecord);
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int q = 0; q < kRecord / 4; ++q)
          dst[e * kRecord / 4 + q] =
              make_float4(rec[e][4 * q], rec[e][4 * q + 1], rec[e][4 * q + 2], rec[e][4 * q + 3]);
    }
    float r[kChannels];
#pragma unroll
    for (int c = 0; c < kChannels; ++c) r[c] = tec::to_float(stage_xr[(h * kChannels + c) * kTile + t]);
    __syncthreads();
    if (m + 1 < m_end) stage(m + 1);  // lands while this slice is computed

    // Online softmax over the offsets: each window value is read once, for
    // the score and then the weighted sum.
    float mx = lowest, den = 0.f;
    float acc[kChannels];
#pragma unroll
    for (int c = 0; c < kChannels; ++c) acc[c] = 0.f;
    // The offsets this warp needs, kPerStep at a time (the last step may hold
    // fewer: its empty slots repeat an offset and weigh 0), so that one
    // rescale of the sums serves kPerStep offsets and their loads overlap.
    for (uint64_t todo = warp_any; todo;) {
      int j[kPerStep];
      bool v[kPerStep];
      const int first = __ffsll(static_cast<long long>(todo)) - 1;  // todo is not 0 here
#pragma unroll
      for (int k = 0; k < kPerStep; ++k) {
        const bool here = todo != 0;
        const int o = here ? __ffsll(static_cast<long long>(todo)) - 1 : first;
        j[k] = s_off[o];
        v[k] = here && ((vb >> o) & 1);
        todo &= todo - 1;
      }
      float l[kPerStep][kChannels];
      float sc[kPerStep];
#pragma unroll
      for (int k = 0; k < kPerStep; ++k) {
        const float4* rec = reinterpret_cast<const float4*>(win_h + j[k] * kRecord);
        float pj = 0.f;
#pragma unroll
        for (int q = 0; q < kRecord / 4; ++q) {
          const float4 v4 = rec[q];
          const float vals[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if (4 * q + i < kChannels) l[k][4 * q + i] = vals[i];
            else pj = vals[i];
          }
        }
        float even = 0.f, odd = 0.f;  // two chains of multiply-adds
#pragma unroll
        for (int c = 0; c < kChannels; ++c) {
          if (c & 1) odd = fmaf(fabsf(l[k][c] + r[c]), a[c], odd);
          else even = fmaf(fabsf(l[k][c] + r[c]), a[c], even);
        }
        sc[k] = select(v[k], fmaf(k2, even + odd, pj), lowest);
      }
      float mx_new = mx;
#pragma unroll
      for (int k = 0; k < kPerStep; ++k) mx_new = fmaxf(mx_new, sc[k]);
      const float f = ex2(mx - mx_new);
      float e[kPerStep];
      den *= f;
#pragma unroll
      for (int k = 0; k < kPerStep; ++k) {
        e[k] = v[k] ? ex2(sc[k] - mx_new) : 0.f;
        den += e[k];
      }
      mx = mx_new;
#pragma unroll
      for (int c = 0; c < kChannels; ++c) {
        float sum = acc[c] * f;
#pragma unroll
        for (int k = 0; k < kPerStep; ++k) sum = fmaf(e[k], l[k][c], sum);
        acc[c] = sum;
      }
    }

    if (in) {
      const float inv = 1.f / fmaxf(den, FLT_MIN);
      T* dst = out + (static_cast<int64_t>(m) * kHC + h * kChannels) * n_nodes + n;
#pragma unroll
      for (int c = 0; c < kChannels; ++c) dst[static_cast<int64_t>(c) * n_nodes] = tec::from_float<T>(acc[c] * inv);
    }
  }
}

struct Launch {
  const void *xl, *xr, *valid;
  const float* att;
  void* out;
  int m, n, n_offsets, reach, aligned;  // reach: the largest |shift|
  float slope;
  StencilShifts p;
  cudaStream_t stream;
};

template <typename T, int kPadMax>
cudaError_t launch_as(const Launch& a) {
  auto kernel = gat_stencil_kernel<T, kPadMax>;
  constexpr int kBytes = Layout<T, kPadMax>::kBytes;
  // Asked on every launch, for the device current now: the shared memory the
  // block needs, and the blocks resident at once, among which the slices are
  // shared out so that the grid is one wave of them.
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, kBytes);
  if (err != cudaSuccess) return err;
  const int resident = sms * per_sm > 0 ? sms * per_sm : 1;
  const int n_tiles = (a.n + kTile - 1) / kTile;
  const int per_tile = resident / n_tiles > 1 ? resident / n_tiles : 1;
  const int slices = (a.m + per_tile - 1) / per_tile;
  const int blocks = n_tiles * ((a.m + slices - 1) / slices);  // at most max(n_tiles, resident)
  kernel<<<blocks, kThreads, kBytes, a.stream>>>(
      static_cast<const T*>(a.xl), static_cast<const T*>(a.xr), static_cast<const uint8_t*>(a.valid),
      a.att, static_cast<T*>(a.out), a.m, a.n, a.n_offsets, slices, n_tiles, a.aligned, a.slope, a.p);
  return cudaGetLastError();
}

// the instantiation whose windows hold this halo
template <typename T>
cudaError_t launch(const Launch& a) {
  return a.reach <= 72 ? launch_as<T, 72>(a) : launch_as<T, 144>(a);
}

constexpr int kGeneralThreads = 256;  // nodes of a block, all of one (slice, head)
constexpr int kGeneralChunk = 16;     // output channels one pass accumulates

template <typename T>
__global__ void __launch_bounds__(kGeneralThreads)
gat_stencil_general_kernel(const T* __restrict__ xl, const T* __restrict__ xr,
                           const uint8_t* __restrict__ valid, const int* __restrict__ shifts,
                           const float* __restrict__ att, T* __restrict__ out, int heads, int channels,
                           int n_nodes, int n_offsets, int n_tiles, float slope) {
  const int n = (blockIdx.x % n_tiles) * kGeneralThreads + threadIdx.x;
  const int64_t mh = blockIdx.x / n_tiles;  // m * heads + h
  if (n >= n_nodes) return;
  const int h = static_cast<int>(mh % heads);
  const int64_t row0 = mh * channels;  // the head's first row: m * heads*channels + h * channels
  const T* const l = xl + row0 * n_nodes;
  const T* const r = xr + row0 * n_nodes + n;
  const float* const a = att + h * channels;
  T* const o = out + row0 * n_nodes + n;

  // offset k's neighbour, or -1 where it is masked or outside [0, N)
  auto neighbour = [&](int k) {
    const int j = n + __ldg(shifts + k);
    return j >= 0 && j < n_nodes && valid[static_cast<int64_t>(k) * n_nodes + n] ? j : -1;
  };
  auto score = [&](int j) {
    float s = 0.f;
    for (int c = 0; c < channels; ++c) {
      const int64_t row = static_cast<int64_t>(c) * n_nodes;
      const float e = tec::to_float(l[row + j]) + tec::to_float(r[row]);
      s = fmaf(__ldg(a + c), e >= 0.f ? e : slope * e, s);
    }
    return s;
  };

  float mx = -FLT_MAX, den = 0.f;
  for (int k = 0; k < n_offsets; ++k) {
    const int j = neighbour(k);
    if (j < 0) continue;
    const float s = score(j);
    if (s > mx) {
      den = den * expf(mx - s) + 1.f;
      mx = s;
    } else {
      den += expf(s - mx);
    }
  }
  const float inv = 1.f / fmaxf(den, FLT_MIN);  // no valid offset: 0, not NaN
  for (int c0 = 0; c0 < channels; c0 += kGeneralChunk) {
    float acc[kGeneralChunk];
#pragma unroll
    for (int q = 0; q < kGeneralChunk; ++q) acc[q] = 0.f;
    for (int k = 0; k < n_offsets; ++k) {
      const int j = neighbour(k);
      if (j < 0) continue;
      const float w = expf(score(j) - mx);
#pragma unroll
      for (int q = 0; q < kGeneralChunk; ++q)
        if (c0 + q < channels) acc[q] = fmaf(w, tec::to_float(l[static_cast<int64_t>(c0 + q) * n_nodes + j]), acc[q]);
    }
#pragma unroll
    for (int q = 0; q < kGeneralChunk; ++q)
      if (c0 + q < channels) o[static_cast<int64_t>(c0 + q) * n_nodes] = tec::from_float<T>(acc[q] * inv);
  }
}

template <typename T>
cudaError_t launch_general(const void* xl, const void* xr, const void* valid, const int* shifts,
                           const float* att, void* out, int m, int heads, int channels, int n,
                           int n_offsets, float slope, cudaStream_t stream) {
  const int n_tiles = (n + kGeneralThreads - 1) / kGeneralThreads;
  const int64_t blocks = static_cast<int64_t>(n_tiles) * m * heads;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  gat_stencil_general_kernel<T><<<static_cast<unsigned>(blocks), kGeneralThreads, 0, stream>>>(
      static_cast<const T*>(xl), static_cast<const T*>(xr), static_cast<const uint8_t*>(valid), shifts, att,
      static_cast<T*>(out), heads, channels, n, n_offsets, n_tiles, slope);
  return cudaGetLastError();
}

}  // namespace

// xl, xr, out: (m, heads*channels, n) contiguous; valid: (n_offsets, n) uint8
// (torch.bool); att: heads*channels fp32 on the device. general = 0 launches
// the tiled kernel, which takes heads=2, channels=11, at most kMaxOffsets
// offsets and |shift| <= kMaxShift, from the host array shifts; general = 1
// launches gat_stencil_general_kernel, which takes any of them and reads the
// same n_offsets shifts from shifts_dev, an int32 array on the device.
extern "C" int gat_stencil_forward(const void* xl, const void* xr, const void* valid,
                                   const int* shifts, const int* shifts_dev, const void* att, void* out,
                                   int m, int heads, int channels, int n, int n_offsets, float slope,
                                   int is_bf16, int general, void* stream) {
  if (m < 1 || n < 1 || heads < 1 || channels < 1 || n_offsets < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto att32 = static_cast<const float*>(att);
  if (general) {
    if (shifts_dev == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(
        is_bf16 ? launch_general<__nv_bfloat16>(xl, xr, valid, shifts_dev, att32, out, m, heads, channels, n,
                                                n_offsets, slope, s)
                : launch_general<float>(xl, xr, valid, shifts_dev, att32, out, m, heads, channels, n, n_offsets,
                                        slope, s));
  }
  if (heads != kHeads || channels != kChannels || n_offsets > kMaxOffsets)
    return static_cast<int>(cudaErrorInvalidValue);
  Launch a{xl, xr, valid, att32, out, m, n, n_offsets, 0, 0, slope, {}, s};
  for (int o = 0; o < n_offsets; ++o) {
    if (shifts[o] > kMaxShift || shifts[o] < -kMaxShift) return static_cast<int>(cudaErrorInvalidValue);
    a.p.shifts[o] = shifts[o];
    a.reach = std::max(a.reach, std::abs(shifts[o]));
  }
  // 16-byte copies need rows that are whole 16-byte chunks and aligned pointers
  const auto a16 = [](const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0; };
  a.aligned = n % (is_bf16 ? 8 : 4) == 0 && a16(xl) && a16(xr);
  return static_cast<int>(is_bf16 ? launch<__nv_bfloat16>(a) : launch<float>(a));
}
