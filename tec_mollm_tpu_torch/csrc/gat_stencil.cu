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
// kernel takes (any heads x channels, any int32 shift, any number of offsets)
// runs gat_stencil_general_kernel, bound by the same bytes and held back, as
// the tiled one is, by its instruction stream. Its design:
// - A block owns one head of a tile of 256, 128 or 64 nodes (a thread a
//   node) and walks consecutive slices (one wave of resident blocks). The
//   tile, the window and the shared-memory layout are set at launch from the
//   stencil's span and C (general_plan): the largest tile whose window, the
//   rows [n0 + min shift, n0 + tile + max shift) of the shifts that can reach
//   a node, fits 110 KB with the rest (two blocks an SM).
// - Each slice's window rows and xr tile are staged by cp.async while the
//   slice before is computed: 16-byte copies where rows are whole 16-byte
//   chunks, else 4-byte copies (a bf16 pair from an even element, rows of odd
//   N starting one element in), element copies only for a pointer that is not
//   4-byte aligned. The window is converted once to node-major fp32 records
//   (an odd count of 16-byte chunks, so that neighbouring nodes' loads fall in
//   distinct banks) beside the head's projection P = k1 att_h . l, two
//   elements a thread where rows hold whole pairs.
// - One pass over the offsets with an online softmax in log2 units (ex2): a
//   neighbour's record is read once for its score P + k2 att_h . |l + r| (the
//   tiled kernel's split of leaky-ReLU: an add and a multiply-add a channel)
//   and its weighted sum; the sums are rescaled only when a score passes its
//   lane's running max by more than kLazy on some lane of the warp. Heads of
//   up to 31 channels keep att, r and the sums in registers (C <= 4 q - 1 for
//   a record of q float4s, q a template width); wider heads loop over groups
//   of 32 output channels, recomputing each score from the window.
// - Validity is a 32-bit word per node and 32 offsets in shared memory, the
//   range check folded in, with the shifts and their records' offsets; a
//   warp walks only the offsets one of its nodes needs. Offsets past the
//   first 512 have their bits and shifts read from device memory each slice.
// - A span too wide for the smallest tile's window (or a head too wide for
//   its tile) keeps the widest window that fits around shift 0 and reads the
//   other offsets' neighbours from device memory in the same kernel (an
//   instantiation of its own, so that a stencil that fits pays nothing for
//   it). Offsets with |shift| >= N reach no node and are never walked.
// Same masking, floor and out-of-range rule as the tiled kernel.
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
// 4 bytes, of which the first `bytes` (0, 2 or 4) come from src and the rest are 0
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(bytes));
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

// ---------------------------------------------------------------------------
// The general form: any heads x channels, any number of offsets, any int32
// shift. A block owns one head of a tile of nodes (a thread a node) and walks
// consecutive slices; its tile, window and shared-memory layout are set at
// launch from the stencil's span and C (general_plan).

constexpr int kWord = 32;                   // offsets a validity word (uint32) holds
constexpr int kResidentWords = 16;          // validity words (512 offsets) a block keeps in shared memory
constexpr int kGeneralTiles[] = {256, 128, 64};  // nodes a block owns, the largest whose window fits first
constexpr int kGeneralBudget = 110 * 1024;  // dynamic shared memory of a block: two blocks fit an SM
constexpr int kNarrowQ[] = {2, 3, 4, 5, 6, 8};  // float4 chunks of a narrow head's record: C <= 4 q - 1
constexpr int kWideQ = 8;                   // float4 chunks of a wide head's channel group (32 channels)
constexpr float kLazy = 8.f;                // log2 units a score may pass the max before the sums are rescaled

struct GeneralArgs {
  const void *xl, *xr;
  const uint8_t* valid;
  const int* shifts;  // the n_offsets shifts, on the device
  const float* att;
  void* out;
  int m, heads, channels, n, n_offsets;
  int tile;         // nodes (and threads) of a block
  int wlen;         // window elements; 0: every neighbour comes from device memory
  int lo;           // window element 0 is node n0 + lo; a multiple of 16 bytes' elements
  int rec;          // floats of a window record
  int res_offsets;  // offsets whose shift and validity bits a block keeps in shared memory
  int sx, sr;       // elements of a staged row of the window and of the xr tile: wlen + E and tile + E
  int copy;         // 2: 16-byte cp.async (rows of whole 16-byte chunks); 1: 4-byte cp.async; 0: element copies
  int slices, units, n_tiles;  // slices a block walks; (tile, head) pairs; node tiles
  int off_stage_xl, off_stage_xr, off_bits, off_warp, off_shift, off_woff;  // bytes into shared memory
  float k1, k2;     // leaky_relu(e) = (k1 e + k2 |e|) / log2(e)
};

// Shared memory of a block, in this order: the fp32 window W (wlen records of
// rec floats, node-major: a record holds a node's C channels and, for a narrow
// head, the projection P = k1 * att_h . l in its last float; a wide head keeps
// P at float C); the staging buffers in xl's type for the next slice's window
// (C rows of sx elements, channel-major as in device memory) and, for a
// narrow head, its xr tile (C rows of sr); the validity words of the first
// res_offsets offsets (a word per node and per warp), their shifts and their
// records' offsets in W (-1: outside it).
template <typename T, int kQ, bool kWide, bool kSpill>
__global__ void __launch_bounds__(256, (kQ <= 3 ? 3 : kQ <= 6 ? 2 : 1))
gat_stencil_general_kernel(const GeneralArgs a) {
  constexpr int E = 16 / sizeof(T);  // elements in a 16-byte copy
  constexpr int kL = 4 * kQ;         // narrow: channel slots 0..kL-2 and P at kL-1; wide: a channel group
  extern __shared__ __align__(16) unsigned char smem[];
  float* const win = reinterpret_cast<float*>(smem);
  T* const stage_xl = reinterpret_cast<T*>(smem + a.off_stage_xl);
  T* const stage_xr = reinterpret_cast<T*>(smem + a.off_stage_xr);
  uint32_t* const s_bits = reinterpret_cast<uint32_t*>(smem + a.off_bits);
  uint32_t* const s_warp = reinterpret_cast<uint32_t*>(smem + a.off_warp);
  int* const s_shift = reinterpret_cast<int*>(smem + a.off_shift);
  int* const s_woff = reinterpret_cast<int*>(smem + a.off_woff);
  const T* const xl = static_cast<const T*>(a.xl);
  const T* const xr = static_cast<const T*>(a.xr);
  T* const out = static_cast<T*>(a.out);

  const int C = a.channels, N = a.n, R = a.rec, TT = a.tile, W = a.wlen, SX = a.sx, SR = a.sr;
  const int unit = blockIdx.x % a.units;
  const int h = unit / a.n_tiles;
  const int n0 = (unit % a.n_tiles) * TT;
  const int m_begin = (blockIdx.x / a.units) * a.slices;
  const int m_end = min(m_begin + a.slices, a.m);
  const int64_t w0 = static_cast<int64_t>(n0) + a.lo;  // node of window element 0; a multiple of E
  const int t = threadIdx.x, warp = t / 32, warps = TT / 32;
  const int n = n0 + t;  // this thread's node
  const bool in = n < N;
  const int words = (a.n_offsets + kWord - 1) / kWord;
  const int res_words = (a.res_offsets + kWord - 1) / kWord;
  // bf16 rows copied 4 bytes at a time start at an odd element where their
  // first element's index is odd (rows of odd N alternate)
  const bool pairs = a.copy == 1 && sizeof(T) == 2;
  const int nodd = pairs ? N & 1 : 0;
  const float lowest = -FLT_MAX;

  // the float offset of a shift's record in W from this node's, or -1 when
  // the window does not hold the whole tile's neighbours at that shift
  auto window_off = [&](int s) {
    const int64_t idx = static_cast<int64_t>(s) - a.lo;
    return idx >= 0 && idx <= W - TT ? static_cast<int>(idx) * R : -1;
  };
  // word w of this node's validity: bit k for offset 32 w + k, valid and its
  // neighbour inside [0, N)
  auto validity = [&](int w) {
    uint32_t vb = 0;
    const int o1 = min(a.n_offsets, (w + 1) * kWord);
    for (int o = w * kWord; o < o1; ++o) {
      const int64_t j = static_cast<int64_t>(n) + (o < a.res_offsets ? s_shift[o] : __ldg(a.shifts + o));
      if (in && j >= 0 && j < N && a.valid[static_cast<int64_t>(o) * N + n]) vb |= 1u << (o - w * kWord);
    }
    return vb;
  };
  // head h's first row of slice m
  auto head_base = [&](int m) { return (static_cast<int64_t>(m) * a.heads + h) * C * static_cast<int64_t>(N); };

  // The resident offsets' shifts and window offsets, then this node's
  // validity words and the offsets any node of the warp needs (ordered
  // before their reads by the barrier after the first slice lands).
  for (int o = t; o < a.res_offsets; o += TT) {
    const int s = a.shifts[o];
    s_shift[o] = s;
    s_woff[o] = window_off(s);
  }
  __syncthreads();
  for (int w = 0; w < res_words; ++w) {
    const uint32_t vb = validity(w);
    s_bits[w * TT + t] = vb;
    const uint32_t any = __reduce_or_sync(0xffffffffu, vb);
    if (t % 32 == 0) s_warp[w * warps + warp] = any;
  }
  // a narrow head's attention vector (0 past C and in P's slot)
  float av[kL];
#pragma unroll
  for (int i = 0; i < kL; ++i) av[i] = !kWide && i < kL - 1 && i < C ? __ldg(a.att + h * C + i) : 0.f;

  // Slice m's window rows (and a narrow head's xr tile) into the staging
  // buffers, row c at c * SX (c * SR), plus 1 where a bf16 row copied in
  // pairs starts at an odd element: 16-byte copies in flight where rows are
  // whole 16-byte chunks, else 4-byte copies in flight (a bf16 pair from an
  // even element; a neighbour outside [0, N) may then hold its row
  // neighbour's value, which the conversion zeroes), or element copies where
  // a pointer is not 4-byte aligned.
  auto stage = [&](int m) {
    const int64_t hb = head_base(m);
    const T* const src_l = xl + hb;
    const T* const src_r = xr + hb;
    if (a.copy == 2) {
      const int chunks = W / E;  // chunks never straddle 0 or N, both multiples of E
      for (int i = t; i < C * chunks; i += TT) {
        const int c = i / chunks, q = i - c * chunks;
        const int64_t j = w0 + q * E;
        const bool ok = j >= 0 && j < N;
        cp_async16(stage_xl + c * SX + q * E, src_l + static_cast<int64_t>(c) * N + (ok ? j : 0), ok);
      }
      if constexpr (!kWide) {
        const int tchunks = TT / E;
        for (int i = t; i < C * tchunks; i += TT) {
          const int c = i / tchunks, q = i - c * tchunks;
          const int j = n0 + q * E;
          const bool ok = j < N;
          cp_async16(stage_xr + c * SR + q * E, src_r + static_cast<int64_t>(c) * N + (ok ? j : 0), ok);
        }
      }
    } else if (pairs) {
      // pair k of row c holds elements 2k - par and 2k - par + 1, nodes j and j + 1
      const int units = W / 2 + 1;
      for (int i = t; i < C * units; i += TT) {
        const int c = i / units, k = i - c * units;
        const int par = static_cast<int>((hb + w0) & 1) ^ (c & nodd);
        const int64_t j = w0 - par + 2 * k;
        const int bytes = j + 1 >= 0 && j + 1 < N ? 4 : j >= 0 && j < N ? 2 : 0;
        cp_async4(stage_xl + c * SX + 2 * k, bytes ? src_l + static_cast<int64_t>(c) * N + j : xl, bytes);
      }
      if constexpr (!kWide) {
        const int tunits = TT / 2 + 1;
        for (int i = t; i < C * tunits; i += TT) {
          const int c = i / tunits, k = i - c * tunits;
          const int par = static_cast<int>((hb + n0) & 1) ^ (c & nodd);
          const int j = n0 - par + 2 * k;
          const int bytes = j + 1 < N ? 4 : j < N ? 2 : 0;  // j >= -1, and j + 1 >= 0 holds
          cp_async4(stage_xr + c * SR + 2 * k, bytes ? src_r + static_cast<int64_t>(c) * N + j : xr, bytes);
        }
      }
    } else if (a.copy == 1) {  // fp32, 4 bytes an element
      for (int i = t; i < C * W; i += TT) {
        const int c = i / W, q = i - c * W;
        const int64_t j = w0 + q;
        const bool ok = j >= 0 && j < N;
        cp_async4(stage_xl + c * SX + q, ok ? src_l + static_cast<int64_t>(c) * N + j : xl, ok ? 4 : 0);
      }
      if constexpr (!kWide)
        for (int c = 0; c < C; ++c)
          cp_async4(stage_xr + c * SR + t, in ? src_r + static_cast<int64_t>(c) * N + n : xr, in ? 4 : 0);
    } else {
      for (int i = t; i < C * W; i += TT) {
        const int c = i / W, q = i - c * W;
        const int64_t j = w0 + q;
        stage_xl[c * SX + q] = j >= 0 && j < N ? src_l[static_cast<int64_t>(c) * N + j] : tec::from_float<T>(0.f);
      }
      if constexpr (!kWide)
        for (int c = 0; c < C; ++c)
          stage_xr[c * SR + t] = in ? src_r[static_cast<int64_t>(c) * N + n] : tec::from_float<T>(0.f);
    }
    cp_async_commit();
  };
  stage(m_begin);

  for (int m = m_begin; m < m_end; ++m) {
    // The slice has landed (and every thread is done with the last one's W).
    // Convert head h's window rows to node-major fp32 records with their
    // projection, zero outside [0, N); a narrow head takes this node's xr
    // values.
    cp_async_wait_all();
    __syncthreads();
    const int64_t base = head_base(m);
    const int par_l = pairs ? static_cast<int>((base + w0) & 1) : 0;  // of row 0; row c: par ^ (c & nodd)
    const int par_r = pairs ? static_cast<int>((base + n0) & 1) : 0;
    if constexpr (!kWide) {
      if (!pairs) {
        // two adjacent elements a thread, a channel's pair in one load (W and
        // SX are even, and the copies zero-filled every element outside [0, N))
        for (int e = 2 * t; e < W; e += 2 * TT) {
          float v0[kL], v1[kL];
          float p0 = 0.f, p1 = 0.f;
#pragma unroll
          for (int i = 0; i < kL - 1; ++i) {
            const float2 x = i < C ? staged_pair(stage_xl + i * SX + e) : make_float2(0.f, 0.f);
            v0[i] = x.x;
            v1[i] = x.y;
            p0 = fmaf(av[i], x.x, p0);
            p1 = fmaf(av[i], x.y, p1);
          }
          v0[kL - 1] = a.k1 * p0;
          v1[kL - 1] = a.k1 * p1;
          float4* const dst = reinterpret_cast<float4*>(win + static_cast<int64_t>(e) * R);
#pragma unroll
          for (int q = 0; q < kQ; ++q) {
            dst[q] = make_float4(v0[4 * q], v0[4 * q + 1], v0[4 * q + 2], v0[4 * q + 3]);
            dst[R / 4 + q] = make_float4(v1[4 * q], v1[4 * q + 1], v1[4 * q + 2], v1[4 * q + 3]);
          }
        }
      } else {
        for (int e = t; e < W; e += TT) {
          const bool ok = static_cast<uint64_t>(w0 + e) < static_cast<uint64_t>(N);
          float v[kL];
          float p = 0.f;
#pragma unroll
          for (int i = 0; i < kL - 1; ++i) {
            v[i] = ok && i < C ? tec::to_float(stage_xl[i * SX + (par_l ^ (i & nodd)) + e]) : 0.f;
            p = fmaf(av[i], v[i], p);
          }
          v[kL - 1] = a.k1 * p;
          float4* const dst = reinterpret_cast<float4*>(win + static_cast<int64_t>(e) * R);
#pragma unroll
          for (int q = 0; q < kQ; ++q) dst[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
        }
      }
    } else {
      for (int e = t; e < W; e += TT) {
        const bool ok = static_cast<uint64_t>(w0 + e) < static_cast<uint64_t>(N);
        float4* const dst = reinterpret_cast<float4*>(win + static_cast<int64_t>(e) * R);
        float p = 0.f;
        for (int q = 0; 4 * q < R; ++q) {
          float v[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int c = 4 * q + i;
            v[i] = ok && c < C ? tec::to_float(stage_xl[c * SX + (par_l ^ (c & nodd)) + e]) : 0.f;
            if (c < C) p = fmaf(__ldg(a.att + h * C + c), v[i], p);
          }
          dst[q] = make_float4(v[0], v[1], v[2], v[3]);
        }
        win[static_cast<int64_t>(e) * R + C] = a.k1 * p;
      }
    }
    float r[kL];
#pragma unroll
    for (int i = 0; i < kL; ++i)
      r[i] = !kWide && i < kL - 1 && i < C ? tec::to_float(stage_xr[i * SR + (par_r ^ (i & nodd)) + t]) : 0.f;
    __syncthreads();
    if (m + 1 < m_end) stage(m + 1);  // lands while this slice is computed

    const T* const xl_h = xl + base;
    const T* const xr_h = xr + base;
    const float* const win_t = win + t * R;
    // Online softmax over the offsets this warp needs, one pass: a neighbour's
    // record is read once for its score and its weighted sum (a wide head
    // reads it again for each group of 32 output channels). With leaky_relu(e)
    // = k1 e + k2 |e| (in log2 units), a score is P[neighbour] + k2 att_h .
    // |l + r| plus k1 att_h . r, which is the same for every offset of a node
    // and leaves the softmax unchanged: it is dropped.
    for (int g0 = 0; g0 < (kWide ? C : 1); g0 += kL) {
      float mx = lowest, den = 0.f, acc[kL];
#pragma unroll
      for (int i = 0; i < kL; ++i) acc[i] = 0.f;
      for (int w = 0; w < words; ++w) {
        uint32_t vb, todo;
        if (w < res_words) {
          vb = s_bits[w * TT + t];
          todo = s_warp[w * warps + warp];
        } else {  // past the resident offsets: the bits from device memory, each slice
          vb = validity(w);
          todo = __reduce_or_sync(0xffffffffu, vb);
        }
        while (todo) {
          const int k = __ffs(static_cast<int>(todo)) - 1;
          todo &= todo - 1;
          const int o = w * kWord + k;
          int s, woff;
          if (o < a.res_offsets) {
            s = s_shift[o];
            woff = s_woff[o];
          } else {
            s = __ldg(a.shifts + o);
            woff = window_off(s);
          }
          const bool v = (vb >> k) & 1;
          const int64_t j = static_cast<int64_t>(n) + s;  // the neighbour (read only where v)
          const bool windowed = !kSpill || woff >= 0;  // the same for every thread of the block
          const float* const rec = win_t + (windowed ? woff : 0);
          float l[kL];
          float sc;
          if constexpr (!kWide) {
            if (windowed) {
#pragma unroll
              for (int q = 0; q < kQ; ++q) {
                const float4 x = reinterpret_cast<const float4*>(rec)[q];
                l[4 * q] = x.x;
                l[4 * q + 1] = x.y;
                l[4 * q + 2] = x.z;
                l[4 * q + 3] = x.w;
              }
            } else if constexpr (kSpill) {  // from device memory, its projection made as the conversion makes it
              float p = 0.f;
#pragma unroll
              for (int i = 0; i < kL - 1; ++i) {
                l[i] = v && i < C ? tec::to_float(xl_h[static_cast<int64_t>(i) * N + j]) : 0.f;
                p = fmaf(av[i], l[i], p);
              }
              l[kL - 1] = a.k1 * p;
            }
            float even = 0.f, odd = 0.f;  // two chains of multiply-adds
#pragma unroll
            for (int i = 0; i < kL - 1; ++i) {
              if (i & 1) odd = fmaf(fabsf(l[i] + r[i]), av[i], odd);
              else even = fmaf(fabsf(l[i] + r[i]), av[i], even);
            }
            sc = select(v, fmaf(a.k2, even + odd, l[kL - 1]), lowest);
          } else {
            // the score over all C channels, four at a time
            float even = 0.f, odd = 0.f, p = 0.f;
            for (int q = 0; 4 * q < C; ++q) {
              float x[4];
              if (windowed) {
                const float4 x4 = reinterpret_cast<const float4*>(rec)[q];
                x[0] = x4.x, x[1] = x4.y, x[2] = x4.z, x[3] = x4.w;
              }
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const int c = 4 * q + i;
                const float ac = c < C ? __ldg(a.att + h * C + c) : 0.f;
                if (!windowed) {
                  x[i] = v && c < C ? tec::to_float(xl_h[static_cast<int64_t>(c) * N + j]) : 0.f;
                  p = fmaf(ac, x[i], p);
                }
                const float rc = in && c < C ? tec::to_float(xr_h[static_cast<int64_t>(c) * N + n]) : 0.f;
                if (i & 1) odd = fmaf(fabsf(x[i] + rc), ac, odd);
                else even = fmaf(fabsf(x[i] + rc), ac, even);
              }
            }
            sc = select(v, fmaf(a.k2, even + odd, windowed ? rec[C] : a.k1 * p), lowest);
            // this group's channels, read again
#pragma unroll
            for (int q = 0; q < kQ; ++q) {
              const int c = g0 + 4 * q;
              if (windowed) {
                const float4 x4 = c < R ? reinterpret_cast<const float4*>(rec + c)[0] : make_float4(0.f, 0.f, 0.f, 0.f);
                l[4 * q] = x4.x, l[4 * q + 1] = x4.y, l[4 * q + 2] = x4.z, l[4 * q + 3] = x4.w;
              } else {
#pragma unroll
                for (int i = 0; i < 4; ++i)
                  l[4 * q + i] = v && c + i < C ? tec::to_float(xl_h[static_cast<int64_t>(c + i) * N + j]) : 0.f;
              }
            }
          }
          constexpr int kSum = kWide ? kL : kL - 1;  // channels summed
          // The sums are rescaled only where a score passes its lane's running
          // max by more than kLazy (log2 units) on some lane of the warp; else
          // a weight is taken against the stale max, at most 2^kLazy.
          if (__any_sync(0xffffffffu, sc > mx + kLazy)) {
            const float mx_new = fmaxf(mx, sc);
            const float f = ex2(mx - mx_new);
            den *= f;
#pragma unroll
            for (int i = 0; i < kSum; ++i) acc[i] *= f;
            mx = mx_new;
          }
          const float ew = v ? ex2(sc - mx) : 0.f;
          den += ew;
#pragma unroll
          for (int i = 0; i < kSum; ++i) acc[i] = fmaf(ew, l[i], acc[i]);
        }
      }
      if (in) {
        const float inv = 1.f / fmaxf(den, FLT_MIN);  // no valid offset: 0, not NaN
        T* const dst = out + base + n;
#pragma unroll
        for (int i = 0; i < (kWide ? kL : kL - 1); ++i)
          if (g0 + i < C) dst[static_cast<int64_t>(g0 + i) * N] = tec::from_float<T>(acc[i] * inv);
      }
    }
  }
}

// What general_plan sets at launch for one call.
struct GeneralPlan {
  int q;              // float4 chunks of a narrow head's record (kNarrowQ); 0 for a wide head (C > 31)
  int tile, wlen, lo, rec, res_offsets;
  int window_offsets;  // offsets read from the window
  int reach;           // offsets that can reach a node (|shift| < n); those outside the window come from device memory
  int64_t bytes;       // dynamic shared memory
  int sx, sr;          // elements of a staged window row and xr row
  int off_stage_xl, off_stage_xr, off_bits, off_warp, off_shift, off_woff;
};

int64_t floor_div(int64_t a, int64_t b) { return a >= 0 ? a / b : -((-a + b - 1) / b); }
int64_t round16(int64_t bytes) { return (bytes + 15) / 16 * 16; }

// The tile, window and shared-memory layout of a call: the largest tile
// (kGeneralTiles) whose window, the tile plus the span of the shifts that can
// reach a node inside [0, N) (|shift| < N), fits kGeneralBudget; else the
// smallest tile with the widest window that fits, centred on shift 0 where the
// span allows, and the offsets outside it read from device memory (none inside
// when not even the tile fits). elem: bytes of an element of xl.
GeneralPlan general_plan(const int* shifts, int n_offsets, int channels, int n, int elem) {
  GeneralPlan p{};
  const int E = 16 / elem;
  for (int q : kNarrowQ)
    if (p.q == 0 && 4 * q - 1 >= channels) p.q = q;
  int chunks = p.q ? p.q : (channels + 1 + 3) / 4;  // float4s of a record: a wide head's C channels and P
  if (chunks % 2 == 0) ++chunks;  // an odd count: neighbouring nodes' records start in distinct bank quads
  p.rec = 4 * chunks;
  p.res_offsets = std::min(n_offsets, kResidentWords * kWord);
  const int64_t res_words = (p.res_offsets + kWord - 1) / kWord;
  int64_t lo = INT64_MAX, hi = INT64_MIN;
  for (int o = 0; o < n_offsets; ++o)
    if (shifts[o] > -n && shifts[o] < n) lo = std::min<int64_t>(lo, shifts[o]), hi = std::max<int64_t>(hi, shifts[o]);
  auto layout = [&](int tile, int64_t wlen) {
    const auto at = [](int64_t off) { return static_cast<int>(std::min<int64_t>(off, INT_MAX)); };
    int64_t off = wlen * p.rec * 4;
    p.off_stage_xl = at(off);
    off += round16(channels * (wlen + E) * elem);
    p.off_stage_xr = at(off);
    off += p.q ? round16(static_cast<int64_t>(channels) * (tile + E) * elem) : 0;
    p.off_bits = at(off);
    off += res_words * tile * 4;
    p.off_warp = at(off);
    off += round16(res_words * (tile / 32) * 4);
    p.off_shift = at(off);
    off += round16(p.res_offsets * 4);
    p.off_woff = at(off);
    return off + round16(p.res_offsets * 4);
  };
  auto finish = [&](int tile, int64_t wlen, int64_t lo_al) {
    p.tile = tile, p.wlen = static_cast<int>(wlen), p.lo = static_cast<int>(lo_al);
    p.sx = p.wlen + E, p.sr = tile + E;
    p.bytes = layout(tile, wlen);
    for (int o = 0; o < n_offsets; ++o) {
      const int64_t idx = static_cast<int64_t>(shifts[o]) - lo_al;
      const bool reaches = shifts[o] > -n && shifts[o] < n;
      p.reach += reaches;
      p.window_offsets += reaches && idx >= 0 && idx <= wlen - tile;
    }
    return p;
  };
  if (lo > hi) return finish(kGeneralTiles[2], 0, 0);  // no offset reaches a node
  const int64_t lo_al = floor_div(lo, E) * E, span = -floor_div(-hi, E) * E - lo_al;
  for (int tile : kGeneralTiles) {
    if (tile > kGeneralTiles[2] && tile / 2 >= n) continue;  // half the tile would be idle
    if (layout(tile, tile + span) <= kGeneralBudget) return finish(tile, tile + span, lo_al);
  }
  const int tile = kGeneralTiles[2];
  const int64_t cap = (kGeneralBudget - layout(tile, 0)) / (p.rec * 4 + channels * elem) / E * E;
  if (cap < tile + E) return finish(tile, 0, 0);
  const int64_t extra = cap - tile - E;  // shifts lo_w .. lo_w + extra fit, wherever lo_w falls in its chunk
  int64_t lo_w = std::max(lo, -extra / 2);
  if (lo_w + extra > hi) lo_w = std::max(lo, hi - extra);
  return finish(tile, cap, floor_div(lo_w, E) * E);
}

template <typename T, int kQ, bool kWide, bool kSpill>
cudaError_t launch_general_as(GeneralArgs a, const GeneralPlan& p, cudaStream_t stream) {
  auto kernel = gat_stencil_general_kernel<T, kQ, kWide, kSpill>;
  const int bytes = static_cast<int>(p.bytes);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, p.tile, bytes);
  if (err != cudaSuccess) return err;
  // the (tile, head) units share the resident blocks: each walks a run of
  // consecutive slices, so that the grid is one wave
  const int64_t resident = std::max(sms * per_sm, 1);
  const int64_t n_tiles = (a.n + p.tile - 1) / p.tile, units = n_tiles * a.heads;
  const int64_t per_unit = std::max<int64_t>(resident / units, 1);
  const int64_t slices = (a.m + per_unit - 1) / per_unit;
  const int64_t blocks = units * ((a.m + slices - 1) / slices);
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  a.n_tiles = static_cast<int>(n_tiles), a.units = static_cast<int>(units), a.slices = static_cast<int>(slices);
  kernel<<<static_cast<unsigned>(blocks), p.tile, bytes, stream>>>(a);
  return cudaGetLastError();
}

// the instantiation for the plan's record width, and with the reads from
// device memory only where some offset that reaches a node lies outside the
// window
template <typename T, bool kSpill>
cudaError_t launch_general_spill(const GeneralArgs& a, const GeneralPlan& p, cudaStream_t stream) {
  switch (p.q) {
    case 2: return launch_general_as<T, 2, false, kSpill>(a, p, stream);
    case 3: return launch_general_as<T, 3, false, kSpill>(a, p, stream);
    case 4: return launch_general_as<T, 4, false, kSpill>(a, p, stream);
    case 5: return launch_general_as<T, 5, false, kSpill>(a, p, stream);
    case 6: return launch_general_as<T, 6, false, kSpill>(a, p, stream);
    case 8: return launch_general_as<T, 8, false, kSpill>(a, p, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_general(const GeneralArgs& a, const GeneralPlan& p, cudaStream_t stream) {
  if (p.q == 0) return launch_general_as<T, kWideQ, true, true>(a, p, stream);
  return p.window_offsets < p.reach ? launch_general_spill<T, true>(a, p, stream)
                                    : launch_general_spill<T, false>(a, p, stream);
}

}  // namespace

// The general form's plan for a call (general_plan), for checks from the
// host: out[0..8] = q, tile, wlen, lo, rec, res_offsets, window_offsets,
// bytes, and the offsets that reach a node (|shift| < n).
extern "C" int gat_stencil_general_plan(const int* shifts, int n_offsets, int channels, int n, int is_bf16,
                                        long long* out) {
  if (n < 1 || channels < 1 || n_offsets < 1 || shifts == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const GeneralPlan p = general_plan(shifts, n_offsets, channels, n, is_bf16 ? 2 : 4);
  const long long v[] = {p.q, p.tile, p.wlen, p.lo, p.rec, p.res_offsets, p.window_offsets, p.bytes, p.reach};
  for (int i = 0; i < 9; ++i) out[i] = v[i];
  return 0;
}

// xl, xr, out: (m, heads*channels, n) contiguous; valid: (n_offsets, n) uint8
// (torch.bool); att: heads*channels fp32 on the device; shifts: the n_offsets
// shifts on the host. general = 0 launches the tiled kernel, which takes
// heads=2, channels=11, at most kMaxOffsets offsets and |shift| <= kMaxShift;
// general = 1 launches gat_stencil_general_kernel, which takes any of them,
// sized from the host shifts, and reads them again from shifts_dev, the same
// int32 array on the device.
extern "C" int gat_stencil_forward(const void* xl, const void* xr, const void* valid,
                                   const int* shifts, const int* shifts_dev, const void* att, void* out,
                                   int m, int heads, int channels, int n, int n_offsets, float slope,
                                   int is_bf16, int general, void* stream) {
  if (m < 1 || n < 1 || heads < 1 || channels < 1 || n_offsets < 1 || shifts == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto att32 = static_cast<const float*>(att);
  // 16-byte copies need rows that are whole 16-byte chunks and aligned pointers
  const auto at = [](const void* ptr, uintptr_t bytes) { return (reinterpret_cast<uintptr_t>(ptr) & (bytes - 1)) == 0; };
  const int aligned = n % (is_bf16 ? 8 : 4) == 0 && at(xl, 16) && at(xr, 16);
  if (general) {
    if (shifts_dev == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    const GeneralPlan p = general_plan(shifts, n_offsets, channels, n, is_bf16 ? 2 : 4);
    GeneralArgs a{};
    a.xl = xl, a.xr = xr, a.valid = static_cast<const uint8_t*>(valid), a.shifts = shifts_dev, a.att = att32;
    a.out = out, a.m = m, a.heads = heads, a.channels = channels, a.n = n, a.n_offsets = n_offsets;
    a.tile = p.tile, a.wlen = p.wlen, a.lo = p.lo, a.rec = p.rec, a.res_offsets = p.res_offsets;
    a.sx = p.sx, a.sr = p.sr;
    a.copy = aligned ? 2 : at(xl, 4) && at(xr, 4) ? 1 : 0;  // 4-byte copies: element or bf16 pair
    a.off_stage_xl = p.off_stage_xl, a.off_stage_xr = p.off_stage_xr, a.off_bits = p.off_bits;
    a.off_warp = p.off_warp, a.off_shift = p.off_shift, a.off_woff = p.off_woff;
    a.k1 = 0.5f * (1.f + slope) * kLog2e, a.k2 = 0.5f * (1.f - slope) * kLog2e;
    return static_cast<int>(is_bf16 ? launch_general<__nv_bfloat16>(a, p, s) : launch_general<float>(a, p, s));
  }
  if (heads != kHeads || channels != kChannels || n_offsets > kMaxOffsets)
    return static_cast<int>(cudaErrorInvalidValue);
  Launch a{xl, xr, valid, att32, out, m, n, n_offsets, 0, aligned, slope, {}, s};
  for (int o = 0; o < n_offsets; ++o) {
    if (shifts[o] > kMaxShift || shifts[o] < -kMaxShift) return static_cast<int>(cudaErrorInvalidValue);
    a.p.shifts[o] = shifts[o];
    a.reach = std::max(a.reach, std::abs(shifts[o]));
  }
  return static_cast<int>(is_bf16 ? launch<__nv_bfloat16>(a) : launch<float>(a));
}
