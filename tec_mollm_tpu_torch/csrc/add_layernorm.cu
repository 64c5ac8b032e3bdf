// The GPT-2 backbone's residual add and LayerNorm in one kernel, for eval calls
// (models/gpt2.py: GPT2Backbone's eval loop runs every ln_1, ln_2 and ln_f
// through it, each fused with the residual add before it).
//
// It replaces no TPU kernel: the JAX package leaves LayerNorm to XLA. It was
// added because the plain lean LayerNorm (ops/add_layernorm.py:lean_layernorm)
// is about ten passes over a (rows, d) activation in device memory: an fp32
// copy, two mean reductions, a square, the broadcast subtract and multiply,
// the cast back to bf16 and the affine's two bf16 passes, after the residual
// add's own pass. For bf16 rows of width d:
//
//   s    = bf16(x + delta)                    (s = x without a residual)
//   mean = sum(s) / d,  var = sum(s^2) / d - mean^2     (fp32, from the rounded s)
//   n    = bf16((s - mean) * rsqrt(var + eps))
//   h    = bf16(bf16(n * bf16(w)) + bf16(b))
//
// which is what the plain add followed by lean_layernorm computes
// (ops/add_layernorm.py:add_layernorm_mirror): each step rounds where the
// plain form's tensor ops round. The subtract, multiplies and adds use the
// _rn intrinsics, so no pair of them contracts into one fma; only the order
// of the fp32 sums differs from PyTorch's reductions.
//
// Bound on this card: bytes. A call reads x and delta once and writes s and
// h once, 4 x 2 x d bytes a row: at the flagship eval batch (141,312 rows of
// 768) 868 MB, 0.259 ms at 3.35 TB/s; its operations (about 20 a element)
// are far below the card's rate.
//
// Design. A warp owns a row: each lane reads 16-byte pieces (8 bf16) of x and
// delta at pieces lane, lane + 32, ... (three a lane at d = 768), all issued
// before any arithmetic, so that every warp keeps its row's loads in flight.
// The statistics are two warp-shuffle sums over the lane's values in
// registers; s is written as soon as it is formed, h after the statistics.
// The grid is one wave of resident blocks that walks the rows (a warp takes
// rows warp, warp + warps in the grid, ...), so each warp rounds w and b to
// bf16 once, into registers, and not once a row.
#include <cstdint>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kPiece = 8;      // bf16 elements in a 16-byte access
constexpr int kMaxPieces = 8;  // pieces a lane: widths up to 32 x 8 x 8 = 2048
constexpr int kMaxWidth = 32 * kPiece * kMaxPieces;

// 8 bf16 values as 4 words, element 2i in the low half of word i
struct Piece {
  uint32_t u[4];
};

__device__ __forceinline__ Piece load_piece(const bf16* p) {
  const uint4 r = __ldg(reinterpret_cast<const uint4*>(p));
  return Piece{{r.x, r.y, r.z, r.w}};
}

__device__ __forceinline__ void store_piece(bf16* p, const Piece& v) {
  *reinterpret_cast<uint4*>(p) = make_uint4(v.u[0], v.u[1], v.u[2], v.u[3]);
}

__device__ __forceinline__ float2 unpack(uint32_t u) {
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}

// a and b rounded to bf16 (to nearest, ties to even, as PyTorch rounds)
__device__ __forceinline__ uint32_t pack(float a, float b) {
  const __nv_bfloat162_raw r = __floats2bfloat162_rn(a, b);
  return static_cast<uint32_t>(r.x) | (static_cast<uint32_t>(r.y) << 16);
}

__device__ __forceinline__ float2 round2(float a, float b) { return unpack(pack(a, b)); }

// 8 fp32 values rounded to bf16, as the plain form's .to(bf16) rounds them
__device__ __forceinline__ Piece round_piece(const float* p) {
  const float4 lo = __ldg(reinterpret_cast<const float4*>(p));
  const float4 hi = __ldg(reinterpret_cast<const float4*>(p + 4));
  return Piece{{pack(lo.x, lo.y), pack(lo.z, lo.w), pack(hi.x, hi.y), pack(hi.z, hi.w)}};
}

// kPieces: 16-byte pieces a lane holds (the row's pieces over 32, rounded up)
template <int kPieces>
__global__ void __launch_bounds__(kThreads, 2)
add_layernorm_kernel(const bf16* __restrict__ x, const bf16* __restrict__ delta, const float* __restrict__ w,
                     const float* __restrict__ b, bf16* __restrict__ s_out, bf16* __restrict__ h_out,
                     int64_t rows, int d, float eps) {
  const int lane = threadIdx.x & 31;
  const int pieces = d / kPiece;
  const float inv_d = 1.0f / static_cast<float>(d);
  Piece wv[kPieces], bv[kPieces];
#pragma unroll
  for (int c = 0; c < kPieces; ++c) {
    const int p = lane + 32 * c;
    if (p < pieces) {
      wv[c] = round_piece(w + p * kPiece);
      bv[c] = round_piece(b + p * kPiece);
    }
  }
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kWarps;
  for (int64_t row = static_cast<int64_t>(blockIdx.x) * kWarps + threadIdx.x / 32; row < rows; row += warps) {
    const int64_t base = row * d;
    Piece sv[kPieces], dv[kPieces];
#pragma unroll
    for (int c = 0; c < kPieces; ++c) {
      const int p = lane + 32 * c;
      if (p < pieces) {
        sv[c] = load_piece(x + base + p * kPiece);
        if (delta != nullptr) dv[c] = load_piece(delta + base + p * kPiece);
      }
    }
    float sum = 0.f, sq = 0.f;
#pragma unroll
    for (int c = 0; c < kPieces; ++c) {
      const int p = lane + 32 * c;
      if (p >= pieces) continue;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float2 v = unpack(sv[c].u[i]);
        if (delta != nullptr) {
          const float2 e = unpack(dv[c].u[i]);
          sv[c].u[i] = pack(__fadd_rn(v.x, e.x), __fadd_rn(v.y, e.y));
          v = unpack(sv[c].u[i]);
        }
        sum += v.x + v.y;
        sq = fmaf(v.x, v.x, fmaf(v.y, v.y, sq));
      }
      if (s_out != nullptr) store_piece(s_out + base + p * kPiece, sv[c]);
    }
    sum = tec::warp_sum(sum);
    sq = tec::warp_sum(sq);
    const float mean = sum * inv_d;
    const float var = __fsub_rn(sq * inv_d, __fmul_rn(mean, mean));
    const float rstd = rsqrtf(__fadd_rn(var, eps));
#pragma unroll
    for (int c = 0; c < kPieces; ++c) {
      const int p = lane + 32 * c;
      if (p >= pieces) continue;
      Piece hv;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 v = unpack(sv[c].u[i]);
        const float2 n = round2(__fmul_rn(__fsub_rn(v.x, mean), rstd), __fmul_rn(__fsub_rn(v.y, mean), rstd));
        const float2 wf = unpack(wv[c].u[i]);
        const float2 bf = unpack(bv[c].u[i]);
        const float2 m = round2(__fmul_rn(n.x, wf.x), __fmul_rn(n.y, wf.y));
        hv.u[i] = pack(__fadd_rn(m.x, bf.x), __fadd_rn(m.y, bf.y));
      }
      store_piece(h_out + base + p * kPiece, hv);
    }
  }
}

template <int kPieces>
int launch(const bf16* x, const bf16* delta, const float* w, const float* b, bf16* s, bf16* h, int64_t rows, int d,
           float eps, cudaStream_t stream) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, add_layernorm_kernel<kPieces>, kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t blocks = (rows + kWarps - 1) / kWarps;
  const int64_t wave = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  const unsigned grid = static_cast<unsigned>(blocks < wave ? blocks : wave);
  add_layernorm_kernel<kPieces><<<grid, kThreads, 0, stream>>>(x, delta, w, b, s, h, rows, d, eps);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// x, delta (may be null), s (may be null; null when delta is), h: (rows, d)
// bf16, contiguous, 16-byte aligned; w, b: (d,) fp32, 16-byte aligned.
// Writes s = x + delta where delta is given, and h = LayerNorm(s).
extern "C" int add_layernorm_forward(const void* x, const void* delta, const void* w, const void* b, void* s,
                                     void* h, int64_t rows, int d, float eps, void* stream) {
  if (rows <= 0 || d < kPiece || d > kMaxWidth || d % kPiece != 0 || (delta == nullptr) != (s == nullptr) ||
      !aligned16(x) || !aligned16(delta) || !aligned16(w) || !aligned16(b) || !aligned16(s) || !aligned16(h))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* xb = static_cast<const bf16*>(x);
  const auto* db = static_cast<const bf16*>(delta);
  const auto* wf = static_cast<const float*>(w);
  const auto* bf = static_cast<const float*>(b);
  auto* sb = static_cast<bf16*>(s);
  auto* hb = static_cast<bf16*>(h);
  auto* st = static_cast<cudaStream_t>(stream);
  switch ((d / kPiece + 31) / 32) {
    case 1: return launch<1>(xb, db, wf, bf, sb, hb, rows, d, eps, st);
    case 2: return launch<2>(xb, db, wf, bf, sb, hb, rows, d, eps, st);
    case 3: return launch<3>(xb, db, wf, bf, sb, hb, rows, d, eps, st);
    case 4: return launch<4>(xb, db, wf, bf, sb, hb, rows, d, eps, st);
    case 5: return launch<5>(xb, db, wf, bf, sb, hb, rows, d, eps, st);
    case 6: return launch<6>(xb, db, wf, bf, sb, hb, rows, d, eps, st);
    case 7: return launch<7>(xb, db, wf, bf, sb, hb, rows, d, eps, st);
    default: return launch<kMaxPieces>(xb, db, wf, bf, sb, hb, rows, d, eps, st);
  }
}
