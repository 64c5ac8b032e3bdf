// The temporal encoder's two multi-scale conv blocks in one kernel, for eval
// calls (models/temporal.py: TemporalEncoder's conv embedder, its default
// unfused MultiScaleConvBlock pair).
//
// It replaces no TPU kernel: the JAX package leaves this block to XLA. It was
// added because the unfused block's round trips through device memory (each
// branch's conv output, its bias pass, the fp32 copy GroupNorm reads, the bf16
// cast back, GELU, two cats) were the largest share of the eval pass that is
// not a GEMM. Per sequence of 48 steps and 22 channels:
//
//   block 1: h_j = conv_{k_j}(x) + b_j over 64 channels, k_j = 3, 5, 7, SAME;
//            a_j = GELU(GroupNorm_1(h_j)) at the even steps only (the steps the
//            stride-2 1x1 conv reads); y1 = sum_j F1_j a_j + f1 (64 x 24)
//   block 2: the same on y1: 64 -> 3 x 128 channels, 24 -> 12 steps; the
//            output (12, 128) position-major, so the patcher reshapes it.
//
// GroupNorm (one group, eps 1e-5) takes fp32 statistics of each (sequence,
// branch) over all its steps, in two passes over the values in registers
// (mean, then the mean square deviation); GELU is the exact erf form. Products
// take bf16 operands and accumulate in fp32 with the conv bias in the
// accumulator; the activations a_j, y1 and the output are rounded to bf16.
// ops/temporal_conv.py:temporal_conv_mirror is this arithmetic in PyTorch.
//
// Bound on this card: operations. At the flagship eval batch (16 windows x
// 2,944 padded nodes = 47,104 sequences) the convolutions and 1x1 convs are
// 457 GFLOP, 0.46 ms at the bf16 tensor cores' 989 TFLOP/s, against 0.073 ms
// for the bytes that must move (the 22-channel input read once, the 12 x 128
// output written once: 244 MB). Nothing between the two blocks touches device
// memory.
//
// Design. A block owns 8 sequences, one a warp, and keeps every intermediate
// of a sequence in its warp's registers and its own slice of shared memory:
// the convolutions run as mma.sync.m16n8k16 products with the output
// channels as rows and the steps as columns, so a branch's whole (channels x
// steps) tile (64 x 48, then 128 x 24) sits in the warp's accumulators and
// its GroupNorm needs only warp shuffles. The input of a convolution is read
// as a Toeplitz view: with the channels of a step contiguous, the window of
// step p over all taps is one contiguous run from row p, so ldmatrix reads
// the im2col matrix without building it (block 1's 22 channels padded to 24,
// 48-byte rows; block 2's 64-channel rows XOR-swizzled). Each branch runs
// over its own taps (15 of the 21 a zero-padded stack of the three kernels
// would take). The branches' activations go to shared memory, and each
// block's 1x1 conv is one product over all three.
//
// Only the weights are shared by the warps. They do not fit in shared memory
// together (465 KB in bf16), so they stream in 25 chunks (a branch's kernel
// or one tap of it, a slice of a 1x1 conv) through a ring of 3 slots, each
// chunk one bulk copy (TMA) from L2, where every block reads them. A ninth
// warp issues the copies: a chunk's slot is refilled as soon as the 8 warps
// have released it (full and empty mbarriers), so no warp waits on another
// to finish a product. To keep the tensor cores fed beside the GroupNorm and
// GELU passes, which run on the FMA and special-function units, the second
// half of the warps starts half a branch behind the first (one warp of each
// half on each scheduler); and every phase is a loop over the branches, not
// an unrolled copy per branch: each runs once a block, and a straight-line
// copy would be fetched from L2 anew every time.
// ldmatrix rows are padded or swizzled so that no read conflicts on a bank.
#include <cmath>
#include <cstdint>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 8;  // one sequence a consumer warp
constexpr int kThreads = (kWarps + 1) * 32;  // and the producer warp
constexpr int kL = 48;     // input steps
constexpr int kCp = 24;    // input channels, padded (the model has 22)
constexpr int kC1 = 64;    // block 1's channels
constexpr int kC2 = 128;   // block 2's channels
constexpr int kL2 = kL / 2;
constexpr int kL3 = kL2 / 2;
constexpr int kBranches = 3;  // branch j has 2j + 3 taps and pads j + 1 steps
constexpr float kEps = 1e-5f;

__host__ __device__ constexpr int taps(int j) { return 2 * j + 3; }
// block 1 kernel rows: taps x 24 channels rounded up to the product's depth,
// plus 8 elements so that consecutive rows start on distinct banks
__host__ __device__ constexpr int k1(int j) { return (taps(j) * kCp + 15) / 16 * 16; }
__host__ __device__ constexpr int ld1(int j) { return k1(j) + 8; }
constexpr int kLdF1 = kBranches * kC1 + 8;  // block 1's 1x1 conv: 64 x (192 + 8)
constexpr int kLdW = kC1 + 8;               // rows of 64 input channels: 144 bytes

// The weight stream: block 1's branch kernels (64 x ld1(j)), its whole 1x1
// conv (64 x 200); block 2's taps branch by branch (128 x 72 each), then its
// 1x1 conv in six slices of 64 input channels (128 x 72 each).
// ops/temporal_conv.py:chunk_shapes packs the same layout.
constexpr int kF1Chunk = kBranches;
constexpr int kW2Chunk = kF1Chunk + 1;
constexpr int kF2Chunk = kW2Chunk + taps(0) + taps(1) + taps(2);
constexpr int kF2Slices = kBranches * kC2 / kC1;
constexpr int kChunks = kF2Chunk + kF2Slices;
__host__ __device__ constexpr int chunk_bytes(int c) {
  return c < kF1Chunk ? kC1 * ld1(c) * 2 : c == kF1Chunk ? kC1 * kLdF1 * 2 : kC2 * kLdW * 2;
}
__host__ __device__ constexpr int chunk_offset(int c) {
  const int head = c < kW2Chunk ? c : kW2Chunk;  // block 2's chunks are all one size
  int off = (c - head) * chunk_bytes(kW2Chunk);
  for (int i = 0; i < head; ++i) off += chunk_bytes(i);
  return off;
}
__host__ __device__ constexpr int w2_first_chunk(int j) {
  int c = kW2Chunk;
  for (int i = 0; i < j; ++i) c += taps(i);
  return c;
}
constexpr int cmax(int a, int b) { return a > b ? a : b; }
constexpr int kWeightBytes = chunk_offset(kChunks);
constexpr int kSlotBytes = cmax(cmax(kC1 * ld1(kBranches - 1), kC1 * kLdF1), kC2 * kLdW) * 2;
constexpr int kStages = 3;

// fp32 parameters (1,920): conv biases, GroupNorm scales and shifts, 1x1 biases
constexpr int kPB1 = 0, kPG1 = 192, kPE1 = 384, kPF1 = 576;
constexpr int kPB2 = 640, kPG2 = 1024, kPE2 = 1408, kPF2 = 1792;

// A warp's shared memory. Region X holds the input (55 rows of 24 channels:
// 3 zero rows each side and the rows the widest product's depth runs past)
// in block 1, then block 2's activations (12 x (384 + 8)), then the output
// rows (12 x 136); region Y holds block 1's activations (24 x (192 + 8)),
// then y1 (30 rows of 64 channels, swizzled, 3 zero rows each side).
constexpr int kXsRows = kL + 7;
constexpr int kLdA1 = kBranches * kC1 + 8;
constexpr int kLdA2 = kBranches * kC2 + 8;
constexpr int kLdOut = kC2 + 8;
constexpr int kY1Rows = kL2 + 6;
constexpr int kRegionX = cmax(cmax(kXsRows * kCp, kL3 * kLdA2), kL3 * kLdOut) * 2;
constexpr int kRegionY = cmax(kL2 * kLdA1, kY1Rows * kC1) * 2;
constexpr int kWarpBytes = kRegionX + kRegionY;
constexpr int kBarrierBytes = 2 * kStages * 8;  // the ring's full and empty mbarriers
constexpr int kSmemBytes = kStages * kSlotBytes + kWarps * kWarpBytes + kBarrierBytes;
static_assert(kRegionX % 16 == 0 && kRegionY % 16 == 0 && kSlotBytes % 16 == 0, "16-byte regions");
static_assert(kSmemBytes <= 227 * 1024, "shared memory of one block");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// Wait until the barrier's phase with the given parity has completed. A phase
// that never completes (a fault in the ring's bookkeeping) traps after about
// 2^35 cycles (~20 s) instead of holding the card forever.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long start = clock64();
  uint32_t done = 0;
  while (!done) {
    if (clock64() - start > (1ll << 35)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}
// one bulk copy (TMA, 1-d) of `bytes` into shared memory, completing on bar
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
               ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
               : "memory");
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}
// d += a * b on a 16x8x16 bf16 tile, fp32 accumulation
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x and 1/x on the special function unit, denormals flushed (their
// arguments here are never denormal; a result that would be is read as 0)
__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float rcp_ftz(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// erfc(z) / 2 for z >= 0 within 1.2e-7 of its value, with no branch: the
// Chebyshev fit of Numerical Recipes' erfcc, erfc(z) = t exp(P(t) - z^2)
// with t = 1 / (1 + z / 2), its coefficients here scaled to base 2 and the
// halving folded into the constant. (CUDA's erff branches on |x| < 1, and a
// warp of GroupNorm outputs takes both sides.)
__device__ __forceinline__ float half_erfc(float z) {
  const float t = rcp_ftz(fmaf(0.5f, z, 1.f));
  float p = fmaf(t, 0.246517298f, -1.18611495f);
  p = fmaf(t, p, 2.14747446f);
  p = fmaf(t, p, -1.63775315f);
  p = fmaf(t, p, 0.402321582f);
  p = fmaf(t, p, -0.26875686f);
  p = fmaf(t, p, 0.139630057f);
  p = fmaf(t, p, 0.539700616f);
  p = fmaf(t, p, 1.4427292f);
  p = fmaf(t, p, -2.82574822f);
  return t * ex2_ftz(fmaf(z * -1.44269504f, z, p));
}

// the exact GELU, y * Phi(y) with Phi(y) = erfc(-y / sqrt 2) / 2
__device__ __forceinline__ float gelu(float y) {
  const float tail = y * half_erfc(fabsf(y) * 0.70710678f);
  return y >= 0.f ? y - tail : tail;
}

// y1's element (row, channel): 128-byte rows whose 16-byte chunks are
// permuted by the row, so that 8 consecutive rows read by ldmatrix hit
// distinct banks
__device__ __forceinline__ int y1_at(int row, int c) {
  return row * kC1 + (((c >> 3) ^ (row & 7)) << 3) + (c & 7);
}

// The weight stream through the ring: chunk c lands in slot c % kStages. The
// producer thread loads it by one bulk copy once every consumer warp has
// released the chunk kStages before it; each consumer warp waits for it,
// reads it, and releases it.
struct Ring {
  uint8_t* slots;
  uint32_t full, empty;  // shared addresses of the kStages full and empty barriers

  __device__ __forceinline__ void produce(const uint8_t* src) const {
    for (int c = 0; c < kChunks; ++c) {
      const int s = c % kStages;
      if (c >= kStages) mbar_wait(empty + 8 * s, ((c / kStages) - 1) & 1);
      mbar_expect_tx(full + 8 * s, chunk_bytes(c));
      bulk_load(smem_u32(slots + s * kSlotBytes), src + chunk_offset(c), chunk_bytes(c), full + 8 * s);
    }
  }
  __device__ __forceinline__ const bf16* acquire(int c) const {
    mbar_wait(full + 8 * (c % kStages), (c / kStages) & 1);
    return reinterpret_cast<const bf16*>(slots + (c % kStages) * kSlotBytes);
  }
  __device__ __forceinline__ void release(int c, int lane) const {
    __syncwarp();  // every lane's reads of the slot are done
    if (lane == 0) mbar_arrive(empty + 8 * (c % kStages));
  }
};

// Mean and 1/sqrt(var + eps) of a warp's (16 MT x 8 NT) accumulator tile, in
// two passes.
// two passes; each a thread's values in 4 independent sums, then the warp's.
template <int MT, int NT>
__device__ __forceinline__ void group_stats(const float (&acc)[MT][NT][4], float& mean, float& rstd) {
  constexpr float inv = 1.f / (MT * 16 * NT * 8);
  float s[4] = {};
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[i] += acc[m][n][i];
  mean = tec::warp_sum((s[0] + s[1]) + (s[2] + s[3])) * inv;
  float v[4] = {};
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float d = acc[m][n][i] - mean;
        v[i] = fmaf(d, d, v[i]);
      }
  rstd = rsqrtf(tec::warp_sum((v[0] + v[1]) + (v[2] + v[3])) * inv + kEps);
}

// GroupNorm's affine and GELU at the even steps of a (16 MT x 8 NT) tile,
// channels as rows and steps as columns, written as act[step / 2][channel]
// in bf16. A thread's even step is column 2q of each n-tile.
template <int MT, int NT, int LD>
__device__ __forceinline__ void gn_gelu_even(const float (&acc)[MT][NT][4], const float* gamma,
                                             const float* beta, bf16* act, int lane) {
  float mean, rstd;
  group_stats(acc, mean, rstd);
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int c = m * 16 + g;  // and c + 8
    const float scale0 = rstd * __ldg(gamma + c), scale1 = rstd * __ldg(gamma + c + 8);
    const float shift0 = __ldg(beta + c) - mean * scale0, shift1 = __ldg(beta + c + 8) - mean * scale1;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      // one conversion for the two values, stored as two halves
      const __nv_bfloat162 v = __floats2bfloat162_rn(gelu(fmaf(acc[m][n][0], scale0, shift0)),
                                                     gelu(fmaf(acc[m][n][2], scale1, shift1)));
      act[(4 * n + q) * LD + c] = v.x;
      act[(4 * n + q) * LD + c + 8] = v.y;
    }
  }
}

// Accumulators of a (16 MT x 8 NT) tile set to the bias of their row
template <int MT, int NT>
__device__ __forceinline__ void init_bias(float (&acc)[MT][NT][4], const float* bias, int lane) {
  const int g = lane >> 2;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const float lo = __ldg(bias + m * 16 + g), hi = __ldg(bias + m * 16 + g + 8);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      acc[m][n][0] = acc[m][n][1] = lo;
      acc[m][n][2] = acc[m][n][3] = hi;
    }
  }
}

// o[co][n] += W[co][k] act[n][k] over KS k-steps of 16: W a (16 MT x LDW)
// chunk, act rows of LDA elements from column k0, n-tiles NT (rows past
// `last` read row `last`)
template <int MT, int NT, int LDW, int LDA, int KS>
__device__ __forceinline__ void product_1x1(float (&o)[MT][NT][4], const bf16* w, const bf16* act,
                                            int k0, int last, int lane) {
  const bf16* arow = w + (lane & 15) * LDW + (lane >> 4) * 8;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    uint32_t b[NT][2];
#pragma unroll
    for (int n = 0; n < NT; n += 2) {
      if (n + 1 < NT) {
        const int row = min(8 * (n + (lane >> 4)) + (lane & 7), last);
        uint32_t r[4];
        ldmatrix_x4(r, act + row * LDA + k0 + ks * 16 + ((lane >> 3) & 1) * 8);
        b[n][0] = r[0], b[n][1] = r[1], b[n + 1][0] = r[2], b[n + 1][1] = r[3];
      } else {
        const int row = min(8 * n + (lane & 7), last);
        uint32_t r[2];
        ldmatrix_x2(r, act + row * LDA + k0 + ks * 16 + ((lane >> 3) & 1) * 8);
        b[n][0] = r[0], b[n][1] = r[1];
      }
    }
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      uint32_t a[4];
      ldmatrix_x4(a, arow + m * 16 * LDW + ks * 16);
#pragma unroll
      for (int n = 0; n < NT; ++n) mma_bf16(o[m][n], a, b[n][0], b[n][1]);
    }
  }
}

// Block 1's branches, one after the other (chunk j each): convolution,
// GroupNorm and GELU into columns 64 j .. 64 j + 63 of act. The branches run
// one copy of the code (a loop, not an unrolled template per branch): every
// phase of the kernel runs once a tile, and straight-line copies would be
// fetched from L2 anew each time.
__device__ __forceinline__ void block1(const Ring& ring, const bf16* xs, bf16* act, const float* pp, int lane) {
#pragma unroll 1
  for (int j = 0; j < kBranches; ++j) {
    const int ld = ld1(j), pad = j + 1;
    const bf16* w = ring.acquire(j);
    float acc[4][6][4];
    init_bias(acc, pp + kPB1 + j * kC1, lane);
    // the Toeplitz view: step p's window starts at input row p + 3 - pad
    const bf16* brow = xs + (8 * (lane >> 4) + (lane & 7) + 3 - pad) * kCp + ((lane >> 3) & 1) * 8;
    const bf16* arow = w + (lane & 15) * ld + (lane >> 4) * 8;
#pragma unroll 1
    for (int ks = 0; ks < k1(j) / 16; ++ks) {
      uint32_t b[6][2];
#pragma unroll
      for (int n = 0; n < 6; n += 2) {
        uint32_t r[4];
        ldmatrix_x4(r, brow + n * 8 * kCp + ks * 16);
        b[n][0] = r[0], b[n][1] = r[1], b[n + 1][0] = r[2], b[n + 1][1] = r[3];
      }
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        uint32_t a[4];
        ldmatrix_x4(a, arow + m * 16 * ld + ks * 16);
#pragma unroll
        for (int n = 0; n < 6; ++n) mma_bf16(acc[m][n], a, b[n][0], b[n][1]);
      }
    }
    ring.release(j, lane);
    // the first half of the warps lets the second start: from here on their
    // products run while these warps normalise, and the other way round
    if (j == 0 && (threadIdx.x >> 5) < kWarps / 2) asm volatile("bar.arrive 1, %0;\n" ::"n"(kWarps * 32));
    gn_gelu_even<4, 6, kLdA1>(acc, pp + kPG1 + j * kC1, pp + kPE1 + j * kC1, act + j * kC1, lane);
  }
}

// Block 2's branches, one after the other: each its taps' chunks, GroupNorm
// and GELU into columns 128 j .. 128 j + 127 of act.
__device__ __forceinline__ void block2(const Ring& ring, const bf16* y1, bf16* act, const float* pp, int lane) {
#pragma unroll 1
  for (int j = 0; j < kBranches; ++j) {
    const int pad = j + 1, c0 = w2_first_chunk(j);
    float acc[8][3][4];
    init_bias(acc, pp + kPB2 + j * kC2, lane);
#pragma unroll 1
    for (int t = 0; t < taps(j); ++t) {
      const bf16* w = ring.acquire(c0 + t);
      const bf16* arow = w + (lane & 15) * kLdW + (lane >> 4) * 8;
      const int row01 = 8 * (lane >> 4) + (lane & 7) + t + 3 - pad;  // n-tiles 0 and 1
      const int row2 = 16 + (lane & 7) + t + 3 - pad;               // n-tile 2
      const int khalf = (lane >> 3) & 1;
#pragma unroll
      for (int ks = 0; ks < kC1 / 16; ++ks) {
        uint32_t b[3][2];
        {
          uint32_t r[4];
          ldmatrix_x4(r, y1 + y1_at(row01, (2 * ks + khalf) * 8));
          b[0][0] = r[0], b[0][1] = r[1], b[1][0] = r[2], b[1][1] = r[3];
        }
        {
          uint32_t r[2];
          ldmatrix_x2(r, y1 + y1_at(row2, (2 * ks + khalf) * 8));
          b[2][0] = r[0], b[2][1] = r[1];
        }
#pragma unroll
        for (int m = 0; m < 8; ++m) {
          uint32_t a[4];
          ldmatrix_x4(a, arow + m * 16 * kLdW + ks * 16);
#pragma unroll
          for (int n = 0; n < 3; ++n) mma_bf16(acc[m][n], a, b[n][0], b[n][1]);
        }
      }
      ring.release(c0 + t, lane);
    }
    gn_gelu_even<8, 3, kLdA2>(acc, pp + kPG2 + j * kC2, pp + kPE2 + j * kC2, act + j * kC2, lane);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    temporal_conv_kernel(const bf16* __restrict__ x, int64_t n_seq, int nodes, int64_t sb,
                         int64_t sn, int64_t sl, int cin, const uint8_t* __restrict__ wpack,
                         const float* __restrict__ pp, bf16* __restrict__ out) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  uint8_t* bars = smem + kStages * kSlotBytes + kWarps * kWarpBytes;
  const Ring ring{smem, smem_u32(bars), smem_u32(bars + 8 * kStages)};
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(ring.full + 8 * s, 1);          // the producer's expect_tx; the copy completes it
      mbar_init(ring.empty + 8 * s, kWarps);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // the last block-wide barrier: the producer warp leaves below
  if (warp == kWarps) {
    if (lane == 0) ring.produce(wpack);
    return;
  }
  uint8_t* mine = smem + kStages * kSlotBytes + warp * kWarpBytes;
  bf16* region_x = reinterpret_cast<bf16*>(mine);
  bf16* region_y = reinterpret_cast<bf16*>(mine + kRegionX);

  // this warp's sequence, step-major with 3 zero rows before and 4 after:
  // every load in flight before the first store
  const int64_t seq = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  const bool live = seq < n_seq;
  const bf16* src = x + (seq / nodes) * sb + (seq % nodes) * sn;
  const bf16 zero = __float2bfloat16(0.f);
  constexpr int kLoads = kL * kCp / 32;
  static_assert(kL * kCp % 32 == 0, "whole rounds of the warp");
  bf16 v[kLoads];
#pragma unroll
  for (int it = 0; it < kLoads; ++it) {
    const int i = lane + 32 * it, l = i / kCp, c = i - l * kCp;
    v[it] = live && c < cin ? src[l * sl + c] : zero;
  }
#pragma unroll
  for (int it = 0; it < kLoads; ++it) region_x[3 * kCp + lane + 32 * it] = v[it];
  constexpr int kZeroChunks = (kXsRows - kL) * kCp / 8;  // 16-byte chunks of the 7 zero rows
  if (lane < kZeroChunks) {
    const int i = lane * 8;  // rows 0..2, then 51..54
    *reinterpret_cast<uint4*>(region_x + (i < 3 * kCp ? i : i + kL * kCp)) = make_uint4(0, 0, 0, 0);
  }
  __syncwarp();
  // the second half of the warps starts once the first has read its first chunk
  if (warp >= kWarps / 2) asm volatile("bar.sync 1, %0;\n" ::"n"(kWarps * 32));

  bf16* act1 = region_y;
  block1(ring, region_x, act1, pp, lane);
  float o1[4][3][4] = {};
  __syncwarp();  // act1's writes before the reads
  product_1x1<4, 3, kLdF1, kLdA1, kBranches * kC1 / 16>(o1, ring.acquire(kF1Chunk), act1, 0, kL2 - 1, lane);
  ring.release(kF1Chunk, lane);

  // y1 = o1 + bias in bf16, rows 3 .. 26 of region Y (over act1)
  __syncwarp();
  bf16* y1 = region_y;
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = m * 16 + g + 8 * h;
      const float bias = __ldg(pp + kPF1 + c);
#pragma unroll
      for (int n = 0; n < 3; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          y1[y1_at(8 * n + 2 * q + e + 3, c)] = __float2bfloat16(o1[m][n][2 * h + e] + bias);
    }
  for (int i = lane; i < 6 * kC1 / 8; i += 32) {  // the zero rows 0..2 and 27..29
    const int r = i / (kC1 / 8);
    *reinterpret_cast<uint4*>(y1 + ((r < 3 ? r : r + kL2) * kC1) + (i % (kC1 / 8)) * 8) =
        make_uint4(0, 0, 0, 0);
  }
  __syncwarp();

  bf16* act2 = region_x;
  block2(ring, y1, act2, pp, lane);
  float o2[8][2][4] = {};
  __syncwarp();  // act2's writes before the reads
#pragma unroll 1
  for (int sl = 0; sl < kF2Slices; ++sl) {
    product_1x1<8, 2, kLdW, kLdA2, kC1 / 16>(o2, ring.acquire(kF2Chunk + sl), act2, sl * kC1, kL3 - 1, lane);
    ring.release(kF2Chunk + sl, lane);
  }

  // out = o2 + bias in bf16: staged as 12 rows of region X, then 16 bytes a lane
  __syncwarp();
  bf16* rows = region_x;
#pragma unroll
  for (int m = 0; m < 8; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = m * 16 + g + 8 * h;
      const float bias = __ldg(pp + kPF2 + c);
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int p = 8 * n + 2 * q + e;
          if (p < kL3) rows[p * kLdOut + c] = __float2bfloat16(o2[m][n][2 * h + e] + bias);
        }
    }
  __syncwarp();
  if (live) {
    bf16* dst = out + seq * (kL3 * kC2);
    for (int i = lane; i < kL3 * kC2 / 8; i += 32) {
      const int r = i / (kC2 / 8), c = (i % (kC2 / 8)) * 8;
      *reinterpret_cast<uint4*>(dst + r * kC2 + c) = *reinterpret_cast<const uint4*>(rows + r * kLdOut + c);
    }
  }
}

}  // namespace

// x: bf16 (B, N, 48, C_in) with unit channel stride and element strides sb,
// sn, sl; sequence s = b * N + n. wpack: the packed bf16 weights (wbytes
// bytes, 16-byte aligned); pp: the 1,920 fp32 parameters. out: (B * N, 12, 128) bf16.
extern "C" int temporal_conv_forward(const void* x, int64_t n_seq, int nodes, int64_t sb, int64_t sn,
                                     int64_t sl, int cin, const void* wpack, int64_t wbytes,
                                     const void* pp, void* out, void* stream) {
  if (n_seq <= 0 || nodes <= 0 || cin < 1 || cin > kCp || wbytes != kWeightBytes ||
      (n_seq + kWarps - 1) / kWarps > 0x7fffffffLL ||
      (reinterpret_cast<uintptr_t>(wpack) & 15) != 0 || (reinterpret_cast<uintptr_t>(out) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(temporal_conv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid = static_cast<unsigned>((n_seq + kWarps - 1) / kWarps);
  temporal_conv_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), n_seq, nodes, sb, sn, sl, cin, static_cast<const uint8_t*>(wpack),
      static_cast<const float*>(pp), static_cast<bf16*>(out));
  return static_cast<int>(cudaGetLastError());
}
