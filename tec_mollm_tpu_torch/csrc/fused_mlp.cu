// Fused GPT-2 MLP residual branch, forward: the Hopper port of the Pallas kernel
// tec_mollm_tpu/ops/fused_mlp.py:_fused_forward (_kernel).
//
//   out = x + c_proj(gelu_tanh(c_fc(LN(x))))      x: (rows, d) bf16
//
// with two-pass fp32 LayerNorm statistics, the LN output cast to bf16, fp32
// accumulation in both products, and the GELU output cast to bf16 before the
// second product, as in the Pallas body.
//
// Bound on this card: operations. 4 * rows * d * dh FLOP (two products) at
// 989 TFLOP/s, 0.674 ms for the flagship eval batch (rows 70656, d 768, dh 3072),
// against ~0.2 GB of compulsory traffic. Only wgmma reaches the tensor cores'
// full rate on Hopper, so both products run on wgmma, fed by TMA.
//
// Design: three launches in one call.
//   1. layer_norm_kernel: one warp a row, two-pass fp32 statistics, the row held
//      in registers, 16-byte loads and stores; writes x_norm (rows, d) bf16.
//      The alternative, normalising each row block into wgmma's swizzled A
//      layout inside GEMM1, could save at most this pass (measured 0.074 ms of
//      the 1.43 ms call on the H100 at the flagship shape, PERF.md) and would
//      make GEMM1 a second kernel with a 64-row tile beside a resident panel,
//      which reuses each B stage over half as many rows; so the pass stays.
//   2. gemm_kernel<kGelu>:     hidden = bf16(gelu_tanh(x_norm @ w1 + b1))
//   3. gemm_kernel<kResidual>: out = bf16(x + (hidden @ w2 + b2))
// The GEMM is persistent and warp-specialised: one block of 3 warpgroups on
// each SM walks over 128 x BN output tiles (BN = 256 where N allows, else 128),
// n fastest, so the tiles in flight share their A rows in L2. Warpgroup 0 is
// the producer: one thread issues the TMA loads of A (128 x 64, K-major) and B
// (64 x BN of the (in, out) weight, N-major, in 64-column boxes) into a ring of
// stages (3 at BN = 256, 6 at 128) with 128-byte swizzle, signalling a "full"
// mbarrier with the bytes landed. Warpgroups 1 and 2 each own 64 rows of the
// tile: they wait on "full", issue 4 wgmma.m64nBNk16 per stage (A K-major, B
// N-major through the transpose bit, so the weights need no transposed copy),
// keep one wgmma group in flight, and release a stage to the producer through
// its "empty" mbarrier once the group that read it has completed. setmaxnreg
// moves registers from the producer (40) to the consumers (232), which hold
// the 64 x BN fp32 accumulator (128 registers at BN = 256). The epilogue adds
// the fp32 bias and applies tanh-GELU (GEMM1) or adds the bias and the bf16
// residual (GEMM2) in fp32, writes bf16 pairs into a swizzled shared staging
// tile, and one thread hands it to a TMA store, which runs while the warpgroup
// starts its next tile (direct stores from the fragments cost GEMM1 0.79 ms
// against 0.55 ms this way, PERF.md). Rows >= M are read as zeros by TMA and
// clipped by the store. The (rows, dh) hidden tensor goes through device
// memory (0.43 GB written and read at the flagship shape); the producer keeps
// loading the next tile's stages during an epilogue, and the stores drain
// behind the next mainloop.
#include <cstdint>

#include <cuda.h>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ------------------------------------------------------------ LayerNorm pass

constexpr int kLnWarps = 8;

// CPL = ceil(d / 256) 16-byte chunks of the row a lane holds in registers
template <int CPL>
__global__ void __launch_bounds__(kLnWarps * 32)
    layer_norm_kernel(const bf16* __restrict__ x, const float* __restrict__ ln_w,
                      const float* __restrict__ ln_b, bf16* __restrict__ y, int64_t rows, int d,
                      float eps) {
  const int lane = threadIdx.x & 31;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kLnWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warps
  const int chunks = d / 8;
  const bf16* src = x + row * d;
  float v[CPL][8];
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    const int col = (lane + 32 * c) * 8;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (lane + 32 * c < chunks) raw = *reinterpret_cast<const uint4*>(src + col);
    const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      v[c][i] = __bfloat162float(e[i]);
      s += v[c][i];
    }
  }
  const float mean = tec::warp_sum(s) / d;
  float q = 0.f;
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    if (lane + 32 * c >= chunks) continue;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float t = v[c][i] - mean;
      q = fmaf(t, t, q);
    }
  }
  const float rstd = rsqrtf(tec::warp_sum(q) / d + eps);
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    if (lane + 32 * c >= chunks) continue;
    const int col = (lane + 32 * c) * 8;
    const float4 w0 = *reinterpret_cast<const float4*>(ln_w + col);
    const float4 w1 = *reinterpret_cast<const float4*>(ln_w + col + 4);
    const float4 b0 = *reinterpret_cast<const float4*>(ln_b + col);
    const float4 b1 = *reinterpret_cast<const float4*>(ln_b + col + 4);
    const float w[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
    uint4 raw;
    bf16* e = reinterpret_cast<bf16*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) e[i] = __float2bfloat16(fmaf((v[c][i] - mean) * rstd, w[i], b[i]));
    *reinterpret_cast<uint4*>(y + row * d + col) = raw;
  }
}

template <int CPL>
cudaError_t launch_layer_norm(const bf16* x, const float* ln_w, const float* ln_b, bf16* y,
                              int64_t rows, int d, float eps, cudaStream_t stream) {
  layer_norm_kernel<CPL><<<static_cast<unsigned>((rows + kLnWarps - 1) / kLnWarps), kLnWarps * 32, 0,
                           stream>>>(x, ln_w, ln_b, y, rows, d, eps);
  return cudaGetLastError();
}

cudaError_t layer_norm(const bf16* x, const float* ln_w, const float* ln_b, bf16* y, int64_t rows,
                       int d, float eps, cudaStream_t s) {
  switch ((d + 255) / 256) {
    case 1: return launch_layer_norm<1>(x, ln_w, ln_b, y, rows, d, eps, s);
    case 2: return launch_layer_norm<2>(x, ln_w, ln_b, y, rows, d, eps, s);
    case 3: return launch_layer_norm<3>(x, ln_w, ln_b, y, rows, d, eps, s);
    case 4: return launch_layer_norm<4>(x, ln_w, ln_b, y, rows, d, eps, s);
    case 5: return launch_layer_norm<5>(x, ln_w, ln_b, y, rows, d, eps, s);
    case 6: return launch_layer_norm<6>(x, ln_w, ln_b, y, rows, d, eps, s);
    default: return cudaErrorInvalidValue;
  }
}

// ------------------------------------------------------------ Hopper primitives

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

// 2-d TMA load of the box at (inner, outer) into shared memory, completing on bar
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int inner, int outer) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(inner), "r"(outer)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile: start address,
// leading and stride byte offsets (16-byte units), layout type 1 (128B swizzle)
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accumulator reads or writes across a wgmma
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// acc (64 x 256 fp32 fragment) += A (64 x 16, smem, K-major) * B (16 x 256, smem, N-major)
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "
      "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, "
      "%82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
      "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, "
      "%124, %125, %126, %127},  "
      "%128, %129, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]),
        "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),
        "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]),
        "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]),
        "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// acc (64 x 128 fp32 fragment) += A (64 x 16, smem, K-major) * B (16 x 128, smem, N-major)
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},  "
      "%64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ float gelu_tanh(float v) {
  const float k0 = 0.7978845608028654f;  // sqrt(2 / pi)
  float t;
  asm("tanh.approx.f32 %0, %1;\n" : "=f"(t) : "f"(k0 * (v + 0.044715f * v * v * v)));
  return 0.5f * v * (1.f + t);
}

constexpr int kGelu = 0;      // GEMM1 epilogue: + b1, tanh-GELU
constexpr int kResidual = 1;  // GEMM2 epilogue: + b2, + x

constexpr int kBM = 128;  // tile rows: 64 per consumer warpgroup
constexpr int kBK = 64;   // depth of a stage: one 128-byte swizzle row of bf16
constexpr int kGemmThreads = 384;
// a block's dynamic shared memory (232,448 bytes on Hopper), less 1 KB to align
// the ring to the 1024-byte swizzle atom and room for the barriers
constexpr uint32_t kSmemBudget = 232448 - 1024 - 256;

template <int BN>
struct GemmShape {
  static constexpr uint32_t kABytes = kBM * kBK * 2;
  static constexpr uint32_t kBox = 64 * 64 * 2;  // a 64 x 64 bf16 box: B in the ring, C in staging
  static constexpr uint32_t kStageBytes = kABytes + (BN / 64) * kBox;
  // the output staging of the two consumer warpgroups, 64 x BN each
  static constexpr uint32_t kOutBytes = 2 * (BN / 64) * kBox;
  static constexpr int kStages = (kSmemBudget - kOutBytes) / kStageBytes;
  static constexpr size_t kSmem =
      1024 + static_cast<size_t>(kStages) * kStageBytes + kOutBytes + 16 * kStages;
};

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// 2-d TMA store of a shared-memory box to (inner, outer); rows past the end
// are not written
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, uint32_t src, int inner,
                                             int outer) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(src), "r"(inner), "r"(outer)
               : "memory");
}

template <int BN>
__device__ __forceinline__ void wgmma_tile(float (&d)[BN / 2], uint64_t da, uint64_t db) {
  if constexpr (BN == 256)
    wgmma_m64n256k16(d, da, db);
  else
    wgmma_m64n128k16(d, da, db);
}

template <int BN, int EPI>
__global__ void __launch_bounds__(kGemmThreads, 1)
    gemm_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
                const __grid_constant__ CUtensorMap map_c, const float* __restrict__ bias,
                const bf16* __restrict__ resid, int m, int n, int k) {
  using G = GemmShape<BN>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t out_stage = ring + G::kStages * G::kStageBytes;
  const uint32_t bars = out_stage + G::kOutBytes;
  auto full_bar = [&](int s) { return bars + 8u * s; };
  auto empty_bar = [&](int s) { return bars + 8u * (G::kStages + s); };
  const int tid = threadIdx.x, wg = tid / 128;
  const int tiles_n = n / BN;
  const int tiles = ((m + kBM - 1) / kBM) * tiles_n;
  const int nk = k / kBK;

  if (tid == 0) {
    for (int s = 0; s < G::kStages; ++s) {
      mbar_init(full_bar(s), 1);        // the producer's expect_tx; TMA completes the bytes
      mbar_init(empty_bar(s), 2 * 128);  // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile / tiles_n) * kBM, n0 = (tile % tiles_n) * BN;
        for (int kb = 0; kb < nk; ++kb) {
          mbar_wait(empty_bar(stage), phase ^ 1);
          const uint32_t dst = ring + stage * G::kStageBytes;
          mbar_expect_tx(full_bar(stage), G::kStageBytes);
          tma_load_2d(dst, &map_a, full_bar(stage), kb * kBK, m0);
#pragma unroll
          for (int j = 0; j < BN / 64; ++j)
            tma_load_2d(dst + G::kABytes + j * G::kBox, &map_b, full_bar(stage), n0 + 64 * j, kb * kBK);
          if (++stage == G::kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ---- consumers: warpgroup 1 takes tile rows 0..63, warpgroup 2 rows 64..127
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int warp = (tid / 32) % 4, lane = tid & 31;
    const uint32_t a_off = (wg - 1) * 64 * 128;  // 64 rows of 128 bytes
    float acc[BN / 2];
    int stage = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = (tile / tiles_n) * kBM, n0 = (tile % tiles_n) * BN;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
      fence_regs(acc);
      int prev = 0;
      for (int kb = 0; kb < nk; ++kb) {
        mbar_wait(full_bar(stage), phase);
        const uint32_t sa = ring + stage * G::kStageBytes + a_off;
        const uint32_t sb = ring + stage * G::kStageBytes + G::kABytes;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          // A: K-major, 8-row groups 1024 bytes apart, k16 steps 32 bytes along the row;
          // B: N-major, 64-column boxes kBox apart, 8-row groups 1024 bytes apart,
          // k16 steps 16 rows of 128 bytes
          wgmma_tile<BN>(acc, wgmma_desc(sa + kk * 32, 16, 1024),
                         wgmma_desc(sb + kk * 2048, G::kBox, 1024));
        }
        wgmma_commit();
        wgmma_wait<1>();  // the group before this one is done: release its stage
        if (kb > 0) mbar_arrive(empty_bar(prev));
        prev = stage;
        if (++stage == G::kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      mbar_arrive(empty_bar(prev));
      fence_regs(acc);

      // epilogue: fragment (j, e) is row 16*warp + lane/4 + 8*(e/2), column 8j + 2*(lane%4) + e%2
      const int rt = warp * 16 + (lane >> 2);  // row within this warpgroup's 64
      const int row_a = m0 + (wg - 1) * 64 + rt;
      const uint32_t out_wg = out_stage + (wg - 1) * (BN / 64) * G::kBox;
      // the previous tile's store has read the staging buffer before it is rewritten
      if (tid % 128 == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      named_sync(wg, 128);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * (lane & 3);
        const float2 bb = *reinterpret_cast<const float2*>(bias + col);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = row_a + 8 * half;
          float v0 = acc[4 * j + 2 * half] + bb.x, v1 = acc[4 * j + 2 * half + 1] + bb.y;
          if constexpr (EPI == kGelu) {
            v0 = gelu_tanh(v0);
            v1 = gelu_tanh(v1);
          } else if (row < m) {
            const __nv_bfloat162 r =
                *reinterpret_cast<const __nv_bfloat162*>(resid + static_cast<int64_t>(row) * n + col);
            v0 += __low2float(r);
            v1 += __high2float(r);
          }
          // bf16 pair into the 128-byte-swizzled staging box j / 8, 16-byte chunk
          // (j % 8) ^ (row % 8): the layout the TMA store reads, free of bank conflicts
          const __nv_bfloat162 packed = __floats2bfloat162_rn(v0, v1);
          const int r = rt + 8 * half;
          const uint32_t dst =
              out_wg + (j / 8) * G::kBox + r * 128 + (((j % 8) ^ (r % 8)) * 16) + (lane & 3) * 4;
          asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(dst),
                       "r"(*reinterpret_cast<const uint32_t*>(&packed))
                       : "memory");
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to TMA
      named_sync(wg, 128);
      if (tid % 128 == 0) {  // rows past M are clipped by the store
#pragma unroll
        for (int box = 0; box < BN / 64; ++box)
          tma_store_2d(&map_c, out_wg + box * G::kBox, n0 + 64 * box, m0 + (wg - 1) * 64);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }
    }
    // the last stores have read the staging buffer before the block's shared memory goes
    if (tid % 128 == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

// ------------------------------------------------------------ host side

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, reached through the runtime so that
// the library needs no -lcuda
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
#if CUDART_VERSION >= 12050
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q) !=
            cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault) != cudaSuccess)
      p = nullptr;
#endif
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// TMA map of a row-major (rows, cols) bf16 matrix, boxes of 64 columns (128
// bytes, the swizzle width) by box_rows rows, 128-byte swizzle; rows and columns
// past the end read as zeros
bool make_map(CUtensorMap* map, const void* ptr, uint64_t rows, uint64_t cols, uint32_t box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * sizeof(bf16)};
  const cuuint32_t box[2] = {64, box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides, box,
                elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// c (m, n) = epilogue(a (m, k) @ b (k, n)), all row-major bf16
template <int BN, int EPI>
cudaError_t launch_gemm(const void* a, const void* b, const float* bias, const bf16* resid,
                        bf16* c, int m, int n, int k, cudaStream_t stream) {
  using G = GemmShape<BN>;
  CUtensorMap map_a, map_b, map_c;
  if (!make_map(&map_a, a, m, k, kBM) || !make_map(&map_b, b, k, n, kBK) ||
      !make_map(&map_c, c, m, n, 64))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(gemm_kernel<BN, EPI>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(G::kSmem));
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  const int64_t tiles = (static_cast<int64_t>(m) + kBM - 1) / kBM * (n / BN);
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  gemm_kernel<BN, EPI><<<grid, kGemmThreads, G::kSmem, stream>>>(
      map_a, map_b, map_c, bias, resid, m, n, k);
  return cudaGetLastError();
}

template <int EPI>
cudaError_t gemm(const void* a, const void* b, const float* bias, const bf16* resid, bf16* c,
                 int m, int n, int k, cudaStream_t stream) {
  return n % 256 == 0 ? launch_gemm<256, EPI>(a, b, bias, resid, c, m, n, k, stream)
                      : launch_gemm<128, EPI>(a, b, bias, resid, c, m, n, k, stream);
}

}  // namespace

// x, out: (rows, d) bf16 contiguous; x_norm: (rows, d) and hidden: (rows, dh)
// bf16 scratch; w1: (d, dh) and w2: (dh, d) bf16 row-major (the (in, out)
// layout of GPT-2's Conv1D); ln_w, ln_b: d fp32; b1: dh fp32; b2: d fp32. d and
// dh multiples of 128, d <= 1536 (the LN pass holds a row in registers);
// pointers 16-byte aligned.
extern "C" int fused_ln_mlp_forward(const void* x, const void* ln_w, const void* ln_b,
                                    const void* w1, const void* b1, const void* w2,
                                    const void* b2, void* x_norm, void* hidden, void* out,
                                    int64_t rows, int d, int dh, float eps, void* stream) {
  if (d % 128 != 0 || dh % 128 != 0 || d > 1536 || rows <= 0 || rows > 0x7fffff00LL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xp = static_cast<const bf16*>(x);
  bf16* xn = static_cast<bf16*>(x_norm);
  bf16* hp = static_cast<bf16*>(hidden);
  const int m = static_cast<int>(rows);
  cudaError_t err = layer_norm(xp, static_cast<const float*>(ln_w), static_cast<const float*>(ln_b),
                               xn, rows, d, eps, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = gemm<kGelu>(xn, w1, static_cast<const float*>(b1), nullptr, hp, m, dh, d, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = gemm<kResidual>(hp, w2, static_cast<const float*>(b2), xp, static_cast<bf16*>(out), m, d,
                        dh, s);
  return static_cast<int>(err);
}
