// Fused GPT-2 MLP residual branch, forward: the Hopper port of the Pallas kernel
// tec_mollm_tpu/ops/fused_mlp.py:_fused_forward (_kernel).
//
//   out = x + c_proj(gelu_tanh(c_fc(LN(x))))      x: (rows, d) bf16
//
// with two-pass fp32 LayerNorm statistics, the LN output cast to bf16, fp32
// accumulation in both products, and the GELU output cast to bf16 before the
// second product, as in the Pallas body.
//
// Design: two launches of a hand-written tensor-core GEMM (mma.sync m16n8k16
// bf16 -> fp32, fragments loaded with ldmatrix, the weight slabs streamed into
// shared memory with cp.async, double buffered).
//   1. ln_fc_gelu: a block owns BM rows. Its prologue copies those rows into a
//      shared-memory panel and normalises them in place, so LN is computed once
//      per row; the block then walks every 128-column chunk of c_fc against that
//      panel. Epilogue: + b1, tanh-GELU, bf16, written to `hidden` (rows, dh).
//   2. proj_residual: a plain 128x128-tiled GEMM of hidden @ w2 whose epilogue
//      adds b2 and the residual x and writes bf16.
// The (rows, dh) hidden tensor goes through device memory between the two
// launches; keeping it on chip (one launch, GEMM2 accumulated per row block) is
// the first thing a faster version removes. The bound at the model's shapes is
// operations: 4 * rows * d * dh multiply-adds against ~0.2 GB of traffic.
#include <cstdint>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;  // 8 warps
constexpr int kBN = 128;       // output columns per block tile
constexpr int kBK = 32;        // depth of one shared-memory slab
constexpr int kPad = 8;        // bf16 row padding: keeps ldmatrix rows on distinct banks

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  const int n = pred ? 16 : 0;  // 0 bytes read: the 16 destination bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ float gelu_tanh(float v) {
  const float k0 = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * v * (1.f + tanhf(k0 * (v + 0.044715f * v * v * v)));
}

// One warp's share of a kBK-deep slab: acc[MI][NI] (16x8 tiles) += A * B, with A
// rows [a_row0, a_row0 + 16*MI) at columns [a_k0, a_k0 + kBK) of a row-major
// shared array (leading dimension lda) and B the slab's rows 0..kBK at columns
// [b_col0, b_col0 + 8*NI) of a row-major (k, n) shared array (leading dim ldb).
template <int MI, int NI>
__device__ __forceinline__ void warp_mma_slab(float (&acc)[MI][NI][4], const bf16* as, int lda,
                                              int a_row0, int a_k0, const bf16* bs, int ldb,
                                              int b_col0, int lane) {
#pragma unroll
  for (int kk = 0; kk < kBK; kk += 16) {
    uint32_t a[MI][4];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
      ldmatrix_x4(a[mi], as + (a_row0 + mi * 16 + (lane & 15)) * lda + a_k0 + kk + (lane >> 4) * 8);
    uint32_t b[NI][2];
#pragma unroll
    for (int nj = 0; nj < NI / 2; ++nj) {
      uint32_t r[4];
      ldmatrix_x4_trans(r, bs + (kk + (lane & 15)) * ldb + b_col0 + nj * 16 + (lane >> 4) * 8);
      b[2 * nj][0] = r[0];
      b[2 * nj][1] = r[1];
      b[2 * nj + 1][0] = r[2];
      b[2 * nj + 1][1] = r[3];
    }
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) mma_bf16(acc[mi][ni], a[mi], b[ni]);
  }
}

// kBK x kBN slab of a row-major (K, ncols) weight into shared memory.
__device__ __forceinline__ void load_b_slab(bf16* bs, const bf16* w, int ncols, int k0, int n0,
                                            int tid) {
  constexpr int kChunks = kBK * kBN / 8;  // 16-byte chunks
#pragma unroll
  for (int i = tid; i < kChunks; i += kThreads) {
    const int r = i / (kBN / 8), c = (i % (kBN / 8)) * 8;
    cp_async16(bs + r * (kBN + kPad) + c, w + static_cast<int64_t>(k0 + r) * ncols + n0 + c, true);
  }
}

template <int BM>
struct Tiling {
  static constexpr int kWarpsM = BM / 32;            // each warp: 32 rows
  static constexpr int kWarpsN = 8 / kWarpsM;
  static constexpr int kWarpN = kBN / kWarpsN;       // columns per warp
  static constexpr int MI = 2;
  static constexpr int NI = kWarpN / 8;
};

// ---- launch 1: LN prologue + x_norm @ w1 + b1 -> tanh-GELU -> hidden (bf16) ----
template <int BM>
__global__ void __launch_bounds__(kThreads, 1)
    ln_fc_gelu_kernel(const bf16* __restrict__ x, const float* __restrict__ ln_w,
                      const float* __restrict__ ln_b, const bf16* __restrict__ w1,
                      const float* __restrict__ b1, bf16* __restrict__ hidden, int64_t rows,
                      int d, int dh, float eps) {
  using T = Tiling<BM>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lda = d + kPad;
  bf16* panel = reinterpret_cast<bf16*>(smem);  // (BM, d + kPad)
  bf16* bstage = panel + BM * lda;              // 2 x (kBK, kBN + kPad)
  constexpr int kStage = kBK * (kBN + kPad);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * BM;

  // prologue: the block's rows into the panel (rows past the end read as zeros)
  const int chunks_per_row = d / 8;
  for (int i = tid; i < BM * chunks_per_row; i += kThreads) {
    const int r = i / chunks_per_row, c = (i % chunks_per_row) * 8;
    const bool ok = row0 + r < rows;
    const int64_t src_row = ok ? row0 + r : 0;
    cp_async16(panel + r * lda + c, x + src_row * d + c, ok);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // two-pass fp32 LayerNorm of each row, in place (one warp per row)
  for (int r = warp; r < BM; r += kThreads / 32) {
    bf16* row = panel + r * lda;
    float s = 0.f;
    for (int c = lane; c < d; c += 32) s += __bfloat162float(row[c]);
    const float mean = tec::warp_sum(s) / d;
    float q = 0.f;
    for (int c = lane; c < d; c += 32) {
      const float v = __bfloat162float(row[c]) - mean;
      q = fmaf(v, v, q);
    }
    const float rstd = rsqrtf(tec::warp_sum(q) / d + eps);
    for (int c = lane; c < d; c += 32) {
      const float v = (__bfloat162float(row[c]) - mean) * rstd;
      row[c] = __float2bfloat16(fmaf(v, ln_w[c], ln_b[c]));
    }
  }
  __syncthreads();

  const int wm = warp / T::kWarpsN, wn = warp % T::kWarpsN;
  const int a_row0 = wm * 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int nk = d / kBK;

  for (int n0 = 0; n0 < dh; n0 += kBN) {
    float acc[T::MI][T::NI][4] = {};
    load_b_slab(bstage, w1, dh, 0, n0, tid);
    cp_async_commit();
    for (int ks = 0; ks < nk; ++ks) {
      if (ks + 1 < nk) {
        load_b_slab(bstage + ((ks + 1) & 1) * kStage, w1, dh, (ks + 1) * kBK, n0, tid);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      warp_mma_slab<T::MI, T::NI>(acc, panel, lda, a_row0, ks * kBK, bstage + (ks & 1) * kStage,
                                  kBN + kPad, wn * T::kWarpN, lane);
      __syncthreads();
    }
    // epilogue: + b1, GELU, bf16
#pragma unroll
    for (int mi = 0; mi < T::MI; ++mi) {
#pragma unroll
      for (int ni = 0; ni < T::NI; ++ni) {
        const int col = n0 + wn * T::kWarpN + ni * 8 + 2 * t4;
        const float bias0 = b1[col], bias1 = b1[col + 1];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int64_t r = row0 + a_row0 + mi * 16 + g + half * 8;
          if (r < rows) {
            const float v0 = gelu_tanh(acc[mi][ni][2 * half] + bias0);
            const float v1 = gelu_tanh(acc[mi][ni][2 * half + 1] + bias1);
            *reinterpret_cast<__nv_bfloat162*>(hidden + r * dh + col) = __floats2bfloat162_rn(v0, v1);
          }
        }
      }
    }
  }
}

// ---- launch 2: hidden @ w2 + b2 + x -> out (bf16) ----
constexpr int kBM2 = 128;

__global__ void __launch_bounds__(kThreads, 2)
    proj_residual_kernel(const bf16* __restrict__ hidden, const bf16* __restrict__ w2,
                         const float* __restrict__ b2, const bf16* __restrict__ x,
                         bf16* __restrict__ out, int64_t rows, int d, int dh) {
  using T = Tiling<kBM2>;
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int lda = kBK + kPad;
  constexpr int kAStage = kBM2 * lda;
  constexpr int kBStage = kBK * (kBN + kPad);
  bf16* astage = reinterpret_cast<bf16*>(smem);  // 2 x (kBM2, kBK + kPad)
  bf16* bstage = astage + 2 * kAStage;           // 2 x (kBK, kBN + kPad)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kBM2;
  const int n0 = blockIdx.y * kBN;
  const int wm = warp / T::kWarpsN, wn = warp % T::kWarpsN;
  const int g = lane >> 2, t4 = lane & 3;

  auto load_a = [&](bf16* as, int k0) {
    constexpr int kChunks = kBM2 * kBK / 8;
#pragma unroll
    for (int i = tid; i < kChunks; i += kThreads) {
      const int r = i / (kBK / 8), c = (i % (kBK / 8)) * 8;
      const bool ok = row0 + r < rows;
      const int64_t src_row = ok ? row0 + r : 0;
      cp_async16(as + r * lda + c, hidden + src_row * dh + k0 + c, ok);
    }
  };

  float acc[T::MI][T::NI][4] = {};
  const int nk = dh / kBK;
  load_a(astage, 0);
  load_b_slab(bstage, w2, d, 0, n0, tid);
  cp_async_commit();
  for (int ks = 0; ks < nk; ++ks) {
    if (ks + 1 < nk) {
      const int s = (ks + 1) & 1;
      load_a(astage + s * kAStage, (ks + 1) * kBK);
      load_b_slab(bstage + s * kBStage, w2, d, (ks + 1) * kBK, n0, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    warp_mma_slab<T::MI, T::NI>(acc, astage + (ks & 1) * kAStage, lda, wm * 32, 0,
                                bstage + (ks & 1) * kBStage, kBN + kPad, wn * T::kWarpN, lane);
    __syncthreads();
  }

#pragma unroll
  for (int mi = 0; mi < T::MI; ++mi) {
#pragma unroll
    for (int ni = 0; ni < T::NI; ++ni) {
      const int col = n0 + wn * T::kWarpN + ni * 8 + 2 * t4;
      const float bias0 = b2[col], bias1 = b2[col + 1];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int64_t r = row0 + wm * 32 + mi * 16 + g + half * 8;
        if (r < rows) {
          const __nv_bfloat162 res = *reinterpret_cast<const __nv_bfloat162*>(x + r * d + col);
          const float v0 = __low2float(res) + (acc[mi][ni][2 * half] + bias0);
          const float v1 = __high2float(res) + (acc[mi][ni][2 * half + 1] + bias1);
          *reinterpret_cast<__nv_bfloat162*>(out + r * d + col) = __floats2bfloat162_rn(v0, v1);
        }
      }
    }
  }
}

template <int BM>
cudaError_t launch_fc(const bf16* x, const float* ln_w, const float* ln_b, const bf16* w1,
                      const float* b1, bf16* hidden, int64_t rows, int d, int dh, float eps,
                      cudaStream_t stream) {
  const size_t smem =
      sizeof(bf16) * (static_cast<size_t>(BM) * (d + kPad) + 2 * kBK * (kBN + kPad));
  cudaError_t err = cudaFuncSetAttribute(ln_fc_gelu_kernel<BM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int64_t blocks = (rows + BM - 1) / BM;
  ln_fc_gelu_kernel<BM><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      x, ln_w, ln_b, w1, b1, hidden, rows, d, dh, eps);
  return cudaGetLastError();
}

}  // namespace

// x, out: (rows, d) bf16 contiguous; hidden: (rows, dh) bf16 scratch; w1: (d, dh)
// and w2: (dh, d) bf16 row-major (the (in, out) layout of GPT-2's Conv1D);
// ln_w, ln_b: d fp32; b1: dh fp32; b2: d fp32. d and dh multiples of 128,
// d <= 1536 (the LN panel of one row block lives in shared memory).
extern "C" int fused_ln_mlp_forward(const void* x, const void* ln_w, const void* ln_b,
                                    const void* w1, const void* b1, const void* w2,
                                    const void* b2, void* hidden, void* out, int64_t rows,
                                    int d, int dh, float eps, void* stream) {
  if (d % kBN != 0 || dh % kBN != 0 || d > 1536 || rows <= 0 || (rows + 63) / 64 > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xp = static_cast<const bf16*>(x);
  const float* lw = static_cast<const float*>(ln_w);
  const float* lb = static_cast<const float*>(ln_b);
  const bf16* w1p = static_cast<const bf16*>(w1);
  const float* b1p = static_cast<const float*>(b1);
  bf16* hp = static_cast<bf16*>(hidden);
  cudaError_t err = d <= 768 ? launch_fc<128>(xp, lw, lb, w1p, b1p, hp, rows, d, dh, eps, s)
                             : launch_fc<64>(xp, lw, lb, w1p, b1p, hp, rows, d, dh, eps, s);
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t smem2 = sizeof(bf16) * (2 * kBM2 * (kBK + kPad) + 2 * kBK * (kBN + kPad));
  err = cudaFuncSetAttribute(proj_residual_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem2));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((rows + kBM2 - 1) / kBM2), d / kBN);
  proj_residual_kernel<<<grid, kThreads, smem2, s>>>(hp, static_cast<const bf16*>(w2),
                                                     static_cast<const float*>(b2), xp,
                                                     static_cast<bf16*>(out), rows, d, dh);
  return static_cast<int>(cudaGetLastError());
}
