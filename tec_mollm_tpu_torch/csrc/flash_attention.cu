// Flash attention forward, T >= 128: the Hopper port of the Pallas kernel
// tec_mollm_tpu/ops/flash_attention.py:_flash_forward (_attn_kernel), with the
// attention dropout of the pretraining path.
//
// out[b, i, h] = sum_j drop(softmax_j(q[b,i,h] . k[b,j,h] * scale)) * v[b,j,h]
// over the keys j < T, and j <= i when causal, for q, k, v of shape (B, T, H, D).
// Scores and softmax are fp32, the probabilities are rounded to v's type before
// the product with v, which accumulates in fp32; the output is written in the
// input type. No row is ever fully masked: every causal row has key 0. Dropout
// (tec::Dropout, common.cuh) keeps probability (i, j) iff the hash of the
// absolute index ((b*H + h)*T + i)*T + j passes, and scales the output by
// 1/(1-p); the softmax sum is taken over the undropped probabilities, as the
// einsum form drops after normalising.
//
// Bound on this card: bytes. q, k, v read once and the output written once is
// 4 * B*T*H*D elements, 50.7 MB in bf16 at the pretraining shape (64, 129, 12,
// 64): 0.015 ms at 3.35 TB/s, against 0.002 ms for its 1.65 GFLOP on the bf16
// tensor cores. So the bf16 kernel needs tensor cores only to keep the
// products off the critical path, and mma.sync (a few times below wgmma's
// rate, still 8x above what the bytes allow) is enough; what it must do is
// read its bytes in 16-byte chunks and read each K/V tile from device memory
// once per block.
//
// bf16 design (FA2): a block of 4 warps takes 64 queries of one (b, h), 16 rows
// a warp; the longest causal tiles launch first. The Q tile comes in through
// cp.async and stays in registers as mma fragments (ldmatrix). K and V tiles of
// 64 keys stream through shared memory with 16-byte cp.async copies, double
// buffered, rows padded by 16 bytes so that ldmatrix reads hit distinct banks.
// S = Q K^T and O += P V run on mma.sync.m16n8k16 (bf16 -> fp32), V through
// ldmatrix.trans. The online softmax works on the S accumulator fragments in
// the log2 domain, with quad shuffles for the row max and sum; P is rounded to
// bf16 in registers, dropped there, and reused as the A operand of P V. A
// causal block stops at its diagonal tile. Keys >= T are zero-filled and
// masked; rows >= T are zero-filled and store nothing. Loads need 16-byte
// aligned pointers and batch, token and head strides (the wrapper copies a view
// that has not).
//
// Rounding: the Pallas kernel normalises the probabilities and then rounds
// them to bf16; this kernel rounds the unnormalised exp(s - m) and divides by
// the fp32 sum at the end. In bf16 the two differ by about one bf16 ulp of a
// probability, inside the bf16 tolerance of the check.
//
// fp32 keeps a scalar kernel (each query row over D/32 neighbouring threads, K
// and V tiles of 32 keys converted to fp32 in shared memory, scalar FMAs): the
// tensor cores have no fp32 product within the fp32 check, and fp32 is on no
// main path. Its loads are element-wise, so any alignment is taken.
#include <cmath>
#include <cstdint>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

struct Strides {  // in elements; the feature axis has unit stride
  int64_t b;
  int64_t t;
  int64_t h;
};

// ---------------------------------------------------------------- fp32: scalar

constexpr int kBlockQ = 64;  // query rows per block
constexpr int kBlockK = 32;  // keys per shared-memory tile
constexpr int kEpt = 32;     // elements of a row each thread holds

// Sum over the S neighbouring lanes of one query row; every lane of the group
// gets the same value (fp32 addition commutes).
template <int S>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = S / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return tec::to_float(tec::from_float<T>(x));
}

template <typename T, int D>
__global__ void __launch_bounds__(kBlockQ * (D / kEpt))
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out, int heads, int t_len,
                           Strides sq, Strides sk, Strides sv, float scale, int causal,
                           tec::Dropout drop) {
  constexpr int kSlices = D / kEpt;  // threads per query row
  __shared__ float ks[kBlockK][D];
  __shared__ float vs[kBlockK][D];

  const int b = blockIdx.x / heads;
  const int h = blockIdx.x % heads;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockQ;
  const int tid = threadIdx.x;
  const int row = tid / kSlices;
  const int slice = tid % kSlices;
  const int qi = q0 + row;

  // rows past T (the last tile's ragged edge) compute on row T-1 and store nothing
  const T* qrow = q + b * sq.b + static_cast<int64_t>(min(qi, t_len - 1)) * sq.t + h * sq.h;
  float qf[kEpt], o[kEpt];
#pragma unroll
  for (int e = 0; e < kEpt; ++e) {
    qf[e] = tec::to_float(qrow[e * kSlices + slice]);
    o[e] = 0.f;
  }
  float m = -INFINITY, l = 0.f;
  const uint64_t row_idx = (static_cast<uint64_t>(blockIdx.x) * t_len + qi) * t_len;

  const T* kbase = k + b * sk.b + h * sk.h;
  const T* vbase = v + b * sv.b + h * sv.h;
  const int kv_end = causal ? min(t_len, q0 + kBlockQ) : t_len;
  for (int k0 = 0; k0 < kv_end; k0 += kBlockK) {
    __syncthreads();  // the previous tile is consumed
    for (int i = tid; i < kBlockK * D; i += blockDim.x) {
      const int j = i / D, d = i % D;
      const int kj = k0 + j;
      float kx = 0.f, vx = 0.f;
      if (kj < t_len) {
        kx = tec::to_float(kbase[kj * sk.t + d]);
        vx = tec::to_float(vbase[kj * sv.t + d]);
      }
      ks[j][d] = kx;
      vs[j][d] = vx;
    }
    __syncthreads();

    float s[kBlockK];
    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      float part = 0.f;
#pragma unroll
      for (int e = 0; e < kEpt; ++e) part = fmaf(qf[e], ks[j][e * kSlices + slice], part);
      part = group_sum<kSlices>(part);
      const int kj = k0 + j;
      const bool valid = kj < t_len && (!causal || kj <= qi);
      s[j] = valid ? part * scale : -INFINITY;
      tile_max = fmaxf(tile_max, s[j]);
    }
    // m_new is finite from the first tile on, since key 0 is valid for every
    // row; on the first tile m = -inf and alpha = exp(-inf) = 0
    const float m_new = fmaxf(m, tile_max);
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int e = 0; e < kEpt; ++e) o[e] *= alpha;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      const float p = expf(s[j] - m_new);  // a masked key: exp(-inf) = 0
      l += p;
      float pr = round_to<T>(p);
      if (drop.on && !drop.keep(row_idx + k0 + j)) pr = 0.f;
#pragma unroll
      for (int e = 0; e < kEpt; ++e) o[e] = fmaf(pr, vs[j][e * kSlices + slice], o[e]);
    }
    m = m_new;
  }

  if (qi < t_len) {
    const float inv = drop.inv_keep / l;
    T* dst = out + ((static_cast<int64_t>(b) * t_len + qi) * heads + h) * D;
#pragma unroll
    for (int e = 0; e < kEpt; ++e) dst[e * kSlices + slice] = tec::from_float<T>(o[e] * inv);
  }
}

template <int D>
cudaError_t launch_scalar(const void* q, const void* k, const void* v, void* out, int batch,
                          int t_len, int heads, Strides sq, Strides sk, Strides sv, float scale,
                          int causal, tec::Dropout drop, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(batch * heads),
                  static_cast<unsigned>((t_len + kBlockQ - 1) / kBlockQ));
  flash_attention_kernel<float, D><<<grid, kBlockQ * (D / kEpt), 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), heads, t_len, sq, sk, sv, scale, causal, drop);
  return cudaGetLastError();
}

// ------------------------------------------------------- bf16: tensor cores

constexpr int kTcThreads = 128;  // 4 warps, 16 query rows each
constexpr int kTcQ = 64;         // query rows per block
constexpr int kTcK = 64;         // keys per K/V tile

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  const int n = pred ? 16 : 0;  // 0 bytes read: the 16 destination bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <int D>
struct TcShape {
  static constexpr int kLd = D + 8;      // shared row, bf16 elements (16 bytes of padding)
  static constexpr int kChunks = D / 8;  // 16-byte chunks a row
  static constexpr size_t kSmem = sizeof(bf16) * (kTcQ + 4 * kTcK) * kLd;  // Q, 2 x K, 2 x V
};

// rows [row0, row0 + rows) of a (T, D) head slice with token stride st into a
// padded shared tile; rows >= t_len are zero-filled
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int64_t st, int row0,
                                          int t_len, int tid) {
  using S = TcShape<D>;
#pragma unroll
  for (int i = tid; i < ROWS * S::kChunks; i += kTcThreads) {
    const int r = i / S::kChunks, c = (i % S::kChunks) * 8;
    const bool ok = row0 + r < t_len;
    cp_async16(dst + r * S::kLd + c, src + static_cast<int64_t>(ok ? row0 + r : 0) * st + c, ok);
  }
}

// blocks an SM keeps resident: registers cap D = 128 at 2, smem allows 4 below
template <int D>
constexpr int kTcMinBlocks = D == 128 ? 2 : 4;

template <int D>
__global__ void __launch_bounds__(kTcThreads, kTcMinBlocks<D>)
    flash_attention_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                              const bf16* __restrict__ v, bf16* __restrict__ out, int heads,
                              int t_len, Strides sq, Strides sk, Strides sv, float scale_log2,
                              int causal, tec::Dropout drop) {
  using S = TcShape<D>;
  constexpr int kLd = S::kLd;
  constexpr int kKd = D / 16;  // k-steps of Q K^T
  constexpr int kNd = D / 8;   // 8-wide output column tiles
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);  // (64, kLd)
  bf16* ks = qs + kTcQ * kLd;                // 2 x (64, kLd)
  bf16* vs = ks + 2 * kTcK * kLd;            // 2 x (64, kLd)

  const int b = blockIdx.x / heads;
  const int h = blockIdx.x % heads;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTcQ;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const bf16* kbase = k + b * sk.b + h * sk.h;
  const bf16* vbase = v + b * sv.b + h * sv.h;
  const int kv_end = causal ? min(t_len, q0 + kTcQ) : t_len;
  const int n_tiles = (kv_end + kTcK - 1) / kTcK;

  load_tile<D, kTcQ>(qs, q + b * sq.b + h * sq.h, sq.t, q0, t_len, tid);
  load_tile<D, kTcK>(ks, kbase, sk.t, 0, t_len, tid);
  load_tile<D, kTcK>(vs, vbase, sv.t, 0, t_len, tid);
  cp_async_commit();

  uint32_t qf[kKd][4];
  float o[kNd][4];
#pragma unroll
  for (int n = 0; n < kNd; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const int r0 = q0 + warp * 16 + g;  // this thread's rows: r0 and r0 + 8
  const uint64_t idx0 = (static_cast<uint64_t>(blockIdx.x) * t_len + r0) * t_len;
  const uint64_t idx1 = idx0 + 8ull * t_len;

  for (int j = 0; j < n_tiles; ++j) {
    const int stage = j & 1;
    if (j + 1 < n_tiles) {  // prefetch the next tile into the other stage
      load_tile<D, kTcK>(ks + (stage ^ 1) * kTcK * kLd, kbase, sk.t, (j + 1) * kTcK, t_len, tid);
      load_tile<D, kTcK>(vs + (stage ^ 1) * kTcK * kLd, vbase, sv.t, (j + 1) * kTcK, t_len, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < kKd; ++kk)
        ldmatrix_x4(qf[kk], qs + (warp * 16 + (lane & 15)) * kLd + kk * 16 + (lane >> 4) * 8);
    }
    const bf16* kt = ks + stage * kTcK * kLd;
    const bf16* vt = vs + stage * kTcK * kLd;
    const int k0 = j * kTcK;

    // S = Q K^T: 8 column tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int n2 = 0; n2 < 4; ++n2) {
#pragma unroll
      for (int kk = 0; kk < kKd; ++kk) {
        uint32_t r[4];
        ldmatrix_x4(r, kt + (n2 * 16 + (lane & 7) + ((lane >> 4) << 3)) * kLd + kk * 16 +
                           ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * n2], qf[kk], r[0], r[1]);
        mma_bf16(s[2 * n2 + 1], qf[kk], r[2], r[3]);
      }
    }

    // scale into the log2 domain; mask keys >= T and, on the diagonal tile, j > i
    const bool edge = k0 + kTcK > t_len || (causal && k0 + kTcK > q0 + 1);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale_log2;
        if (edge) {
          const int key = k0 + n * 8 + 2 * t4 + (e & 1);
          const int row = r0 + (e >> 1) * 8;
          if (key >= t_len || (causal && key > row)) x = -INFINITY;
        }
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2], base[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const float m_new = fmaxf(m[hr], quad_max(mx[hr]));
      base[hr] = m_new == -INFINITY ? 0.f : m_new;  // a row with no key yet stays 0
      alpha[hr] = exp2f(m[hr] - base[hr]);          // m = -inf on the first tile: 0
      m[hr] = m_new;
      l[hr] *= alpha[hr];
    }
#pragma unroll
    for (int n = 0; n < kNd; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // P = exp2(S - m): the row sums take every probability, P V only the kept ones
    uint32_t pa[4][4];  // A fragments of P, one per 16-key step
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = exp2f(s[n][e] - base[e >> 1]);
        l[e >> 1] += p[e];
        if (drop.on) {
          const uint64_t key = static_cast<uint64_t>(k0 + n * 8 + 2 * t4 + (e & 1));
          if (!drop.keep(((e >> 1) ? idx1 : idx0) + key)) p[e] = 0.f;
        }
      }
      pa[n >> 1][(n & 1) * 2] = pack_bf16(p[0], p[1]);
      pa[n >> 1][(n & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
    }

    // O += P V: V (keys x D) through ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int n2 = 0; n2 < kNd / 2; ++n2) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, vt + (kk * 16 + (lane & 15)) * kLd + n2 * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * n2], pa[kk], r[0], r[1]);
        mma_bf16(o[2 * n2 + 1], pa[kk], r[2], r[3]);
      }
    }
    __syncthreads();  // this stage is consumed before the next prefetch overwrites it
  }

  const float lsum[2] = {quad_sum(l[0]), quad_sum(l[1])};  // every lane, before any branch
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = r0 + hr * 8;
    if (row >= t_len) continue;
    const float inv = drop.inv_keep / lsum[hr];
    bf16* dst = out + ((static_cast<int64_t>(b) * t_len + row) * heads + h) * D + 2 * t4;
#pragma unroll
    for (int n = 0; n < kNd; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dst + n * 8) =
          __floats2bfloat162_rn(o[n][2 * hr] * inv, o[n][2 * hr + 1] * inv);
  }
}

template <int D>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* out, int batch,
                      int t_len, int heads, Strides sq, Strides sk, Strides sv, float scale,
                      int causal, tec::Dropout drop, cudaStream_t stream) {
  constexpr size_t smem = TcShape<D>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(flash_attention_tc_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(batch * heads),
                  static_cast<unsigned>((t_len + kTcQ - 1) / kTcQ));
  flash_attention_tc_kernel<D><<<grid, kTcThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), heads, t_len, sq, sk, sv, scale * 1.4426950408889634f, causal,
      drop);
  return cudaGetLastError();
}

cudaError_t launch(const void* q, const void* k, const void* v, void* out, int batch, int t_len,
                   int heads, int head_dim, Strides sq, Strides sk, Strides sv, float scale,
                   int causal, int is_bf16, tec::Dropout drop, cudaStream_t s) {
#define TEC_FLASH_CASE(D)                                                                    \
  case D:                                                                                    \
    return is_bf16 ? launch_tc<D>(q, k, v, out, batch, t_len, heads, sq, sk, sv, scale, causal, \
                                  drop, s)                                                   \
                   : launch_scalar<D>(q, k, v, out, batch, t_len, heads, sq, sk, sv, scale,     \
                                      causal, drop, s);
  switch (head_dim) {
    TEC_FLASH_CASE(32)
    TEC_FLASH_CASE(64)
    TEC_FLASH_CASE(128)
    default: return cudaErrorInvalidValue;
  }
#undef TEC_FLASH_CASE
}

}  // namespace

// q, k, v: (batch, t_len, heads, head_dim) with unit stride on the last axis and
// the given batch / token / head strides (in elements; for bf16, multiples of 8
// with a 16-byte aligned pointer); out: contiguous (batch, t_len, heads,
// head_dim). head_dim 32, 64 or 128; scale multiplies the fp32 scores
// (1/sqrt(head_dim)); causal != 0 masks key j > query i. dropout != 0 drops
// with the given seed, threshold and 1/(1-p).
extern "C" int flash_attention_forward(const void* q, const void* k, const void* v, void* out,
                                       int batch, int t_len, int heads, int head_dim,
                                       int64_t q_sb, int64_t q_st, int64_t q_sh, int64_t k_sb,
                                       int64_t k_st, int64_t k_sh, int64_t v_sb, int64_t v_st,
                                       int64_t v_sh, int is_bf16, int causal, float scale,
                                       int dropout, uint32_t seed, uint32_t threshold,
                                       float inv_keep, void* stream) {
  const int64_t rows = static_cast<int64_t>(batch) * heads;
  if (batch <= 0 || t_len <= 0 || heads <= 0 || rows > 0x7fffffffLL ||
      (t_len + kBlockQ - 1) / kBlockQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides sq{q_sb, q_st, q_sh}, sk{k_sb, k_st, k_sh}, sv{v_sb, v_st, v_sh};
  const tec::Dropout drop{tec::dropout_key(seed), threshold, dropout ? inv_keep : 1.f, dropout};
  return static_cast<int>(launch(q, k, v, out, batch, t_len, heads, head_dim, sq, sk, sv, scale,
                                 causal, is_bf16, drop, static_cast<cudaStream_t>(stream)));
}
