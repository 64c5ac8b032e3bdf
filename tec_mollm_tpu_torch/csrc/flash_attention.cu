// Flash attention forward, T >= 128: the Hopper port of the Pallas kernel
// tec_mollm_tpu/ops/flash_attention.py:_flash_forward (_attn_kernel).
//
// out[b, i, h] = sum_j softmax_j(q[b,i,h] . k[b,j,h] * scale) * v[b,j,h]
// over the keys j < T, and j <= i when causal, for q, k, v of shape (B, T, H, D).
// Scores and softmax are fp32, the probabilities are rounded to v's type before
// the product with v, which accumulates in fp32; the output is written in the
// input type. No row is ever fully masked: every causal row has key 0.
//
// Design: one block per (b*h, tile of 64 queries), the longest causal tiles
// launched first. Each query row belongs to D/32 neighbouring threads; each
// holds 32 of the row's elements (element e*(D/32) + slice, so that the threads
// of a row read neighbouring shared-memory words) of q and of the fp32 output
// in registers. K and V stream through shared memory in tiles of 32 keys,
// converted to fp32 once per tile, and an online softmax in fp32 carries the
// running max and sum across tiles; a causal block stops at its last query.
// Unlike the TPU kernel, K and V never sit whole in fast memory: at T = 1024
// and D = 64 that would be 256 KB, more than a block's 227 KB. The keys a tile
// runs past T (the ragged edge at T = 129) are masked here: the TPU wrapper
// pads T to its block and masks keys >= t_valid instead.
//
// Rounding: the Pallas kernel normalises the probabilities and then rounds
// them to bf16; this kernel rounds the unnormalised exp(s - m) to the input
// type and divides by the fp32 sum at the end. In bf16 the two differ by
// about one bf16 ulp of a probability, inside the bf16 tolerance of the check.
//
// Bound on this card: bytes. q, k, v read once and the output written once is
// 4 * B*T*H*D elements, 50.7 MB in bf16 at the pretraining shape (64, 129, 12,
// 64): 0.015 ms at 3.35 TB/s, against 0.002 ms for its 1.65 GFLOP on the bf16
// tensor cores. This first kernel multiplies with scalar fp32 FMAs (each K and
// V element read from shared memory feeds one FMA), so it runs at a fraction
// of either bound; mma.sync or wgmma tiles with TMA loads are later work.
// Loads are element-wise, so any alignment and any row, token and head
// strides are taken: q, k and v are strided views of the c_attn projection.
#include <cmath>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kBlockQ = 64;  // query rows per block
constexpr int kBlockK = 32;  // keys per shared-memory tile
constexpr int kEpt = 32;     // elements of a row each thread holds

struct Strides {  // in elements; the feature axis has unit stride
  int64_t b;
  int64_t t;
  int64_t h;
};

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
                           Strides sq, Strides sk, Strides sv, float scale, int causal) {
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
      const float pr = round_to<T>(p);
#pragma unroll
      for (int e = 0; e < kEpt; ++e) o[e] = fmaf(pr, vs[j][e * kSlices + slice], o[e]);
    }
    m = m_new;
  }

  if (qi < t_len) {
    const float inv = 1.f / l;
    T* dst = out + ((static_cast<int64_t>(b) * t_len + qi) * heads + h) * D;
#pragma unroll
    for (int e = 0; e < kEpt; ++e) dst[e * kSlices + slice] = tec::from_float<T>(o[e] * inv);
  }
}

template <typename T, int D>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* out, int batch,
                     int t_len, int heads, Strides sq, Strides sk, Strides sv, float scale,
                     int causal, cudaStream_t stream) {
  const int64_t rows = static_cast<int64_t>(batch) * heads;
  const int tiles = (t_len + kBlockQ - 1) / kBlockQ;
  if (rows > 0x7fffffffLL || tiles > 65535) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(rows), static_cast<unsigned>(tiles));
  flash_attention_kernel<T, D><<<grid, kBlockQ * (D / kEpt), 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), heads, t_len, sq, sk, sv, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int batch, int t_len,
                   int heads, int head_dim, Strides sq, Strides sk, Strides sv, float scale,
                   int causal, cudaStream_t s) {
  switch (head_dim) {
    case 32: return launch_d<T, 32>(q, k, v, out, batch, t_len, heads, sq, sk, sv, scale, causal, s);
    case 64: return launch_d<T, 64>(q, k, v, out, batch, t_len, heads, sq, sk, sv, scale, causal, s);
    case 128: return launch_d<T, 128>(q, k, v, out, batch, t_len, heads, sq, sk, sv, scale, causal, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v: (batch, t_len, heads, head_dim) with unit stride on the last axis and
// the given batch / token / head strides (in elements); out: contiguous
// (batch, t_len, heads, head_dim). head_dim 32, 64 or 128; scale multiplies the
// fp32 scores (1/sqrt(head_dim)); causal != 0 masks key j > query i.
extern "C" int flash_attention_forward(const void* q, const void* k, const void* v, void* out,
                                       int batch, int t_len, int heads, int head_dim,
                                       int64_t q_sb, int64_t q_st, int64_t q_sh, int64_t k_sb,
                                       int64_t k_st, int64_t k_sh, int64_t v_sb, int64_t v_st,
                                       int64_t v_sh, int is_bf16, int causal, float scale,
                                       void* stream) {
  if (batch <= 0 || t_len <= 0 || heads <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Strides sq{q_sb, q_st, q_sh}, sk{k_sb, k_st, k_sh}, sv{v_sb, v_st, v_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(q, k, v, out, batch, t_len, heads, head_dim, sq, sk, sv,
                                      scale, causal, s)
              : launch<float>(q, k, v, out, batch, t_len, heads, head_dim, sq, sk, sv, scale,
                              causal, s);
  return static_cast<int>(err);
}
