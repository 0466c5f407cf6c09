// Attention over one head for 64 query rows, shared by eva_attn_block.cu
// (the attention step of the EVA block), eva_attention.cu (the
// natural-layout attention of ViTAttention) and attention_heads.cu (the
// (B, H, N, hd) attention).
//
// q, k and v are (B, N, ...) bf16 with their own row and batch strides,
// head h at columns h*hd .. h*hd+hd-1 of each row; the output is a
// contiguous (B, N, D) bf16, head h at the same columns.  Rounding points:
// fp32 scores from bf16 q and k; a first pass takes each row's exact
// maximum over the N real keys, a second forms p = exp((s - max) * scale)
// in fp32, accumulates bf16(p) . v in fp32 and divides by the fp32 sum of
// p.  With kLN, q and k first go through a per-head LayerNorm (fp32
// statistics over the 64 values, one gamma/beta shared by all heads),
// rounded to bf16 before q.k^T.
//
// The head width in shared memory is the template parameter kHd (16, 32,
// 64 or 128).  A head of hd < kHd real columns is padded with zeros there:
// zero columns add nothing to q.k^T, and the padded output columns are not
// written.  Rows of hd == kHd columns move in 16-byte vectors, others one
// element at a time.
//
// One block of 4 warps per (64 queries, head, batch); keys and values
// stream through shared memory in chunks of 64, the last chunk masked to
// the real keys.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <mma.h>
#include <cstdint>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kHead = 64;      // head dim of the EVA and ViT paths
constexpr int kTile = 64;      // GEMM tile rows/cols, attention query rows
constexpr int kThreads = 128;  // 4 warps
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float bf(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ bf16 rn(float x) { return __float2bfloat16_rn(x); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// LayerNorm of one 64-value head row, lanes holding columns lane and
// lane + 32: fp32 mean and variance, (x - mu) * (1 / sqrt(var + eps)) * g + b
// with no FMA contraction, rounded to bf16.  Called by all 32 lanes.
__device__ __forceinline__ void head_layernorm(float x0, float x1,
                                               const float* g, const float* b,
                                               float eps, int lane, bf16& y0,
                                               bf16& y1) {
  const float mu = warp_sum(x0 + x1) / kHead;
  const float d0 = x0 - mu, d1 = x1 - mu;
  const float var = warp_sum(d0 * d0 + d1 * d1) / kHead;
  const float inv = 1.f / sqrtf(var + eps);
  y0 = rn(__fadd_rn(__fmul_rn(__fmul_rn(d0, inv), g[lane]), b[lane]));
  y1 = rn(__fadd_rn(__fmul_rn(__fmul_rn(d1, inv), g[lane + 32]), b[lane + 32]));
}

struct AttnArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  int64_t ld_q, ld_k, ld_v;  // row strides, in elements
  int64_t bs_q, bs_k, bs_v;  // batch strides, in elements
  const float* gq;           // per-head LayerNorm of q and k (kLN only)
  const float* bq;
  const float* gk;
  const float* bk;
  bf16* out;                 // (B, N, D) contiguous
  int N, D;
  float scale, eps;
  int hd = kHead;            // real head width, at most kHd
};

// Shared-memory layout for head width kHd: q, k and v tiles, then per warp
// its 16 rows of fp32 scores (later of the output) and of bf16(p).
template <int kHd>
struct AttnSmem {
  static constexpr int kLd = kHd + 8;                           // bf16 q/k/v
  static constexpr int kLdS = (kHd > kTile ? kHd : kTile) + 4;  // fp32
  static constexpr int kLdP = kTile + 8;                        // bf16 p
  static constexpr size_t kBytes = 3 * kTile * kLd * sizeof(bf16) +
                                   4 * 16 * kLdS * sizeof(float) +
                                   4 * 16 * kLdP * sizeof(bf16);
};

// Rows row0 .. row0+63 of a (rows, hd) operand into a kHd-wide tile; rows
// past n_rows and columns past hd are zero.
template <int kHd>
__device__ __forceinline__ void load_rows(bf16 (*dst)[kHd + 8], const bf16* src,
                                          int row0, int n_rows, int64_t ld,
                                          int hd) {
  if (hd == kHd) {  // 16-byte vectors: kHd / 8 per row
    for (int chunk = threadIdx.x; chunk < kTile * kHd / 8; chunk += kThreads) {
      const int r = chunk / (kHd / 8), col = (chunk % (kHd / 8)) * 8;
      *reinterpret_cast<uint4*>(&dst[r][col]) =
          (row0 + r < n_rows)
              ? *reinterpret_cast<const uint4*>(src + (row0 + r) * ld + col)
              : make_uint4(0, 0, 0, 0);
    }
  } else {
    for (int i = threadIdx.x; i < kTile * kHd; i += kThreads) {
      const int r = i / kHd, col = i % kHd;
      dst[r][col] = (row0 + r < n_rows && col < hd) ? src[(row0 + r) * ld + col]
                                                    : rn(0.f);
    }
  }
}

// The per-head LayerNorm of the real rows of a tile in shared memory, one
// warp per row.  The caller synchronises before and after.
__device__ __forceinline__ void layernorm_rows(bf16 (*t)[kHead + 8], int row0,
                                               int n_rows, const float* g,
                                               const float* b, float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < kTile && row0 + r < n_rows; r += kThreads / 32)
    head_layernorm(bf(t[r][lane]), bf(t[r][lane + 32]), g, b, eps, lane,
                   t[r][lane], t[r][lane + 32]);
}

template <bool kLN, int kHd>
__global__ void __launch_bounds__(kThreads) attn_kernel(AttnArgs a) {
  static_assert(kHd % 16 == 0 && kHd <= 128, "head width 16, 32, 64 or 128");
  static_assert(!kLN || kHd == kHead, "the q/k LayerNorm takes 64-wide heads");
  using L = AttnSmem<kHd>;
  extern __shared__ __align__(128) unsigned char smem[];
  auto sQ = reinterpret_cast<bf16 (*)[L::kLd]>(smem);
  auto sK = sQ + kTile;
  auto sV = sK + kTile;
  auto sS = reinterpret_cast<float (*)[16][L::kLdS]>(
      smem + 3 * kTile * L::kLd * sizeof(bf16));
  auto sP = reinterpret_cast<bf16 (*)[16][L::kLdP]>(
      smem + 3 * kTile * L::kLd * sizeof(bf16) +
      4 * 16 * L::kLdS * sizeof(float));

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int N = a.N, hd = a.hd;
  const bf16* qg = a.q + b * a.bs_q + h * hd;
  const bf16* kg = a.k + b * a.bs_k + h * hd;
  const bf16* vg = a.v + b * a.bs_v + h * hd;

  // a key chunk, LayerNorm'd when kLN, ready for the warps' fragments
  auto load_keys = [&](int k0) {
    load_rows<kHd>(sK, kg, k0, N, a.ld_k, hd);
    if constexpr (kLN) {
      __syncthreads();
      layernorm_rows(sK, k0, N, a.gk, a.bk, a.eps);
    }
  };

  load_rows<kHd>(sQ, qg, q0, N, a.ld_q, hd);
  if constexpr (kLN) {
    __syncthreads();
    layernorm_rows(sQ, q0, N, a.gq, a.bq, a.eps);
  }
  __syncthreads();
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qa[kHd / 16];
#pragma unroll
  for (int kk = 0; kk < kHd / 16; ++kk)
    wmma::load_matrix_sync(qa[kk], &sQ[warp * 16][kk * 16], L::kLd);

  // lane (r, half) owns row r of this warp's 16 and 32 of the 64 key
  // columns of a chunk
  const int r = lane >> 1, c0 = (lane & 1) * 32;
  float (*S)[L::kLdS] = sS[warp];
  bf16 (*P)[L::kLdP] = sP[warp];

  auto scores = [&]() {  // S = Q_w . K_chunk^T, fp32
#pragma unroll
    for (int j = 0; j < kTile / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> s;
      wmma::fill_fragment(s, 0.f);
#pragma unroll
      for (int kk = 0; kk < kHd / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kb;
        wmma::load_matrix_sync(kb, &sK[j * 16][kk * 16], L::kLd);
        wmma::mma_sync(s, qa[kk], kb, s);
      }
      wmma::store_matrix_sync(&S[0][j * 16], s, L::kLdS, wmma::mem_row_major);
    }
    __syncwarp();
  };

  // pass 1: the exact row maximum over all keys
  float mx = -CUDART_INF_F;
  for (int k0 = 0; k0 < N; k0 += kTile) {
    __syncthreads();
    load_keys(k0);
    __syncthreads();
    scores();
    const int valid = min(kTile, N - k0);
    for (int c = 0; c < 32; ++c)
      if (c0 + c < valid) mx = fmaxf(mx, S[r][c0 + c]);
    __syncwarp();
  }
  mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));

  // pass 2: p = exp((s - max) * scale); o = bf16(p) . v; l = sum of fp32 p
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> o[kHd / 16];
#pragma unroll
  for (int j = 0; j < kHd / 16; ++j) wmma::fill_fragment(o[j], 0.f);
  float l = 0.f;
  for (int k0 = 0; k0 < N; k0 += kTile) {
    __syncthreads();
    load_rows<kHd>(sV, vg, k0, N, a.ld_v, hd);
    load_keys(k0);
    __syncthreads();
    scores();
    const int valid = min(kTile, N - k0);
    for (int c = 0; c < 32; ++c) {
      float p = 0.f;
      if (c0 + c < valid) {
        p = expf(__fmul_rn(__fsub_rn(S[r][c0 + c], mx), a.scale));
        l += p;
      }
      P[r][c0 + c] = rn(p);
    }
    __syncwarp();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pa;
      wmma::load_matrix_sync(pa, &P[0][kk * 16], L::kLdP);
#pragma unroll
      for (int j = 0; j < kHd / 16; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vb;
        wmma::load_matrix_sync(vb, &sV[kk * 16][j * 16], L::kLd);
        wmma::mma_sync(o[j], pa, vb, o[j]);
      }
    }
    __syncwarp();
  }
  l += __shfl_xor_sync(kFull, l, 1);

#pragma unroll
  for (int j = 0; j < kHd / 16; ++j)
    wmma::store_matrix_sync(&S[0][j * 16], o[j], L::kLdS, wmma::mem_row_major);
  __syncwarp();
  // lane (r, half) writes half of row r's kHd output columns, the real ones
  const int q = q0 + warp * 16 + r, oc0 = (lane & 1) * (kHd / 2);
  if (q < N) {
    bf16* dst = a.out + (static_cast<size_t>(b) * N + q) * a.D + h * hd + oc0;
    for (int c = 0; c < kHd / 2; ++c)
      if (oc0 + c < hd) dst[c] = rn(S[r][oc0 + c] / l);
  }
}

// One launch of attn_kernel over (query tiles, H heads, B batches) on
// `stream`; returns cudaGetLastError() after it.
template <bool kLN, int kHd = kHead>
cudaError_t launch_attention(const AttnArgs& a, int B, int H,
                             cudaStream_t stream) {
  constexpr size_t kBytes = AttnSmem<kHd>::kBytes;
  cudaError_t e = cudaFuncSetAttribute(
      attn_kernel<kLN, kHd>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kBytes));
  if (e != cudaSuccess) return e;
  const dim3 grid((a.N + kTile - 1) / kTile, H, B);
  attn_kernel<kLN, kHd><<<grid, kThreads, kBytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace
