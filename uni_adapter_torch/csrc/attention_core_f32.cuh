// fp32 attention over one head for 64 query rows, shared by
// attention_fp32.cu (the (B, H, N, hd) attention), eva_attention.cu (the
// natural-layout attention, its fp32 entry) and eva_attn_block.cu (the EVA
// block, its fp32 entry).  The fp32 counterpart of attention_core.cuh,
// with the same operand layout: q, k and v are (B, N, ...) fp32 with their
// own row and batch strides, head h at columns h*hd .. h*hd+hd-1 of each
// row; the output is a contiguous (B, N, D) fp32, head h at the same
// columns.
//
// Two kernels.  launch_attention<false, 64>, every fp32 launch of the main
// paths (no q/k LayerNorm, head width 64), runs attn_f32_tc_kernel of
// attention_core_f32_tc.cuh: split TF32 on the tensor cores, three TF32
// products per fp32 product, to a few fp32 ulps.  Every other
// instantiation (the LayerNorm variant, head widths 16, 32 and 128) runs
// attn_f32_kernel below.
//
// attn_f32_kernel's numerics: every product is an fp32 FFMA with fp32
// accumulation; nothing is rounded to a narrower type, and no tensor-core
// instruction is used.  Scores are t = (q . k) * scale; p = exp(t - max);
// o = (p . v) / sum(p).  With kLN, q and k first go through a per-head
// LayerNorm (fp32 statistics over the 64 values, one gamma/beta shared by
// all heads), kept in fp32.
//
// One pass, online softmax.  The bf16 core takes two passes so that
// bf16(p) is rounded against the exact row maximum, as the reference
// rounds it.  In fp32 p is never rounded to a narrower type, so the
// maximum only keeps exp() in range: a running maximum m, with the
// partial sums and the output accumulators rescaled by exp(m_old - m_new)
// when it grows, gives the two-pass result up to a few fp32 ulps, and
// computes q . k^T once instead of twice (a third of the work on the
// FFMA pipes).
//
// Layout: one block of 128 threads (16 x 8) per (64 queries, head,
// batch).  Thread (ty, tx) owns query rows ty + 16*i (i < 4); for the
// scores, key columns tx + 8*j (j < 8) of each 64-key chunk; for the
// output, head columns tx*VW + 8*VW*j + e (VW = 4, or 2 at kHd 16).  The
// 8 threads of a row sit in one warp, so row maxima and sums are three
// xor shuffles.  q, k and v tiles are row-major in dynamic shared memory
// (rows padded by 4 floats, so 8 rows read as float4 hit 32 distinct
// banks); p goes through a padded 64 x 64 tile between the two products.
// That is 69 KB at kHd 64 and 117 KB at kHd 128, above the 48 KB of
// static shared memory, hence cudaFuncAttributeMaxDynamicSharedMemorySize.
//
// The head width in shared memory is the template parameter kHd (16, 32,
// 64 or 128).  A head of hd < kHd real columns is padded with zeros there;
// zero columns add nothing to q . k^T, and the padded output columns are
// not written.  Rows of hd == kHd columns move as float4, others one
// float at a time.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <cstdint>

namespace {
namespace f32 {

constexpr int kRows = 64;      // query rows per block, keys per chunk
constexpr int kThreads = 128;  // 16 x 8 threads, 4 warps
constexpr int kLnWidth = 64;   // head width of the q/k LayerNorm
constexpr unsigned kFull = 0xffffffffu;

struct AttnArgs {
  const float* q;
  const float* k;
  const float* v;
  int64_t ld_q, ld_k, ld_v;  // row strides, in elements
  int64_t bs_q, bs_k, bs_v;  // batch strides, in elements
  const float* gq;           // per-head LayerNorm of q and k (kLN only)
  const float* bq;
  const float* gk;
  const float* bk;
  float* out;                // (B, N, D) contiguous
  int N, D;
  float scale, eps;
  int hd;                    // real head width, at most kHd
};

// Shared memory for head width kHd: q, k and v tiles (rows padded by 4:
// a stride of 4 mod 32 words), then the p tile (a stride of 8 mod 32, so
// that the 4 x 8 threads of a warp store one p each to distinct banks).
template <int kHd>
struct Smem {
  static constexpr int kLd = kHd + 4;
  static constexpr int kLdP = kRows + 8;
  static constexpr size_t kBytes =
      (3 * kRows * kLd + kRows * kLdP) * sizeof(float);
};

__device__ __forceinline__ float group8_sum(float v) {
#pragma unroll
  for (int off = 1; off < 8; off <<= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__device__ __forceinline__ float group8_max(float v) {
#pragma unroll
  for (int off = 1; off < 8; off <<= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// Rows row0 .. row0+63 of a (rows, hd) operand into a kHd-wide tile; rows
// past n_rows and columns past hd are zero.
template <int kHd>
__device__ __forceinline__ void load_rows(float (*dst)[Smem<kHd>::kLd],
                                          const float* src, int row0,
                                          int n_rows, int64_t ld, int hd) {
  if (hd == kHd) {  // float4 vectors: kHd / 4 per row
    for (int c = threadIdx.x; c < kRows * kHd / 4; c += kThreads) {
      const int r = c / (kHd / 4), col = (c % (kHd / 4)) * 4;
      *reinterpret_cast<float4*>(&dst[r][col]) =
          (row0 + r < n_rows)
              ? *reinterpret_cast<const float4*>(src + (row0 + r) * ld + col)
              : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int i = threadIdx.x; i < kRows * kHd; i += kThreads) {
      const int r = i / kHd, col = i % kHd;
      dst[r][col] =
          (row0 + r < n_rows && col < hd) ? src[(row0 + r) * ld + col] : 0.f;
    }
  }
}

// The per-head LayerNorm of the real rows of a 64-wide tile, one warp per
// row, lanes on columns lane and lane + 32: fp32 mean and variance,
// (x - mu) * (1 / sqrt(var + eps)) * g + b.  The caller synchronises
// before and after.
__device__ __forceinline__ void layernorm_rows(float (*t)[Smem<kLnWidth>::kLd],
                                               int row0, int n_rows,
                                               const float* g, const float* b,
                                               float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < kRows && row0 + r < n_rows; r += kThreads / 32) {
    const float x0 = t[r][lane], x1 = t[r][lane + 32];
    const float mu = warp_sum(x0 + x1) / kLnWidth;
    const float d0 = x0 - mu, d1 = x1 - mu;
    const float inv = 1.f / sqrtf(warp_sum(d0 * d0 + d1 * d1) / kLnWidth + eps);
    t[r][lane] = d0 * inv * g[lane] + b[lane];
    t[r][lane + 32] = d1 * inv * g[lane + 32] + b[lane + 32];
  }
}

template <bool kLN, int kHd>
__global__ void __launch_bounds__(kThreads) attn_f32_kernel(AttnArgs a) {
  static_assert(kHd == 16 || kHd == 32 || kHd == 64 || kHd == 128,
                "head width 16, 32, 64 or 128");
  static_assert(!kLN || kHd == kLnWidth, "the q/k LayerNorm takes 64-wide heads");
  using L = Smem<kHd>;
  constexpr int kVW = kHd >= 32 ? 4 : 2;  // output columns per vector
  constexpr int kVN = kHd / (8 * kVW);    // vectors per thread and row
  extern __shared__ __align__(16) float smem[];
  auto sQ = reinterpret_cast<float (*)[L::kLd]>(smem);
  auto sK = sQ + kRows;
  auto sV = sK + kRows;
  auto sP = reinterpret_cast<float (*)[L::kLdP]>(smem + 3 * kRows * L::kLd);

  const int ty = threadIdx.x >> 3, tx = threadIdx.x & 7;
  const int q0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int N = a.N, hd = a.hd;
  const float* qg = a.q + b * a.bs_q + h * hd;
  const float* kg = a.k + b * a.bs_k + h * hd;
  const float* vg = a.v + b * a.bs_v + h * hd;

  load_rows<kHd>(sQ, qg, q0, N, a.ld_q, hd);
  if constexpr (kLN) {
    __syncthreads();
    layernorm_rows(sQ, q0, N, a.gq, a.bq, a.eps);
  }

  float m[4], l[4], o[4][kVN * kVW];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -CUDART_INF_F;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kVN * kVW; ++c) o[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < N; k0 += kRows) {
    __syncthreads();  // the previous chunk's p and v are consumed
    load_rows<kHd>(sK, kg, k0, N, a.ld_k, hd);
    load_rows<kHd>(sV, vg, k0, N, a.ld_v, hd);
    if constexpr (kLN) {
      __syncthreads();
      layernorm_rows(sK, k0, N, a.gk, a.bk, a.eps);
    }
    __syncthreads();

    // scores of rows ty + 16i against keys tx + 8j of the chunk
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < kHd; d += 4) {
      float4 qv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&sQ[ty + 16 * i][d]);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 kv = *reinterpret_cast<const float4*>(&sK[tx + 8 * j][d]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[i][j] = fmaf(qv[i].x, kv.x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv.y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv.z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv.w, s[i][j]);
        }
      }
    }

    // online softmax: running max, rescale, p into shared memory
    const int valid = min(kRows, N - k0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float cm = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = (tx + 8 * j < valid) ? s[i][j] * a.scale : -CUDART_INF_F;
        cm = fmaxf(cm, s[i][j]);
      }
      const float mn = fmaxf(m[i], group8_max(cm));  // finite: valid >= 1
      const float corr = expf(m[i] - mn);            // 0 on the first chunk
      m[i] = mn;
      l[i] *= corr;
#pragma unroll
      for (int c = 0; c < kVN * kVW; ++c) o[i][c] *= corr;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = expf(s[i][j] - mn);          // 0 past the real keys
        l[i] += p;
        sP[ty + 16 * i][tx + 8 * j] = p;
      }
    }
    __syncthreads();

    // o += p . v over the chunk's keys (v rows past N are zero)
#pragma unroll 2
    for (int c = 0; c < kRows; c += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(&sP[ty + 16 * i][c]);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        float vv[kVN * kVW];
#pragma unroll
        for (int n = 0; n < kVN; ++n) {
          const float* src = &sV[c + cc][tx * kVW + 8 * kVW * n];
          if constexpr (kVW == 4) {
            const float4 t = *reinterpret_cast<const float4*>(src);
            vv[4 * n] = t.x;
            vv[4 * n + 1] = t.y;
            vv[4 * n + 2] = t.z;
            vv[4 * n + 3] = t.w;
          } else {
            vv[2 * n] = src[0];
            vv[2 * n + 1] = src[1];
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = cc == 0 ? pv[i].x : cc == 1 ? pv[i].y
                        : cc == 2 ? pv[i].z : pv[i].w;
#pragma unroll
          for (int e = 0; e < kVN * kVW; ++e) o[i][e] = fmaf(p, vv[e], o[i][e]);
        }
      }
    }
  }

  // o / sum(p), the real rows and columns only
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float inv_l = 1.f / group8_sum(l[i]);
    const int q = q0 + ty + 16 * i;
    if (q >= N) continue;
    float* dst = a.out + (static_cast<int64_t>(b) * N + q) * a.D + h * hd;
#pragma unroll
    for (int n = 0; n < kVN; ++n) {
      const int col = tx * kVW + 8 * kVW * n;
      if constexpr (kVW == 4) {
        if (hd == kHd) {
          *reinterpret_cast<float4*>(dst + col) =
              make_float4(o[i][4 * n] * inv_l, o[i][4 * n + 1] * inv_l,
                          o[i][4 * n + 2] * inv_l, o[i][4 * n + 3] * inv_l);
          continue;
        }
      }
#pragma unroll
      for (int e = 0; e < kVW; ++e)
        if (col + e < hd) dst[col + e] = o[i][kVW * n + e] * inv_l;
    }
  }
}

// attention_core_f32_tc.cuh, included at the end of this header.
inline cudaError_t launch_attention_tc(const AttnArgs& a, int B, int H,
                                       cudaStream_t stream);

// One launch of the fp32 attention over (H heads, B batches, query tiles)
// on `stream`: attn_f32_tc_kernel without the LayerNorm at head width 64,
// attn_f32_kernel otherwise.  *ran_tc is set to 1 when the launch ran
// attn_f32_tc_kernel, else 0, so that the wrapper counts that kernel's
// launches from the launch itself.  Returns cudaGetLastError() after it.
template <bool kLN, int kHd = 64>
cudaError_t launch_attention(const AttnArgs& a, int B, int H,
                             cudaStream_t stream, int* ran_tc) {
  if constexpr (!kLN && kHd == 64) {
    const cudaError_t e = launch_attention_tc(a, B, H, stream);
    *ran_tc = e == cudaSuccess;
    return e;
  } else {
    *ran_tc = 0;
    constexpr size_t kBytes = Smem<kHd>::kBytes;
    cudaError_t e = cudaFuncSetAttribute(
        attn_f32_kernel<kLN, kHd>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kBytes));
    if (e != cudaSuccess) return e;
    const dim3 grid((a.N + kRows - 1) / kRows, H, B);
    attn_f32_kernel<kLN, kHd><<<grid, kThreads, kBytes, stream>>>(a);
    return cudaGetLastError();
  }
}

}  // namespace f32
}  // namespace

#include "attention_core_f32_tc.cuh"
