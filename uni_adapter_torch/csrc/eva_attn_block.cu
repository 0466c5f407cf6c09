// The whole EVA attention side of a transformer block for Hopper (sm_90a):
// q/k/v projections, per-head q/k LayerNorm, softmax(q.k^T * scale).v and
// the out projection, on the post-norm1 tokens xn (B, N, D) in bf16.
//
// Replaces: uni_adapter_tpu/ops/attention_pallas.py::eva_attn_block_fused
//   (_eva_block_kernel).  Rounding points mirrored from that kernel:
//   each projection accumulates in fp32, rounds to bf16, then adds its
//   bf16 bias (k has none); q/k LayerNorm takes fp32 statistics over the
//   head (eps from the caller) and rounds to bf16; scores are fp32,
//   p = exp((s - max) * scale) in fp32, p.v runs on bf16(p) with fp32
//   accumulation and is divided by the fp32 sum of p; heads are
//   concatenated in bf16; the out projection rounds like the others.
//
// What bounds it on the H100: tensor-core operations.  At the main path's
//   (B, N, D, H) = (2, 513, 1024, 16) it is ~10.8 GFLOP (8.6 in the four
//   projections, 2.2 in q.k^T and p.v) against ~12.6 MB of compulsory
//   traffic (four 2 MB weights, xn in, the result out): ~11 us at
//   989 TFLOP/s bf16 against ~4 us at 3.35 TB/s.
//
// What the design does about it: the TPU kernel keeps all four 1024^2
//   weights resident in VMEM (8 MB); a 227 KB SM cannot, so the span is
//   three launches on one stream:
//   (a) gemm_kernel: a tiled bf16 tensor-core GEMM (WMMA 16x16x16, fp32
//       accumulation, 64x64 tiles, K in steps of 32 with the next step's
//       tiles prefetched into registers) of xn by [Wq|Wk|Wv].  A 64-wide
//       column tile is one head, so the epilogue applies the bias and the
//       per-head LayerNorm while the tile is still on chip;
//   (b) attn_kernel, the bf16 attention core (attention_core.cuh, shared
//       with eva_attention.cu and attention_heads.cu), on the q/k/v columns
//       of that product: mma.sync fragments in registers, keys and values
//       streamed by cp.async; at the main path's 288 blocks of 64 queries,
//       four blocks of 4 warps an SM.  A first pass finds each row's exact
//       maximum, a second forms p against it, so no running rescale is
//       needed and the rounding of bf16(p) is the reference's;
//   (c) gemm_kernel again for the out projection with its bias.
//   The q/k/v and head-concat intermediates make one round trip through
//   device memory (~8 MB at the main path), which is what a later PR with
//   wgmma/TMA and a fused out projection would remove.
//
// The fp32 entry (uat_eva_attn_block_fp32) is the same span on fp32 xn and
//   weights, the fp32 form of _eva_block_kernel: every product fp32 FFMA
//   with fp32 accumulation, nothing rounded to a narrower type, no tensor
//   cores.  Bound by operations: the same ~10.8 GFLOP is ~0.16 ms at
//   67 TFLOP/s fp32, against ~25 MB of compulsory traffic (~7.5 us).  The
//   same three launches: (a) sgemm_f32_kernel, a shared-memory-tiled fp32
//   GEMM (64x64 tiles, K in steps of 32 prefetched into registers, 4x8
//   outputs a thread fed by float4 shared-memory reads) of xn by
//   [Wq|Wk|Wv], whose epilogue adds the bias and applies the per-head
//   LayerNorm in fp32, the 8 threads of a row holding its 64 columns (three
//   xor shuffles per statistic); (b) the fp32 attention of
//   attention_core_f32.cuh on the q/k/v columns; (c) sgemm_f32_kernel for
//   the out projection with its bias.
#include <mma.h>

#include "attention_core.cuh"
#include "attention_core_f32.cuh"

namespace {

using namespace nvcuda;

constexpr int kTile = 64;      // GEMM tile rows/cols
constexpr int kThreads = 128;  // GEMM threads, 4 warps
constexpr int kStepK = 32;     // GEMM K step

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

// C[:, s*seg_n : (s+1)*seg_n] = A . W[s]^T (+ bias[s]) (-> LayerNorm[s]),
// for the segments s the column tiles cover.  W[s] is (seg_n, K) row-major,
// PyTorch's (out, in) layout; LayerNorm is per 64-column head.
struct GemmArgs {
  const bf16* A;
  int M, K;
  const bf16* W[3];
  const bf16* bias[3];      // nullptr: no bias
  const float* ln_g[3];     // nullptr: no LayerNorm
  const float* ln_b[3];
  bf16* C;
  int ldc, seg_n;
  float eps;
};

__global__ void __launch_bounds__(kThreads) gemm_kernel(GemmArgs g) {
  __shared__ __align__(128) bf16 sA[kTile][kStepK + 8];
  __shared__ __align__(128) bf16 sB[kTile][kStepK + 8];
  __shared__ __align__(128) float sC[kTile][kTile + 4];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n0 = blockIdx.x * kTile, m0 = blockIdx.y * kTile;
  const int seg = n0 / g.seg_n, nl = n0 - seg * g.seg_n;
  const bf16* W = g.W[seg] + static_cast<size_t>(nl) * g.K;

  // each thread moves 2 of the 256 16-byte chunks of each 64x32 tile
  uint4 ra[2], rb[2];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int chunk = tid + c * kThreads, r = chunk >> 2, col = (chunk & 3) * 8;
      ra[c] = (m0 + r < g.M)
                  ? *reinterpret_cast<const uint4*>(
                        g.A + static_cast<size_t>(m0 + r) * g.K + k0 + col)
                  : make_uint4(0, 0, 0, 0);
      rb[c] = *reinterpret_cast<const uint4*>(
          W + static_cast<size_t>(r) * g.K + k0 + col);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  const int wr = (warp >> 1) * 32, wc = (warp & 1) * 32;

  fetch(0);
  for (int k0 = 0; k0 < g.K; k0 += kStepK) {
    __syncthreads();  // the previous step's fragments are loaded
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int chunk = tid + c * kThreads, r = chunk >> 2, col = (chunk & 3) * 8;
      *reinterpret_cast<uint4*>(&sA[r][col]) = ra[c];
      *reinterpret_cast<uint4*>(&sB[r][col]) = rb[c];
    }
    __syncthreads();
    if (k0 + kStepK < g.K) fetch(k0 + kStepK);  // in flight during the MMAs
#pragma unroll
    for (int kk = 0; kk < kStepK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], &sA[wr + i * 16][kk], kStepK + 8);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], &sB[wc + j * 16][kk], kStepK + 8);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&sC[wr + i * 16][wc + j * 16], acc[i][j],
                              kTile + 4, wmma::mem_row_major);
  __syncthreads();

  // epilogue: one warp per row, lanes on columns lane and lane + 32
  const bf16* bias = g.bias[seg];
  const float* ln_g = g.ln_g[seg];
  const float* ln_b = g.ln_b[seg];
  for (int r = warp; r < kTile; r += kThreads / 32) {
    const int m = m0 + r;
    if (m >= g.M) break;  // rows only grow; warp-uniform
    bf16 y0 = rn(sC[r][lane]), y1 = rn(sC[r][lane + 32]);
    if (bias != nullptr) {
      y0 = rn(bf(y0) + bf(bias[nl + lane]));
      y1 = rn(bf(y1) + bf(bias[nl + lane + 32]));
    }
    if (ln_g != nullptr)
      head_layernorm(bf(y0), bf(y1), ln_g, ln_b, g.eps, lane, y0, y1);
    bf16* c = g.C + static_cast<size_t>(m) * g.ldc + n0;
    c[lane] = y0;
    c[lane + 32] = y1;
  }
}

// C[:, s*seg_n : (s+1)*seg_n] = A . W[s]^T (+ bias[s]) (-> LayerNorm[s])
// in fp32, as GemmArgs above.  Needs K % 32 == 0 and 16-byte aligned A
// and W rows.
struct SgemmArgs {
  const float* A;
  int M, K;
  const float* W[3];
  const float* bias[3];     // nullptr: no bias
  const float* ln_g[3];     // nullptr: no LayerNorm
  const float* ln_b[3];
  float* C;
  int ldc, seg_n;
  float eps;
};

constexpr int kSgemmLd = kStepK + 4;  // 36 words: 8 rows read as float4 hit 32 banks

__global__ void __launch_bounds__(kThreads) sgemm_f32_kernel(SgemmArgs g) {
  __shared__ __align__(16) float sA[kTile][kSgemmLd];
  __shared__ __align__(16) float sB[kTile][kSgemmLd];

  // thread (ty, tx) owns rows ty + 16*i and columns tx + 8*j of the tile;
  // the 8 threads of a row are lanes of one warp
  const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7;
  const int n0 = blockIdx.x * kTile, m0 = blockIdx.y * kTile;
  const int seg = n0 / g.seg_n, nl = n0 - seg * g.seg_n;
  const float* W = g.W[seg] + static_cast<size_t>(nl) * g.K;

  // each thread moves 4 of the 512 float4 of each 64x32 tile
  float4 ra[4], rb[4];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int chunk = tid + c * kThreads, r = chunk >> 3, col = (chunk & 7) * 4;
      ra[c] = (m0 + r < g.M)
                  ? *reinterpret_cast<const float4*>(
                        g.A + static_cast<size_t>(m0 + r) * g.K + k0 + col)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
      rb[c] = *reinterpret_cast<const float4*>(
          W + static_cast<size_t>(r) * g.K + k0 + col);
    }
  };

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  fetch(0);
  for (int k0 = 0; k0 < g.K; k0 += kStepK) {
    __syncthreads();  // the previous step's tiles are consumed
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int chunk = tid + c * kThreads, r = chunk >> 3, col = (chunk & 7) * 4;
      *reinterpret_cast<float4*>(&sA[r][col]) = ra[c];
      *reinterpret_cast<float4*>(&sB[r][col]) = rb[c];
    }
    __syncthreads();
    if (k0 + kStepK < g.K) fetch(k0 + kStepK);  // in flight during the FFMAs
#pragma unroll
    for (int kk = 0; kk < kStepK; kk += 4) {
      float4 a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(&sA[ty + 16 * i][kk]);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 b = *reinterpret_cast<const float4*>(&sB[tx + 8 * j][kk]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][j] = fmaf(a[i].x, b.x, acc[i][j]);
          acc[i][j] = fmaf(a[i].y, b.y, acc[i][j]);
          acc[i][j] = fmaf(a[i].z, b.z, acc[i][j]);
          acc[i][j] = fmaf(a[i].w, b.w, acc[i][j]);
        }
      }
    }
  }

  // epilogue: bias, then the per-head LayerNorm over the row's 64 columns
  const float* bias = g.bias[seg];
  const float* ln_g = g.ln_g[seg];
  const float* ln_b = g.ln_b[seg];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float y[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      y[j] = bias != nullptr ? acc[i][j] + bias[nl + tx + 8 * j] : acc[i][j];
    if (ln_g != nullptr) {  // block-uniform: every lane takes the shuffles
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) sum += y[j];
      const float mu = f32::group8_sum(sum) / kHead;
      float sq = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        y[j] -= mu;
        sq += y[j] * y[j];
      }
      const float inv = 1.f / sqrtf(f32::group8_sum(sq) / kHead + g.eps);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        y[j] = y[j] * inv * ln_g[tx + 8 * j] + ln_b[tx + 8 * j];
    }
    const int m = m0 + ty + 16 * i;
    if (m < g.M) {
      float* c = g.C + static_cast<size_t>(m) * g.ldc + n0;
#pragma unroll
      for (int j = 0; j < 8; ++j) c[tx + 8 * j] = y[j];
    }
  }
}

}  // namespace

// xn: (B*N, D) bf16; wq/wk/wv/wo: (D, D) bf16 in (out, in) layout;
// bq/bv/bo: (D,) bf16 (k has no bias); gq/bqn/gk/bkn: (64,) fp32 per-head
// LayerNorm; qkv: (B*N, 3D) and attn: (B*N, D) bf16 workspaces; out:
// (B*N, D) bf16.  Needs D == 64*H.  Returns cudaGetLastError() after the
// last launch (0 on success).
extern "C" int uat_eva_attn_block(
    const bf16* xn, const bf16* wq, const bf16* bq, const bf16* wk,
    const bf16* wv, const bf16* bv, const float* gq, const float* bqn,
    const float* gk, const float* bkn, const bf16* wo, const bf16* bo,
    bf16* qkv, bf16* attn, bf16* out, int B, int N, int D, int H, float scale,
    float eps, cudaStream_t stream) {
  if (D != H * kHead || B <= 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int M = B * N;

  GemmArgs a{};
  a.A = xn;
  a.M = M;
  a.K = D;
  a.W[0] = wq; a.W[1] = wk; a.W[2] = wv;
  a.bias[0] = bq; a.bias[1] = nullptr; a.bias[2] = bv;
  a.ln_g[0] = gq; a.ln_b[0] = bqn;
  a.ln_g[1] = gk; a.ln_b[1] = bkn;
  a.ln_g[2] = nullptr; a.ln_b[2] = nullptr;
  a.C = qkv;
  a.ldc = 3 * D;
  a.seg_n = D;
  a.eps = eps;
  const dim3 grid_qkv(3 * D / kTile, (M + kTile - 1) / kTile);
  gemm_kernel<<<grid_qkv, kThreads, 0, stream>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  AttnArgs t{};
  t.q = qkv;
  t.k = qkv + D;
  t.v = qkv + 2 * D;
  t.ld_q = t.ld_k = t.ld_v = 3 * D;
  t.bs_q = t.bs_k = t.bs_v = static_cast<int64_t>(N) * 3 * D;
  t.out = attn;
  t.N = N;
  t.D = D;
  t.scale = scale;
  t.eps = eps;
  e = launch_attention<false>(t, B, H, stream);  // q/k LayerNorm'd above
  if (e != cudaSuccess) return static_cast<int>(e);

  GemmArgs p{};
  p.A = attn;
  p.M = M;
  p.K = D;
  p.W[0] = wo;
  p.bias[0] = bo;
  p.C = out;
  p.ldc = D;
  p.seg_n = D;
  p.eps = eps;
  const dim3 grid_out(D / kTile, (M + kTile - 1) / kTile);
  gemm_kernel<<<grid_out, kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The fp32 entry: xn (B*N, D), wq/wk/wv/wo (D, D) in (out, in) layout,
// bq/bv/bo (D,), gq/bqn/gk/bkn (64,), qkv (B*N, 3D) and attn (B*N, D)
// workspaces and out (B*N, D), all fp32, xn and the weights 16-byte
// aligned.  Needs D == 64*H.  Returns cudaGetLastError() after the last
// launch (0 on success).
extern "C" int uat_eva_attn_block_fp32(
    const float* xn, const float* wq, const float* bq, const float* wk,
    const float* wv, const float* bv, const float* gq, const float* bqn,
    const float* gk, const float* bkn, const float* wo, const float* bo,
    float* qkv, float* attn, float* out, int B, int N, int D, int H,
    float scale, float eps, cudaStream_t stream) {
  if (D != H * kHead || B <= 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int M = B * N;

  SgemmArgs a{};
  a.A = xn;
  a.M = M;
  a.K = D;
  a.W[0] = wq; a.W[1] = wk; a.W[2] = wv;
  a.bias[0] = bq; a.bias[1] = nullptr; a.bias[2] = bv;
  a.ln_g[0] = gq; a.ln_b[0] = bqn;
  a.ln_g[1] = gk; a.ln_b[1] = bkn;
  a.ln_g[2] = nullptr; a.ln_b[2] = nullptr;
  a.C = qkv;
  a.ldc = 3 * D;
  a.seg_n = D;
  a.eps = eps;
  const dim3 grid_qkv(3 * D / kTile, (M + kTile - 1) / kTile);
  sgemm_f32_kernel<<<grid_qkv, kThreads, 0, stream>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  f32::AttnArgs t{};
  t.q = qkv;
  t.k = qkv + D;
  t.v = qkv + 2 * D;
  t.ld_q = t.ld_k = t.ld_v = 3 * D;
  t.bs_q = t.bs_k = t.bs_v = static_cast<int64_t>(N) * 3 * D;
  t.out = attn;
  t.N = N;
  t.D = D;
  t.scale = scale;
  t.eps = eps;
  t.hd = kHead;
  e = f32::launch_attention<false>(t, B, H, stream);  // q/k LayerNorm'd above
  if (e != cudaSuccess) return static_cast<int>(e);

  SgemmArgs p{};
  p.A = attn;
  p.M = M;
  p.K = D;
  p.W[0] = wo;
  p.bias[0] = bo;
  p.C = out;
  p.ldc = D;
  p.seg_n = D;
  p.eps = eps;
  const dim3 grid_out(D / kTile, (M + kTile - 1) / kTile);
  sgemm_f32_kernel<<<grid_out, kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}
