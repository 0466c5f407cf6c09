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
//   (b) attn_kernel: one block per (64 queries, head, batch); keys and
//       values stream through shared memory in chunks of 64.  A first pass
//       finds each row's exact maximum, a second forms p against it, so no
//       running rescale is needed and the rounding of bf16(p) is the
//       reference's;
//   (c) gemm_kernel again for the out projection with its bias.
//   The q/k/v and head-concat intermediates make one round trip through
//   device memory (~8 MB at the main path), which is what a later PR with
//   wgmma/TMA and a fused out projection would remove.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <mma.h>
#include <cstdint>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kHead = 64;      // head dim: one GEMM column tile per head
constexpr int kTile = 64;      // GEMM tile rows/cols, attention query rows
constexpr int kStepK = 32;     // GEMM K step
constexpr int kThreads = 128;  // 4 warps
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float bf(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ bf16 rn(float x) { return __float2bfloat16_rn(x); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
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
    if (ln_g != nullptr) {
      const float x0 = bf(y0), x1 = bf(y1);
      const float mu = warp_sum(x0 + x1) / kHead;
      const float d0 = x0 - mu, d1 = x1 - mu;
      const float var = warp_sum(d0 * d0 + d1 * d1) / kHead;
      const float inv = 1.f / sqrtf(var + g.eps);
      y0 = rn(__fadd_rn(__fmul_rn(__fmul_rn(d0, inv), ln_g[lane]), ln_b[lane]));
      y1 = rn(__fadd_rn(__fmul_rn(__fmul_rn(d1, inv), ln_g[lane + 32]),
                        ln_b[lane + 32]));
    }
    bf16* c = g.C + static_cast<size_t>(m) * g.ldc + n0;
    c[lane] = y0;
    c[lane + 32] = y1;
  }
}

// Attention over one head for 64 query rows.  qkv: (B*N, 3D) with q, k, v
// of head h at columns h*64, D + h*64, 2D + h*64; out: (B*N, D).
constexpr int kLd = kHead + 8;  // bf16 row stride in shared memory
constexpr int kLdS = kTile + 4;  // fp32 row stride
constexpr size_t kAttnSmem =
    3 * kTile * kLd * sizeof(bf16)            // sQ, sK, sV
    + 4 * 16 * kLdS * sizeof(float)           // per-warp scores
    + 4 * 16 * kLd * sizeof(bf16);            // per-warp bf16(p)

__device__ __forceinline__ void load_rows(bf16 (*dst)[kLd], const bf16* src,
                                         int row0, int n_rows, int ld) {
  // 64 rows x 64 bf16 = 512 chunks of 16 bytes; rows past n_rows are zero
  for (int chunk = threadIdx.x; chunk < kTile * kHead / 8; chunk += kThreads) {
    const int r = chunk >> 3, col = (chunk & 7) * 8;
    *reinterpret_cast<uint4*>(&dst[r][col]) =
        (row0 + r < n_rows)
            ? *reinterpret_cast<const uint4*>(src + static_cast<size_t>(row0 + r) * ld + col)
            : make_uint4(0, 0, 0, 0);
  }
}

__global__ void __launch_bounds__(kThreads)
attn_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out, int N, int D,
            float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  auto sQ = reinterpret_cast<bf16 (*)[kLd]>(smem);
  auto sK = sQ + kTile;
  auto sV = sK + kTile;
  auto sS = reinterpret_cast<float (*)[16][kLdS]>(
      smem + 3 * kTile * kLd * sizeof(bf16));
  auto sP = reinterpret_cast<bf16 (*)[16][kLd]>(
      smem + 3 * kTile * kLd * sizeof(bf16) + 4 * 16 * kLdS * sizeof(float));

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int ld = 3 * D;
  const bf16* base = qkv + static_cast<size_t>(b) * N * ld;
  const bf16* qg = base + h * kHead;
  const bf16* kg = base + D + h * kHead;
  const bf16* vg = base + 2 * D + h * kHead;

  load_rows(sQ, qg, q0, N, ld);
  __syncthreads();
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qa[kHead / 16];
#pragma unroll
  for (int kk = 0; kk < kHead / 16; ++kk)
    wmma::load_matrix_sync(qa[kk], &sQ[warp * 16][kk * 16], kLd);

  // lane (r, half) owns row r of this warp's 16 and 32 of the 64 columns
  const int r = lane >> 1, c0 = (lane & 1) * 32;
  float (*S)[kLdS] = sS[warp];
  bf16 (*P)[kLd] = sP[warp];

  auto scores = [&]() {  // S = Q_w . K_chunk^T, fp32
#pragma unroll
    for (int j = 0; j < kTile / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> s;
      wmma::fill_fragment(s, 0.f);
#pragma unroll
      for (int kk = 0; kk < kHead / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kb;
        wmma::load_matrix_sync(kb, &sK[j * 16][kk * 16], kLd);
        wmma::mma_sync(s, qa[kk], kb, s);
      }
      wmma::store_matrix_sync(&S[0][j * 16], s, kLdS, wmma::mem_row_major);
    }
    __syncwarp();
  };

  // pass 1: the exact row maximum over all keys
  float mx = -CUDART_INF_F;
  for (int k0 = 0; k0 < N; k0 += kTile) {
    __syncthreads();
    load_rows(sK, kg, k0, N, ld);
    __syncthreads();
    scores();
    const int valid = min(kTile, N - k0);
    for (int c = 0; c < 32; ++c)
      if (c0 + c < valid) mx = fmaxf(mx, S[r][c0 + c]);
    __syncwarp();
  }
  mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));

  // pass 2: p = exp((s - max) * scale); o = bf16(p) . v; l = sum of fp32 p
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> o[kHead / 16];
#pragma unroll
  for (int j = 0; j < kHead / 16; ++j) wmma::fill_fragment(o[j], 0.f);
  float l = 0.f;
  for (int k0 = 0; k0 < N; k0 += kTile) {
    __syncthreads();
    load_rows(sK, kg, k0, N, ld);
    load_rows(sV, vg, k0, N, ld);
    __syncthreads();
    scores();
    const int valid = min(kTile, N - k0);
    for (int c = 0; c < 32; ++c) {
      float p = 0.f;
      if (c0 + c < valid) {
        p = expf(__fmul_rn(__fsub_rn(S[r][c0 + c], mx), scale));
        l += p;
      }
      P[r][c0 + c] = rn(p);
    }
    __syncwarp();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pa;
      wmma::load_matrix_sync(pa, &P[0][kk * 16], kLd);
#pragma unroll
      for (int j = 0; j < kHead / 16; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vb;
        wmma::load_matrix_sync(vb, &sV[kk * 16][j * 16], kLd);
        wmma::mma_sync(o[j], pa, vb, o[j]);
      }
    }
    __syncwarp();
  }
  l += __shfl_xor_sync(kFull, l, 1);

#pragma unroll
  for (int j = 0; j < kHead / 16; ++j)
    wmma::store_matrix_sync(&S[0][j * 16], o[j], kLdS, wmma::mem_row_major);
  __syncwarp();
  const int q = q0 + warp * 16 + r;
  if (q < N) {
    bf16* dst = out + (static_cast<size_t>(b) * N + q) * D + h * kHead + c0;
    for (int c = 0; c < 32; ++c) dst[c] = rn(S[r][c0 + c] / l);
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

  e = cudaFuncSetAttribute(attn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(kAttnSmem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid_attn((N + kTile - 1) / kTile, H, B);
  attn_kernel<<<grid_attn, kThreads, kAttnSmem, stream>>>(qkv, attn, N, D, scale);
  e = cudaGetLastError();
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
