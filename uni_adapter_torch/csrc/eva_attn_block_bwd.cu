// The backward of the fp32 EVA attention side's attention step and of its
// per-head q/k LayerNorm, for Hopper (sm_90a): given the forward's q^, k^
// (after the LayerNorm), v and the step's output O, and dO, the gradient
// of the loss by the raw q and k (before the LayerNorm), by v, and by the
// LayerNorms' gamma and beta.
//
// Replaces no TPU kernel: the JAX package trains with its Pallas flags
// off (cli/pretrain.py builds Uni3D with use_pallas_* False) and XLA
// differentiates the attention (uni_adapter_tpu/models/common.py
// EvaAttention).  On the card the forward is the fp32 entry of
// eva_attn_block.cu, which autograd cannot see through, so its backward
// is written here.  The out projection's and the q/k/v projections'
// products around it are large plain GEMMs (cuBLAS, as the JAX package
// leaves them to XLA); this file is what lies between them.
//
// The arithmetic (s = q^.k^T per head, unscaled, as the forward keeps it):
//   m = max_j s, l = sum_j exp((s - m) * scale), P = exp((s - m) * scale) / l,
//   Delta = rowsum(dO o O),
//   dV = P^T.dO, dS = P o (dO.V^T - Delta), dq^ = scale dS.k^, dk^ = scale dS^T.q^;
//   then per (row, head) the LayerNorm's backward over its 64 values:
//   x^ = (x - mu) * (1 / sqrt(var + eps)), dx^ = dy * gamma,
//   dx = rstd (dx^ - mean(dx^) - x^ mean(dx^ x^)), dgamma += dy x^, dbeta += dy,
//   from the raw x (x^ is recomputed, never recovered as (y - beta) / gamma).
//
// What bounds it on the H100: operations.  A head's backward is five
// N x N x 64 products (s, dP = dO.V^T, dV, dq^, dk^): at Uni3D-L's (B, N,
// D, H) = (2, 513, 1024, 16) 5 * 2 * B*H*N^2*64 = 5.39 GFLOP, 80 us at 67
// TFLOP/s FFMA; on the tensor cores in split TF32 three TF32 products
// each, 16.2 GFLOP, 33 us at 494.7 TFLOP/s; against ~42 MB read and
// written (13 us at 3.35 TB/s).
//
// What the design does about it:
//   * Every product runs on the tensor cores in split TF32, the scheme of
//     attention_core_f32_tc.cuh (its tf32_rna, split_tf32, mma_tf32 and
//     mma_split): each fp32 operand is hi + lo, each product lo.hi +
//     hi.lo + hi.hi on mma.sync.m16n8k8.tf32 with fp32 accumulation, a
//     few fp32 ulps from the FFMA product.  P and dS are split as they
//     leave the accumulators and never round to a narrower type.
//   * Seven products, not eight: (1) takes m and l online in its one pass
//     over the keys (the dq^ accumulators rescaled by 2^(m_old - m_new)
//     when the maximum grows, as the forward's output is), so s is not
//     computed for the statistics alone; (2) recomputes s and dP, the two
//     beyond the five.  A dq^ summed across key tiles would need atomics
//     or a workspace of per-key-tile partials (B*H*ceil(N/64)*N*64 floats,
//     303 MB at batch 16) to save those two.
//   * No float atomics: dq^ is summed by the block of its query tile,
//     dk^ and dv by the block of their key tile, each over the other
//     side's chunks in order, and dgamma/dbeta by per-block partials that
//     (3) adds in block order.  Every sum runs in the same order on every
//     run, so gradients are bitwise equal from run to run (a resumed
//     training run equals an uninterrupted one).
//   * The LayerNorm backward is fused into (1)'s and (2)'s epilogues: the
//     quad of lanes that holds a row's 64 dq^ (dk^) accumulators recomputes
//     x^ from the raw row, writes dq (dk) and adds to its block's dgamma
//     and dbeta partials; dq^ and dk^ never reach device memory.
//
// Three kernels, one after the other on the caller's stream:
//   (1) eva_bwd_dq_kernel, a block per (64 queries, batch, head): Delta,
//       then over 32-key chunks s, dP and dq^ += dS.k^ with m and l
//       online; writes (m + log2 l, Delta) a row for (2), dq, and its
//       dgamma_q / dbeta_q partials;
//   (2) eva_bwd_dkdv_kernel, a block per (64 keys, batch, head): over
//       32-query chunks s^T, dP^T, P^T from (1)'s statistics, dv += P^T.dO
//       and dk^ += dS^T.q^; writes dv, dk and its dgamma_k / dbeta_k
//       partials;
//   (3) eva_bwd_ln_sum_kernel: the partials added in block order, a warp
//       an output.
//
// Layouts.  A block is 4 warps of 16 rows (queries in (1), keys in (2)).
// Its own 64 rows of the two left operands (q^ scale log2(e) and dO in
// (1), k^ scale log2(e) and v in (2)) stay in shared memory for the
// whole pass; the other side's rows stream through a two-stage cp.async
// ring of 32-row chunks.  Every tile is row-major, rows padded to kLdV =
// 68 floats (4 mod 32 words), and every fragment is read as 32-bit words
// from the fp32 values and split in registers.  Lane (g, t) of an
// m16n8k8 takes A at (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4) and B
// at (k = t, n = g), (t + 4, g):
//   * s = (q^ c).k^T and dP = dO.V^T in (1), s^T = (k^ c).q^T and dP^T =
//     V.dO^T in (2): both operands are row-major tiles with the head dims
//     as k.  A's words sit at 4g + t (mod 32) and B's, rows j*8 + g of the
//     chunk at dims t and t + 4, also at 4g + t: no bank conflict.
//   * dq^ += dS.k^ in (1), dv += P^T.dO and dk^ += dS^T.q^ in (2): A is an
//     accumulator (rows g, g + 8; its 8 chunk rows at columns 2t, 2t + 1),
//     and the sum over chunk rows may take them in any order, so k-step
//     j's logical columns t and t + 4 are chunk rows 8j + 2t and 8j + 2t
//     + 1: the accumulator is the A fragment with no shuffle
//     (attention_core_f32_tc.cuh's relabelling), and B is the chunk's
//     rows 8j + 2t and 8j + 2t + 1 at head dim 8n + g, read row-major as
//     stored: 8t + g (mod 32), no bank conflict.  So the transposed
//     products need no transposed copy: P^T and dS^T come out of (2)'s
//     accumulators with keys as rows, the layout their A wants.
//   * Ragged N: rows past N are zeros in shared memory; keys (1) or
//     queries (2) past N get P = 0; 8-row blocks of a chunk with no real
//     row are skipped; a warp whose 16 rows are all past N copies its
//     share and skips the math; rows past N are not written and add
//     nothing to the partials.
//
// Any head count H with D == 64 H (a tensor-parallel rank's head shard
// too), B*H <= 65535.
#include <atomic>
#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

#include "attention_core_f32_tc.cuh"  // split TF32, mma.sync, cp.async, ex2

namespace {
namespace bwd {

// Rows of the other side a chunk, and the blocks an SM of (1) and of (2)
// that their registers are capped for: chosen by
// scripts/attn_bwd_configs.py on the card.
#ifndef UAT_BWD_CONFIG
#define UAT_BWD_CONFIG 32, 3, 3
#endif
constexpr int kConfig[] = {UAT_BWD_CONFIG};
constexpr int kChunk = kConfig[0];
constexpr int kDqMinBlocks = kConfig[1], kDkdvMinBlocks = kConfig[2];

constexpr int kHd = 64;                    // head dim
constexpr int kRows = 64;                  // a block's queries or keys
constexpr int kStatRound = 32;             // statistics rows: N rounded up
constexpr int kWarps = kRows / 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kLd = f32::kLdV;             // row stride of every tile
constexpr int kTile = kRows * kLd;         // floats of a block's own tile
constexpr int kChunkTile = kChunk * kLd;   // floats of a chunk's tile
constexpr int kStages = 2;                 // chunks in shared memory
constexpr int kKS = kHd / 8;               // k-steps over the head dims
constexpr int kNB = kChunk / 8;            // 8-row blocks of a chunk
constexpr int kSumBlocks = 32;             // of (3), 256 threads each
// (1): its q and dO tiles, then per stage a K and a V chunk; (2): its K
// and V tiles, then per stage a q^ and a dO chunk and the chunk's (m +
// log2 l, Delta) pairs
constexpr int kDqStage = 2 * kChunkTile;
constexpr int kDkdvStage = 2 * kChunkTile + 2 * kChunk;
constexpr int kDqSmem = (2 * kTile + kStages * kDqStage) * 4;
constexpr int kDkdvSmem = (2 * kTile + kStages * kDkdvStage) * 4;
static_assert(kChunk % f32::kTcChunk == 0, "load_chunk moves kTcChunk rows");
static_assert(kWarps * 2 * kHd <= kStages * kDqStage,
              "the partials' reduction fits in the stages");
static_assert(2 * kHd == kThreads, "a thread a partial of the block");

struct Args {
  const float* qkv;   // (B*N, 3D): q^ | k^ | v, head h at columns 64h
  const float* o;     // (B*N, D): the forward step's output
  const float* dout;  // (B*N, D): dO
  const float* raw;   // (B*N, 2D): q (with its bias) | k before the LayerNorm
  const float* gq;    // (64,)
  const float* gk;
  float* dqkv;        // (B*N, 3D): dq | dk | dv
  float* stats;       // (B*H, Ns, 2): m + log2 l (log2 units), Delta
  float* partials;    // (2, blocks, 2, 64): dgamma, dbeta of q, then of k
  int N, D, H, Ns;
  float scale, eps;
};

// Rows of a padded N: (1)'s statistics rows of one (batch, head), so that
// each starts 16-byte aligned and (2) reads a chunk's as cp.async vectors.
constexpr int stat_rows(int N) {
  return (N + kStatRound - 1) / kStatRound * kStatRound;
}

// Raise kernel's dynamic shared-memory limit to `bytes`, once per device.
template <typename Kernel>
cudaError_t raise_smem_once(Kernel kernel, int bytes,
                            std::atomic<uint64_t>& raised) {
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  const uint64_t bit = uint64_t{1} << (device & 63);
  if (raised.load(std::memory_order_acquire) & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes);
  if (e == cudaSuccess) raised.fetch_or(bit, std::memory_order_release);
  return e;
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(f32::kFull, v, 1);
  return v + __shfl_xor_sync(f32::kFull, v, 2);
}

// Rows row0 .. row0 + 63 of a (rows, 64) operand with row stride ld into
// a block tile, times c; rows past n_rows are zeros.
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int row0, int n_rows, int64_t ld,
                                          float c) {
  for (int i = threadIdx.x; i < kRows * kHd / 4; i += kThreads) {
    const int r = i / (kHd / 4), col = 4 * (i % (kHd / 4));
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n_rows)
      x = *reinterpret_cast<const float4*>(src + (row0 + r) * ld + col);
    *reinterpret_cast<float4*>(dst + r * kLd + col) =
        make_float4(x.x * c, x.y * c, x.z * c, x.w * c);
  }
}

// d[j] = a . b^T over the 64 head dims for the 8-row blocks j of a chunk:
// a is the warp's 16 rows of a block tile, b the chunk's tile; d[j][e] at
// a rows g (e < 2) and g + 8, chunk rows 8j + 2t + (e & 1).  Blocks with
// empty(j) stay zero.
template <typename Skip>
__device__ __forceinline__ void dot_rows(float (&d)[kNB][4], const float* a,
                                         const float* b, int g, int t,
                                         Skip empty) {
#pragma unroll
  for (int j = 0; j < kNB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kKS; ++kk) {
    const float* ar = a + g * kLd + kk * 8 + t;
    uint32_t ah[4], al[4];
    f32::split_tf32(ar[0], ah[0], al[0]);
    f32::split_tf32(ar[8 * kLd], ah[1], al[1]);
    f32::split_tf32(ar[4], ah[2], al[2]);
    f32::split_tf32(ar[8 * kLd + 4], ah[3], al[3]);
    float bf[kNB][2];
#pragma unroll
    for (int j = 0; j < kNB; ++j) {
      const float* br = b + (j * 8 + g) * kLd + kk * 8 + t;
      bf[j][0] = br[0];
      bf[j][1] = br[4];
    }
    f32::mma_split<0, kNB>(d, ah, al, bf, empty);
  }
}

// acc[n] += p . b over a chunk's rows: p in dot_rows' accumulator layout
// is the A operand (k-step j's logical columns t and t + 4 are chunk rows
// 8j + 2t and 8j + 2t + 1), b the chunk's tile, acc[n] at head dims 8n +
// 2t + (e & 1).  Blocks with empty(j) add nothing.
template <typename Skip>
__device__ __forceinline__ void acc_rows(float (&acc)[kKS][4],
                                         const float (&p)[kNB][4],
                                         const float* b, int g, int t,
                                         Skip empty) {
  auto none = [](int) { return false; };
#pragma unroll
  for (int j = 0; j < kNB; ++j) {
    if (empty(j)) continue;
    uint32_t ph[4], pl[4];
    f32::split_tf32(p[j][0], ph[0], pl[0]);
    f32::split_tf32(p[j][2], ph[1], pl[1]);
    f32::split_tf32(p[j][1], ph[2], pl[2]);
    f32::split_tf32(p[j][3], ph[3], pl[3]);
    const float* br = b + (j * 8 + 2 * t) * kLd + g;
    float bf[kKS][2];
#pragma unroll
    for (int n = 0; n < kKS; ++n) {
      bf[n][0] = br[n * 8];
      bf[n][1] = br[kLd + n * 8];
    }
    f32::mma_split<0, kKS / 2>(acc, ph, pl, bf, none);  // in two halves:
    f32::mma_split<kKS / 2, kKS>(acc, ph, pl, bf, none);  // fewer registers
  }
}

// The LayerNorm's backward for rows g and g + 8 of a warp's 16, whose 64
// values a quad holds as dy[n][2r + e] (row g + 8r, head dim 8n + 2t +
// e): x^ from the raw rows (row stride ld_raw), dx written to out (row
// stride ld_out) for the rows below rows_left, and this lane's dy x^ and
// dy of those rows added to pg and pb.
__device__ __forceinline__ void ln_bwd(const float (&dy)[kKS][4],
                                       const float* raw, int64_t ld_raw,
                                       float* out, int64_t ld_out,
                                       const float* gamma, int rows_left,
                                       float eps, int g, int t,
                                       float (&pg)[kKS][2],
                                       float (&pb)[kKS][2]) {
  constexpr float kInv = 1.f / kHd;
  float gm[kKS][2];
#pragma unroll
  for (int n = 0; n < kKS; ++n) {
    const float2 v = *reinterpret_cast<const float2*>(gamma + 8 * n + 2 * t);
    gm[n][0] = v.x;
    gm[n][1] = v.y;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = g + 8 * r;
    const bool real = row < rows_left;
    float x[kKS][2];
#pragma unroll
    for (int n = 0; n < kKS; ++n) {
      float2 v = make_float2(0.f, 0.f);
      if (real)
        v = *reinterpret_cast<const float2*>(raw + row * ld_raw + 8 * n +
                                             2 * t);
      x[n][0] = v.x;
      x[n][1] = v.y;
    }
    float sum = 0.f;
#pragma unroll
    for (int n = 0; n < kKS; ++n) sum += x[n][0] + x[n][1];
    const float mu = quad_sum(sum) * kInv;
    float sq = 0.f;
#pragma unroll
    for (int n = 0; n < kKS; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        x[n][e] -= mu;
        sq += x[n][e] * x[n][e];
      }
    const float rstd = 1.f / sqrtf(quad_sum(sq) * kInv + eps);
    float sdx = 0.f, sdxx = 0.f;
#pragma unroll
    for (int n = 0; n < kKS; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        x[n][e] *= rstd;  // x^
        const float dxh = dy[n][2 * r + e] * gm[n][e];
        sdx += dxh;
        sdxx += dxh * x[n][e];
      }
    const float mdx = quad_sum(sdx) * kInv, mdxx = quad_sum(sdxx) * kInv;
    if (!real) continue;
#pragma unroll
    for (int n = 0; n < kKS; ++n) {
      float y[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float d = dy[n][2 * r + e];
        y[e] = rstd * (d * gm[n][e] - mdx - x[n][e] * mdxx);
        pg[n][e] += d * x[n][e];
        pb[n][e] += d;
      }
      *reinterpret_cast<float2*>(out + row * ld_out + 8 * n + 2 * t) =
          make_float2(y[0], y[1]);
    }
  }
}

// The block's dgamma and dbeta partials (pg, pb of every lane) summed in
// a fixed order, over g by shuffles, then over the warps in order, into
// dst[0, 64) and dst[64, 128).  `red` is kWarps * 128 floats of shared
// memory that no thread still reads.
__device__ __forceinline__ void block_partials(float (&pg)[kKS][2],
                                               float (&pb)[kKS][2],
                                               float* red, float* dst) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int n = 0; n < kKS; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        pg[n][e] += __shfl_xor_sync(f32::kFull, pg[n][e], o);
        pb[n][e] += __shfl_xor_sync(f32::kFull, pb[n][e], o);
      }
  if (lane < 4) {
#pragma unroll
    for (int n = 0; n < kKS; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        red[warp * 2 * kHd + 8 * n + 2 * lane + e] = pg[n][e];
        red[warp * 2 * kHd + kHd + 8 * n + 2 * lane + e] = pb[n][e];
      }
  }
  __syncthreads();
  float v = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) v += red[w * 2 * kHd + threadIdx.x];
  dst[threadIdx.x] = v;
}

// (1) dq^ for 64 queries of one (batch, head), the rows' statistics for
// (2), then dq and the block's dgamma_q / dbeta_q partials.
__global__ void __launch_bounds__(kThreads, kDqMinBlocks)
    eva_bwd_dq_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;           // q^ * c
  float* sDO = sQ + kTile;    // dO
  float* sKV = sDO + kTile;   // the stages: a K chunk, then a V chunk
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int N = a.N, D = a.D;
  const int q0 = blockIdx.x * kRows, row0 = q0 + warp * 16;
  const int64_t ld3 = 3 * static_cast<int64_t>(D);
  const int64_t m0 = static_cast<int64_t>(b) * N;  // the batch's first row
  const float* qg = a.qkv + m0 * ld3 + h * kHd;
  const float* dog = a.dout + m0 * D + h * kHd;
  const int n_chunks = (N + kChunk - 1) / kChunk;
  const bool active = row0 < N;  // a real query in this warp's rows?

  auto sK = [&](int i) { return sKV + (i % kStages) * kDqStage; };
  auto sV = [&](int i) { return sK(i) + kChunkTile; };
  auto load = [&](int i) {
    for (int c = 0; i < n_chunks && c < kChunk; c += f32::kTcChunk) {
      f32::load_chunk<kLd, kThreads>(sK(i) + c * kLd, qg + D, i * kChunk + c,
                                     N, ld3, kHd, tid);
      f32::load_chunk<kLd, kThreads>(sV(i) + c * kLd, qg + 2 * D,
                                     i * kChunk + c, N, ld3, kHd, tid);
    }
  };
#pragma unroll
  for (int i = 0; i < kStages; ++i) {
    load(i);
    cp_async_commit();
  }

  // q^ times c = scale * log2(e): s in log2 units, p = 2^(s - m)
  load_tile(sQ, qg, q0, N, ld3, a.scale * 1.4426950408889634f);
  load_tile(sDO, dog, q0, N, D, 1.f);
  // Delta = rowsum(dO o O) of rows g and g + 8: a lane's 16 dims, then
  // its quad's
  float delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int q = row0 + g + 8 * r;
    float s = 0.f;
    if (q < N) {
      const float4* o4 = reinterpret_cast<const float4*>(
          a.o + (m0 + q) * D + h * kHd + 16 * t);
      const float4* d4 = reinterpret_cast<const float4*>(
          dog + q * static_cast<int64_t>(D) + 16 * t);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 x = o4[i], y = d4[i];
        s = fmaf(x.x, y.x, s);
        s = fmaf(x.y, y.y, s);
        s = fmaf(x.z, y.z, s);
        s = fmaf(x.w, y.w, s);
      }
    }
    delta[r] = quad_sum(s);
  }

  // acc: dS'.k^ with dS' = 2^(s - m) (dP - Delta), m the running maximum
  // (rescaled by 2^(m_old - m_new) as it grows, divided by l at the end);
  // rows g, g + 8 (r = e / 2), head dims 8n + 2t + (e & 1)
  float acc[kKS][4];
#pragma unroll
  for (int n = 0; n < kKS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};
  const float* qa = sQ + warp * 16 * kLd;
  const float* da = sDO + warp * 16 * kLd;

  auto chunk = [&](auto tail, int i) {
    constexpr bool kTail = decltype(tail)::value;
    const int valid = N - i * kChunk;  // real keys of the chunk
    auto empty = [&](int j) { return kTail && j * 8 >= valid; };
    float s[kNB][4], dp[kNB][4];
    dot_rows(s, qa, sK(i), g, t, empty);
    dot_rows(dp, da, sV(i), g, t, empty);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m[r];
#pragma unroll
      for (int j = 0; j < kNB; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (kTail && j * 8 + 2 * t + e >= valid)
            s[j][2 * r + e] = -CUDART_INF_F;
          mx = fmaxf(mx, s[j][2 * r + e]);
        }
      mx = fmaxf(mx, __shfl_xor_sync(f32::kFull, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(f32::kFull, mx, 2));  // a real key
      const float corr = ex2(m[r] - mx);                     // 0 at first
      m[r] = mx;
      l[r] *= corr;
#pragma unroll
      for (int n = 0; n < kKS; ++n) {
        acc[n][2 * r] *= corr;
        acc[n][2 * r + 1] *= corr;
      }
#pragma unroll
      for (int j = 0; j < kNB; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = ex2(s[j][2 * r + e] - mx);  // 0 past the real keys
          l[r] += p;
          s[j][2 * r + e] = p * (dp[j][2 * r + e] - delta[r]);  // dS'
        }
    }
    acc_rows(acc, s, sK(i), g, t, empty);
  };

  for (int i = 0; i < n_chunks; ++i) {
    cp_async_wait<kStages - 1>();  // chunk i's group has landed
    __syncthreads();
    if (active) {
      if (N - i * kChunk >= kChunk) chunk(std::false_type{}, i);
      else chunk(std::true_type{}, i);
    }
    __syncthreads();  // the stage is free
    load(i + kStages);
    cp_async_commit();
  }
  cp_async_wait<0>();  // the last groups are empty: nothing in flight

  // the rows' statistics for (2), in log2 units: P = 2^(s - (m + log2 l))
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = quad_sum(l[r]);
  float* st = a.stats + static_cast<int64_t>(bh) * a.Ns * 2;
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int q = row0 + g + 8 * r;
      if (q < N)
        *reinterpret_cast<float2*>(st + 2 * q) =
            make_float2(m[r] + log2f(l[r]), delta[r]);
    }
  }
  // dq^ = scale dS.k^, then the q LayerNorm's backward into dq
  float pg[kKS][2] = {}, pb[kKS][2] = {};
  if (active) {
    const float f[2] = {a.scale / l[0], a.scale / l[1]};
#pragma unroll
    for (int n = 0; n < kKS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= f[e >> 1];
    ln_bwd(acc, a.raw + (m0 + row0) * 2 * D + h * kHd,
           2 * static_cast<int64_t>(D), a.dqkv + (m0 + row0) * ld3 + h * kHd,
           ld3, a.gq, N - row0, a.eps, g, t, pg, pb);
  }
  block_partials(pg, pb, sKV,
                 a.partials + (static_cast<int64_t>(blockIdx.y) * gridDim.x +
                               blockIdx.x) * 2 * kHd);
}

// (2) dk^ and dv for 64 keys of one (batch, head), then dv, dk and the
// block's dgamma_k / dbeta_k partials.
__global__ void __launch_bounds__(kThreads, kDkdvMinBlocks)
    eva_bwd_dkdv_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  float* sK = smem;           // k^ * c
  float* sV = sK + kTile;
  float* sQD = sV + kTile;    // the stages: a q^ chunk, a dO chunk, stats
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int N = a.N, D = a.D;
  const int k0 = blockIdx.x * kRows, row0 = k0 + warp * 16;
  const int64_t ld3 = 3 * static_cast<int64_t>(D);
  const int64_t m0 = static_cast<int64_t>(b) * N;
  const float* qg = a.qkv + m0 * ld3 + h * kHd;
  const float* dog = a.dout + m0 * D + h * kHd;
  const float* stg = a.stats + static_cast<int64_t>(bh) * a.Ns * 2;
  const int n_chunks = (N + kChunk - 1) / kChunk;
  const bool active = row0 < N;  // a real key in this warp's rows?

  auto sQc = [&](int i) { return sQD + (i % kStages) * kDkdvStage; };
  auto sDOc = [&](int i) { return sQc(i) + kChunkTile; };
  auto sSt = [&](int i) { return sQc(i) + 2 * kChunkTile; };
  auto load = [&](int i) {
    if (i >= n_chunks) return;
    for (int c = 0; c < kChunk; c += f32::kTcChunk) {
      f32::load_chunk<kLd, kThreads>(sQc(i) + c * kLd, qg, i * kChunk + c, N,
                                     ld3, kHd, tid);
      f32::load_chunk<kLd, kThreads>(sDOc(i) + c * kLd, dog, i * kChunk + c,
                                     N, D, kHd, tid);
    }
    // (m + log2 l, Delta) of the chunk's queries, two a 16-byte vector;
    // past N zeros (a half vector at an odd N)
    for (int v = tid; v < kChunk / 2; v += kThreads) {
      const int q = i * kChunk + 2 * v;
      const int bytes = q + 1 < N ? 16 : q < N ? 8 : 0;
      cp_async16(sSt(i) + 4 * v, bytes ? stg + 2 * q : stg, bytes);
    }
  };
#pragma unroll
  for (int i = 0; i < kStages; ++i) {
    load(i);
    cp_async_commit();
  }
  load_tile(sK, qg + D, k0, N, ld3, a.scale * 1.4426950408889634f);
  load_tile(sV, qg + 2 * D, k0, N, ld3, 1.f);

  // dv and dk^ of keys g, g + 8 (r = e / 2) at head dims 8n + 2t + (e & 1)
  float dv[kKS][4], dk[kKS][4];
#pragma unroll
  for (int n = 0; n < kKS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dv[n][e] = dk[n][e] = 0.f;
  const float* ka = sK + warp * 16 * kLd;
  const float* va = sV + warp * 16 * kLd;

  auto chunk = [&](auto tail, int i) {
    constexpr bool kTail = decltype(tail)::value;
    const int valid = N - i * kChunk;  // real queries of the chunk
    auto empty = [&](int j) { return kTail && j * 8 >= valid; };
    float s[kNB][4], dp[kNB][4];  // s^T and dP^T: keys x queries
    dot_rows(s, ka, sQc(i), g, t, empty);
    dot_rows(dp, va, sDOc(i), g, t, empty);
    const float* st = sSt(i);
#pragma unroll
    for (int j = 0; j < kNB; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qc = j * 8 + 2 * t + e;  // the query within the chunk
        const float2 sd = *reinterpret_cast<const float2*>(st + 2 * qc);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float p = kTail && qc >= valid
                              ? 0.f
                              : ex2(s[j][2 * r + e] - sd.x);
          s[j][2 * r + e] = p;                                  // P^T
          dp[j][2 * r + e] = p * (dp[j][2 * r + e] - sd.y);     // dS^T
        }
      }
    acc_rows(dv, s, sDOc(i), g, t, empty);
    acc_rows(dk, dp, sQc(i), g, t, empty);
  };

  for (int i = 0; i < n_chunks; ++i) {
    cp_async_wait<kStages - 1>();
    __syncthreads();
    if (active) {
      if (N - i * kChunk >= kChunk) chunk(std::false_type{}, i);
      else chunk(std::true_type{}, i);
    }
    __syncthreads();
    load(i + kStages);
    cp_async_commit();
  }
  cp_async_wait<0>();

  float pg[kKS][2] = {}, pb[kKS][2] = {};
  if (active) {
    float* out = a.dqkv + (m0 + row0) * ld3 + h * kHd;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = g + 8 * r;
      if (row0 + row >= N) continue;
#pragma unroll
      for (int n = 0; n < kKS; ++n)
        *reinterpret_cast<float2*>(out + row * ld3 + 2 * D + 8 * n + 2 * t) =
            make_float2(dv[n][2 * r], dv[n][2 * r + 1]);
    }
#pragma unroll
    for (int n = 0; n < kKS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[n][e] *= a.scale;
    ln_bwd(dk, a.raw + (m0 + row0) * 2 * D + D + h * kHd,
           2 * static_cast<int64_t>(D), out + D, ld3, a.gk, N - row0, a.eps,
           g, t, pg, pb);
  }
  const int64_t blocks = static_cast<int64_t>(gridDim.x) * gridDim.y;
  block_partials(pg, pb, sQD,
                 a.partials + (blocks + static_cast<int64_t>(blockIdx.y) *
                                            gridDim.x + blockIdx.x) * 2 * kHd);
}

// (3) dgamma_q, dbeta_q, dgamma_k, dbeta_k: (1)'s and (2)'s partials added
// in block order, a warp an output (lane l takes blocks l, l + 32, ...,
// then a fixed shuffle tree).
__global__ void __launch_bounds__(256)
    eva_bwd_ln_sum_kernel(const float* partials, int64_t blocks, float* out) {
  const int w = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;  // output
  const int lane = threadIdx.x & 31;
  const int seg = w / (2 * kHd), col = w % (2 * kHd);
  const float* p = partials + seg * blocks * 2 * kHd + col;
  float v = 0.f;
  for (int64_t i = lane; i < blocks; i += 32) v += p[i * 2 * kHd];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(f32::kFull, v, o);
  if (lane == 0) out[w] = v;
}
static_assert(kSumBlocks * 256 / 32 == 4 * kHd, "a warp an output");

std::atomic<uint64_t> dq_smem_raised{0}, dkdv_smem_raised{0};

}  // namespace bwd
}  // namespace

// The floats of uat_eva_attn_block_bwd's two workspaces at (B, N, H):
// stats, the row statistics (B*H, N rounded up to kStatRound, 2); and
// partials, the dgamma/dbeta partials (2, blocks, 2, 64), a block a
// kRows-row tile of one (batch, head).  Returns 0, or
// cudaErrorInvalidValue for B, N or H below 1.
extern "C" int uat_eva_attn_block_bwd_workspace(int B, int N, int H,
                                                int64_t* stats_floats,
                                                int64_t* partial_floats) {
  using namespace bwd;
  if (B <= 0 || N <= 0 || H <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t bh = static_cast<int64_t>(B) * H;
  *stats_floats = bh * stat_rows(N) * 2;
  *partial_floats = 2 * ((N + kRows - 1) / kRows) * bh * 2 * kHd;
  return 0;
}

// qkv: (B*N, 3D) q^ | k^ | v and o: (B*N, D), the fp32 block's workspaces
// after its forward; dout: (B*N, D) dO; raw: (B*N, 2D) q (with its bias)
// | k before the LayerNorm; gq, gk: (64,) the LayerNorms' gammas; dqkv:
// (B*N, 3D) out, dq | dk | dv by the raw q, k and by v; stats and
// partials: workspaces of stats_floats and partial_floats floats, at least
// what uat_eva_attn_block_bwd_workspace gives; dln: (4, 64)
// out, dgamma_q, dbeta_q, dgamma_k, dbeta_k.  All fp32, contiguous,
// 16-byte aligned.  Needs D == 64*H and B*H <= 65535.  Returns
// cudaGetLastError() after the last launch (0 on success).
extern "C" int uat_eva_attn_block_bwd(
    const float* qkv, const float* o, const float* dout, const float* raw,
    const float* gq, const float* gk, float* dqkv, float* stats,
    int64_t stats_floats, float* partials, int64_t partial_floats,
    float* dln, int B, int N, int D, int H, float scale, float eps,
    cudaStream_t stream) {
  using namespace bwd;
  if (D != H * kHd || B <= 0 || N <= 0 || B * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + kRows - 1) / kRows, B * H);
  const int64_t blocks = static_cast<int64_t>(grid.x) * grid.y;
  const int Ns = stat_rows(N);
  if (stats_floats < static_cast<int64_t>(B) * H * Ns * 2 ||
      partial_floats < 2 * blocks * 2 * kHd)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = raise_smem_once(eva_bwd_dq_kernel, kDqSmem,
                                  dq_smem_raised);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = raise_smem_once(eva_bwd_dkdv_kernel, kDkdvSmem, dkdv_smem_raised);
  if (e != cudaSuccess) return static_cast<int>(e);
  const Args args{qkv, o, dout, raw, gq, gk, dqkv, stats, partials,
                  N, D, H, Ns, scale, eps};
  eva_bwd_dq_kernel<<<grid, kThreads, kDqSmem, stream>>>(args);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  eva_bwd_dkdv_kernel<<<grid, kThreads, kDkdvSmem, stream>>>(args);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  eva_bwd_ln_sum_kernel<<<kSumBlocks, 256, 0, stream>>>(partials, blocks,
                                                        dln);
  return static_cast<int>(cudaGetLastError());
}
