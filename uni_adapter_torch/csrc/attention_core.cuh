// The bf16 attention core for Hopper (sm_90a), shared by eva_attention.cu
// (the natural-layout attention of ViTAttention), attention_heads.cu (the
// (B, H, N, hd) attention) and eva_attn_block.cu (the attention step of the
// EVA block).
//
// Replaces, with those three entries:
//   uni_adapter_tpu/ops/attention_pallas.py::eva_attention_fused
//   (_eva_fused_kernel), ::attention_pallas_heads (_attn_heads_kernel) and
//   the attention step of ::eva_attn_block_fused (_eva_block_kernel).
//
// q, k and v are (B, N, ...) bf16 with their own row and batch strides,
// head h at columns h*hd .. h*hd+hd-1 of each row; the output is a
// contiguous (B, N, D) bf16, head h at the same columns.
//
// Rounding points, the Pallas kernels' (attention_pallas.py:89-135,
// :196-247): scores are fp32 from bf16 q and k (tensor-core products,
// fp32 accumulation); a first pass takes each row's exact maximum over the
// N real keys; a second forms p = exp((s - max) * scale) in fp32,
// accumulates bf16(p) . v in fp32 and divides by the fp32 sum of p; the
// output is bf16.  With kLN, q and k first go through a per-head LayerNorm
// (fp32 statistics over the 64 values, one gamma/beta shared by all heads),
// rounded to bf16 before q.k^T.  No online softmax: the maximum is exact
// before any p is formed, so bf16(p) rounds where the reference rounds it
// and only the order of summation differs.  exp((s - max) * scale) is
// computed as 2^(s * c - max * c) with c = scale * log2(e): one FFMA and
// one ex2.approx (relative error ~2^-22), which moves p by a few fp32 ulps,
// the same class as the order of summation in s itself.
//
// What bounds it on the H100: at the main paths' shapes neither bytes nor
// operations.  (1, 16, 513, 64), the Uni3D-L extraction, reads q, k, v and
// writes the output, 4.2 MB (1.3 us at 3.35 TB/s), against 1.08 GFLOP of
// q.k^T and p.v (1.1 us at 989 TFLOP/s bf16; the second q.k^T of the exact
// maximum adds half of that again); the natural layout's (2, 385, 512, 8)
// and (2, 513, 384, 6) are 3.2 MB and 0.6-0.8 GFLOP, ~1 us either way.
// What sets the time is latency: 54-288 blocks, each walking its keys twice
// in 64-key chunks, a chain of copies, tensor-core products and the exp of
// every score (16 a clock on an SM's special-function units).
//
// What the design does about latency:
//   * fragments stay in registers: q.k^T and p.v are mma.sync.m16n8k16
//     (bf16 in, fp32 accumulate) on ldmatrix fragments; each warp owns 16
//     query rows (a slab) and takes a 64-key chunk in two halves of 32
//     (fewer registers live); row maxima and sums are quad shuffles on the
//     accumulator; p is formed in registers and packed as bf16 straight
//     into the A fragment of p.v (the m16n8k16 accumulator layout is the A
//     layout); v is read with ldmatrix.trans.  Scores never touch shared
//     memory;
//   * more warps per SM with no extra device-memory traffic: a block of
//     kSlabs slabs splits its keys among kSplit ranges of kSlabs warps
//     (chunk c to range c % kSplit), each range synchronising on its own
//     named barrier.  Pass 1: each range takes its rows' maxima, which
//     combine through shared memory into the exact row maximum.  Pass 2:
//     each range accumulates a partial o and sum of p against that
//     maximum; the partials are summed in shared memory before the one
//     division and the bf16 store.  The shape is chosen per launch from
//     the grid (launch_attention), so that an SM holds ~16 warps in one
//     wave where it can: 64 rows x 4 ranges at 54-112 blocks, 80 rows x 3
//     ranges for Uni3D's 16 heads at N = 513 (112 blocks, where 64-row
//     blocks would be 144 on 132 SMs), 64 x 1 (four blocks an SM) for the
//     block's 288, 64 x 2 at head width 128;
//   * asynchronous copies: each range streams its chunks through a ring of
//     two stages with 16-byte cp.async, each copy issued two chunks ahead.
//     V is first needed in pass 2, so the V of the range's last two chunks
//     is fetched at the start into the V slots pass 1 leaves idle, and pass
//     2 walks the chunks backwards: its first two find K still in place
//     from pass 1 and V landed, and the rest are fetched two ahead.  The q
//     tile is loaded, and LayerNorm'd when kLN, once; with kLN each key
//     chunk is LayerNorm'd once per pass as it lands (8 lanes a row, three
//     shuffles a statistic), never per warp;
//   * only real work: a warp whose 16 rows hold no real query skips the
//     math (the last query tile at N = 385 or 513 holds one row, and its
//     slab's warps sit on four different SM sub-partitions); full chunks
//     run without masks, and the last chunk computes only the 16-key
//     column blocks that hold real keys (one key at N = 385 and 513); the
//     query tile is the slowest grid index, so the last, lightest tiles are
//     the blocks that wait for or share an SM;
//   * no host work on the way: cudaFuncSetAttribute (dynamic shared
//     memory) runs once per instantiation and device.
//
// Any N, any hd <= 128: the head width in shared memory is the template
// parameter kHd (16, 32, 64 or 128).  A head of hd < kHd real columns is
// padded with zeros there (they add nothing to q.k^T), rows move one
// element at a time, and only the hd real output columns are written; rows
// of hd == kHd columns move as 16-byte cp.async.  Rows past N are zero and
// their keys masked: -inf in the maximum, p = 0.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <atomic>
#include <cstdint>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kHead = 64;      // head dim of every path; the q/k LayerNorm's width
constexpr int kChunk = 64;     // keys a chunk
constexpr int kStages = 2;     // chunks a key range has in shared memory
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float bf(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ bf16 rn(float x) { return __float2bfloat16_rn(x); }

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

// ---- PTX: shared-memory addresses, cp.async, ldmatrix, mma, barriers ----

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously; src_bytes = 0
// writes 16 zero bytes and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `kPending` of this thread's copy groups are in flight.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// The kThreads threads of one key range (barrier 0 is __syncthreads').
template <int kThreads>
__device__ __forceinline__ void range_sync(int range) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + range), "n"(kThreads) : "memory");
}

// Four 8x8 bf16 matrices, one row address per lane (lanes 8m..8m+7 give
// matrix m's rows); `trans` hands each lane a column pair, not a row pair.
template <bool kTrans>
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  if constexpr (kTrans)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_addr(p))
        : "memory");
  else
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_addr(p))
        : "memory");
}

// d += a . b on the tensor cores: a 16x16 bf16 (row), b 16x8 bf16 (col),
// d 16x8 fp32.  Lane (g = lane / 4, t = lane % 4) holds d rows g and g + 8,
// columns 2t and 2t + 1.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a . b (the accumulator starts at zero).
__device__ __forceinline__ void mma_bf16_first(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 2^x on the special-function unit (one instruction; results below 2^-126
// flush to zero, where bf16(p) and the fp32 sum of p lose nothing).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---- tiles in shared memory ----

// Shared memory for head width kHd, kSlabs 16-row query slabs and kSplit
// key ranges: the q tile, then per range kStages stages of a K and a V
// chunk (reused at the end for the ranges' partial outputs), then the
// ranges' row maxima.  Rows are padded by 16 bytes, so the 8 row addresses
// of an ldmatrix hit distinct banks.
template <int kHd, int kSlabs, int kSplit>
struct AttnSmem {
  static constexpr int kLd = kHd + 8;
  static constexpr int kQRows = 16 * kSlabs;
  static constexpr int kQTile = kQRows * kLd;  // elements of the q tile
  static constexpr int kTile = kChunk * kLd;   // elements of a K or V chunk
  static constexpr size_t kStageOffset = kQTile * sizeof(bf16);
  static constexpr size_t kMaxOffset =
      kStageOffset + kSplit * kStages * 2 * kTile * sizeof(bf16);
  static constexpr size_t kBytes = kMaxOffset + kSplit * kQRows * sizeof(float);
  // a range's partial output for one warp: kHd/8 fragments of 4 and 2 sums
  // a lane
  static constexpr int kPart = (kHd / 8 * 4 + 2) * 32;
  static_assert((kSplit - 1) * kSlabs * kPart * sizeof(float) <=
                    kSplit * kStages * 2 * kTile * sizeof(bf16),
                "the partial outputs fit in the key stages");
};

// Rows row0 .. row0+kRows-1 of a (rows, hd) operand into a kHd-wide tile,
// by kThreads threads from thread t; rows past n_rows and columns past hd
// are zero.  hd == kHd: 16-byte cp.async (the caller commits); otherwise
// element by element.
template <int kHd, int kRows, int kThreads>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int row0,
                                          int n_rows, int64_t ld, int hd,
                                          int t) {
  constexpr int kLd = kHd + 8;
  if (hd == kHd) {
    // thread t moves column block t % (kHd/8) of rows t / (kHd/8) + kStep*m
    constexpr int kVec = kHd / 8, kStep = kThreads / kVec;
    static_assert(kThreads % kVec == 0, "whole rows");
    const int r0 = t / kVec, col = (t % kVec) * 8;
    const bf16* from = src + static_cast<int64_t>(row0 + r0) * ld + col;
#pragma unroll
    for (int m = 0; m < (kRows + kStep - 1) / kStep; ++m) {
      const int r = r0 + m * kStep;
      if (kRows % kStep != 0 && r >= kRows) break;  // past the tile
      const bool real = row0 + r < n_rows;
      cp_async16(dst + r * kLd + col,
                 real ? from + static_cast<int64_t>(m * kStep) * ld : src,
                 real ? 16 : 0);
    }
  } else {
    for (int i = t; i < kRows * kHd; i += kThreads) {
      const int r = i / kHd, col = i % kHd;
      dst[r * kLd + col] = (row0 + r < n_rows && col < hd)
                               ? src[static_cast<int64_t>(row0 + r) * ld + col]
                               : rn(0.f);
    }
  }
}

// The per-head LayerNorm of the rows < n_rows - row0 of a kRows x 64 tile,
// in place, by kThreads threads from thread t: 8 lanes a row, 8 columns a
// lane, fp32 mean and variance, (x - mu) * (1 / sqrt(var + eps)) * g + b
// with no FMA contraction, rounded to bf16.  Every lane of a warp takes
// the same number of rows (the shuffles need them all): a warp holds four
// consecutive rows and kRows is a multiple of four.
template <int kRows, int kThreads>
__device__ __forceinline__ void layernorm_tile(bf16* tile, int row0,
                                               int n_rows, const float* g,
                                               const float* b, float eps,
                                               int t) {
  constexpr int kLd = kHead + 8;
  const int c = (t & 7) * 8;
  float gc[8], bc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    gc[i] = g[c + i];
    bc[i] = b[c + i];
  }
#pragma unroll
  static_assert(kRows % 4 == 0 && kThreads % 32 == 0, "whole warps a row group");
  for (int r = t >> 3; r < kRows; r += kThreads / 8) {
    uint4 raw = *reinterpret_cast<const uint4*>(tile + r * kLd + c);
    bf16* x8 = reinterpret_cast<bf16*>(&raw);
    float x[8], sum = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      x[i] = bf(x8[i]);
      sum += x[i];
    }
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) sum += __shfl_xor_sync(kFull, sum, off);
    const float mu = sum / kHead;
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      x[i] -= mu;
      sq += x[i] * x[i];
    }
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) sq += __shfl_xor_sync(kFull, sq, off);
    const float inv = 1.f / sqrtf(sq / kHead + eps);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      x8[i] = rn(__fadd_rn(__fmul_rn(__fmul_rn(x[i], inv), gc[i]), bc[i]));
    if (row0 + r < n_rows)
      *reinterpret_cast<uint4*>(tile + r * kLd + c) = raw;
  }
}

// ---- the kernel ----

// Warps of a block: kSlabs query slabs of 16 rows times kSplit key ranges.
template <int kSlabs, int kSplit>
constexpr int kAttnThreads = 32 * kSlabs * kSplit;

// One block per (head, batch, 16 * kSlabs queries): kSlabs * kSplit warps,
// warp w on key range r = w / kSlabs and query slab (w + r) % kSlabs, so
// that a range's warps, and a slab's, sit on different SM sub-partitions
// (w % 4): the last query tile's one real slab is spread over all four.
// At kHd <= 64 the registers are capped so that 16 warps fit an SM (128 a
// thread); kHd 128 takes what it needs.
template <bool kLN, int kHd, int kSlabs, int kSplit>
__global__ void __launch_bounds__(
    kAttnThreads<kSlabs, kSplit>,
    kHd > kHead ? 1 : 512 / kAttnThreads<kSlabs, kSplit>)
    attn_kernel(AttnArgs a) {
  static_assert(kHd % 16 == 0 && kHd <= 128, "head width 16, 32, 64 or 128");
  static_assert(!kLN || kHd == kHead, "the q/k LayerNorm takes 64-wide heads");
  using L = AttnSmem<kHd, kSlabs, kSplit>;
  constexpr int kThreads = kAttnThreads<kSlabs, kSplit>;
  constexpr int kRT = 32 * kSlabs;      // threads of a key range
  constexpr int kQRows = L::kQRows;
  constexpr int kLd = L::kLd;
  constexpr int kKT = kHd / 16;  // k-steps of q.k^T; column pairs of p.v
  constexpr int kNT = kHd / 8;   // 8-column output fragments
  constexpr int kSF = kChunk / 8;  // 8-key score fragments of a chunk
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  float* sMax = reinterpret_cast<float*>(smem + L::kMaxOffset);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int range = warp / kSlabs, slab = (warp + range) % kSlabs;
  const int rt = tid - range * kRT;  // thread within its range
  const int g = lane >> 2, t4 = lane & 3;  // accumulator row and column pair
  const int h = blockIdx.x, b = blockIdx.y, q0 = blockIdx.z * kQRows;
  const int N = a.N, hd = a.hd;
  const bf16* qg = a.q + b * a.bs_q + h * hd;
  const bf16* kg = a.k + b * a.bs_k + h * hd;
  const bf16* vg = a.v + b * a.bs_v + h * hd;
  // does this warp's slab hold a real query row?
  const bool active = q0 + slab * 16 < N;

  // this range's chunks: range, range + kSplit, ...  Chunk i lives in
  // stage i % kStages.
  const int n_chunks = (N + kChunk - 1) / kChunk;
  const int mine =
      range < n_chunks ? (n_chunks - range + kSplit - 1) / kSplit : 0;
  bf16* sKV = sQ + L::kQTile + L::kTile * range * kStages * 2;
  auto sK = [&](int i) { return sKV + (i % kStages) * 2 * L::kTile; };
  auto sV = [&](int i) { return sKV + ((i % kStages) * 2 + 1) * L::kTile; };
  auto key0 = [&](int i) { return (range + i * kSplit) * kChunk; };
  auto load_k = [&](int i) {
    if (0 <= i && i < mine)
      load_tile<kHd, kChunk, kRT>(sK(i), kg, key0(i), N, a.ld_k, hd, rt);
  };
  auto load_v = [&](int i) {
    if (0 <= i && i < mine)
      load_tile<kHd, kChunk, kRT>(sV(i), vg, key0(i), N, a.ld_v, hd, rt);
  };
  auto ln_k = [&](int i) {  // the caller synchronises the range around it
    if constexpr (kLN)
      layernorm_tile<kChunk, kRT>(sK(i), key0(i), N, a.gk, a.bk, a.eps, rt);
  };

  // Copies, one group each: the q tile with K of chunk 0; K of chunks 1 ..
  // kStages-1; V of pass 2's first kStages chunks (the range's last ones),
  // which pass 1's V slots hold idle, so that their first read from device
  // memory hides behind pass 1.
  load_tile<kHd, kQRows, kThreads>(sQ, qg, q0, N, a.ld_q, hd, tid);
  load_k(0);
  cp_async_commit();
#pragma unroll
  for (int i = 1; i < kStages; ++i) {
    load_k(i);
    cp_async_commit();
  }
#pragma unroll
  for (int i = 1; i <= kStages; ++i) load_v(mine - i);
  cp_async_commit();
  cp_async_wait<kStages>();  // the q tile and chunk 0
  __syncthreads();
  if constexpr (kLN) {
    layernorm_tile<kQRows, kThreads>(sQ, q0, N, a.gq, a.bq, a.eps, tid);
    __syncthreads();
  }
  uint32_t qa[kKT][4];
#pragma unroll
  for (int kk = 0; kk < kKT; ++kk)
    ldsm_x4<false>(qa[kk], sQ + (slab * 16 + (lane & 15)) * kLd + kk * 16 +
                               (lane >> 4) * 8);

  // s = q . k^T over half hf (32 keys) of a chunk: the scores and p of a
  // half take 16 and 8 registers, where a whole chunk's would take 32 and
  // 16.  In the last chunk (kTail) only over the 16-key column blocks that
  // hold real keys, the others zero.
  auto scores = [&](auto tail, const bf16* kt, int hf, float (&s)[kSF / 2][4],
                    int valid) {
    constexpr bool kTail = decltype(tail)::value;
    if constexpr (kTail) {
#pragma unroll
      for (int j = 0; j < kSF / 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < kKT; ++kk)
#pragma unroll
      for (int jp = 0; jp < kSF / 4; ++jp) {
        const int jj = hf * (kSF / 4) + jp;  // 16-key column block
        if (!kTail || jj * 16 < valid) {
          uint32_t r[4];
          ldsm_x4<false>(r, kt + (jj * 16 + (lane & 7) + ((lane >> 4) << 3)) *
                                     kLd + kk * 16 + ((lane >> 3) & 1) * 8);
          if (kk == 0) {
            mma_bf16_first(s[2 * jp], qa[kk], r[0], r[1]);
            mma_bf16_first(s[2 * jp + 1], qa[kk], r[2], r[3]);
          } else {
            mma_bf16(s[2 * jp], qa[kk], r[0], r[1]);
            mma_bf16(s[2 * jp + 1], qa[kk], r[2], r[3]);
          }
        }
      }
  };
  // is score (j, e) of half hf of this lane a real key of a chunk holding
  // `valid`?
  auto real_key = [&](int hf, int j, int e, int valid) {
    return hf * 32 + 8 * j + 2 * t4 + (e & 1) < valid;
  };

  // pass 1: the exact maximum of rows g and g + 8 (r = e / 2) over the real
  // keys, two running maxima a row (even and odd columns)
  float mx2[2][2] = {{-CUDART_INF_F, -CUDART_INF_F},
                     {-CUDART_INF_F, -CUDART_INF_F}};
  auto max_chunk = [&](auto tail, int i) {
    constexpr bool kTail = decltype(tail)::value;
    const int valid = N - key0(i);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      if (kTail && hf * 32 >= valid) break;
      float s[kSF / 2][4];
      scores(tail, sK(i), hf, s, valid);
#pragma unroll
      for (int j = 0; j < kSF / 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!kTail || real_key(hf, j, e, valid))
            mx2[e >> 1][e & 1] = fmaxf(mx2[e >> 1][e & 1], s[j][e]);
    }
  };
  for (int i = 0; i < mine; ++i) {
    // chunk i landed: its group is followed by those of chunks i+1 ..
    // i+kStages-1 and, at i < kStages, by the V prefetch's
    if (i < kStages) cp_async_wait<kStages>();
    else cp_async_wait<kStages - 1>();
    range_sync<kRT>(range);
    if constexpr (kLN) {
      ln_k(i);
      range_sync<kRT>(range);
    }
    if (active) {
      if (N - key0(i) >= kChunk) max_chunk(std::false_type{}, i);
      else max_chunk(std::true_type{}, i);
    }
    range_sync<kRT>(range);  // the stage is free
    load_k(i + kStages);
    cp_async_commit();
  }
  cp_async_wait<0>();  // the V prefetch, for pass 2
  float mx[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx2[r][0], mx2[r][1]);
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
  }
  if constexpr (kSplit > 1) {
    if (t4 == 0) {
      sMax[range * kQRows + slab * 16 + g] = mx[0];
      sMax[range * kQRows + slab * 16 + g + 8] = mx[1];
    }
  }
  __syncthreads();  // the maxima, and the prefetched V, for every warp
  if constexpr (kSplit > 1) {
#pragma unroll
    for (int r = 0; r < kSplit; ++r) {
      mx[0] = fmaxf(mx[0], sMax[r * kQRows + slab * 16 + g]);
      mx[1] = fmaxf(mx[1], sMax[r * kQRows + slab * 16 + g + 8]);
    }
  }

  // pass 2, over the range's chunks backwards, so that the last kStages
  // start with K still in place from pass 1 and V prefetched:
  // p = exp((s - max) * scale) = 2^(s * c - max * c), c = scale * log2(e)
  // (one FFMA and one ex2); o = bf16(p) . v; l = the sum of fp32 p (two
  // partial sums a row)
  const float c = a.scale * 1.4426950408889634f;
  const float mc[2] = {mx[0] * c, mx[1] * c};
  float o[kNT][4];
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float l2[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  auto pv_chunk = [&](auto tail, int i) {
    constexpr bool kTail = decltype(tail)::value;
    const int valid = N - key0(i);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      if (kTail && hf * 32 >= valid) break;
      float s[kSF / 2][4];
      scores(tail, sK(i), hf, s, valid);
      uint32_t pa[kSF / 4][4];  // p as the A fragments of p.v
#pragma unroll
      for (int j = 0; j < kSF / 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = ex2(fmaf(s[j][e], c, -mc[e >> 1]));
          if (kTail && !real_key(hf, j, e, valid)) p = 0.f;
          l2[e >> 1][e & 1] += p;
          s[j][e] = p;
        }
        pa[j >> 1][(j & 1) * 2] = pack_bf16(s[j][0], s[j][1]);
        pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(s[j][2], s[j][3]);
      }
#pragma unroll
      for (int kl = 0; kl < kSF / 4; ++kl) {
        const int kk = hf * (kSF / 4) + kl;  // 16-key row block of V
        if (!kTail || kk * 16 < valid) {
#pragma unroll
          for (int np = 0; np < kKT; ++np) {
            uint32_t r[4];
            ldsm_x4<true>(r, sV(i) + (kk * 16 + (lane & 7) +
                                      ((lane >> 3) & 1) * 8) * kLd +
                                 np * 16 + (lane >> 4) * 8);
            mma_bf16(o[2 * np], pa[kl], r[0], r[1]);
            mma_bf16(o[2 * np + 1], pa[kl], r[2], r[3]);
          }
        }
      }
    }
  };
  for (int i = mine - 1; i >= 0; --i) {
    if (i < mine - kStages) {  // chunk i was fetched kStages iterations ago
      cp_async_wait<kStages - 1>();
      range_sync<kRT>(range);
      if constexpr (kLN) {
        ln_k(i);
        range_sync<kRT>(range);
      }
    }
    if (active) {
      if (N - key0(i) >= kChunk) pv_chunk(std::false_type{}, i);
      else pv_chunk(std::true_type{}, i);
    }
    range_sync<kRT>(range);  // the stage is free
    load_k(i - kStages);
    load_v(i - kStages);
    cp_async_commit();
  }
  float l[2] = {l2[0][0] + l2[0][1], l2[1][0] + l2[1][1]};

  // the ranges' partial o and l summed in range 0 (in range order)
  if constexpr (kSplit > 1) {
    __syncthreads();  // every range is done with its stages
    float* part = reinterpret_cast<float*>(smem + L::kStageOffset);
    if (range > 0 && active) {
      float* p = part + ((range - 1) * kSlabs + slab) * L::kPart;
#pragma unroll
      for (int n = 0; n < kNT; ++n)
        *reinterpret_cast<float4*>(p + (n * 32 + lane) * 4) =
            make_float4(o[n][0], o[n][1], o[n][2], o[n][3]);
      *reinterpret_cast<float2*>(p + kNT * 128 + lane * 2) =
          make_float2(l[0], l[1]);
    }
    __syncthreads();
    if (range > 0 || !active) return;
#pragma unroll
    for (int r = 1; r < kSplit; ++r) {
      const float* p = part + ((r - 1) * kSlabs + slab) * L::kPart;
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        const float4 x = *reinterpret_cast<const float4*>(p + (n * 32 + lane) * 4);
        o[n][0] += x.x;
        o[n][1] += x.y;
        o[n][2] += x.z;
        o[n][3] += x.w;
      }
      const float2 y = *reinterpret_cast<const float2*>(p + kNT * 128 + lane * 2);
      l[0] += y.x;
      l[1] += y.y;
    }
  } else if (!active) {
    return;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(kFull, l[r], 1);
    l[r] += __shfl_xor_sync(kFull, l[r], 2);
  }

  // rows g and g + 8 of the slab, columns 8n + 2t and 8n + 2t + 1: the real ones
  bf16* dst = a.out + static_cast<int64_t>(b) * N * a.D + h * hd;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int q = q0 + slab * 16 + g + 8 * r;
    if (q >= N) continue;
    bf16* row = dst + static_cast<int64_t>(q) * a.D;
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      const int col = n * 8 + 2 * t4;
      const float y0 = o[n][2 * r] / l[r], y1 = o[n][2 * r + 1] / l[r];
      if (hd == kHd) {
        *reinterpret_cast<uint32_t*>(row + col) = pack_bf16(y0, y1);
      } else {
        if (col < hd) row[col] = rn(y0);
        if (col + 1 < hd) row[col + 1] = rn(y1);
      }
    }
  }
}

// One launch of attn_kernel<kLN, kHd, kSlabs, kSplit> over (H heads, B
// batches, query tiles) on `stream`; the dynamic shared-memory limit is
// raised once per device.  Returns cudaGetLastError() after the launch.
template <bool kLN, int kHd, int kSlabs, int kSplit>
cudaError_t launch_split(const AttnArgs& a, int B, int H, int device,
                         cudaStream_t stream) {
  constexpr size_t kBytes = AttnSmem<kHd, kSlabs, kSplit>::kBytes;
  static std::atomic<uint64_t> raised{0};  // one bit per device
  const uint64_t bit = uint64_t{1} << (device & 63);
  if (!(raised.load(std::memory_order_acquire) & bit)) {
    const cudaError_t e = cudaFuncSetAttribute(
        attn_kernel<kLN, kHd, kSlabs, kSplit>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kBytes));
    if (e != cudaSuccess) return e;
    raised.fetch_or(bit, std::memory_order_release);
  }
  // the query tile varies slowest: blocks start in this order, so the
  // last tiles (one real row at N = 385 or 513) are the ones that share an
  // SM when the grid exceeds the SMs
  constexpr int kQRows = 16 * kSlabs;
  const dim3 grid(H, B, (a.N + kQRows - 1) / kQRows);
  attn_kernel<kLN, kHd, kSlabs, kSplit>
      <<<grid, kAttnThreads<kSlabs, kSplit>, kBytes, stream>>>(a);
  return cudaGetLastError();
}

// The attention over (H heads, B batches, query tiles) on `stream`, in the
// shape that keeps ~16 warps on every SM in one wave where it can: 64-row
// blocks with 4 key ranges when they fit the SMs once (OpenShape's and
// ULIP-2's grids); else 80-row blocks (5 slabs) with 3 ranges when those do
// (N = 513 on 16 heads: 112 blocks, where 64-row ones would be 144 on 132
// SMs); else 64-row blocks with 1 range, four an SM (the EVA block's 288).
// At kHd 128, whose fragments take twice the registers, 64-row blocks with
// 2 ranges.  Returns cudaGetLastError() after the launch.
template <bool kLN, int kHd = kHead>
cudaError_t launch_attention(const AttnArgs& a, int B, int H,
                             cudaStream_t stream) {
  int device = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return e;
  auto blocks = [&](int rows) {
    return static_cast<int64_t>((a.N + rows - 1) / rows) * H * B;
  };
  if constexpr (kHd > kHead) {
    return launch_split<kLN, kHd, 4, 2>(a, B, H, device, stream);
  } else {
    if (blocks(64) <= sms)
      return launch_split<kLN, kHd, 4, 4>(a, B, H, device, stream);
    if (blocks(80) <= sms)
      return launch_split<kLN, kHd, 5, 3>(a, B, H, device, stream);
    return launch_split<kLN, kHd, 4, 1>(a, B, H, device, stream);
  }
}

}  // namespace
