// fp32 attention at head width 64 without the q/k LayerNorm, on the
// tensor cores in split TF32, for Hopper (sm_90a): the kernel that
// f32::launch_attention<false, 64> runs (attention_core_f32.cuh), so every
// fp32 launch of the main paths: the attention step of the fp32 EVA block
// (its q and k are LayerNorm'd in the GEMM epilogue), the fp32
// natural-layout attention without LayerNorm, and the fp32 (B, H, N, hd)
// attention at hd 33..64.  The LayerNorm variant and the other head
// widths stay on attn_f32_kernel (FFMA).
//
// Replaces, with those entries: the fp32 form of
//   uni_adapter_tpu/ops/attention_pallas.py::attention_pallas
//   (_attn_kernel): t = (q . k) * scale, keys past N masked, p = exp(t -
//   max), o = (p . v) / sum(p), all in fp32; and the fp32 runs of
//   ::eva_attention_fused and the attention step of ::eva_attn_block_fused.
//
// Numerics: split TF32.  Each fp32 operand x is hi = tf32_rna(x) plus lo =
// tf32_rna(x - hi) (x - hi is exact in fp32), and each fp32 product x . y
// is lo(x) hi(y) + hi(x) lo(y) + hi(x) hi(y): three mma.sync.m16n8k8.tf32
// with fp32 accumulation, the two small terms first.  What is dropped,
// lo . lo and the rounding of lo, is ~2^-21 of the product: a few fp32
// ulps, the class of the FFMA kernel's summation order (the TPU's fp32
// product at its highest precision is likewise a multi-pass emulation on
// a narrower unit).  q.k^T and p.v are both split; p is split as it
// leaves the accumulators and is never rounded to a narrower type.  q is
// scaled by c = scale * log2(e) as it is loaded, so scores are in log2
// units and p = 2^(s - max) is one FADD and one ex2.approx (relative
// error ~2^-22).  One pass, online softmax, as in attention_core_f32.cuh
// and for its reason: nothing is rounded against the maximum, so a
// running maximum m, with the partial sums and the output accumulators
// rescaled by 2^(m_old - m_new) when it grows, gives the two-pass result
// up to a few fp32 ulps.
//
// What bounds it on the H100: operations.  4*B*H*N^2*64 flop is 2.16
// GFLOP at the block's (2, 513, 1024, 16), 32 us at 67 TFLOP/s fp32 for
// the FFMA kernel; the split's three TF32 products are 6.5 GFLOP, 13 us at
// 494.7 TFLOP/s TF32, against 8.4 MB, 2.5 us at 3.35 TB/s.  mma.sync
// reaches part of the TF32 peak, and the split itself (3 instructions an
// operand, a warp splitting every K and V value it reads) competes for
// the same issue slots.
//
// Layout: the skeleton of the bf16 core (attention_core.cuh).  A block is
// kSlabs warps of 16 query rows times kSplit key ranges; range r takes
// the 32-key chunks r, r + kSplit, ... through a two-stage 16-byte
// cp.async ring and synchronises on its own named barrier; the ranges'
// partial (m, sum of p, o) are merged in shared memory before the one
// division.  The block shape is chosen per launch from the grid (64 rows
// x 4 ranges, 80 x 3, 64 x 2), so that an SM holds ~16 warps.
// The q tile is scaled, split and stored once per block (shared memory,
// hi and lo of a dim pair in one 16-byte word: an A fragment is two
// 16-byte loads), where hi and lo in registers would take 64 of a
// thread's 128 and spill; the 16 x 32 scores of a chunk and the 16 x 64
// output are accumulators.  Each product's three passes run over all its
// independent accumulators (4 score blocks, 4 + 4 output blocks) before
// the next pass, so that the tensor cores always hold several.
//   * The TF32 m16n8k8 accumulator is not its A layout: lane (g, t) holds
//     score columns 2t and 2t + 1, the A fragment wants columns t and
//     t + 4.  The sum over keys does not care about their order, so p.v
//     reads V's B fragment at key rows 2t and 2t + 1 where the layout says
//     t and t + 4: p goes from the accumulators to the A operand with no
//     shuffle.  The same relabelling of the head dims (logical t and t + 4
//     are dims 2t and 2t + 1) lets q.k^T read a K fragment as one 8-byte
//     load.
//   * ldmatrix moves b16 and cannot transpose 32-bit elements, so K and V
//     fragments are plain shared-memory loads: K rows padded to 72 floats
//     (8 mod 32: the 8-byte loads of a half-warp hit 32 banks), V rows to
//     68 (4 mod 32: keys 2t and 2t + 1 of 8 columns hit 32 banks).
//   * Ragged tails: keys past N are zero in shared memory and -inf before
//     the maximum; 8-key blocks with no real key are skipped; rows past N
//     are zero and not written; a warp whose 16 rows hold no real query
//     skips the math but still copies its share of K and V.
//
// Any hd in 33..64 (the head width in shared memory is 64): a narrower
// head is padded with zeros there, moved one element at a time, and only
// its real output columns are written; rows of 64 move as 16-byte
// cp.async.
#pragma once

#include "attention_core.cuh"      // cp.async, named barriers, ex2
#include "attention_core_f32.cuh"  // f32::AttnArgs

namespace {
namespace f32 {

// The block shapes, (query slabs, key ranges) three times: the first
// where its blocks fit the SMs once, else the second where its do, else
// the third.  Chosen by scripts/attn_f32_tc_configs.py on the card.
#ifndef UAT_F32_TC_SHAPES
#define UAT_F32_TC_SHAPES 4, 4, 5, 3, 4, 2
#endif

constexpr int kTcHead = 64;        // head width in shared memory
constexpr int kTcChunk = 32;       // keys a chunk
constexpr int kTcStages = 2;       // chunks a key range has in shared memory
constexpr int kLdQ = 2 * kTcHead + 16;  // q row stride, 16 mod 32 words
constexpr int kLdK = kTcHead + 8;       // K row stride, 8 mod 32 words
constexpr int kLdV = kTcHead + 4;       // V row stride, 4 mod 32 words

// Shared memory of 16 * kSlabs query rows and kSplit key ranges: the q
// tile, split (a row's 32 dim pairs as (hi, hi, lo, lo)); then per range
// kTcStages stages of a K and a V chunk.  At the end, after the barrier
// that ends every read of the q tile and the stages, the ranges' partial
// outputs (a warp's: 8 fragments of 4 and (m, l) of its two rows, a lane)
// reuse it all from its start.
template <int kSlabs, int kSplit>
struct TcSmem {
  static constexpr int kQTile = 16 * kSlabs * kLdQ;  // floats
  static constexpr int kKTile = kTcChunk * kLdK;
  static constexpr int kStage = kKTile + kTcChunk * kLdV;
  static constexpr int kRange = kTcStages * kStage;
  static constexpr int kPart = (kTcHead / 8 + 1) * 4 * 32;
  static constexpr size_t kBytes =
      (kQTile + kSplit * kRange) * sizeof(float);
  static_assert((kSplit - 1) * kSlabs * kPart <= kQTile + kSplit * kRange,
                "the partial outputs fit in the shared memory");
};

// x rounded to TF32's 10 mantissa bits, to nearest with ties away from
// zero: the bits of cvt.rna.tf32.f32 for every finite x, in two integer
// instructions (on sm_90a the PTX cvt compiles to a longer sequence that
// also screens infinities and NaNs, which no operand here holds).
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo to ~2^-22 of x, both TF32.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// d += a . b on the tensor cores: a 16x8 TF32 (row), b 8x8 TF32 (col), d
// 16x8 fp32.  Lane (g, t) holds a at (g, t), (g + 8, t), (g, t + 4),
// (g + 8, t + 4); b at (t, g), (t + 4, g); d at rows g and g + 8,
// columns 2t and 2t + 1.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d[n] += a . b[n] for fragments kLo <= n < kHi in split TF32, from a's
// hi and lo and the fp32 b[n] (2 values a lane): lo(a) hi(b), then
// hi(a) lo(b), then hi(a) hi(b) on each accumulator, the small terms
// first; each pass runs over all its fragments before the next, so that
// that many products are in flight.  Fragments with skip(n) are left as
// they are.
template <int kLo, int kHi, int kN, typename Skip>
__device__ __forceinline__ void mma_split(float (&d)[kN][4],
                                          const uint32_t (&ah)[4],
                                          const uint32_t (&al)[4],
                                          const float (&b)[kN][2], Skip skip) {
  uint32_t bh[kN][2], bl[kN][2];
#pragma unroll
  for (int n = kLo; n < kHi; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) split_tf32(b[n][e], bh[n][e], bl[n][e]);
#pragma unroll
  for (int n = kLo; n < kHi; ++n)
    if (!skip(n)) mma_tf32(d[n], al, bh[n][0], bh[n][1]);
#pragma unroll
  for (int n = kLo; n < kHi; ++n)
    if (!skip(n)) mma_tf32(d[n], ah, bl[n][0], bl[n][1]);
#pragma unroll
  for (int n = kLo; n < kHi; ++n)
    if (!skip(n)) mma_tf32(d[n], ah, bh[n][0], bh[n][1]);
}

// Rows row0 .. row0 + kTcChunk - 1 of a (rows, hd) operand into a tile of
// row stride kLd, by kThreads threads from thread t; rows past n_rows and
// columns past hd are zero.  hd == 64: 16-byte cp.async (the caller
// commits); otherwise element by element.
template <int kLd, int kThreads>
__device__ __forceinline__ void load_chunk(float* dst, const float* src,
                                           int row0, int n_rows, int64_t ld,
                                           int hd, int t) {
  if (hd == kTcHead) {
    constexpr int kVec = kTcHead / 4;  // 16-byte vectors a row
    for (int c = t; c < kTcChunk * kVec; c += kThreads) {
      const int r = c / kVec, col = (c % kVec) * 4;
      const bool real = row0 + r < n_rows;
      cp_async16(dst + r * kLd + col,
                 real ? src + static_cast<int64_t>(row0 + r) * ld + col : src,
                 real ? 16 : 0);
    }
  } else {
    for (int i = t; i < kTcChunk * kTcHead; i += kThreads) {
      const int r = i / kTcHead, col = i % kTcHead;
      dst[r * kLd + col] = (row0 + r < n_rows && col < hd)
                               ? src[static_cast<int64_t>(row0 + r) * ld + col]
                               : 0.f;
    }
  }
}

template <int kSlabs, int kSplit>
constexpr int kTcThreads = 32 * kSlabs * kSplit;

// One block per (head, batch, 16 * kSlabs queries): kSlabs * kSplit warps,
// warp w on key range r = w / kSlabs and query slab (w + r) % kSlabs (a
// range's warps, and a slab's, on different SM sub-partitions).  Registers
// capped so that 16 warps fit an SM.
template <int kSlabs, int kSplit>
__global__ void __launch_bounds__(kTcThreads<kSlabs, kSplit>,
                                  512 / kTcThreads<kSlabs, kSplit>)
    attn_f32_tc_kernel(AttnArgs a) {
  using L = TcSmem<kSlabs, kSplit>;
  constexpr int kRT = 32 * kSlabs;     // threads of a key range
  constexpr int kKS = kTcHead / 8;     // k-steps of q.k^T; output fragments
  constexpr int kNB = kTcChunk / 8;    // 8-key blocks of a chunk
  extern __shared__ __align__(16) float smem_tc[];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int range = warp / kSlabs, slab = (warp + range) % kSlabs;
  const int rt = tid - range * kRT;  // thread within its range
  const int g = lane >> 2, t4 = lane & 3;
  const int h = blockIdx.x, b = blockIdx.y, q0 = blockIdx.z * 16 * kSlabs;
  const int N = a.N, hd = a.hd;
  const float* qg = a.q + b * a.bs_q + h * hd;
  const float* kg = a.k + b * a.bs_k + h * hd;
  const float* vg = a.v + b * a.bs_v + h * hd;
  const bool active = q0 + slab * 16 < N;  // a real query in this slab?

  // this range's chunks: range, range + kSplit, ...; chunk i in stage
  // i % kTcStages, its K and V in copy group i
  const int n_chunks = (N + kTcChunk - 1) / kTcChunk;
  const int mine =
      range < n_chunks ? (n_chunks - range + kSplit - 1) / kSplit : 0;
  float* sQ = smem_tc;
  float* sKV = smem_tc + L::kQTile + range * L::kRange;
  auto sK = [&](int i) { return sKV + (i % kTcStages) * L::kStage; };
  auto sV = [&](int i) { return sK(i) + L::kKTile; };
  auto key0 = [&](int i) { return (range + i * kSplit) * kTcChunk; };
  auto load = [&](int i) {
    if (i < mine) {
      load_chunk<kLdK, kRT>(sK(i), kg, key0(i), N, a.ld_k, hd, rt);
      load_chunk<kLdV, kRT>(sV(i), vg, key0(i), N, a.ld_v, hd, rt);
    }
  };
#pragma unroll
  for (int i = 0; i < kTcStages; ++i) {
    load(i);
    cp_async_commit();
  }

  // the q tile times c = scale * log2(e), split once for every range:
  // dims 2p and 2p + 1 of a row as (hi, hi, lo, lo) at 4p; k-step kk of
  // q.k^T takes pair 4kk + t as logical columns t and t + 4
  const float c = a.scale * 1.4426950408889634f;
  constexpr int kPairs = kTcHead / 2;  // dim pairs a row
  for (int i = tid; i < 16 * kSlabs * kPairs;
       i += kTcThreads<kSlabs, kSplit>) {
    const int r = i / kPairs, col = 2 * (i % kPairs);
    const float* src = qg + static_cast<int64_t>(q0 + r) * a.ld_q + col;
    float2 x = make_float2(0.f, 0.f);
    if (q0 + r < N) {
      if (hd == kTcHead) {
        x = *reinterpret_cast<const float2*>(src);
      } else {
        if (col < hd) x.x = src[0];
        if (col + 1 < hd) x.y = src[1];
      }
    }
    uint32_t h0, l0, h1, l1;
    split_tf32(x.x * c, h0, l0);
    split_tf32(x.y * c, h1, l1);
    *reinterpret_cast<uint4*>(sQ + r * kLdQ + 2 * col) =
        make_uint4(h0, h1, l0, l1);
  }
  __syncthreads();
  const float* q_g = sQ + (slab * 16 + g) * kLdQ + 4 * t4;  // row g
  const float* q_g8 = q_g + 8 * kLdQ;                       // row g + 8

  // o: rows g, g + 8 (r = e / 2), head dims 8n + 2t, 8n + 2t + 1; m: the
  // rows' running maxima (in log2 units); l: this lane's share of sum(p)
  float o[kKS][4];
#pragma unroll
  for (int n = 0; n < kKS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};

  auto chunk = [&](auto tail, int i) {
    constexpr bool kTail = decltype(tail)::value;
    const int valid = N - key0(i);  // real keys of the chunk (all if >= 32)
    const float* kt = sK(i);
    const float* vt = sV(i);
    // 8-key block j of the chunk holds no real key?
    auto empty = [&](int j) { return kTail && j * 8 >= valid; };
    // s = (q c) . k^T: 8-key block j at columns 2t, 2t + 1
    float s[kNB][4];
#pragma unroll
    for (int j = 0; j < kNB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKS; ++kk) {
      const float4 x = *reinterpret_cast<const float4*>(q_g + 16 * kk);
      const float4 y = *reinterpret_cast<const float4*>(q_g8 + 16 * kk);
      const uint32_t ah[4] = {__float_as_uint(x.x), __float_as_uint(y.x),
                              __float_as_uint(x.y), __float_as_uint(y.y)};
      const uint32_t al[4] = {__float_as_uint(x.z), __float_as_uint(y.z),
                              __float_as_uint(x.w), __float_as_uint(y.w)};
      float kf[kNB][2];
#pragma unroll
      for (int j = 0; j < kNB; ++j) {
        const float2 kv = *reinterpret_cast<const float2*>(
            kt + (j * 8 + g) * kLdK + kk * 8 + 2 * t4);
        kf[j][0] = kv.x;
        kf[j][1] = kv.y;
      }
      mma_split<0, kNB>(s, ah, al, kf, empty);
    }
    // online softmax: the rows' new maxima over the real keys, the old
    // partial sums and outputs rescaled, p = 2^(s - m) in place
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m[r];
#pragma unroll
      for (int j = 0; j < kNB; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (kTail && j * 8 + 2 * t4 + e >= valid)
            s[j][2 * r + e] = -CUDART_INF_F;
          mx = fmaxf(mx, s[j][2 * r + e]);
        }
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));  // finite: a real key
      const float corr = ex2(m[r] - mx);              // 0 on the first chunk
      m[r] = mx;
      l[r] *= corr;
#pragma unroll
      for (int n = 0; n < kKS; ++n) {
        o[n][2 * r] *= corr;
        o[n][2 * r + 1] *= corr;
      }
#pragma unroll
      for (int j = 0; j < kNB; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = ex2(s[j][2 * r + e] - mx);  // 0 past the real keys
          l[r] += p;
          s[j][2 * r + e] = p;
        }
    }
    // o += p . v: key block j is a k-step whose logical columns t and
    // t + 4 are keys 2t and 2t + 1, the accumulator's own columns
#pragma unroll
    for (int j = 0; j < kNB; ++j) {
      if (empty(j)) continue;
      uint32_t ph[4], pl[4];
      split_tf32(s[j][0], ph[0], pl[0]);
      split_tf32(s[j][2], ph[1], pl[1]);
      split_tf32(s[j][1], ph[2], pl[2]);
      split_tf32(s[j][3], ph[3], pl[3]);
      const float* v0 = vt + (j * 8 + 2 * t4) * kLdV + g;
      float vf[kKS][2];
#pragma unroll
      for (int n = 0; n < kKS; ++n) {
        vf[n][0] = v0[n * 8];
        vf[n][1] = v0[kLdV + n * 8];
      }
      auto none = [](int) { return false; };
      mma_split<0, kKS / 2>(o, ph, pl, vf, none);  // in two halves: fewer
      mma_split<kKS / 2, kKS>(o, ph, pl, vf, none);  // registers live
    }
  };

  for (int i = 0; i < mine; ++i) {
    cp_async_wait<kTcStages - 1>();  // chunk i's group has landed
    range_sync<kRT>(range);
    if (active) {
      if (N - key0(i) >= kTcChunk) chunk(std::false_type{}, i);
      else chunk(std::true_type{}, i);
    }
    range_sync<kRT>(range);  // the stage is free
    load(i + kTcStages);
    cp_async_commit();
  }
  cp_async_wait<0>();  // the last groups are empty: nothing in flight

  // the ranges' partial (o, m, l) merged into range 0's, in range order
  if constexpr (kSplit > 1) {
    __syncthreads();  // every range is done with the q tile and its stages
    if (range > 0 && active) {
      float* p = smem_tc + ((range - 1) * kSlabs + slab) * L::kPart;
#pragma unroll
      for (int n = 0; n < kKS; ++n)
        *reinterpret_cast<float4*>(p + (n * 32 + lane) * 4) =
            make_float4(o[n][0], o[n][1], o[n][2], o[n][3]);
      *reinterpret_cast<float4*>(p + (kKS * 32 + lane) * 4) =
          make_float4(m[0], m[1], l[0], l[1]);
    }
    __syncthreads();
    if (range > 0 || !active) return;
#pragma unroll
    for (int rg = 1; rg < kSplit; ++rg) {
      const float* p = smem_tc + ((rg - 1) * kSlabs + slab) * L::kPart;
      const float4 ml =
          *reinterpret_cast<const float4*>(p + (kKS * 32 + lane) * 4);
      const float mr[2] = {ml.x, ml.y}, lr[2] = {ml.z, ml.w};
      float f[2], fr[2];  // range 0's factors, range rg's (0 if it had no key)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float mx = fmaxf(m[r], mr[r]);
        f[r] = ex2(m[r] - mx);
        fr[r] = ex2(mr[r] - mx);
        m[r] = mx;
        l[r] = l[r] * f[r] + lr[r] * fr[r];
      }
#pragma unroll
      for (int n = 0; n < kKS; ++n) {
        const float4 x =
            *reinterpret_cast<const float4*>(p + (n * 32 + lane) * 4);
        o[n][0] = o[n][0] * f[0] + x.x * fr[0];
        o[n][1] = o[n][1] * f[0] + x.y * fr[0];
        o[n][2] = o[n][2] * f[1] + x.z * fr[1];
        o[n][3] = o[n][3] * f[1] + x.w * fr[1];
      }
    }
  } else if (!active) {
    return;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(kFull, l[r], 1);
    l[r] += __shfl_xor_sync(kFull, l[r], 2);
  }

  // o / sum(p): rows g and g + 8 of the slab, the real rows and columns
  float* dst = a.out + static_cast<int64_t>(b) * N * a.D + h * hd;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int q = q0 + slab * 16 + g + 8 * r;
    if (q >= N) continue;
    const float inv_l = 1.f / l[r];
    float* row = dst + static_cast<int64_t>(q) * a.D;
#pragma unroll
    for (int n = 0; n < kKS; ++n) {
      const int col = n * 8 + 2 * t4;
      const float y0 = o[n][2 * r] * inv_l, y1 = o[n][2 * r + 1] * inv_l;
      if (hd == kTcHead) {
        *reinterpret_cast<float2*>(row + col) = make_float2(y0, y1);
      } else {
        if (col < hd) row[col] = y0;
        if (col + 1 < hd) row[col + 1] = y1;
      }
    }
  }
}

// One launch of attn_f32_tc_kernel<kSlabs, kSplit> over (H heads, B
// batches, query tiles) on `stream`, the last tiles (one real row at N =
// 385 or 513) slowest; the dynamic shared-memory limit is raised once per
// device.  Returns cudaGetLastError() after the launch.
template <int kSlabs, int kSplit>
cudaError_t launch_tc_split(const AttnArgs& a, int B, int H, int device,
                            cudaStream_t stream) {
  constexpr size_t kBytes = TcSmem<kSlabs, kSplit>::kBytes;
  static std::atomic<uint64_t> raised{0};  // one bit per device
  const uint64_t bit = uint64_t{1} << (device & 63);
  if (!(raised.load(std::memory_order_acquire) & bit)) {
    const cudaError_t e = cudaFuncSetAttribute(
        attn_f32_tc_kernel<kSlabs, kSplit>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kBytes));
    if (e != cudaSuccess) return e;
    raised.fetch_or(bit, std::memory_order_release);
  }
  constexpr int kQRows = 16 * kSlabs;
  const dim3 grid(H, B, (a.N + kQRows - 1) / kQRows);
  attn_f32_tc_kernel<kSlabs, kSplit>
      <<<grid, kTcThreads<kSlabs, kSplit>, kBytes, stream>>>(a);
  return cudaGetLastError();
}

// The split-TF32 attention over (H heads, B batches, query tiles) in the
// first of three block shapes whose blocks fit the SMs once, else the
// third.  UAT_F32_TC_SHAPES: 64-row blocks with 4 key ranges (row 9's
// OpenShape and ULIP grids, the natural layout's), 80-row blocks with 3
// ranges (Uni3D's 16 heads at N = 513), else 64-row blocks with 2 ranges,
// two an SM (registers and shared memory), so that the block's 288 run
// 264 in a first wave and the last query tiles' (one real row each),
// which start last, in a second.
template <int kS1, int kR1, int kS2, int kR2, int kS3, int kR3>
cudaError_t launch_tc_shapes(const AttnArgs& a, int B, int H,
                             cudaStream_t stream) {
  int device = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return e;
  auto blocks = [&](int slabs) {
    return static_cast<int64_t>((a.N + 16 * slabs - 1) / (16 * slabs)) * H *
           B;
  };
  if (blocks(kS1) <= sms)
    return launch_tc_split<kS1, kR1>(a, B, H, device, stream);
  if (blocks(kS2) <= sms)
    return launch_tc_split<kS2, kR2>(a, B, H, device, stream);
  return launch_tc_split<kS3, kR3>(a, B, H, device, stream);
}

inline cudaError_t launch_attention_tc(const AttnArgs& a, int B, int H,
                                       cudaStream_t stream) {
  return launch_tc_shapes<UAT_F32_TC_SHAPES>(a, B, H, stream);
}

}  // namespace f32
}  // namespace
