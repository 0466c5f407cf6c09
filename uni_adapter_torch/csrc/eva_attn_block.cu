// The whole EVA attention side of a transformer block for Hopper (sm_90a):
// q/k/v projections, per-head q/k LayerNorm, softmax(q.k^T * scale).v and
// the out projection, on the post-norm1 tokens xn (B, N, D), in bf16
// (uat_eva_attn_block) or fp32 (uat_eva_attn_block_fp32).
//
// Replaces: uni_adapter_tpu/ops/attention_pallas.py::eva_attn_block_fused
//   (_eva_block_kernel).  Rounding points mirrored from that kernel:
//   each projection accumulates in fp32, rounds to bf16, then adds its
//   bf16 bias (k has none); q/k LayerNorm takes fp32 statistics over the
//   head (eps from the caller), (x - mu) * (1 / sqrt(var + eps)) * g + b
//   with no FMA contraction, and rounds to bf16; the attention step rounds
//   as attention_core.cuh says; heads are concatenated in bf16; the out
//   projection rounds like the others.  The fp32 entry rounds nothing below
//   fp32: its GEMMs are FFMA, with no tensor-core instruction, and its
//   attention step is split TF32 on the tensor cores, three TF32 products
//   per fp32 product (attention_core_f32_tc.cuh), to a few fp32 ulps.
//
// The TPU kernel keeps all four 1024^2 weights resident in VMEM (8 MB); a
//   227 KB SM cannot, so the span is three launches on one stream: (a) a
//   GEMM of xn by [Wq|Wk|Wv] whose epilogue adds the biases and applies
//   the per-head LayerNorm (a 64-wide column group is one head), (b) the
//   attention core (attention_core.cuh / attention_core_f32.cuh) on the
//   q/k/v columns of that product, (c) the same GEMM for the out
//   projection with its bias.
//
// What bounds the GEMMs on the H100: operations.  At the main path's
//   (B, N, D, H) = (2, 513, 1024, 16), M = 1026 rows: 6.45 GFLOP for
//   q/k/v (N = 3072) and 2.15 for the out projection, 6.5 + 2.2 us at
//   989 TFLOP/s bf16 against ~14 MB (4.2 us at 3.35 TB/s); in fp32 96 +
//   32 us at 67 TFLOP/s against ~29 MB (8.6 us).  What holds them off that
//   bound at these short grids: wave quantization (M = 8 * 128 + 2, so the
//   last row of tiles holds 2 real rows; 72-432 tiles on 132 SMs), the
//   latency of each K step's loads, and, in fp32, the issue slots and
//   latency of the shared-memory loads that feed the FFMAs.
//
// bf16: gemm_bf16_kernel, wgmma.mma_async m64nNk16 (bf16 operands, fp32
//   accumulators in registers), one or two warpgroups a block, each 64
//   rows of the tile.  A and W tiles are 64 K values (128 bytes) wide, in
//   shared memory in the 128-byte swizzled layout the wgmma descriptors
//   read (16-byte chunk c of row r at r * 128 + ((c ^ r % 8) * 16)), in a
//   ring of kStages: tile kt + kStages - 2 is in flight while wgmma runs
//   on tile kt and one group of wgmma (tile kt - 1) may still read its
//   slot, so one __syncthreads per K step.  The ring is filled by 16-byte
//   cp.async from every thread, not TMA: xn, qkv and attn are fresh
//   buffers on every call, so TMA would need five tensor maps encoded on
//   the host per call on a host-bound path; cp.async costs 4-8 copy
//   instructions a thread per 64-wide K step and no host work.  q/k/v
//   runs 128 x 128 tiles (two warpgroups) in 3 stages, two blocks an SM,
//   all 216 in one wave; the out projection 64 x 64 tiles (one
//   warpgroup) in 4 stages, 272 blocks.  The epilogue works on the
//   accumulator registers: a thread holds 16 values of each of its two
//   rows per head, the rest in the 3 other lanes of its quad, so the
//   LayerNorm statistics take two xor shuffles.
//
// fp32: gemm_f32_kernel, a register-blocked FFMA SGEMM: 8 x 8 or 4 x 8
//   outputs a thread (rows ty + TY*i, columns 64*(tx/8) + tx%8 + 8*j),
//   float4 reads along K of both operands, which are stored as they lie
//   in device memory (K-contiguous rows padded by 4 floats, so 8
//   consecutive rows read as float4 hit 32 distinct banks) and moved by
//   16-byte cp.async, K in steps of 32 through a 3-stage ring, one
//   __syncthreads per step, fmaf accumulation in K order.  q/k/v: 96 x 128
//   tiles (8 x 8 a thread, 192 threads), 11 x 24 = 264 blocks, two an SM:
//   one wave, as even as M = 1026 allows.  Out projection: 64 x 128 tiles
//   whose K steps two groups of 256 threads split (16 of each 32), 136
//   blocks of 16 warps; group 1's partial sums reach group 0 through shared
//   memory and are added in that fixed order.  The 8 lanes of a head row
//   hold its 64 columns and reduce the LayerNorm statistics with three xor
//   shuffles.
//
// Both take any M = B*N >= 1 (the ragged last tile's rows are zero-filled
// on load and not stored, and a warp or warpgroup whose rows are all past
// M only loads), any input width D that is a multiple of 64 and any H >= 1
// heads of 64 columns, Dh = 64*H: the q/k/v GEMM is M x 3Dh x D (K = D),
// the out GEMM M x D x Dh (K = Dh), both multiples of the K steps; column
// tiles past 3Dh or D are zero-filled and not stored.  D == Dh is the
// whole attention of a block; D > Dh is a rank's head shard under tensor
// parallelism (q/k/v weights (Dh, D), the out projection (D, Dh)), whose
// out GEMM is called with no bias and writes its partial sum in fp32,
// unrounded, for the caller to sum over the ranks, round and bias.  No
// atomics: every output's sum runs in the same order on every run.  The
// tiles are compile-time constants (UAT_*_TILE below, chosen by
// scripts/gemm_tiles.py on the card); cudaFuncSetAttribute for dynamic
// shared memory runs once per device.
#include <atomic>
#include <type_traits>

#include "attention_core.cuh"
#include "attention_core_f32.cuh"

// Tiles of the four GEMMs: bf16 (warpgroups, columns, ring stages), fp32
// (rows, columns, rows a thread, K step, K split groups).  The alternatives' times are in
// PERF.md (scripts/gemm_tiles.py).
#ifndef UAT_BF16_QKV_TILE
#define UAT_BF16_QKV_TILE 2, 128, 3
#endif
#ifndef UAT_BF16_OUT_TILE
#define UAT_BF16_OUT_TILE 1, 64, 4
#endif
#ifndef UAT_F32_QKV_TILE
#define UAT_F32_QKV_TILE 96, 128, 8, 32, 1
#endif
#ifndef UAT_F32_OUT_TILE
#define UAT_F32_OUT_TILE 64, 128, 4, 32, 2
#endif

namespace {

// C[:, s*seg_n : (s+1)*seg_n] = A . W[s]^T (+ bias[s]) (-> LayerNorm[s]),
// for the n / seg_n segments s.  A is (M, K) row-major, W[s] is (seg_n, K)
// row-major, PyTorch's (out, in) layout; LayerNorm is per 64-column head.
template <typename T>
struct GemmArgs {
  const T* A;
  int M, K;
  const T* W[3];
  const T* bias[3];         // nullptr: no bias
  const float* ln_g[3];     // nullptr: no LayerNorm
  const float* ln_b[3];
  T* C;
  float* C32;               // non-null: C's fp32 partial sums, unrounded
  int n, seg_n;             // columns of C; columns of a segment
  float eps;
};

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

__device__ __forceinline__ void cp_async16_to(uint32_t dst, const void* src,
                                              int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// The row of W[] behind column n of C (n < g.n).
template <typename T>
__device__ __forceinline__ const T* weight_row(const GemmArgs<T>& g, int n) {
  const int seg = n / g.seg_n;
  return g.W[seg] + static_cast<size_t>(n - seg * g.seg_n) * g.K;
}

// ---------------------------------------------------------------- bf16 ---
namespace wg {

constexpr int kBK = 64;          // K a stage: one 128-byte swizzle row

template <int kN>
struct Wgmma;

// d (64 x kN fp32, this thread's share) += A . B^T over k16: A 64 x 16 and
// B kN x 16 bf16, both K-major in the 128-byte swizzled layout.
template <>
struct Wgmma<64> {
  __device__ static __forceinline__ void mma(float (&d)[32], uint64_t da,
                                             uint64_t db) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  __device__ static __forceinline__ void mma(float (&d)[64], uint64_t da,
                                             uint64_t db) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<256> {
  __device__ static __forceinline__ void mma(float (&d)[128], uint64_t da,
                                             uint64_t db) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127 "
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "l"(da), "l"(db), "r"(1));
  }
};

// wgmma descriptor of a K-major tile in the 128-byte swizzled layout at
// shared address `saddr`: 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |          // LBO (unused), 16 B
         (static_cast<uint64_t>(1024 >> 4) << 32) |  // SBO, 1024 B
         (static_cast<uint64_t>(1) << 62);           // 128-byte swizzle
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}
// cp.async's writes (generic proxy) visible to wgmma's reads (async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// kWG warpgroups of 64 rows, kBN columns, a ring of kStages: tile kt +
// kStages - 2 in flight while wgmma runs on tile kt.
template <int kWG, int kBN, int kStages>
struct Tile {
  static_assert(kStages >= 3, "a free slot beside the one wgmma may read");
  static constexpr int kBM = 64 * kWG;
  static constexpr int kThreads = 128 * kWG;
  static constexpr int kABytes = kBM * 128;
  static constexpr int kStageBytes = kABytes + kBN * 128;
  static constexpr int kSmem = kStages * kStageBytes + 1024;  // + alignment
  static constexpr int kAChunks = kBM * 8 / kThreads;         // 4
  static constexpr int kBChunks = kBN * 8 / kThreads;
};

template <int kWG, int kBN, int kStages>
__global__ void __launch_bounds__(128 * kWG)
    gemm_bf16_kernel(GemmArgs<bf16> g) {
  using L = Tile<kWG, kBN, kStages>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const int tid = threadIdx.x, wgi = tid >> 7;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * L::kBM;
  const int ktiles = g.K / kBK;
  // a warpgroup whose 64 rows are all past M (the ragged last tile) only
  // loads: warpgroup-uniform
  const bool live = m0 + wgi * 64 < g.M;

  // this thread's 16-byte chunks (row r = c / 8, chunk c % 8) of each tile:
  // source rows and swizzled offsets, fixed over K
  const bf16* a_src[L::kAChunks];
  const bf16* b_src[L::kBChunks];
  uint32_t a_off[L::kAChunks], b_off[L::kBChunks];
  int a_bytes[L::kAChunks], b_bytes[L::kBChunks];
#pragma unroll
  for (int i = 0; i < L::kAChunks; ++i) {
    const int c = tid + i * L::kThreads, r = c >> 3, q = c & 7;
    const int m = m0 + r;
    a_bytes[i] = m < g.M ? 16 : 0;  // rows past M: zeros
    a_src[i] = g.A + static_cast<size_t>(m < g.M ? m : 0) * g.K + q * 8;
    a_off[i] = r * 128 + ((q ^ (r & 7)) << 4);
  }
#pragma unroll
  for (int i = 0; i < L::kBChunks; ++i) {
    const int c = tid + i * L::kThreads, r = c >> 3, q = c & 7;
    const int n = n0 + r;
    b_bytes[i] = n < g.n ? 16 : 0;  // columns past n: zeros
    b_src[i] = weight_row(g, n < g.n ? n : 0) + q * 8;
    b_off[i] = L::kABytes + r * 128 + ((q ^ (r & 7)) << 4);
  }
  auto load = [&](int kt) {
    const uint32_t s = base + (kt % kStages) * L::kStageBytes;
    const int k0 = kt * kBK;
#pragma unroll
    for (int i = 0; i < L::kAChunks; ++i)
      cp_async16_to(s + a_off[i], a_src[i] + k0, a_bytes[i]);
#pragma unroll
    for (int i = 0; i < L::kBChunks; ++i)
      cp_async16_to(s + b_off[i], b_src[i] + k0, b_bytes[i]);
  };

  float acc[kBN / 2];
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 2; ++s) {
    if (s < ktiles) load(s);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<kStages - 3>();  // this thread's copies of tile kt landed
    fence_proxy_async();
    __syncthreads();  // everyone's landed; wgmma of tile kt - 2 retired
    if (kt + kStages - 2 < ktiles) load(kt + kStages - 2);
    cp_async_commit();
    if (!live) continue;  // loads only: this warpgroup's rows are past M
    const uint32_t s = base + (kt % kStages) * L::kStageBytes;
    const uint32_t sa = s + wgi * 64 * 128, sb = s + L::kABytes;
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < kBK / 16; ++k)  // 32 bytes of each row a k16 step
      Wgmma<kBN>::mma(acc, desc_sw128(sa + 32 * k), desc_sw128(sb + 32 * k));
    wgmma_commit();
    wgmma_wait<1>();  // tile kt - 1's group retired; tile kt's in flight
  }
  wgmma_wait<0>();

  // epilogue on the accumulators: lane (g4 = lane / 4, t4 = lane % 4) of
  // warp w holds rows 16w + g4 (acc[4j], acc[4j+1]) and 16w + g4 + 8
  // (acc[4j+2], acc[4j+3]), columns 8j + 2*t4 and 8j + 2*t4 + 1
  const int lane = tid & 31, g4 = lane >> 2, t4 = lane & 3;
  const int row0 = m0 + wgi * 64 + ((tid & 127) >> 5) * 16 + g4;
#pragma unroll
  for (int h = 0; h < kBN / 64; ++h) {
    const int col0 = n0 + 64 * h;
    if (col0 >= g.n) break;  // block-uniform
    if (g.C32 != nullptr) {  // block-uniform: the partial sums, unrounded
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int m = row0 + 8 * r;
        if (m >= g.M) continue;
        float* c = g.C32 + static_cast<size_t>(m) * g.n + col0 + 2 * t4;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<float2*>(c + 8 * j) =
              make_float2(acc[(8 * h + j) * 4 + 2 * r],
                          acc[(8 * h + j) * 4 + 2 * r + 1]);
      }
      continue;
    }
    const int seg = col0 / g.seg_n, nl = col0 - seg * g.seg_n;
    const bf16* bias = g.bias[seg];
    const float* ln_g = g.ln_g[seg];
    const float* ln_b = g.ln_b[seg];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float x[16];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          bf16 y = rn(acc[(8 * h + j) * 4 + 2 * r + e]);
          if (bias != nullptr) y = rn(bf(y) + bf(bias[nl + 8 * j + 2 * t4 + e]));
          x[2 * j + e] = bf(y);
        }
      if (ln_g != nullptr) {  // block-uniform
        float sum = 0.f;
#pragma unroll
        for (int i = 0; i < 16; ++i) sum += x[i];
        sum += __shfl_xor_sync(kFull, sum, 1);
        sum += __shfl_xor_sync(kFull, sum, 2);
        const float mu = sum / kHead;
        float sq = 0.f;
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          x[i] -= mu;
          sq += x[i] * x[i];
        }
        sq += __shfl_xor_sync(kFull, sq, 1);
        sq += __shfl_xor_sync(kFull, sq, 2);
        const float inv = 1.f / sqrtf(sq / kHead + g.eps);
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = 8 * j + 2 * t4 + e;
            x[2 * j + e] = bf(rn(__fadd_rn(
                __fmul_rn(__fmul_rn(x[2 * j + e], inv), ln_g[c]), ln_b[c])));
          }
      }
      const int m = row0 + 8 * r;
      if (m < g.M) {
        bf16* c = g.C + static_cast<size_t>(m) * g.n + col0 + 2 * t4;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<uint32_t*>(c + 8 * j) =
              pack_bf16(x[2 * j], x[2 * j + 1]);
      }
    }
  }
}

// One launch of gemm_bf16_kernel<kWG, kBN, kStages> over C's tiles on
// `stream`.
template <int kWG, int kBN, int kStages>
cudaError_t launch(const GemmArgs<bf16>& g, cudaStream_t stream) {
  using L = Tile<kWG, kBN, kStages>;
  static std::atomic<uint64_t> raised{0};
  const cudaError_t e = raise_smem_once(
      gemm_bf16_kernel<kWG, kBN, kStages>, L::kSmem, raised);
  if (e != cudaSuccess) return e;
  const dim3 grid((g.n + kBN - 1) / kBN, (g.M + L::kBM - 1) / L::kBM);
  gemm_bf16_kernel<kWG, kBN, kStages>
      <<<grid, L::kThreads, L::kSmem, stream>>>(g);
  return cudaGetLastError();
}

}  // namespace wg

// ---------------------------------------------------------------- fp32 ---
namespace sg {

constexpr int kStages = 3;       // ring depth; tile kt + 2 in flight

// kBM x kBN tile (kBN 64 or 128: one or two heads), kTM x 8 outputs a
// thread of a group of (kBN / 8) x (kBM / kTM), K in steps of kBK (16 or
// 32) of which each of kSplit groups takes kBK / kSplit.  A and W tiles
// are stored as they lie in device memory, K-contiguous rows of kBK floats
// padded by 4 (a stride of 4 mod 32 words: 8 consecutive rows read as
// float4 hit 32 distinct banks), so 16-byte cp.async moves them and float4
// reads run along K.
template <int kBM, int kBN, int kTM, int kBK, int kSplit>
struct Tile {
  static constexpr int kLd = kBK + 4;
  static constexpr int kTX = kBN / 8, kTY = kBM / kTM;
  static constexpr int kGroup = kTX * kTY;         // threads a split group
  static constexpr int kThreads = kSplit * kGroup;
  static constexpr int kKG = kBK / kSplit;         // K a group a stage
  static constexpr int kStageFloats = (kBM + kBN) * kLd;
  static constexpr int kSmem = kStages * kStageFloats * sizeof(float);
  static constexpr int kRowChunks = kBK / 4;  // 16-byte chunks a row
  static constexpr int kAChunks = (kBM * kRowChunks + kThreads - 1) / kThreads;
  static constexpr int kBChunks = (kBN * kRowChunks + kThreads - 1) / kThreads;
  static_assert((kSplit - 1) * kTM * 8 * kGroup <= kStages * kStageFloats,
                "the partial sums fit in the ring");
};

// at least 512 threads an SM, up to 65536 / 512 registers a thread
template <int kBM, int kBN, int kTM, int kBK, int kSplit>
__global__ void __launch_bounds__(
    Tile<kBM, kBN, kTM, kBK, kSplit>::kThreads,
    512 / Tile<kBM, kBN, kTM, kBK, kSplit>::kThreads)
    gemm_f32_kernel(GemmArgs<float> g) {
  using L = Tile<kBM, kBN, kTM, kBK, kSplit>;
  constexpr int kLd = L::kLd;
  static_assert(kBN == 64 || kBN == 128, "one or two heads a column tile");
  extern __shared__ float4 smem_f4[];
  float* smem = reinterpret_cast<float*>(smem_f4);
  const int tid = threadIdx.x, grp = tid / L::kGroup, t = tid % L::kGroup;
  const int tx = t % L::kTX, ty = t / L::kTX;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const int ktiles = g.K / kBK;
  // a warp whose rows are all past M (the ragged last tile) only loads:
  // its lowest row is its first ty
  const bool live = m0 + (t & ~31) / L::kTX < g.M;

  // this thread's 16-byte chunks (row c / kRowChunks) of each tile:
  // sources and offsets, fixed over K; rows past M or n are zero-filled
  const float* a_src[L::kAChunks];
  const float* b_src[L::kBChunks];
  int a_off[L::kAChunks], b_off[L::kBChunks];
  bool a_in[L::kAChunks], b_in[L::kBChunks];
  // a tile whose chunks do not divide among the threads: the last pass
  // moves only chunks that exist
  auto exists = [](int i, int rows) {
    return (i + 1) * L::kThreads <= rows * L::kRowChunks ||
           threadIdx.x + i * L::kThreads < rows * L::kRowChunks;
  };
#pragma unroll
  for (int i = 0; i < L::kAChunks; ++i) {
    const int c = tid + i * L::kThreads, r = c / L::kRowChunks, m = m0 + r;
    const int q = (c % L::kRowChunks) * 4;
    a_in[i] = m < g.M;
    a_src[i] = g.A + static_cast<size_t>(a_in[i] ? m : 0) * g.K + q;
    a_off[i] = r * kLd + q;
  }
#pragma unroll
  for (int i = 0; i < L::kBChunks; ++i) {
    const int c = tid + i * L::kThreads, r = c / L::kRowChunks, n = n0 + r;
    const int q = (c % L::kRowChunks) * 4;
    b_in[i] = n < g.n;
    b_src[i] = weight_row(g, b_in[i] ? n : 0) + q;
    b_off[i] = (kBM + r) * kLd + q;
  }
  auto load = [&](int kt) {
    float* s = smem + (kt % kStages) * L::kStageFloats;
    const int k0 = kt * kBK;
#pragma unroll
    for (int i = 0; i < L::kAChunks; ++i)
      if (exists(i, kBM))
        cp_async16_to(smem_addr(s + a_off[i]), a_src[i] + k0,
                      a_in[i] ? 16 : 0);
#pragma unroll
    for (int i = 0; i < L::kBChunks; ++i)
      if (exists(i, kBN))
        cp_async16_to(smem_addr(s + b_off[i]), b_src[i] + k0,
                      b_in[i] ? 16 : 0);
  };

  // rows ty + kTY*i, columns 64*(tx/8) + tx%8 + 8*j of the tile: the 8
  // threads of a head row sit in one warp, and 8 of them reading 8
  // consecutive W rows as float4 hit 32 distinct banks
  const int cbase = 64 * (tx >> 3) + (tx & 7);
  float acc[kTM][8];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ktiles) load(s);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<kStages - 2>();  // this thread's copies of tile kt landed
    __syncthreads();  // everyone's landed; tile kt - 1's slot is free
    if (kt + kStages - 1 < ktiles) load(kt + kStages - 1);
    cp_async_commit();
    if (!live) continue;
    const float* sA = smem + (kt % kStages) * L::kStageFloats + grp * L::kKG;
    const float* sB = sA + kBM * kLd;
#pragma unroll
    for (int kk = 0; kk < L::kKG; kk += 4) {
#pragma unroll
      for (int jh = 0; jh < 8; jh += 4) {  // four columns at a time
        float4 b[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          b[j] = *reinterpret_cast<const float4*>(
              sB + (cbase + 8 * (jh + j)) * kLd + kk);
#pragma unroll
        for (int i = 0; i < kTM; ++i) {
          const float4 a = *reinterpret_cast<const float4*>(
              sA + (ty + L::kTY * i) * kLd + kk);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float& c = acc[i][jh + j];
            c = fmaf(a.x, b[j].x, c);
            c = fmaf(a.y, b[j].y, c);
            c = fmaf(a.z, b[j].z, c);
            c = fmaf(a.w, b[j].w, c);
          }
        }
      }
    }
  }

  if constexpr (kSplit > 1) {
    // groups 1.. hand their partial sums to group 0, which adds them in
    // group order: a fixed order, the same on every run
    cp_async_wait<0>();
    __syncthreads();  // the ring is free
    if (grp > 0) {
      float* part = smem + ((grp - 1) * kTM * 8) * L::kGroup + t;
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) part[(i * 8 + j) * L::kGroup] = acc[i][j];
    }
    __syncthreads();
    if (grp > 0) return;
#pragma unroll
    for (int q = 0; q < kSplit - 1; ++q) {
      const float* part = smem + (q * kTM * 8) * L::kGroup + t;
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] += part[(i * 8 + j) * L::kGroup];
    }
  }

  // epilogue: bias, then the per-head LayerNorm over the row's 64 columns,
  // held by the 8 lanes tx & ~7 .. tx | 7 of one warp
  const int col0 = n0 + 64 * (tx >> 3);
  const bool head = col0 < g.n;  // else a zero-filled head past C's columns
  const int seg = head ? col0 / g.seg_n : 0;
  const int nl = head ? col0 - seg * g.seg_n : 0;
  const float* bias = g.bias[seg];
  const float* ln_g = g.ln_g[seg];
  const float* ln_b = g.ln_b[seg];
  const int c = tx & 7;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    float y[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      y[j] = bias != nullptr ? acc[i][j] + bias[nl + c + 8 * j] : acc[i][j];
    // every lane takes the shuffles: a warp may hold heads of two segments
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) sum += y[j];
    const float mu = f32::group8_sum(sum) / kHead;
    float d[8], sq = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      d[j] = y[j] - mu;
      sq += d[j] * d[j];
    }
    const float inv = 1.f / sqrtf(f32::group8_sum(sq) / kHead + g.eps);
    if (ln_g != nullptr) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        y[j] = d[j] * inv * ln_g[c + 8 * j] + ln_b[c + 8 * j];
    }
    const int m = m0 + ty + L::kTY * i;
    if (head && m < g.M) {
      float* out = g.C + static_cast<size_t>(m) * g.n + col0 + c;
#pragma unroll
      for (int j = 0; j < 8; ++j) out[8 * j] = y[j];
    }
  }
}

// One launch of gemm_f32_kernel<kBM, kBN, kTM, kBK, kSplit> over C's
// tiles on `stream`.
template <int kBM, int kBN, int kTM, int kBK, int kSplit>
cudaError_t launch(const GemmArgs<float>& g, cudaStream_t stream) {
  using L = Tile<kBM, kBN, kTM, kBK, kSplit>;
  static std::atomic<uint64_t> raised{0};
  const cudaError_t e = raise_smem_once(
      gemm_f32_kernel<kBM, kBN, kTM, kBK, kSplit>, L::kSmem, raised);
  if (e != cudaSuccess) return e;
  const dim3 grid((g.n + kBN - 1) / kBN, (g.M + kBM - 1) / kBM);
  gemm_f32_kernel<kBM, kBN, kTM, kBK, kSplit>
      <<<grid, L::kThreads, L::kSmem, stream>>>(g);
  return cudaGetLastError();
}

}  // namespace sg

// The q/k/v GEMM's arguments: xn (M, D) by [Wq|Wk|Wv] (each (Dh, D)) into
// qkv (M, 3Dh), bias on q and v, LayerNorm on q and k.
template <typename T>
GemmArgs<T> qkv_args(const T* xn, const T* wq, const T* bq, const T* wk,
                     const T* wv, const T* bv, const float* gq,
                     const float* bqn, const float* gk, const float* bkn,
                     T* qkv, int M, int D, int Dh, float eps) {
  GemmArgs<T> a{};
  a.A = xn;
  a.M = M;
  a.K = D;
  a.W[0] = wq; a.W[1] = wk; a.W[2] = wv;
  a.bias[0] = bq; a.bias[1] = nullptr; a.bias[2] = bv;
  a.ln_g[0] = gq; a.ln_b[0] = bqn;
  a.ln_g[1] = gk; a.ln_b[1] = bkn;
  a.C = qkv;
  a.n = 3 * Dh;
  a.seg_n = Dh;
  a.eps = eps;
  return a;
}

// The out projection's: attn (M, Dh) by Wo (D, Dh) plus bo into out (M, D)
// of T; with no bo, the partial sums into out (M, D) of fp32, unrounded.
template <typename T>
GemmArgs<T> out_args(const T* attn, const T* wo, const T* bo, void* out,
                     int M, int D, int Dh) {
  GemmArgs<T> p{};
  p.A = attn;
  p.M = M;
  p.K = Dh;
  p.W[0] = wo;
  p.bias[0] = bo;
  if (bo == nullptr && !std::is_same<T, float>::value)
    p.C32 = static_cast<float*>(out);
  else
    p.C = static_cast<T*>(out);
  p.n = D;
  p.seg_n = D;
  return p;
}

// The attention step's operands: the q/k/v column slices of qkv (M, 3Dh).
template <typename Args, typename T>
Args attn_args(const T* qkv, T* attn, int N, int Dh, float scale, float eps) {
  Args t{};
  t.q = qkv;
  t.k = qkv + Dh;
  t.v = qkv + 2 * Dh;
  t.ld_q = t.ld_k = t.ld_v = 3 * Dh;
  t.bs_q = t.bs_k = t.bs_v = static_cast<int64_t>(N) * 3 * Dh;
  t.out = attn;
  t.N = N;
  t.D = Dh;
  t.scale = scale;
  t.eps = eps;
  return t;
}

// The entries' shapes: D a multiple of 64, H >= 1 heads, B, N >= 1.
bool valid_shape(int B, int N, int D, int H) {
  return B > 0 && N > 0 && H > 0 && D > 0 && D % kHead == 0;
}

}  // namespace

// xn: (B*N, D) bf16; wq/wk/wv: (Dh, D) and wo: (D, Dh) bf16 in (out, in)
// layout, Dh = 64*H; bq/bv: (Dh,) bf16 (k has no bias); bo: (D,) bf16 or
// null; gq/bqn/gk/bkn: (64,) fp32 per-head LayerNorm; qkv: (B*N, 3Dh) and
// attn: (B*N, Dh) bf16 workspaces; out: (B*N, D), bf16 with bo, or with a
// null bo fp32, the out projection's partial sums unrounded and unbiased
// (a head shard's, D > Dh); xn and the weights 16-byte aligned, out
// 8-byte aligned.  D must be a multiple of 64.  Returns cudaGetLastError()
// after the last launch (0 on success).
extern "C" int uat_eva_attn_block(
    const bf16* xn, const bf16* wq, const bf16* bq, const bf16* wk,
    const bf16* wv, const bf16* bv, const float* gq, const float* bqn,
    const float* gk, const float* bkn, const bf16* wo, const bf16* bo,
    bf16* qkv, bf16* attn, void* out, int B, int N, int D, int H, float scale,
    float eps, cudaStream_t stream) {
  if (!valid_shape(B, N, D, H)) return static_cast<int>(cudaErrorInvalidValue);
  const int M = B * N, Dh = H * kHead;
  cudaError_t e = wg::launch<UAT_BF16_QKV_TILE>(
      qkv_args(xn, wq, bq, wk, wv, bv, gq, bqn, gk, bkn, qkv, M, D, Dh, eps),
      stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = launch_attention<false>(
      attn_args<AttnArgs>(qkv, attn, N, Dh, scale, eps), B, H,
      stream);  // q/k LayerNorm'd above
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(wg::launch<UAT_BF16_OUT_TILE>(
      out_args(attn, wo, bo, out, M, D, Dh), stream));
}

// The fp32 entry: the bf16 entry's shapes, all fp32 (with a null bo, out
// holds the partial sums, unbiased).  *ran_tc is set to 1 when the
// attention step ran attn_f32_tc_kernel, else 0.  Returns
// cudaGetLastError() after the last launch (0 on success).
extern "C" int uat_eva_attn_block_fp32(
    const float* xn, const float* wq, const float* bq, const float* wk,
    const float* wv, const float* bv, const float* gq, const float* bqn,
    const float* gk, const float* bkn, const float* wo, const float* bo,
    float* qkv, float* attn, void* out, int B, int N, int D, int H,
    float scale, float eps, cudaStream_t stream, int* ran_tc) {
  if (!valid_shape(B, N, D, H)) return static_cast<int>(cudaErrorInvalidValue);
  const int M = B * N, Dh = H * kHead;
  cudaError_t e = sg::launch<UAT_F32_QKV_TILE>(
      qkv_args(xn, wq, bq, wk, wv, bv, gq, bqn, gk, bkn, qkv, M, D, Dh, eps),
      stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  auto t = attn_args<f32::AttnArgs>(qkv, attn, N, Dh, scale, eps);
  t.hd = kHead;
  // q/k LayerNorm'd above
  e = f32::launch_attention<false>(t, B, H, stream, ran_tc);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(sg::launch<UAT_F32_OUT_TILE>(
      out_args(attn, wo, bo, out, M, D, Dh), stream));
}
