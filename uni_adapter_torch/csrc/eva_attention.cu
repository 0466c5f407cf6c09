// Natural-layout multi-head attention for Hopper (sm_90a):
// softmax(q.k^T * scale).v on q, k, v (B, N, D) in bf16, heads as 64-wide
// column slices, with an optional per-head q/k LayerNorm.
//
// Replaces: uni_adapter_tpu/ops/attention_pallas.py::eva_attention_fused
//   (_eva_fused_kernel).  Rounding points mirrored from that kernel: with
//   gamma/beta given, q and k of each head go through a LayerNorm with fp32
//   statistics and are rounded to bf16; scores are fp32 from bf16 operands;
//   the maximum is taken over the real keys; p = exp((s - max) * scale) in
//   fp32; p.v runs on bf16(p) with fp32 accumulation and is divided by the
//   fp32 sum of p; the output is bf16.
//
// What bounds it on the H100: latency, not bytes or operations.  At
//   OpenShape-G's (B, N, D, H) = (2, 385, 512, 8) and ULIP-2's
//   (2, 513, 384, 6) the function reads q, k and v and writes the output,
//   4 x B*N*D*2 bytes = ~3.2 MB, ~0.94 us at 3.35 TB/s, against
//   4*B*H*N^2*64 = 0.61 and 0.81 GFLOP, ~0.6-0.8 us at 989 TFLOP/s bf16.
//   The grids are 112 and 108 blocks of 64 queries, fewer than the 132
//   SMs, each walking its keys twice.
//
// What the design does about it: the bf16 attention core of
//   attention_core.cuh, which reads q, k and v as column slices of
//   row-strided tensors.  ViTAttention hands over the three slices of its
//   fused (B, N, 3D) qkv product; each operand comes with its own row and
//   batch stride, so no slice is copied, and the kernel writes a
//   contiguous (B, N, D).  At these grids (112 and 108 blocks of 64
//   queries) the core splits each block's keys among four ranges of 4
//   warps, 16 warps an SM, with fragments in
//   registers (mma.sync) and keys and values streamed by cp.async.  A first
//   pass takes each row's exact maximum, a second forms p against it, so
//   bf16(p) rounds as in the reference; the last 64-key chunk (one key at
//   N = 385 and 513) computes only its real keys' columns.  The LayerNorm
//   variant normalises the q tile once and each key chunk once per pass
//   as it lands in shared memory.
//
// The fp32 entry (uat_eva_attention_fp32) is the same function on fp32
//   q, k, v: the fp32 form of _eva_fused_kernel ("fp32 runs stay fp32"),
//   the LayerNorm kept in fp32, scores, p and p . v in fp32: split TF32 on
//   the tensor cores without the LayerNorm (attention_core_f32_tc.cuh, the
//   main paths' variant), FFMA with it (attention_core_f32.cuh).  At the
//   same shapes it moves 4 x B*N*D*4 bytes = ~6.3 MB, ~1.9 us, against
//   0.61 and 0.81 GFLOP, ~9 and 12 us at 67 TFLOP/s fp32 (3.7 and 4.9 us
//   for the split's three TF32 products at 494.7): bound by operations.
#include "attention_core.cuh"
#include "attention_core_f32.cuh"

// q, k, v: bf16 with unit column stride, 16-byte aligned rows (strides in
// elements, multiples of 8); gq/bq/gk/bk: (64,) fp32 per-head LayerNorm, all
// null for none; out: (B, N, D) bf16 contiguous.  Needs D == 64*H.  Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int uat_eva_attention(
    const bf16* q, const bf16* k, const bf16* v, int64_t ld_q, int64_t ld_k,
    int64_t ld_v, int64_t bs_q, int64_t bs_k, int64_t bs_v, const float* gq,
    const float* bq, const float* gk, const float* bk, bf16* out, int B, int N,
    int D, int H, float scale, float eps, cudaStream_t stream) {
  if (D != H * kHead || B <= 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool ln = gq != nullptr;
  if (ln && (bq == nullptr || gk == nullptr || bk == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  AttnArgs a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.ld_q = ld_q;
  a.ld_k = ld_k;
  a.ld_v = ld_v;
  a.bs_q = bs_q;
  a.bs_k = bs_k;
  a.bs_v = bs_v;
  a.gq = gq;
  a.bq = bq;
  a.gk = gk;
  a.bk = bk;
  a.out = out;
  a.N = N;
  a.D = D;
  a.scale = scale;
  a.eps = eps;
  const cudaError_t e = ln ? launch_attention<true>(a, B, H, stream)
                           : launch_attention<false>(a, B, H, stream);
  return static_cast<int>(e);
}

// The fp32 entry: q, k, v fp32 with unit column stride and 16-byte aligned
// rows (strides in elements, multiples of 4); gq/bq/gk/bk as above; out:
// (B, N, D) fp32 contiguous.  Needs D == 64*H.  *ran_tc is set to 1 when
// the launch ran attn_f32_tc_kernel (no LayerNorm), else 0.  Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int uat_eva_attention_fp32(
    const float* q, const float* k, const float* v, int64_t ld_q, int64_t ld_k,
    int64_t ld_v, int64_t bs_q, int64_t bs_k, int64_t bs_v, const float* gq,
    const float* bq, const float* gk, const float* bk, float* out, int B, int N,
    int D, int H, float scale, float eps, cudaStream_t stream, int* ran_tc) {
  if (D != H * f32::kLnWidth || B <= 0 || N <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool ln = gq != nullptr;
  if (ln && (bq == nullptr || gk == nullptr || bk == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  f32::AttnArgs a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.ld_q = ld_q;
  a.ld_k = ld_k;
  a.ld_v = ld_v;
  a.bs_q = bs_q;
  a.bs_k = bs_k;
  a.bs_v = bs_v;
  a.gq = gq;
  a.bq = bq;
  a.gk = gk;
  a.bk = bk;
  a.out = out;
  a.N = N;
  a.D = D;
  a.scale = scale;
  a.eps = eps;
  a.hd = f32::kLnWidth;
  const cudaError_t e =
      ln ? f32::launch_attention<true>(a, B, H, stream, ran_tc)
         : f32::launch_attention<false>(a, B, H, stream, ran_tc);
  return static_cast<int>(e);
}
