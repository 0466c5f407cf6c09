// (B, H, N, hd) multi-head attention for Hopper (sm_90a):
// softmax(q.k^T * scale).v on contiguous bf16 q, k, v, each head a
// separate (N, hd) slice, any hd up to 128.
//
// Replaces: uni_adapter_tpu/ops/attention_pallas.py::attention_pallas_heads
//   (_attn_heads_kernel).  Rounding points mirrored from that kernel:
//   scores are fp32 from bf16 operands; the maximum is taken over the real
//   keys only; p = exp((s - max) * scale) in fp32; p.v runs on bf16(p)
//   with fp32 accumulation and is divided by the fp32 sum of p; the output
//   is bf16.
//
// What bounds it on the H100: latency, not bytes or operations.  At the
//   extraction paths' shapes, (B, H, N, hd) = (1, 16, 513, 64) for
//   Uni3D-L, (1, 8, 385, 64) for OpenShape-G and (1, 6, 513, 64) for
//   ULIP-2, the function reads q, k, v and writes the output,
//   4 * B*H*N*hd * 2 bytes = 4.2, 1.6 and 1.6 MB, ~1.3, 0.5 and 0.5 us at
//   3.35 TB/s, against 4*B*H*N^2*hd = 1.08, 0.30 and 0.40 GFLOP, ~1.1, 0.3
//   and 0.4 us at 989 TFLOP/s bf16.  The grids are 144, 56 and 54 blocks of
//   64 queries on 132 SMs, each walking its keys twice.
//
// What the design does about it: a contiguous (B, H, N, hd) tensor is B*H
//   slices of N rows of hd, so the kernel is the bf16 attention core of
//   attention_core.cuh launched over B*H "batches" of one head each (row
//   stride hd, batch stride N*hd): no copy, no transpose, and the Pallas
//   kernel's head grouping and its padding of keys to 128 lanes have no
//   counterpart.  The core keeps its fragments in registers (mma.sync),
//   streams keys and values through a two-stage cp.async ring, and splits
//   each block's keys among ranges of warps so that an SM holds ~16 warps
//   in one wave: 64 queries x 4 ranges at OpenShape's 56 and ULIP's 54
//   blocks, 80 queries x 3 ranges at Uni3D's 16 heads (112 blocks, where
//   64-query blocks would be 144 on 132 SMs).  hd = 64,
//   the head dim of every path, is the core as the block and the
//   natural-layout attention run it.  Any other hd runs a variant whose
//   head width in shared memory is hd rounded up to 16, 32, 64 or 128,
//   with zeros past hd (they add nothing to q.k^T) and only the hd real
//   output columns written.  The first pass takes each row's exact
//   maximum, so bf16(p) rounds as in the reference; the last 64-key chunk
//   (one key at N = 385 and 513) computes only its real keys' columns.
#include "attention_core.cuh"

// q, k, v: (B, H, N, hd) bf16 contiguous, 16-byte aligned; out: the same
// shape.  Needs 1 <= hd <= 128 and B*H <= 65535.  Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int uat_attention_heads(const bf16* q, const bf16* k, const bf16* v,
                                   bf16* out, int B, int H, int N, int hd,
                                   float scale, cudaStream_t stream) {
  const int64_t slices = static_cast<int64_t>(B) * H;
  if (B <= 0 || H <= 0 || N <= 0 || hd <= 0 || hd > 128 || slices > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  AttnArgs a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.ld_q = a.ld_k = a.ld_v = hd;
  a.bs_q = a.bs_k = a.bs_v = static_cast<int64_t>(N) * hd;
  a.out = out;
  a.N = N;
  a.D = hd;
  a.scale = scale;
  a.hd = hd;
  const int n = static_cast<int>(slices);
  cudaError_t e;
  if (hd <= 16)
    e = launch_attention<false, 16>(a, n, 1, stream);
  else if (hd <= 32)
    e = launch_attention<false, 32>(a, n, 1, stream);
  else if (hd <= 64)
    e = launch_attention<false, 64>(a, n, 1, stream);
  else
    e = launch_attention<false, 128>(a, n, 1, stream);
  return static_cast<int>(e);
}
