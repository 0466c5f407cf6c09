// (B, H, N, hd) multi-head attention in fp32 for Hopper (sm_90a):
// softmax(q.k^T * scale).v on contiguous fp32 q, k, v, each head a
// separate (N, hd) slice, any hd up to 128.
//
// Replaces: uni_adapter_tpu/ops/attention_pallas.py::attention_pallas
//   (_attn_kernel), and is the fp32 route of attention_pallas_heads.  That
//   kernel casts q and k to fp32, forms fp32 scores times the scale, masks
//   the padded keys, takes the row max, exp and p / sum(p), then p . v with
//   fp32 accumulation; with fp32 operands every step is fp32, as here
//   (attention_core_f32.cuh: at hd 33..64 split TF32 on the tensor cores,
//   to a few fp32 ulps; otherwise fp32 FFMA).
//
// What bounds it on the H100: operations.  At the extraction paths'
//   shapes, (B, H, N, hd) = (1, 16, 513, 64) for Uni3D-L, (1, 8, 385, 64)
//   for OpenShape-G and (1, 6, 513, 64) for ULIP-2, it is 4*B*H*N^2*hd =
//   1.08, 0.30 and 0.40 GFLOP, ~16, 4.5 and 6 us at 67 TFLOP/s fp32 (the
//   split's three TF32 products: ~6.5, 1.8 and 2.4 us at 494.7 TFLOP/s
//   TF32), against 4 * B*H*N*hd * 4 bytes = 8.4, 3.2 and 3.2 MB, ~2.5,
//   0.9 and 0.9 us at 3.35 TB/s.
//
// What the design does about it: a contiguous (B, H, N, hd) tensor is B*H
//   slices of N rows of hd, so the kernel is the fp32 attention of
//   attention_core_f32.cuh launched over B*H "batches" of one head each
//   (row stride hd, batch stride N*hd): no copy, no transpose, and the
//   Pallas kernel's padding of keys and head dim to 128 lanes has no
//   counterpart.  The core takes q . k^T once (online softmax).  hd = 64,
//   every path's head dim (and hd 33..63, padded to 64), runs
//   attn_f32_tc_kernel: split-TF32 mma.sync fragments in registers, keys
//   split among warps, the block shape picked from the grid
//   (attention_core_f32_tc.cuh).  hd <= 32 and hd > 64 run
//   attn_f32_kernel, 4 x 8 FFMA register tiles fed by float4
//   shared-memory reads, whose head width in shared memory is hd rounded
//   up to 16, 32 or 128, with zeros past hd and only the hd real output
//   columns written.
#include "attention_core_f32.cuh"

// q, k, v: (B, H, N, hd) fp32 contiguous, 16-byte aligned when hd is 16,
// 32, 64 or 128; out: the same shape.  Needs 1 <= hd <= 128 and
// B*H <= 65535.  *ran_tc is set to 1 when the launch ran
// attn_f32_tc_kernel (hd 33..64), else 0.  Returns cudaGetLastError()
// after the launch (0 on success).
extern "C" int uat_attention_fp32(const float* q, const float* k,
                                  const float* v, float* out, int B, int H,
                                  int N, int hd, float scale,
                                  cudaStream_t stream, int* ran_tc) {
  const int64_t slices = static_cast<int64_t>(B) * H;
  if (B <= 0 || H <= 0 || N <= 0 || hd <= 0 || hd > 128 || slices > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  f32::AttnArgs a{};
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
    e = f32::launch_attention<false, 16>(a, n, 1, stream, ran_tc);
  else if (hd <= 32)
    e = f32::launch_attention<false, 32>(a, n, 1, stream, ran_tc);
  else if (hd <= 64)
    e = f32::launch_attention<false, 64>(a, n, 1, stream, ran_tc);
  else
    e = f32::launch_attention<false, 128>(a, n, 1, stream, ran_tc);
  return static_cast<int>(e);
}
