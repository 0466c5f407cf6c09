// The arithmetic that the kNN kernels (knn.cu, knn_gather.cu) share, so
// that they cannot part in rounding or in tie-breaking.
//
// Distance: knn_pallas's expansion d = (|q|^2 + |x|^2) - 2 q.x in fp32,
//   every term with __fmul_rn/__fadd_rn/__fsub_rn in the plain PyTorch
//   version's order (ops/knn.py::sqdist), so no FMA contraction can change
//   a tie.
// Order: (distance, index) lexicographic; equal distances go to the lower
//   index, as the Pallas kernel's masked iota-min does.
#pragma once

#include <cuda_runtime.h>

namespace knn_core {

constexpr unsigned kFull = 0xffffffffu;

// |p|^2 = (x*x + y*y) + z*z
__device__ __forceinline__ float norm2(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                   __fmul_rn(z, z));
}

// (q2 + x2) - 2 * ((qx*x + qy*y) + qz*z)
__device__ __forceinline__ float sqdist(float qx, float qy, float qz,
                                        float q2, float x, float y, float z,
                                        float x2) {
  const float cross = __fadd_rn(__fadd_rn(__fmul_rn(qx, x), __fmul_rn(qy, y)),
                                __fmul_rn(qz, z));
  return __fsub_rn(__fadd_rn(q2, x2), __fmul_rn(2.f, cross));
}

// (v, i) comes before (bv, bi)
__device__ __forceinline__ bool before(float v, int i, float bv, int bi) {
  return v < bv || (v == bv && i < bi);
}

// The warp's least (value, index); every lane ends with it.
__device__ __forceinline__ void warp_argmin(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(kFull, v, off);
    const int oi = __shfl_xor_sync(kFull, i, off);
    if (before(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

}  // namespace knn_core
