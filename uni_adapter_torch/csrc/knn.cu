// k-nearest-neighbour selection for Hopper (sm_90a).
//
// Replaces: uni_adapter_tpu/ops/knn_pallas.py::knn_pallas (_knn_kernel,
//   sqdist_plane).  Same contract: d = (|q|^2 + |x|^2) - 2 q.x in fp32
//   (no TF32, no reduced-precision pass), then k min-extractions giving
//   (B, S, k) indices in ascending distance, ties to the lowest index.
//
// What bounds it on the H100: neither bytes nor arithmetic at the main
//   path's shape.  (B, N, S, k) = (2, 1024, 512, 64) reads 18 KB and
//   writes 512 KB; the distances are 1 M multiply-adds.  The time is the
//   k dependent selection rounds of each query: an argmin over N
//   candidates, 64 times in a row.
//
// What the design does about it: one warp per query and eight queries
//   per block, with the cloud's xyz and |x|^2 in shared memory (16 KB at
//   N=1024).  Each lane computes and keeps its N/32 distances in
//   registers (points lane, lane+32, ...), so the selection never touches
//   memory: a round is a 5-step shuffle argmin on (value, lower index);
//   only the winning lane then knocks its point out with +inf and rescans
//   its own registers for its next local minimum.  The distance and the
//   argmin come from knn_core.cuh, shared with knn_gather.cu: the indices
//   equal the plain PyTorch version's exactly.
//
// Takes N <= 2048 (64 distances a lane); larger clouds go to knn_gather.cu,
//   which streams the cloud in tiles.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <climits>
#include <cstdint>

#include "knn_core.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

template <int PPL>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
knn_kernel(const float* __restrict__ xyz, const float* __restrict__ query,
           int64_t* __restrict__ out, int N, int S, int k) {
  extern __shared__ float smem[];  // sx[N] | sy[N] | sz[N] | x2[N]
  float* sx = smem;
  float* sy = smem + N;
  float* sz = smem + 2 * N;
  float* sw = smem + 3 * N;
  const int b = blockIdx.y;
  const float* p = xyz + static_cast<size_t>(b) * N * 3;
  for (int j = threadIdx.x; j < N; j += blockDim.x) {
    const float x = p[3 * j], y = p[3 * j + 1], z = p[3 * j + 2];
    sx[j] = x;
    sy[j] = y;
    sz[j] = z;
    sw[j] = knn_core::norm2(x, y, z);
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int s = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (s >= S) return;  // whole warps only: no barrier follows
  const float* qp = query + (static_cast<size_t>(b) * S + s) * 3;
  const float qx = qp[0], qy = qp[1], qz = qp[2];
  const float q2 = knn_core::norm2(qx, qy, qz);

  float d[PPL];
#pragma unroll
  for (int t = 0; t < PPL; ++t) {
    const int j = lane + 32 * t;
    if (j < N) {
      d[t] = knn_core::sqdist(qx, qy, qz, q2, sx[j], sy[j], sz[j], sw[j]);
    } else {
      d[t] = CUDART_INF_F;  // pads never win
    }
  }

  // this lane's minimum; indices grow with t, so '<' keeps the lowest
  float lv = CUDART_INF_F;
  int li = INT_MAX;
#pragma unroll
  for (int t = 0; t < PPL; ++t) {
    if (d[t] < lv) {
      lv = d[t];
      li = lane + 32 * t;
    }
  }

  int64_t* o = out + (static_cast<size_t>(b) * S + s) * k;
  for (int r = 0; r < k; ++r) {
    float bv = lv;
    int bi = li;
    knn_core::warp_argmin(bv, bi);
    if (lane == 0) o[r] = bi;
    if ((bi & 31) == lane) {
      const int tw = bi >> 5;
      lv = CUDART_INF_F;
      li = INT_MAX;
#pragma unroll
      for (int t = 0; t < PPL; ++t) {
        if (t == tw) d[t] = CUDART_INF_F;
        if (d[t] < lv) {
          lv = d[t];
          li = lane + 32 * t;
        }
      }
    }
  }
}

template <int PPL>
cudaError_t launch(const float* xyz, const float* query, int64_t* out, int B,
                   int N, int S, int k, cudaStream_t stream) {
  const size_t smem = 4 * static_cast<size_t>(N) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        knn_kernel<PPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((S + kWarpsPerBlock - 1) / kWarpsPerBlock, B);
  knn_kernel<PPL><<<grid, kWarpsPerBlock * 32, smem, stream>>>(
      xyz, query, out, N, S, k);
  return cudaGetLastError();
}

}  // namespace

// xyz: (B, N, 3), query: (B, S, 3) float32 contiguous; out: (B, S, k) int64.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int uat_knn(const float* xyz, const float* query, int64_t* out,
                       int B, int N, int S, int k, cudaStream_t stream) {
  if (N <= 32) return launch<1>(xyz, query, out, B, N, S, k, stream);
  if (N <= 64) return launch<2>(xyz, query, out, B, N, S, k, stream);
  if (N <= 128) return launch<4>(xyz, query, out, B, N, S, k, stream);
  if (N <= 256) return launch<8>(xyz, query, out, B, N, S, k, stream);
  if (N <= 512) return launch<16>(xyz, query, out, B, N, S, k, stream);
  if (N <= 1024) return launch<32>(xyz, query, out, B, N, S, k, stream);
  if (N <= 2048) return launch<64>(xyz, query, out, B, N, S, k, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
