// Farthest point sampling for Hopper (sm_90a).
//
// Replaces: uni_adapter_tpu/ops/fps_pallas.py::fps_pallas_batched
//   (_fps_batched_kernel).  Same contract: the first centre is index 0;
//   the running minimum distance starts at +inf; d = (x-cx)^2 + (y-cy)^2
//   + (z-cz)^2 summed left to right in fp32; the next centre is the first
//   index attaining the maximum.
//
// What bounds it on the H100: latency, not bytes or operations.  A cloud
//   is 12 KB in and 4 KB out (N=1024 -> 512 centres), but the 512 rounds
//   are dependent: round i+1 needs the argmax of round i.  The time is
//   512 x (distance update + block-wide argmax + barrier).
//
// What the design does about it: one block per cloud; the cloud's xyz
//   is copied once into shared memory (centroid lookups) and each thread
//   keeps its PPT points and their running minimum in registers, so a
//   round touches no device memory.  The argmax is a warp shuffle on
//   (value, lower index), one shared-memory exchange between the 8 warps
//   and a single barrier per round (the exchange slots are double
//   buffered by round parity, so no second barrier is needed).  The
//   distance uses __fmul_rn/__fadd_rn so the compiler cannot contract it
//   into FMAs: the indices equal the plain PyTorch version's exactly.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void take_max(float& best, int& best_i, float v,
                                         int i) {
  if (v > best || (v == best && i < best_i)) {
    best = v;
    best_i = i;
  }
}

template <int PPT>
__global__ void __launch_bounds__(kThreads)
fps_kernel(const float* __restrict__ xyz, int64_t* __restrict__ out, int N,
           int npoint) {
  extern __shared__ float smem[];  // sx[N] | sy[N] | sz[N]
  float* sx = smem;
  float* sy = smem + N;
  float* sz = smem + 2 * N;
  __shared__ float red_val[2][kWarps];
  __shared__ int red_idx[2][kWarps];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* p = xyz + static_cast<size_t>(blockIdx.x) * N * 3;
  for (int j = tid; j < N; j += kThreads) {
    sx[j] = p[3 * j];
    sy[j] = p[3 * j + 1];
    sz[j] = p[3 * j + 2];
  }
  __syncthreads();

  float px[PPT], py[PPT], pz[PPT], dist[PPT];
#pragma unroll
  for (int t = 0; t < PPT; ++t) {
    const int j = tid + t * kThreads;
    const bool valid = j < N;
    px[t] = valid ? sx[j] : 0.f;
    py[t] = valid ? sy[j] : 0.f;
    pz[t] = valid ? sz[j] : 0.f;
    // pads sit at -inf and can never be the maximum
    dist[t] = valid ? CUDART_INF_F : -CUDART_INF_F;
  }

  int64_t* o = out + static_cast<size_t>(blockIdx.x) * npoint;
  int farthest = 0;
  for (int i = 0; i < npoint; ++i) {
    if (tid == 0) o[i] = farthest;
    const float cx = sx[farthest], cy = sy[farthest], cz = sz[farthest];
    float best = -CUDART_INF_F;
    int best_i = N;
#pragma unroll
    for (int t = 0; t < PPT; ++t) {
      const float dx = __fsub_rn(px[t], cx);
      const float dy = __fsub_rn(py[t], cy);
      const float dz = __fsub_rn(pz[t], cz);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                __fmul_rn(dz, dz));
      dist[t] = fminf(dist[t], d);
      // indices grow with t, so a strict '>' keeps the first maximum
      if (dist[t] > best) {
        best = dist[t];
        best_i = tid + t * kThreads;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(kFull, best, off);
      const int oi = __shfl_xor_sync(kFull, best_i, off);
      take_max(best, best_i, ov, oi);
    }
    const int buf = i & 1;
    if (lane == 0) {
      red_val[buf][warp] = best;
      red_idx[buf][warp] = best_i;
    }
    __syncthreads();
    best = red_val[buf][0];
    best_i = red_idx[buf][0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) take_max(best, best_i, red_val[buf][w], red_idx[buf][w]);
    farthest = best_i;
  }
}

template <int PPT>
cudaError_t launch(const float* xyz, int64_t* out, int B, int N, int npoint,
                   cudaStream_t stream) {
  const size_t smem = 3 * static_cast<size_t>(N) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fps_kernel<PPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  fps_kernel<PPT><<<B, kThreads, smem, stream>>>(xyz, out, N, npoint);
  return cudaGetLastError();
}

}  // namespace

// xyz: (B, N, 3) float32 contiguous; out: (B, npoint) int64.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int uat_fps(const float* xyz, int64_t* out, int B, int N,
                       int npoint, cudaStream_t stream) {
  if (N <= kThreads) return launch<1>(xyz, out, B, N, npoint, stream);
  if (N <= 2 * kThreads) return launch<2>(xyz, out, B, N, npoint, stream);
  if (N <= 4 * kThreads) return launch<4>(xyz, out, B, N, npoint, stream);
  if (N <= 8 * kThreads) return launch<8>(xyz, out, B, N, npoint, stream);
  if (N <= 16 * kThreads) return launch<16>(xyz, out, B, N, npoint, stream);
  if (N <= 32 * kThreads) return launch<32>(xyz, out, B, N, npoint, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
