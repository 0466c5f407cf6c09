// Farthest point sampling for clouds of any size on Hopper (sm_90a): one
// block of 1024 threads per cloud, the running minimum kept in memory.
//
// Replaces: uni_adapter_tpu/ops/fps_pallas.py::fps_pallas (_fps_kernel, the
//   grid over clouds).  Same contract as fps.cu: the first centre is index
//   0; the running minimum distance starts at +inf; d = (x-cx)^2 +
//   (y-cy)^2 + (z-cz)^2 summed left to right in fp32; the next centre is
//   the first index attaining the maximum.
//
// What bounds it on the H100: latency.  At 10,000 points -> 512 centres a
//   cloud is 120 KB in and 4 KB out, and the 512 rounds are dependent.
//
// What the design does about it: fps.cu keeps each thread's points and
//   their running minimum in registers, which ends at 8192 points.  Here
//   the cloud's xyz and running minimum sit in shared memory while 16 N
//   bytes fit (N = 10,000 takes 160 KB, past the 48 KB default, so the
//   launcher raises the block's limit); above that the running minimum is
//   a (B, N) fp32 scratch in device memory and the coordinates are read
//   through L1/L2.  Each round every thread updates its ceil(N/1024)
//   points (index order, so a strict '>' keeps the first maximum), a warp
//   shuffle takes the arg-max on (value, lower index), the 32 warps
//   exchange their winners through shared memory slots that are double
//   buffered by round parity, and a second shuffle over the 32 slots gives
//   every warp the centre: one barrier a round.  The distance uses
//   __fmul_rn/__fadd_rn/__fsub_rn so that the indices equal the plain
//   PyTorch version's exactly.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
// the reduction slots: 2 buffers x 32 warps x (float, int)
constexpr int kStaticShared = 2 * kWarps * 8;

__device__ __forceinline__ void take_max(float& best, int& best_i, float v,
                                         int i) {
  if (v > best || (v == best && i < best_i)) {
    best = v;
    best_i = i;
  }
}

__device__ __forceinline__ void warp_argmax(float& best, int& best_i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(kFull, best, off);
    const int oi = __shfl_xor_sync(kFull, best_i, off);
    take_max(best, best_i, ov, oi);
  }
}

// kShared: xyz and the running minimum in shared memory (16 N bytes);
// otherwise the minimum in `scratch` (B, N) and xyz read from `xyz`.
template <bool kShared>
__global__ void __launch_bounds__(kThreads)
fps_grid_kernel(const float* __restrict__ xyz, float* __restrict__ scratch,
                int64_t* __restrict__ out, int N, int npoint) {
  extern __shared__ float smem[];  // kShared: sx[N] | sy[N] | sz[N] | dist[N]
  __shared__ float red_val[2][kWarps];
  __shared__ int red_idx[2][kWarps];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* p = xyz + static_cast<size_t>(blockIdx.x) * N * 3;
  float* dist = kShared ? smem + 3 * static_cast<size_t>(N)
                        : scratch + static_cast<size_t>(blockIdx.x) * N;
  for (int j = tid; j < N; j += kThreads) {
    if (kShared) {
      smem[j] = p[3 * j];
      smem[N + j] = p[3 * j + 1];
      smem[2 * N + j] = p[3 * j + 2];
    }
    dist[j] = CUDART_INF_F;
  }
  __syncthreads();

  int64_t* o = out + static_cast<size_t>(blockIdx.x) * npoint;
  int farthest = 0;
  for (int i = 0; i < npoint; ++i) {
    if (tid == 0) o[i] = farthest;
    float cx, cy, cz;
    if (kShared) {
      cx = smem[farthest];
      cy = smem[N + farthest];
      cz = smem[2 * N + farthest];
    } else {
      cx = p[3 * farthest];
      cy = p[3 * farthest + 1];
      cz = p[3 * farthest + 2];
    }
    float best = -CUDART_INF_F;
    int best_i = INT_MAX;
    for (int j = tid; j < N; j += kThreads) {
      float x, y, z;
      if (kShared) {
        x = smem[j];
        y = smem[N + j];
        z = smem[2 * N + j];
      } else {
        x = p[3 * j];
        y = p[3 * j + 1];
        z = p[3 * j + 2];
      }
      const float dx = __fsub_rn(x, cx);
      const float dy = __fsub_rn(y, cy);
      const float dz = __fsub_rn(z, cz);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                __fmul_rn(dz, dz));
      const float m = fminf(dist[j], d);
      dist[j] = m;
      if (m > best) {
        best = m;
        best_i = j;
      }
    }
    warp_argmax(best, best_i);
    const int buf = i & 1;
    if (lane == 0) {
      red_val[buf][warp] = best;
      red_idx[buf][warp] = best_i;
    }
    __syncthreads();
    best = red_val[buf][lane];
    best_i = red_idx[buf][lane];
    warp_argmax(best, best_i);
    farthest = best_i;
  }
}

int shared_limit() {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  return optin;
}

}  // namespace

// The largest N whose xyz and running minimum fit in the block's shared
// memory on the current device; above it the launcher needs `scratch`.
extern "C" int uat_fps_grid_shared_points() {
  return (shared_limit() - kStaticShared) / 16;
}

// xyz: (B, N, 3) float32 contiguous; out: (B, npoint) int64; scratch: a
// (B, N) float32 buffer, read only when N > uat_fps_grid_shared_points()
// (may be null otherwise).  Returns cudaGetLastError() after the launch
// (0 on success).
extern "C" int uat_fps_grid(const float* xyz, float* scratch, int64_t* out,
                            int B, int N, int npoint, cudaStream_t stream) {
  if (N <= 0 || npoint <= 0 || npoint > N)
    return static_cast<int>(cudaErrorInvalidValue);
  if (N <= uat_fps_grid_shared_points()) {
    const size_t smem = 16 * static_cast<size_t>(N);
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          fps_grid_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    fps_grid_kernel<true><<<B, kThreads, smem, stream>>>(xyz, nullptr, out, N,
                                                         npoint);
  } else {
    if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    fps_grid_kernel<false><<<B, kThreads, 0, stream>>>(xyz, scratch, out, N,
                                                       npoint);
  }
  return static_cast<int>(cudaGetLastError());
}
