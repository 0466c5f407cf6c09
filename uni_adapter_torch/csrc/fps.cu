// Farthest point sampling for Hopper (sm_90a), clouds of up to 4096
// points: one block per cloud, the cloud in registers.
//
// Replaces: uni_adapter_tpu/ops/fps_pallas.py::fps_pallas_batched
//   (_fps_batched_kernel).  Same contract (fps_core.cuh): the first centre
//   is index 0; the running minimum starts at +inf; d = (x-cx)^2 +
//   (y-cy)^2 + (z-cz)^2 summed left to right in fp32; the next centre is
//   the lowest index attaining the maximum.
//
// What bounds it on the H100: its dependent rounds, not bytes or
//   operations.  A (1024, 3) cloud is 12 KB in and 4 KB out, and 512
//   centres are 511 rounds, each of which needs the argmax of the one
//   before: the time is 511 x the latency of (distance update, block-wide
//   argmax, centre lookup).
//
// What the design does about it: every thread keeps its P points and
//   their running minima, as keys, in registers (warp w a contiguous range
//   of 32 P indices), and a round shortens the chain after the update.  A
//   tree over the P keys gives the thread's argmax; two redux.sync give
//   the warp's (no shuffle butterfly); with one warp that is the centre,
//   with W > 1 each warp writes its winner to a slot (double-buffered by
//   round parity), one barrier follows, and every thread reads the W slots
//   as 16-byte vectors and takes their argmax by a tree: the lower slot is
//   the lower index range, so ties need no index compare.  The centre's
//   coordinates come from one shared-memory copy of the cloud (a 16-byte
//   load).  The centres go out 32 at a time from warp 0's lanes, not one
//   global store a round.  The size classes and the warps a block of each
//   were chosen by measurement (scripts/fps_configs.py; UAT_FPS_CLASSES
//   overrides them there).  The classes end at 4096 points: above it a
//   cluster of blocks (fps_grid.cu) is within 3% of a 6144-point class
//   and 12% faster than an 8192-point one.
#include <cuda_runtime.h>

#include "fps_core.cuh"

#ifndef UAT_FPS_CLASSES
#define UAT_FPS_CLASSES 256, 1, 512, 2, 1024, 4, 2048, 4, 4096, 8
#endif

namespace {

// The size classes, ascending: (largest N of the class, warps a block).
constexpr int kClassTable[] = {UAT_FPS_CLASSES};
constexpr int kClasses = sizeof(kClassTable) / (2 * sizeof(int));
static_assert(sizeof(kClassTable) == 2 * kClasses * sizeof(int),
              "UAT_FPS_CLASSES is (largest N, warps) pairs");

// Every thread: the largest of the W warps' keys in `slots` (key, index),
// the lower slot on a tie.  Warp w holds a lower index range than warp
// w + 1, so the lower slot is the lower index.  The slots are read as
// 16-byte vectors, and the tree needs no shuffle.
template <int W>
__device__ __forceinline__ void slots_argmax(const uint2* slots,
                                             unsigned& key, unsigned& idx) {
  unsigned k[W], ix[W];
  const uint4* v = reinterpret_cast<const uint4*>(slots);
#pragma unroll
  for (int w = 0; w < W / 2; ++w) {
    const uint4 q = v[w];
    k[2 * w] = q.x;
    ix[2 * w] = q.y;
    k[2 * w + 1] = q.z;
    ix[2 * w + 1] = q.w;
  }
#pragma unroll
  for (int s = 1; s < W; s *= 2) {
#pragma unroll
    for (int w = 0; w + s < W; w += 2 * s) {
      if (k[w + s] > k[w]) {
        k[w] = k[w + s];
        ix[w] = ix[w + s];
      }
    }
  }
  key = k[0];
  idx = ix[0];
}

template <int W, int P>
__global__ void __launch_bounds__(W * 32)
fps_kernel(const float* __restrict__ xyz, int64_t* __restrict__ out, int N,
           int npoint) {
  extern __shared__ float4 sxyz[];  // the cloud: x, y, z, unused
  // each warp's winner (key, index), double-buffered by round parity
  __shared__ __align__(16) uint2 slots[2][W > 1 ? W : 2];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int first = warp * 32 * P + lane;  // this thread's lowest index
  const float* p = xyz + static_cast<size_t>(blockIdx.x) * N * 3;
  float px[P], py[P], pz[P];
  unsigned key[P];
#pragma unroll
  for (int t = 0; t < P; ++t) {
    const int j = first + 32 * t;
    const bool real = j < N;
    px[t] = real ? p[3 * j] : 0.f;
    py[t] = real ? p[3 * j + 1] : 0.f;
    pz[t] = real ? p[3 * j + 2] : 0.f;
    key[t] = real ? fps::kInfKey : 0u;
    if (real) sxyz[j] = make_float4(px[t], py[t], pz[t], 0.f);
  }
  __syncthreads();

  fps::OutRow row{out + static_cast<size_t>(blockIdx.x) * npoint, npoint};
  if (warp == 0) row.put(0, 0, lane);
  float4 c = sxyz[0];
  for (int i = 1; i < npoint; ++i) {
    unsigned best;
    int best_t;
    fps::thread_round<P>(px, py, pz, key, c.x, c.y, c.z, best, best_t);
    unsigned idx = first + 32 * best_t;
    fps::warp_argmax(best, idx);
    if constexpr (W > 1) {
      const int buf = i & 1;
      if (lane == 0) slots[buf][warp] = make_uint2(best, idx);
      __syncthreads();
      slots_argmax<W>(slots[buf], best, idx);
    }
    c = sxyz[idx];
    if (warp == 0) row.put(i, idx, lane);
  }
}

template <int W, int P>
cudaError_t launch(const float* xyz, int64_t* out, int B, int N, int npoint,
                   cudaStream_t stream) {
  const size_t smem = 16 * static_cast<size_t>(N);
  // the opt-in is needed once static (the slots) and dynamic shared memory
  // together pass 48 KB: from N = 3065 with 8 warps
  constexpr size_t kSlots = 2 * (W > 1 ? W : 2) * sizeof(uint2);
  if (smem + kSlots > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fps_kernel<W, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  fps_kernel<W, P><<<B, W * 32, smem, stream>>>(xyz, out, N, npoint);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_class(const float* xyz, int64_t* out, int B, int N,
                         int npoint, cudaStream_t stream) {
  if constexpr (K == kClasses) {
    return cudaErrorInvalidValue;
  } else {
    constexpr int points = kClassTable[2 * K], W = kClassTable[2 * K + 1];
    constexpr int P = points / (32 * W);
    static_assert(W >= 1 && W <= 32 && (W & (W - 1)) == 0 && P >= 1 &&
                      P * 32 * W == points,
                  "a class's warps: a power of two that divides its points");
    if (N <= points)
      return launch<W, P>(xyz, out, B, N, npoint, stream);
    return launch_class<K + 1>(xyz, out, B, N, npoint, stream);
  }
}

}  // namespace

// xyz: (B, N, 3) float32 contiguous, N <= the largest class (4096); out:
// (B, npoint) int64.  Returns cudaGetLastError() after the launch (0 on
// success; cudaErrorInvalidValue above the largest class).
extern "C" int uat_fps(const float* xyz, int64_t* out, int B, int N,
                       int npoint, cudaStream_t stream) {
  if (B <= 0 || N <= 0 || npoint <= 0 || npoint > N)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_class<0>(xyz, out, B, N, npoint, stream));
}
