// k-nearest-neighbour selection for Hopper (sm_90a).
//
// Replaces: uni_adapter_tpu/ops/knn_pallas.py::knn_pallas (_knn_kernel,
//   sqdist_plane).  Same contract: d = (|q|^2 + |x|^2) - 2 q.x in fp32
//   (no TF32, no reduced-precision pass), then the k nearest as (B, S, k)
//   indices in ascending distance, ties to the lowest index.
//
// What bounds it on the H100: neither bytes nor arithmetic at the main
//   path's shape.  (B, N, S, k) = (2, 1024, 512, 64) reads 18 KB and
//   writes 256 KB; the distances are 1 M multiply-adds.  The time is the
//   selection's chains of dependent steps, at the 8 warps an SM that 1024
//   queries give.
//
// What the design does about it: one warp per query and UAT_KNN_WARPS
//   queries a block (8, scripts/knn_configs.py), with the cloud's (x, y,
//   z, |x|^2) in shared memory (16 KB at N=1024).  Each lane computes its
//   N/32 distances (points lane, lane+32, ...) and keeps them in registers
//   as order-preserving uint32 keys.  The selection comes from
//   knn_core.cuh, shared with knn_gather.cu, and runs no k dependent
//   argmin rounds: search_kth brings a bound down, one warp-wide count a
//   bit, until at most k + kSlack keys lie below it (or to the exact k-th
//   key, if that is tied with more); those keys are listed in shared
//   memory from per-lane masks (and the k-th key's ties after them, lowest
//   index first, k in all), and each listed entry's rank among them places
//   the k least.  The indices equal the plain PyTorch version's exactly.
//
// Takes N <= 2048 (64 keys a lane) and any k <= N (k + kSlack entries of
//   8 bytes a warp in shared memory); larger clouds go to knn_gather.cu,
//   which streams the cloud in tiles.
#include <cuda_runtime.h>
#include <cstdint>

#include "knn_core.cuh"

#ifndef UAT_KNN_WARPS
#define UAT_KNN_WARPS 8
#endif

namespace {

constexpr int kWarpsPerBlock = UAT_KNN_WARPS;
// Candidates a warp may list beyond k: the search stops once at most
// k + kSlack keys lie below its bound.
constexpr int kSlack = 64;

using knn_core::kEmpty;
using knn_core::kFull;
using knn_core::kPadKey;

template <int PPL>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
knn_kernel(const float* __restrict__ xyz, const float* __restrict__ query,
           int64_t* __restrict__ out, int N, int S, int k) {
  // points[32 PPL] (x, y, z, |x|^2) | lists[kWarpsPerBlock][k + kSlack]
  extern __shared__ float4 points[];
  unsigned long long* lists =
      reinterpret_cast<unsigned long long*>(points + 32 * PPL);
  const int b = blockIdx.y;
  const float* p = xyz + static_cast<size_t>(b) * N * 3;
  constexpr int kThreads = kWarpsPerBlock * 32;
  constexpr int kLoads = (32 * PPL + kThreads - 1) / kThreads;
  float x[kLoads], y[kLoads], z[kLoads];
#pragma unroll
  for (int i = 0; i < kLoads; ++i) {  // every load issued before any store
    const int j = threadIdx.x + i * kThreads;
    if (j < N) {
      x[i] = p[3 * j];
      y[i] = p[3 * j + 1];
      z[i] = p[3 * j + 2];
    }
  }
#pragma unroll
  for (int i = 0; i < kLoads; ++i) {
    const int j = threadIdx.x + i * kThreads;
    if (j < N) {
      points[j] = make_float4(x[i], y[i], z[i],
                              knn_core::norm2(x[i], y[i], z[i]));
    }
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int s = blockIdx.x * kWarpsPerBlock + warp;
  if (s >= S) return;  // whole warps only: no barrier follows
  unsigned long long* list = lists + warp * (k + kSlack);
  const float* qp = query + (static_cast<size_t>(b) * S + s) * 3;
  const float4 q = make_float4(qp[0], qp[1], qp[2],
                               knn_core::norm2(qp[0], qp[1], qp[2]));

  // keys of points lane, lane + 32, ... (past N: stale shared memory,
  // then pads)
  unsigned u[PPL];
#pragma unroll
  for (int t = 0; t < PPL; ++t) {
    u[t] = knn_core::point_key(q, points[lane + 32 * t]);
  }
  if (N < 32 * PPL) {
#pragma unroll
    for (int t = 0; t < PPL; ++t) {
      if (lane + 32 * t >= N) u[t] = kPadKey;
    }
  }

  // Bring the bound down until at most k + kSlack keys lie below it, then
  // list them; or, if the k-th key is tied with too many, list the keys
  // below it and then its ties, lowest index first, k in all.
  const unsigned none[1] = {kPadKey};  // no carried list
  unsigned hi = kPadKey, kth = 0;
  int below = N;
  const int cap = k + kSlack;
  const auto key_at = [&](int t) {
    return knn_core::point_key(q, points[lane + 32 * t]);
  };
  unsigned m[4];
  int listed;
  if (below <= cap || !knn_core::search_kth(u, none, k, cap, hi, below, kth)) {
    knn_core::mask_below(u, hi, m);
    listed = knn_core::list_masked(m, lane, key_at, list, 0);
  } else {
    knn_core::mask_below(u, kth, m);
    listed = knn_core::list_masked(m, lane, key_at, list, 0);
    listed = knn_core::compact_equal(u, lane, kth, list, listed, k);
  }
  __syncwarp();

  // each listed entry's rank among them (they are distinct): the k least
  // go to their places
  int64_t* o = out + (static_cast<size_t>(b) * S + s) * k;
  for (int p0 = 0; p0 < listed; p0 += 64) {
    const int p1 = p0 + lane, p2 = p1 + 32;
    const unsigned long long e1 = p1 < listed ? list[p1] : kEmpty;
    const unsigned long long e2 = p2 < listed ? list[p2] : kEmpty;
    int r1 = 0, r2 = 0;
#pragma unroll 4
    for (int i = 0; i < listed; ++i) {
      const unsigned long long e = list[i];
      r1 += e < e1;
      r2 += e < e2;
    }
    if (p1 < listed && r1 < k) o[r1] = knn_core::entry_index(e1);
    if (p2 < listed && r2 < k) o[r2] = knn_core::entry_index(e2);
  }
}

template <int PPL>
cudaError_t launch(const float* xyz, const float* query, int64_t* out, int B,
                   int N, int S, int k, cudaStream_t stream) {
  const size_t smem = 32 * PPL * sizeof(float4) +
                      static_cast<size_t>(kWarpsPerBlock) * (k + kSlack) * 8;
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
// Needs 0 < k <= N <= 2048.  Returns cudaGetLastError() after the launch
// (0 on success).
extern "C" int uat_knn(const float* xyz, const float* query, int64_t* out,
                       int B, int N, int S, int k, cudaStream_t stream) {
  if (k <= 0 || k > N) return static_cast<int>(cudaErrorInvalidValue);
  if (N <= 32) return launch<1>(xyz, query, out, B, N, S, k, stream);
  if (N <= 64) return launch<2>(xyz, query, out, B, N, S, k, stream);
  if (N <= 128) return launch<4>(xyz, query, out, B, N, S, k, stream);
  if (N <= 256) return launch<8>(xyz, query, out, B, N, S, k, stream);
  if (N <= 512) return launch<16>(xyz, query, out, B, N, S, k, stream);
  if (N <= 1024) return launch<32>(xyz, query, out, B, N, S, k, stream);
  if (N <= 2048) return launch<64>(xyz, query, out, B, N, S, k, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
