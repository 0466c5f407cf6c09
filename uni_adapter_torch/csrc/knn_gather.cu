// k-nearest-neighbour selection with the neighbours' values gathered in the
// same launch, for clouds of any size, on Hopper (sm_90a).
//
// Replaces: uni_adapter_tpu/ops/knn_pallas.py::knn_gather_pallas
//   (_knn_gather_kernel).  Same contract: d = (|q|^2 + |x|^2) - 2 q.x in
//   fp32 (no TF32), the k nearest in ascending distance with ties to the
//   lowest index, and for each of them values[b, idx, :C] copied exactly
//   (C <= 8 fp32 channels; C = 0 gives the indices alone).  Indices are
//   written as int64.
//
// What bounds it on the H100: latency, as in knn.cu.  At Uni3D's grouping
//   of a 10,000-point cloud ((B, N, S, k, C) = (2, 10000, 512, 64, 6)) it
//   reads 0.5 MB, writes 1.8 MB and needs 10 M distances of 8 fp32
//   operations: a few microseconds at the card's peaks.  The time is the
//   dependent selection rounds of each query.
//
// What the design does about it: one warp per query, eight queries a
//   block, as in knn.cu, but the cloud is streamed in index order in tiles
//   of 2048 points (xyz and |x|^2 in 32 KB of shared memory), so N has no
//   limit below int32 indexing.  Each lane keeps 64 of a tile's distances
//   in registers, and the best k so far travel from tile to tile in
//   registers too: ceil(k/32) (distance, index) pairs a lane, entry r in
//   lane r % 32.  A tile takes k rounds; each round is one shuffle argmin
//   on (distance, index) over the carried pairs and the tile together, and
//   its winner becomes entry r of the new carried set.  The order is a
//   total order on (distance, index), so the k winners do not depend on
//   where the tiles end, and ties go to the lowest index.  The distance
//   and the argmin come from knn_core.cuh, shared with knn.cu.  After the
//   last tile each lane writes its entries' indices and copies their C
//   values from the (B, N, C) array.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <climits>
#include <cstdint>

#include "knn_core.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kPPL = 64;            // a tile's distances per lane
constexpr int kTile = 32 * kPPL;    // points per tile

using knn_core::before;

// This lane's least candidate (lv, li) and where it sits (loc): tile
// register t (loc = t, point j0 + 32 t) or carried slot c (loc = kPPL + c).
template <int KPL>
__device__ __forceinline__ void least(const float (&d)[kPPL],
                                      const float (&cv)[KPL],
                                      const int (&ci)[KPL], int j0, float& lv,
                                      int& li, int& loc) {
  lv = CUDART_INF_F;
  li = INT_MAX;
  loc = -1;
#pragma unroll
  for (int t = 0; t < kPPL; ++t) {
    if (before(d[t], j0 + 32 * t, lv, li)) {
      lv = d[t];
      li = j0 + 32 * t;
      loc = t;
    }
  }
#pragma unroll
  for (int c = 0; c < KPL; ++c) {
    if (before(cv[c], ci[c], lv, li)) {
      lv = cv[c];
      li = ci[c];
      loc = kPPL + c;
    }
  }
}

template <int KPL>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
knn_gather_kernel(const float* __restrict__ xyz,
                  const float* __restrict__ query,
                  const float* __restrict__ values, int64_t* __restrict__ out,
                  float* __restrict__ gathered, int N, int S, int k, int C) {
  __shared__ float sx[kTile], sy[kTile], sz[kTile], sw[kTile];
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int s = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  // warps past the last query still load tiles and meet the barriers
  const bool active = s < S;
  const float* p = xyz + static_cast<size_t>(b) * N * 3;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (active) {
    const float* qp = query + (static_cast<size_t>(b) * S + s) * 3;
    qx = qp[0];
    qy = qp[1];
    qz = qp[2];
  }
  const float q2 = knn_core::norm2(qx, qy, qz);

  // the best k so far: entry r in lane r % 32, slot r / 32; empty slots
  // hold (inf, INT_MAX) and never win, since every tile and the carried
  // set together hold at least k real points (k <= N, the first tile holds
  // min(N, 2048) >= k points)
  float cv[KPL];
  int ci[KPL];
#pragma unroll
  for (int c = 0; c < KPL; ++c) {
    cv[c] = CUDART_INF_F;
    ci[c] = INT_MAX;
  }

  for (int base = 0; base < N; base += kTile) {
    const int n = min(kTile, N - base);
    __syncthreads();  // every warp is done with the previous tile
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      const float* pj = p + 3 * static_cast<size_t>(base + j);
      const float x = pj[0], y = pj[1], z = pj[2];
      sx[j] = x;
      sy[j] = y;
      sz[j] = z;
      sw[j] = knn_core::norm2(x, y, z);
    }
    __syncthreads();
    if (!active) continue;

    float d[kPPL];
#pragma unroll
    for (int t = 0; t < kPPL; ++t) {
      const int j = lane + 32 * t;
      d[t] = j < n ? knn_core::sqdist(qx, qy, qz, q2, sx[j], sy[j], sz[j],
                                      sw[j])
                   : CUDART_INF_F;  // pads lose to every real point
    }
    float nv[KPL];
    int ni[KPL];
#pragma unroll
    for (int c = 0; c < KPL; ++c) {
      nv[c] = CUDART_INF_F;
      ni[c] = INT_MAX;
    }

    float lv;
    int li, loc;
    least(d, cv, ci, base + lane, lv, li, loc);

    for (int r = 0; r < k; ++r) {
      float bv = lv;
      int bi = li;
      knn_core::warp_argmin(bv, bi);
      if (lane == (r & 31)) {
#pragma unroll
        for (int c = 0; c < KPL; ++c) {
          if (c == (r >> 5)) {
            nv[c] = bv;
            ni[c] = bi;
          }
        }
      }
      // the winner is a real point, and real indices are unique among the
      // candidates: exactly one lane holds it
      if (li == bi) {
#pragma unroll
        for (int t = 0; t < kPPL; ++t) {
          if (t == loc) d[t] = CUDART_INF_F;
        }
#pragma unroll
        for (int c = 0; c < KPL; ++c) {
          if (kPPL + c == loc) {
            cv[c] = CUDART_INF_F;
            ci[c] = INT_MAX;
          }
        }
        least(d, cv, ci, base + lane, lv, li, loc);
      }
    }
#pragma unroll
    for (int c = 0; c < KPL; ++c) {
      cv[c] = nv[c];
      ci[c] = ni[c];
    }
  }
  if (!active) return;

  const size_t row = static_cast<size_t>(b) * S + s;
  const float* vb = values + static_cast<size_t>(b) * N * C;
#pragma unroll
  for (int c = 0; c < KPL; ++c) {
    const int r = 32 * c + lane;
    if (r < k) {
      out[row * k + r] = ci[c];
      const float* src = vb + static_cast<size_t>(ci[c]) * C;
      float* dst = gathered + (row * k + r) * C;
      for (int ch = 0; ch < C; ++ch) dst[ch] = src[ch];
    }
  }
}

template <int KPL>
cudaError_t launch(const float* xyz, const float* query, const float* values,
                   int64_t* out, float* gathered, int B, int N, int S, int k,
                   int C, cudaStream_t stream) {
  const dim3 grid((S + kWarpsPerBlock - 1) / kWarpsPerBlock, B);
  knn_gather_kernel<KPL><<<grid, kWarpsPerBlock * 32, 0, stream>>>(
      xyz, query, values, out, gathered, N, S, k, C);
  return cudaGetLastError();
}

}  // namespace

// xyz: (B, N, 3), query: (B, S, 3), values: (B, N, C) float32 contiguous
// (values and gathered may be null when C = 0); out: (B, S, k) int64,
// gathered: (B, S, k, C) float32.  Needs 0 < k <= min(N, 128), 0 <= C <= 8.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int uat_knn_gather(const float* xyz, const float* query,
                              const float* values, int64_t* out,
                              float* gathered, int B, int N, int S, int k,
                              int C, cudaStream_t stream) {
  if (k <= 0 || k > N || C < 0 || C > 8)
    return static_cast<int>(cudaErrorInvalidValue);
  if (k <= 32)
    return launch<1>(xyz, query, values, out, gathered, B, N, S, k, C, stream);
  if (k <= 64)
    return launch<2>(xyz, query, values, out, gathered, B, N, S, k, C, stream);
  if (k <= 128)
    return launch<4>(xyz, query, values, out, gathered, B, N, S, k, C, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
