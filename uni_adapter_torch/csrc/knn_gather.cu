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
//   selection's chains of dependent steps, at the 8 warps an SM that 1024
//   queries give.
//
// What the design does about it: one warp a query, a block of
//   kWarpsPerBlock queries streaming the cloud in index order in tiles of
//   kTile points ((x, y, z, |x|^2) in shared memory, loads issued before
//   the barrier), so N has no limit below int32 indexing; each lane keeps
//   its kTile/32 keys of a tile as uint32 in registers (UAT_KNN_GATHER_TILE:
//   warps a block, tile; chosen by scripts/knn_configs.py: 4, 2048).  A
//   warp carries the k least entries so far, sorted, in shared memory, and
//   their keys in registers.  A tile key at or above the carried k-th key
//   cannot enter (a tile's indices exceed every carried index, so the
//   carried entry wins a tie): the keys below it are masked and counted
//   (one __reduce_add_sync), and a tile with none costs only its
//   distances.  Up to kCap survivors are listed at once from the masks;
//   more (the first tile, or a cloud that nears the query tile by tile)
//   first bring the bound down by search_kth until at most kList remain,
//   or to the exact k-th key of carried and tile together, whose ties are
//   then listed lowest index first.  merge_candidates places every carried
//   and listed entry at its rank.  No step runs k dependent rounds,
//   neither a query nor a tile.  The k least (distance, index) pairs are
//   one total order's, so they do not depend on where the tiles end.
//   After the last tile the warp writes the indices and copies their C
//   values, 32 consecutive floats at a time.  The arithmetic is
//   knn_core.cuh's, shared with knn.cu.
#include <cuda_runtime.h>
#include <cstdint>

#include "knn_core.cuh"

#ifndef UAT_KNN_GATHER_TILE
#define UAT_KNN_GATHER_TILE 4, 2048
#endif

namespace {

constexpr int kConfig[] = {UAT_KNN_GATHER_TILE};
constexpr int kWarpsPerBlock = kConfig[0];
constexpr int kTile = kConfig[1];
constexpr int kPPL = kTile / 32;  // a tile's keys a lane
static_assert(kPPL >= 1 && kPPL * 32 == kTile,
              "UAT_KNN_GATHER_TILE: warps a block, tile (a multiple of 32)");

using knn_core::kEmpty;
using knn_core::kFull;
using knn_core::kPadKey;

// Shared memory: the tile's points (x, y, z, |x|^2), then for each warp
// its list (32 KPL entries) and candidates (kCap = 64 KPL), then each
// warp's rank histogram (32 KPL + 1 ints).
template <int KPL>
constexpr size_t smem_bytes() {
  return kTile * sizeof(float4) +
         static_cast<size_t>(kWarpsPerBlock) * 96 * KPL * 8 +
         static_cast<size_t>(kWarpsPerBlock) * (32 * KPL + 1) * sizeof(int);
}

template <int KPL>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
knn_gather_kernel(const float* __restrict__ xyz,
                  const float* __restrict__ query,
                  const float* __restrict__ values, int64_t* __restrict__ out,
                  float* __restrict__ gathered, int N, int S, int k, int C) {
  constexpr int kList = 32 * KPL, kCap = 64 * KPL;
  constexpr int kThreads = kWarpsPerBlock * 32;
  constexpr int kLoads = (kTile + kThreads - 1) / kThreads;
  extern __shared__ float4 tile[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned long long* lists =
      reinterpret_cast<unsigned long long*>(tile + kTile);
  unsigned long long* list = lists + warp * (kList + kCap);
  unsigned long long* cand = list + kList;
  int* hist = reinterpret_cast<int*>(lists + kWarpsPerBlock * (kList + kCap)) +
              warp * (kList + 1);

  const int b = blockIdx.y;
  const int s = blockIdx.x * kWarpsPerBlock + warp;
  // warps past the last query still load tiles and meet the barriers
  const bool active = s < S;
  const float* p = xyz + static_cast<size_t>(b) * N * 3;
  float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
  if (active) {
    const float* qp = query + (static_cast<size_t>(b) * S + s) * 3;
    q = make_float4(qp[0], qp[1], qp[2], knn_core::norm2(qp[0], qp[1], qp[2]));
  }

#pragma unroll
  for (int i = 0; i < KPL; ++i) list[lane + 32 * i] = kEmpty;
  unsigned ck[KPL];  // the listed keys: entry lane + 32 i
#pragma unroll
  for (int i = 0; i < KPL; ++i) ck[i] = kPadKey;
  unsigned kth_key = kPadKey;  // the k-th listed key (a pad until k are)

  const auto key_at = [&](int t) {
    return knn_core::point_key(q, tile[lane + 32 * t]);
  };
  for (int base = 0; base < N; base += kTile) {
    const int n = min(kTile, N - base);
    float x[kLoads], y[kLoads], z[kLoads];
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {  // issued before the barrier
      const int j = threadIdx.x + i * kThreads;
      if (j < n) {
        const float* pj = p + 3 * static_cast<size_t>(base + j);
        x[i] = pj[0];
        y[i] = pj[1];
        z[i] = pj[2];
      }
    }
    __syncthreads();  // every warp is done with the previous tile
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int j = threadIdx.x + i * kThreads;
      if (j < n) {
        tile[j] = make_float4(x[i], y[i], z[i],
                              knn_core::norm2(x[i], y[i], z[i]));
      }
    }
    __syncthreads();
    if (!active) continue;

    unsigned u[kPPL];  // past the tile's end: stale points, then pads
#pragma unroll
    for (int t = 0; t < kPPL; ++t) u[t] = key_at(t);
    if (n < kTile) {
#pragma unroll
      for (int t = 0; t < kPPL; ++t) {
        if (lane + 32 * t >= n) u[t] = kPadKey;
      }
    }
    // only keys below the carried k-th key can enter
    unsigned hi = kth_key;
    unsigned m[4];
    int below = static_cast<int>(
        __reduce_add_sync(kFull, knn_core::mask_below(u, hi, m)));
    if (below == 0) continue;
    int count = 0;
    if (below > kCap) {
      // Too many to list: bring hi down until at most kList lie below it,
      // or to the k-th key exactly; if it is tied, list the keys below it
      // and then its ties, lowest index first.
      unsigned kth = 0;
      const bool tied = knn_core::search_kth(u, ck, k, kList, hi, below, kth);
      knn_core::mask_below(u, tied ? kth : hi, m);
      count = knn_core::list_masked(m, base + lane, key_at, cand, 0);
      if (tied) {
        count = knn_core::compact_equal(u, base + lane, kth, cand, count,
                                        kCap);
      }
    } else {
      count = knn_core::list_masked(m, base + lane, key_at, cand, 0);
    }
    __syncwarp();
    knn_core::merge_candidates<KPL, 2 * KPL>(list, k, cand, count, hist);
    kth_key = knn_core::entry_key(list[k - 1]);
#pragma unroll
    for (int i = 0; i < KPL; ++i) {
      const int r = lane + 32 * i;
      ck[i] = r < k ? knn_core::entry_key(list[r]) : kPadKey;
    }
  }
  if (!active) return;

  const size_t row = static_cast<size_t>(b) * S + s;
  for (int r = lane; r < k; r += 32) {
    out[row * k + r] = knn_core::entry_index(list[r]);
  }
  const float* vb = values + static_cast<size_t>(b) * N * C;
  float* g = gathered + row * k * C;
  for (int e = lane; e < k * C; e += 32) {
    const int r = e / C;
    g[e] = vb[static_cast<size_t>(knn_core::entry_index(list[r])) * C +
              (e - r * C)];
  }
}

template <int KPL>
cudaError_t launch(const float* xyz, const float* query, const float* values,
                   int64_t* out, float* gathered, int B, int N, int S, int k,
                   int C, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<KPL>();
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        knn_gather_kernel<KPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((S + kWarpsPerBlock - 1) / kWarpsPerBlock, B);
  knn_gather_kernel<KPL><<<grid, kWarpsPerBlock * 32, smem, stream>>>(
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
