// Ball query for Hopper (sm_90a): up to nsample points within a radius of
// each query point.
//
// Replaces: uni_adapter_tpu/ops/ballquery_pallas.py::query_ball_pallas
//   (_ballquery_kernel, sqdist_plane).  Same contract: d = (|q|^2 + |x|^2)
//   - 2 q.x in fp32, a point is in the ball when d <= r^2; the first
//   nsample in-ball indices in ascending index order; unfilled slots take
//   the first in-ball index; an empty ball gives N-1 in every slot.
//
// What bounds it on the H100: neither bytes nor arithmetic.  At
//   OpenShape-G's (B, N, S, nsample) = (2, 1024, 384, 64) it reads 34 KB,
//   writes 197 KB of indices (counted as int32; this kernel writes int64)
//   and needs at most 786 K distances of 8 fp32 operations: ~0.1 us at the
//   card's peaks.  The time is latency: one launch, the cloud's way from
//   L2 into the SMs, and for each query a chain of dependent steps, each
//   a warp vote and a count that decides whether the walk goes on.  768
//   queries give one warp each fewer than 6 warps an SM, too few to hide
//   the latency of those steps.
//
// What the design does about it: the TPU kernel computes the whole (S, N)
//   key plane and extracts nsample minima one by one (64 rounds of a
//   lane-min and a knock-out).  On a GPU the first nsample in-ball indices
//   by index are an ordered compaction.  A block of kQueries queries
//   stages the cloud in shared memory once for all of them, in tiles of
//   kTile points as (x, y, z, |x|^2) (|x|^2 computed once a point; past
//   the cloud's end NaN, which no ball holds); each thread's loads of the
//   next tile are in flight while the current tile's rounds run.  Each query has kGroup warps, which walk the
//   tile in rounds of kRound points: warp g of the group takes the g-th
//   contiguous run of kChunks 32-point chunks, whose distances and
//   __ballot_sync votes are independent of each other.  Each warp posts
//   its run's in-ball count and first in-ball index to shared memory, and
//   after the round's barrier reads its group's: the counts of the runs
//   before its own place its in-ball lanes (slot = count + the runs
//   before + popc(the votes of the lower lanes)), so the indices land in
//   ascending order, in int64, up to 32 consecutive slots a store.  The
//   posts are double-buffered by round parity, so a round needs one
//   barrier (__syncthreads_or, which also says whether any query of the
//   block was still open).  A query stops after the round in which
//   nsample are found; the block stops streaming tiles once every query
//   of it is full.  Full and idle warps stage and meet every barrier.
//   UAT_BALLQUERY_CONFIG: queries a block, warps a query, chunks a warp a
//   round, tile; chosen by scripts/ballquery_configs.py.  Each distance
//   is knn_core.cuh's (__fmul_rn/__fadd_rn/__fsub_rn in the plain
//   version's order), so no FMA contraction moves a point across r^2: the
//   indices equal the plain PyTorch version's exactly.
#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

#include "knn_core.cuh"

#ifndef UAT_BALLQUERY_CONFIG
#define UAT_BALLQUERY_CONFIG 2, 4, 8, 1024
#endif

namespace {

constexpr int kConfig[] = {UAT_BALLQUERY_CONFIG};
constexpr int kQueries = kConfig[0];  // queries a block
constexpr int kGroup = kConfig[1];    // warps a query
constexpr int kChunks = kConfig[2];   // 32-point chunks a warp a round
constexpr int kTile = kConfig[3];     // points a tile in shared memory
constexpr int kWarps = kQueries * kGroup;
constexpr int kThreads = 32 * kWarps;
constexpr int kRound = 32 * kChunks * kGroup;  // a query's points a round
constexpr int kLoads = (kTile + kThreads - 1) / kThreads;  // a thread stages
static_assert(kThreads <= 1024 && kTile % kRound == 0 &&
                  kTile * sizeof(float4) + 2 * kWarps * sizeof(int2) <=
                      48 * 1024,
              "UAT_BALLQUERY_CONFIG: queries a block, warps a query, chunks "
              "a warp a round, tile (a multiple of the round, < 3072)");

using knn_core::kFull;

__global__ void __launch_bounds__(kThreads)
ballquery_kernel(const float* __restrict__ xyz, const float* __restrict__ query,
                 int64_t* __restrict__ out, int N, int S, int nsample,
                 float r2) {
  __shared__ float4 tile[kTile];
  // each warp's run in a round: (in-ball count, first in-ball index)
  __shared__ int2 post[2][kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned lower = (1u << lane) - 1u;  // the lanes below this one
  const int g = warp % kGroup;               // this warp's run
  const int b = blockIdx.y;
  const int s = blockIdx.x * kQueries + warp / kGroup;
  // warps past the last query still stage tiles and meet the barriers
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
  int64_t* o = out + (static_cast<size_t>(b) * S + s) * nsample;

  // the query's state, the same in each of its warps
  int count = 0;   // in-ball points found so far
  int first = -1;  // the first in-ball index, -1 while there is none
  int parity = 0;
  bool more = true;  // some query of the block was open last round
  // this thread's points of the next tile, loaded while the rounds of the
  // current one run
  float x[kLoads], y[kLoads], z[kLoads];
  const auto load = [&](int base) {
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int j = base + threadIdx.x + i * kThreads;
      if (threadIdx.x + i * kThreads < kTile && j < N) {
        const float* pj = p + 3 * static_cast<size_t>(j);
        x[i] = pj[0];
        y[i] = pj[1];
        z[i] = pj[2];
      }
    }
  };
  load(0);
  for (int base = 0; base < N && more; base += kTile) {
    const int n = min(kTile, N - base);
    // every warp is done with the previous tile; stop once every query of
    // the block is full
    if (base > 0 && !__syncthreads_or(active && count < nsample)) break;
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int j = threadIdx.x + i * kThreads;
      if (j < kTile) {
        tile[j] = j < n ? make_float4(x[i], y[i], z[i],
                                      knn_core::norm2(x[i], y[i], z[i]))
                        : make_float4(__int_as_float(0x7fffffff), 0.f, 0.f,
                                      0.f);
      }
    }
    __syncthreads();
    if (base + kTile < N) load(base + kTile);
    for (int t0 = 0; t0 < n && more; t0 += kRound) {
      const int r0 = t0 + 32 * kChunks * g;  // this warp's run in the tile
      const bool open = active && count < nsample;
      unsigned vote[kChunks];
      int in_run = 0, first_in_run = INT_MAX;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) vote[c] = 0u;
      if (open) {
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
          const float4 pt = tile[r0 + 32 * c + lane];
          vote[c] = __ballot_sync(
              kFull, knn_core::sqdist(qx, qy, qz, q2, pt.x, pt.y, pt.z,
                                      pt.w) <= r2);
        }
#pragma unroll
        for (int c = 0; c < kChunks; ++c) in_run += __popc(vote[c]);
        if (first < 0) {
#pragma unroll
          for (int c = kChunks - 1; c >= 0; --c) {
            if (vote[c] != 0u) first_in_run = r0 + 32 * c + __ffs(vote[c]) - 1;
          }
        }
      }
      if (lane == 0) post[parity][warp] = make_int2(in_run, first_in_run);
      more = __syncthreads_or(open);
      if (open) {
        int slot0 = count, in_round = 0, first_in_round = INT_MAX;
#pragma unroll
        for (int h = 0; h < kGroup; ++h) {
          const int2 v = post[parity][warp - g + h];
          slot0 += h < g ? v.x : 0;
          in_round += v.x;
          first_in_round = min(first_in_round, v.y);
        }
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
          if (vote[c] == 0u) continue;
          if (vote[c] >> lane & 1u) {
            const int slot = slot0 + __popc(vote[c] & lower);
            if (slot < nsample) o[slot] = base + r0 + 32 * c + lane;
          }
          slot0 += __popc(vote[c]);
        }
        if (first < 0 && in_round > 0) first = base + first_in_round;
        count += in_round;
      }
      parity ^= 1;
    }
  }
  if (!active) return;
  const int64_t fill = first < 0 ? N - 1 : first;
  for (int t = min(count, nsample) + 32 * g + lane; t < nsample;
       t += 32 * kGroup)
    o[t] = fill;
}

}  // namespace

// xyz: (B, N, 3), query: (B, S, 3) float32 contiguous; out: (B, S, nsample)
// int64; r2: the squared radius in fp32.  Returns cudaGetLastError() after
// the launch (0 on success).
extern "C" int uat_ballquery(const float* xyz, const float* query, int64_t* out,
                             int B, int N, int S, int nsample, float r2,
                             cudaStream_t stream) {
  if (B <= 0 || N <= 0 || S <= 0 || nsample <= 0 || nsample > N)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((S + kQueries - 1) / kQueries, B);
  ballquery_kernel<<<grid, kThreads, 0, stream>>>(xyz, query, out, N, S,
                                                  nsample, r2);
  return static_cast<int>(cudaGetLastError());
}
