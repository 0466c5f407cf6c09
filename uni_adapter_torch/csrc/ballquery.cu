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
//   card's peaks.  The time is latency: one launch, and for each query a
//   walk over the cloud whose steps each wait on a load and a warp vote.
//
// What the design does about it: the TPU kernel computes the whole (S, N)
//   key plane and extracts nsample minima one by one (64 rounds of a
//   lane-min and a knock-out).  On a GPU the first nsample in-ball indices
//   by index are an ordered compaction: one warp per query walks the cloud
//   in index order, 32 points a step; __ballot_sync marks the in-ball
//   points and each in-ball lane writes its index at slot count +
//   popc(votes of the lower lanes).  The walk stops once nsample are found.
//   Each distance uses __fmul_rn/__fadd_rn/__fsub_rn in the plain
//   version's order, so no FMA contraction moves a point across r^2: the
//   indices equal the plain PyTorch version's exactly.  Nothing is staged
//   in shared memory: the cloud (12 KB at N = 1024) stays in L1/L2 after
//   the first warps read it.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float norm2(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
ballquery_kernel(const float* __restrict__ xyz, const float* __restrict__ query,
                 int64_t* __restrict__ out, int N, int S, int nsample,
                 float r2) {
  const int lane = threadIdx.x & 31;
  const int s = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int b = blockIdx.y;
  if (s >= S) return;  // whole warps only
  const float* p = xyz + static_cast<size_t>(b) * N * 3;
  const float* qp = query + (static_cast<size_t>(b) * S + s) * 3;
  const float qx = qp[0], qy = qp[1], qz = qp[2];
  const float q2 = norm2(qx, qy, qz);
  int64_t* o = out + (static_cast<size_t>(b) * S + s) * nsample;

  int count = 0;      // in-ball points found so far (warp-uniform)
  int first = N - 1;  // the first in-ball index; N-1 for an empty ball
  for (int base = 0; base < N && count < nsample; base += 32) {
    const int j = base + lane;
    bool in = false;
    if (j < N) {
      const float x = __ldg(p + 3 * j), y = __ldg(p + 3 * j + 1),
                  z = __ldg(p + 3 * j + 2);
      const float cross = __fadd_rn(
          __fadd_rn(__fmul_rn(qx, x), __fmul_rn(qy, y)), __fmul_rn(qz, z));
      const float d = __fsub_rn(__fadd_rn(q2, norm2(x, y, z)),
                                __fmul_rn(2.f, cross));
      in = d <= r2;
    }
    const unsigned vote = __ballot_sync(kFull, in);
    if (count == 0 && vote != 0) first = base + __ffs(vote) - 1;
    if (in) {
      const int slot = count + __popc(vote & ((1u << lane) - 1u));
      if (slot < nsample) o[slot] = j;
    }
    count += __popc(vote);
  }
  for (int t = min(count, nsample) + lane; t < nsample; t += 32) o[t] = first;
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
  const dim3 grid((S + kWarpsPerBlock - 1) / kWarpsPerBlock, B);
  ballquery_kernel<<<grid, kWarpsPerBlock * 32, 0, stream>>>(
      xyz, query, out, N, S, nsample, r2);
  return static_cast<int>(cudaGetLastError());
}
