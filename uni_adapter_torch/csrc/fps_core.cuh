// The round of farthest point sampling shared by fps.cu and fps_grid.cu.
//
// Contract (uni_adapter_tpu/ops/fps_pallas.py, both kernels): the first
// centre is index 0; the running minimum starts at +inf; d = (x-cx)^2 +
// (y-cy)^2 + (z-cz)^2 summed left to right in fp32 (the _rn intrinsics,
// so nothing is contracted into an FMA); the next centre is the lowest
// index attaining the maximum.
//
// Keys.  Every running minimum is >= +0.0 or +inf, so its bits as an
// unsigned integer order as the floats do, and the running minimum is
// kept as those bits: min() of keys is fminf() of distances.  A pad slot
// (an index >= N) holds key 0, the key of distance +0.0, from the start,
// so it never rises; since every pad's index is above every real one,
// the lowest-index rule puts each real point first even in a round where
// every real distance is 0.
//
// The argmax of a warp is two `redux.sync` instructions: the largest key,
// then the lowest index among the lanes that hold it.
#pragma once

#include <cuda_runtime.h>
#include <cstdint>

namespace fps {

constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kInfKey = 0x7f800000u;  // the bits of +inf
constexpr unsigned kNoIndex = 0xffffffffu;

__device__ __forceinline__ unsigned distance_key(float x, float y, float z,
                                                 float cx, float cy,
                                                 float cz) {
  const float dx = __fsub_rn(x, cx);
  const float dy = __fsub_rn(y, cy);
  const float dz = __fsub_rn(z, cz);
  const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                            __fmul_rn(dz, dz));
  return __float_as_uint(d);
}

// One thread's round over its P points (registers): each running minimum
// takes the distance to the centre, then a tree over the P keys gives the
// largest and its slot t.  Slots hold ascending indices, and a pair keeps
// its lower slot unless the upper one is strictly larger, so a tie goes to
// the lower index.  Points are laid out so that warp w of a block holds a
// contiguous range of 32 P indices and lane l the ones = l mod 32 in it
// (loads stay coalesced, and warps hold ascending ranges).
template <int P>
__device__ __forceinline__ void thread_round(const float (&px)[P],
                                             const float (&py)[P],
                                             const float (&pz)[P],
                                             unsigned (&key)[P], float cx,
                                             float cy, float cz,
                                             unsigned& best, int& best_t) {
  unsigned k[P];
  int slot[P];
#pragma unroll
  for (int t = 0; t < P; ++t) {
    key[t] = min(key[t], distance_key(px[t], py[t], pz[t], cx, cy, cz));
    k[t] = key[t];
    slot[t] = t;
  }
#pragma unroll
  for (int s = 1; s < P; s *= 2) {
#pragma unroll
    for (int t = 0; t + s < P; t += 2 * s) {
      if (k[t + s] > k[t]) {
        k[t] = k[t + s];
        slot[t] = slot[t + s];
      }
    }
  }
  best = k[0];
  best_t = slot[0];
}

// Every lane ends with the warp's largest key and the lowest index that
// holds it (lanes may hold their indices in any order).
__device__ __forceinline__ void warp_argmax(unsigned& key, unsigned& idx) {
  const unsigned m = __reduce_max_sync(kFull, key);
  idx = __reduce_min_sync(kFull, key == m ? idx : kNoIndex);
  key = m;
}

// The (npoint) row of a cloud, written by one warp: lane i % 32 holds
// round i's centre, and the warp stores 32 centres (256 bytes, coalesced)
// every 32 rounds instead of one store a round.
struct OutRow {
  int64_t* row;
  int npoint;
  unsigned held = 0;

  __device__ __forceinline__ void put(int i, unsigned centre, int lane) {
    const int r = i & 31;
    if (lane == r) held = centre;
    if (r == 31 || i == npoint - 1) {
      if (lane <= r) row[i - r + lane] = static_cast<int64_t>(held);
    }
  }
};

}  // namespace fps
