// Farthest point sampling for clouds of any size on Hopper (sm_90a): a
// thread-block cluster per cloud, the cloud in the cluster's registers.
//
// Replaces: uni_adapter_tpu/ops/fps_pallas.py::fps_pallas (_fps_kernel, the
//   grid over clouds).  Same contract as fps.cu (fps_core.cuh): the first
//   centre is index 0; the running minimum starts at +inf; d = (x-cx)^2 +
//   (y-cy)^2 + (z-cz)^2 summed left to right in fp32; the next centre is
//   the lowest index attaining the maximum.
//
// What bounds it on the H100: its dependent rounds.  At (10,000, 3) -> 512
//   centres a cloud is 120 KB in and 4 KB out, and each of the 511 rounds
//   needs the argmax of the one before; on one SM a round is also bound by
//   that SM's issue rate over all N points.
//
// What the design does about it: a cluster of C blocks (C SMs) takes a
//   cloud, each block a contiguous slice in rank order, each warp a
//   contiguous range of it, each thread P points and their running minima
//   (as keys) in registers, with a copy of the block's slice in shared
//   memory for the winners' coordinates.  A round: every thread updates
//   its points and takes its argmax by a tree, every warp by two
//   redux.sync; then each warp writes its winner (key, index, x, y, z)
//   into its slot in every block of the cluster through distributed shared
//   memory (lane r stores to rank r), and every warp reads the C x W slots
//   of its own block and reduces them itself: the centre and its
//   coordinates.  No barrier orders the exchange (a cluster barrier a
//   round measured twice the round): a slot is three 64-bit words written
//   by relaxed cluster-scope stores, each word tagged with the round, and
//   a reader polls its slots until all three words carry this round's
//   tag.  The slots are double-buffered by round parity: a warp writes a
//   buffer again only after reading every warp's slot of the round
//   between, which each wrote after reading the buffer.  The tile (4 warps
//   a block, C the least power of two that leaves a thread at most 8
//   points, at most the portable 8 blocks: clusters of 16 measured slower)
//   was chosen by scripts/fps_configs.py.  A cloud above the cluster's
//   registers (kMaxPoints a thread) keeps its running minimum in a (B, N)
//   device-memory scratch and reads its coordinates from xyz each round,
//   on a cluster of 8, with the same exchange.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>

#include "fps_core.cuh"

#ifndef UAT_FPS_GRID_TILE
#define UAT_FPS_GRID_TILE 4, 8
#endif

namespace cg = cooperative_groups;

namespace {

// Warps a block and the target points a thread (which sets C); the
// largest portable cluster.
constexpr int kTile[] = {UAT_FPS_GRID_TILE};
constexpr int kWarps = kTile[0];
constexpr int kThreads = 32 * kWarps;
constexpr int kTargetPoints = kTile[1];
constexpr int kMaxCluster = 8;
// Registers: at most this many points a thread (and a slice copy of at
// most 128 KB), else device memory.
constexpr int kMaxPoints = std::min(32, 8192 / kThreads);
constexpr int kMaxSlots = kMaxCluster * kWarps;
constexpr unsigned kTagBit = 0x80000000u;
static_assert(kWarps >= 1 && kWarps <= 32 && kTargetPoints >= 1 &&
                  kTargetPoints <= kMaxPoints,
              "UAT_FPS_GRID_TILE is (warps a block, target points a thread)");

// One slot a (rank, warp) of the cluster and round parity, three 64-bit
// words: x bits | key, y bits | index, z bits | round.  A key (the bits of
// a distance >= +0.0) and an index (< 2^31) leave bit 31 free: it holds
// bit 1 of the round, which tells a round from the one two before it, the
// last to use the buffer.  The stores of one slot may land in any order;
// a reader takes the slot when all three words carry its round, and since
// it saw the buffer's previous round (or its initial words) complete, no
// older word can match (each word is read coherently).
struct Exchange {
  unsigned long long w[2][kMaxSlots][3];
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Write this warp's winner of round i into its slot of every block of the
// cluster: lane r < C stores to rank r.
__device__ __forceinline__ void publish(Exchange& ex, int i, int slot,
                                        int lane, int C, unsigned key,
                                        unsigned idx, float x, float y,
                                        float z) {
  if (lane >= C) return;
  const unsigned tag = (static_cast<unsigned>(i) << 30) & kTagBit;
  const unsigned long long w0 =
      static_cast<unsigned long long>(__float_as_uint(x)) << 32 | (key | tag);
  const unsigned long long w1 =
      static_cast<unsigned long long>(__float_as_uint(y)) << 32 | (idx | tag);
  const unsigned long long w2 =
      static_cast<unsigned long long>(__float_as_uint(z)) << 32 |
      static_cast<unsigned>(i);
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(smem_addr(&ex.w[i & 1][slot][0])), "r"(lane));
  asm volatile(
      "st.relaxed.cluster.shared::cluster.u64 [%0], %1;\n"
      "st.relaxed.cluster.shared::cluster.u64 [%0+8], %2;\n"
      "st.relaxed.cluster.shared::cluster.u64 [%0+16], %3;\n" ::"r"(remote),
      "l"(w0), "l"(w1), "l"(w2)
      : "memory");
}

// Round i's centre from the slots of this block: each lane polls its
// slots until all three words carry round i's tag, takes their argmax
// (the lower index on a tie), and the warp reduces the lanes' winners.
// Every lane ends with the centre's index and coordinates.
__device__ __forceinline__ void take_centre(const Exchange& ex, int i,
                                            int nslots, int lane,
                                            unsigned& centre, float& cx,
                                            float& cy, float& cz) {
  const unsigned tag = (static_cast<unsigned>(i) << 30) & kTagBit;
  unsigned k = 0, ix = fps::kNoIndex;
  unsigned long long pos0 = 0, pos1 = 0, pos2 = 0;
  for (int s = lane; s < nslots; s += 32) {
    const unsigned addr = smem_addr(&ex.w[i & 1][s][0]);
    unsigned long long w0, w1, w2;
    for (unsigned tries = 0;; ++tries) {
      asm volatile(
          "ld.relaxed.cluster.shared::cta.u64 %0, [%3];\n"
          "ld.relaxed.cluster.shared::cta.u64 %1, [%3+8];\n"
          "ld.relaxed.cluster.shared::cta.u64 %2, [%3+16];\n"
          : "=l"(w0), "=l"(w1), "=l"(w2)
          : "r"(addr)
          : "memory");
      if (static_cast<unsigned>(w2) == static_cast<unsigned>(i) &&
          (static_cast<unsigned>(w0) & kTagBit) == tag &&
          (static_cast<unsigned>(w1) & kTagBit) == tag)
        break;
      if (tries == (1u << 26)) __trap();  // a lost slot: fail, never hang
    }
    const unsigned ks = static_cast<unsigned>(w0) & ~kTagBit;
    const unsigned is = static_cast<unsigned>(w1) & ~kTagBit;
    if (ks > k || (ks == k && is < ix)) {
      k = ks;
      ix = is;
      pos0 = w0;
      pos1 = w1;
      pos2 = w2;
    }
  }
  unsigned m = k;
  centre = ix;
  fps::warp_argmax(m, centre);
  const int src = __ffs(__ballot_sync(fps::kFull, ix == centre)) - 1;
  cx = __uint_as_float(__shfl_sync(fps::kFull, static_cast<unsigned>(pos0 >> 32), src));
  cy = __uint_as_float(__shfl_sync(fps::kFull, static_cast<unsigned>(pos1 >> 32), src));
  cz = __uint_as_float(__shfl_sync(fps::kFull, static_cast<unsigned>(pos2 >> 32), src));
}

// P > 0: P points a thread in registers, the block's slice of kThreads * P
// points.  P == 0: the running minimum in `scratch` (B, N) and the
// coordinates read from xyz, the block's slice of `slice` points.
template <int P>
__global__ void __launch_bounds__(kThreads)
fps_grid_kernel(const float* __restrict__ xyz, unsigned* __restrict__ scratch,
                int64_t* __restrict__ out, int N, int npoint, int slice) {
  extern __shared__ float4 sxyz[];  // P > 0: the block's slice
  __shared__ Exchange ex;

  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int cloud = blockIdx.x / C;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int base = rank * slice;
  const float* p = xyz + static_cast<size_t>(cloud) * N * 3;
  const int nslots = C * kWarps;
  const int slot = rank * kWarps + warp;
  // No round's tag yet: word 2 holds no round, and bit 31 of words 0 and 1
  // is the opposite of the first round to use the buffer (round 1 for
  // buffer 1, 2 for buffer 0), so a slot whose word 2 has landed before
  // the others is not taken for complete.
  for (int s = tid; s < 2 * nslots; s += kThreads) {
    const int b = s / nslots;
    const unsigned long long stale = b == 1 ? kTagBit : 0u;
    ex.w[b][s % nslots][0] = stale;
    ex.w[b][s % nslots][1] = stale;
    ex.w[b][s % nslots][2] = ~0ull;
  }

  constexpr int PR = P > 0 ? P : 1;  // register arrays of P == 0 go unused
  float px[PR], py[PR], pz[PR];
  unsigned key[PR];
  unsigned* mins = nullptr;
  const int end = min(base + slice, N);
  const int first = warp * 32 * P + lane;  // P > 0: lowest local index
  if constexpr (P > 0) {
#pragma unroll
    for (int t = 0; t < P; ++t) {
      const int j = base + first + 32 * t;
      const bool real = j < N;
      px[t] = real ? p[3 * j] : 0.f;
      py[t] = real ? p[3 * j + 1] : 0.f;
      pz[t] = real ? p[3 * j + 2] : 0.f;
      key[t] = real ? fps::kInfKey : 0u;
      sxyz[first + 32 * t] = make_float4(px[t], py[t], pz[t], 0.f);
    }
  } else {
    mins = scratch + static_cast<size_t>(cloud) * N;
    for (int j = base + tid; j < end; j += kThreads) mins[j] = fps::kInfKey;
  }

  fps::OutRow row{out + static_cast<size_t>(cloud) * npoint, npoint};
  const bool writer = rank == 0 && warp == 0;
  if (writer) row.put(0, 0, lane);
  float cx = p[0], cy = p[1], cz = p[2];
  // the slices and slots are in place and every block of the cluster runs
  cluster.sync();

  for (int i = 1; i < npoint; ++i) {
    unsigned best, idx;
    float wx, wy, wz;
    if constexpr (P > 0) {
      int best_t;
      fps::thread_round<P>(px, py, pz, key, cx, cy, cz, best, best_t);
      idx = base + first + 32 * best_t;
      fps::warp_argmax(best, idx);
      const float4 w = sxyz[idx - base];
      wx = w.x;
      wy = w.y;
      wz = w.z;
    } else {
      best = 0;
      unsigned mine = fps::kNoIndex;
      float bx = 0.f, by = 0.f, bz = 0.f;
      for (int j = base + tid; j < end; j += kThreads) {
        const float x = p[3 * j], y = p[3 * j + 1], z = p[3 * j + 2];
        const unsigned k =
            min(mins[j], fps::distance_key(x, y, z, cx, cy, cz));
        mins[j] = k;
        // j ascends: '>' keeps the lowest index, the first j is always taken
        if (k > best || mine == fps::kNoIndex) {
          best = k;
          mine = j;
          bx = x;
          by = y;
          bz = z;
        }
      }
      idx = mine;
      fps::warp_argmax(best, idx);
      const int src = __ffs(__ballot_sync(fps::kFull, mine == idx)) - 1;
      wx = __shfl_sync(fps::kFull, bx, src);
      wy = __shfl_sync(fps::kFull, by, src);
      wz = __shfl_sync(fps::kFull, bz, src);
    }
    publish(ex, i, slot, lane, C, best, idx, wx, wy, wz);
    take_centre(ex, i, nslots, lane, idx, cx, cy, cz);
    if (writer) row.put(i, idx, lane);
  }
}

struct Plan {
  int cluster;  // blocks a cloud
  int points;   // points a thread in registers; 0: device memory
};

Plan plan_for(int N) {
  int C = 1;
  while (C < kMaxCluster &&
         static_cast<long long>(C) * kThreads * kTargetPoints < N)
    C *= 2;
  const long long per_block = (static_cast<long long>(N) + C - 1) / C;
  const int P = static_cast<int>((per_block + kThreads - 1) / kThreads);
  if (P > kMaxPoints) return {kMaxCluster, 0};
  return {C, P};
}

template <int P>
cudaError_t launch(const float* xyz, unsigned* scratch, int64_t* out, int B,
                   int N, int npoint, int C, cudaStream_t stream) {
  auto kernel = fps_grid_kernel<P>;
  const int slice = P > 0 ? kThreads * P : (N + C - 1) / C;
  const int smem = P > 0 ? kThreads * P * 16 : 0;
  cudaError_t e = cudaSuccess;
  // the opt-in is needed once static (the exchange) and dynamic shared
  // memory together pass 48 KB: at 24 points a thread
  if (smem + sizeof(Exchange) > 48 * 1024)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * C);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, xyz, scratch, out, N, npoint, slice);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <int P>
cudaError_t launch_points(int points, const float* xyz, unsigned* scratch,
                          int64_t* out, int B, int N, int npoint, int C,
                          cudaStream_t stream) {
  if constexpr (P > kMaxPoints) {
    return cudaErrorInvalidValue;
  } else {
    if (points == P)
      return launch<P>(xyz, scratch, out, B, N, npoint, C, stream);
    return launch_points<P + 1>(points, xyz, scratch, out, B, N, npoint, C,
                                stream);
  }
}

}  // namespace

// The largest N a cluster holds in registers; above it the launcher needs
// `scratch`.
extern "C" int uat_fps_grid_register_points() {
  return kMaxCluster * kThreads * kMaxPoints;
}

// The launch for a cloud of N points: blocks in its cluster, threads a
// block, points a thread in registers (0: the device-memory branch).
extern "C" int uat_fps_grid_plan(int N, int* cluster, int* threads,
                                 int* points) {
  if (N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Plan plan = plan_for(N);
  *cluster = plan.cluster;
  *threads = kThreads;
  *points = plan.points;
  return 0;
}

// xyz: (B, N, 3) float32 contiguous; out: (B, npoint) int64; scratch: a
// (B, N) 32-bit buffer, read only when N > uat_fps_grid_register_points()
// (may be null otherwise).  Returns cudaGetLastError() after the launch
// (0 on success).
extern "C" int uat_fps_grid(const float* xyz, void* scratch, int64_t* out,
                            int B, int N, int npoint, cudaStream_t stream) {
  if (B <= 0 || N <= 0 || npoint <= 0 || npoint > N)
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan plan = plan_for(N);
  if (plan.points == 0 && scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_points<0>(
      plan.points, xyz, static_cast<unsigned*>(scratch), out, B, N, npoint,
      plan.cluster, stream));
}
