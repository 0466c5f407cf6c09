// The arithmetic that the kNN kernels (knn.cu, knn_gather.cu) share, so
// that they cannot part in rounding, in tie-breaking or in selection.
//
// Distance: knn_pallas's expansion d = (|q|^2 + |x|^2) - 2 q.x in fp32,
//   every term with __fmul_rn/__fadd_rn/__fsub_rn in the plain PyTorch
//   version's order (ops/knn.py::sqdist), so no FMA contraction can change
//   a tie.
// Order: (distance, index) lexicographic; equal distances go to the lower
//   index, as the Pallas kernel's masked iota-min does.
// Keys: each distance maps to a uint32 in the same order (order_key), and
//   an entry packs (key, index) into one uint64 (entry), so one integer
//   compare orders entries as the contract does.
// Selection, in three steps that never run k dependent rounds:
//   1. search_kth finds the k-th smallest key bit by bit from the top,
//      one warp-wide count a bit (at most 32), or stops as soon as the
//      keys below its upper bound are few enough to list;
//   2. the keys below a bound are listed from per-lane bit masks (a lane's
//      place from a prefix sum of the lanes' counts, mask_below and
//      list_masked), and, where the k-th key is tied, the equal keys after
//      them in index order, lowest first (compact, by ballot prefix
//      counts);
//   3. a listed entry's place in the sorted result is its rank, a count
//      of the entries before it (merge_candidates; knn.cu counts directly),
//      so no sort network and no atomics decide an order: the result is
//      the same every launch.
#pragma once

#include <cuda_runtime.h>
#include <cstdint>

namespace knn_core {

constexpr unsigned kFull = 0xffffffffu;
// The key of a pad (a register past the cloud's end): above every real
// key, which is at most order_key(+inf) = 0xff800000.
constexpr unsigned kPadKey = 0xffffffffu;
// An empty slot of a list: after every real entry.
constexpr unsigned long long kEmpty = ~0ull;

// |p|^2 = (x*x + y*y) + z*z
__device__ __forceinline__ float norm2(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                   __fmul_rn(z, z));
}

// (q2 + x2) - 2 * ((qx*x + qy*y) + qz*z).  Never -0: q2 + x2 is a sum of
// squares, +0 at the least, and a - a is +0 under round-to-nearest.
__device__ __forceinline__ float sqdist(float qx, float qy, float qz,
                                        float q2, float x, float y, float z,
                                        float x2) {
  const float cross = __fadd_rn(__fadd_rn(__fmul_rn(qx, x), __fmul_rn(qy, y)),
                                __fmul_rn(qz, z));
  return __fsub_rn(__fadd_rn(q2, x2), __fmul_rn(2.f, cross));
}

// An fp32 distance as a uint32 in the same order: negatives (two
// near-coincident points can come out a hair below 0; a query's own point
// comes out +0 exactly, as cross = q2) have all bits flipped, the rest
// their sign bit.
__device__ __forceinline__ unsigned order_key(float d) {
  const unsigned b = __float_as_uint(d);
  return b ^ ((0u - (b >> 31)) | 0x80000000u);
}

// The key of the point p = (x, y, z, |x|^2) from query q = (qx, qy, qz,
// |q|^2).
__device__ __forceinline__ unsigned point_key(const float4& q,
                                              const float4& p) {
  return order_key(sqdist(q.x, q.y, q.z, q.w, p.x, p.y, p.z, p.w));
}

// (key, index) as one uint64: the key in the high word.
__device__ __forceinline__ unsigned long long entry(unsigned key, int idx) {
  return (static_cast<unsigned long long>(key) << 32) |
         static_cast<unsigned>(idx);
}

__device__ __forceinline__ unsigned entry_key(unsigned long long e) {
  return static_cast<unsigned>(e >> 32);
}

__device__ __forceinline__ int entry_index(unsigned long long e) {
  return static_cast<int>(static_cast<unsigned>(e));
}

// This lane's keys below `bound` as masks: bit t >> 2 of m[t & 3] for
// u[t] (four words, so that four chains of ORs run side by side).
// Returns their number.
template <int W>
__device__ __forceinline__ int mask_below(const unsigned (&u)[W],
                                          unsigned bound, unsigned (&m)[4]) {
  static_assert(W <= 128, "mask_below: at most 128 keys a lane");
  m[0] = m[1] = m[2] = m[3] = 0u;
#pragma unroll
  for (int t = 0; t < W; ++t) {
    if (u[t] < bound) m[t & 3] |= 1u << (t >> 2);
  }
  return __popc(m[0]) + __popc(m[1]) + __popc(m[2]) + __popc(m[3]);
}

template <int W>
__device__ __forceinline__ int count_below(const unsigned (&u)[W],
                                           unsigned bound) {
  unsigned m[4];
  return mask_below(u, bound, m);
}

// The k-th smallest key of a warp's keys u (W a lane, a tile's) and
// listed keys ck (KW a lane, the entries carried so far), pads excluded.
// On entry, the keys below `hi` number at least k, and `below` of them
// are u's.  Each bit from the top halves the range that holds the k-th
// key with one warp-wide count (u's in the low 16 bits, ck's in the high
// 16, one __reduce_add_sync); a bit whose half starts at or above hi is
// decided without one.  Returns false as soon as u's keys below hi number
// at most `cap` (hi and below updated: the k least entries all lie below
// hi, and those of u can be listed); else true after the last bit, with
// kth the k-th smallest key exactly (the k-th key is then tied with more
// keys of u than cap allows).  cap < 0 always runs to the last bit.
template <int W, int KW>
__device__ __forceinline__ bool search_kth(const unsigned (&u)[W],
                                           const unsigned (&ck)[KW], int k,
                                           int cap, unsigned& hi, int& below,
                                           unsigned& kth) {
  unsigned ans = 0;  // the keys below ans number fewer than k
#pragma unroll 1
  for (int bit = 31; bit >= 0; --bit) {
    const unsigned mid = ans | (1u << bit);
    if (mid >= hi) continue;  // at least k below mid: the bit is 0
    unsigned n = static_cast<unsigned>(count_below(u, mid)) +
                 (static_cast<unsigned>(count_below(ck, mid)) << 16);
    n = __reduce_add_sync(kFull, n);
    if (static_cast<int>((n & 0xffffu) + (n >> 16)) < k) {
      ans = mid;
    } else {
      hi = mid;
      below = static_cast<int>(n & 0xffffu);
      if (below <= cap) return false;
    }
  }
  kth = ans;
  return true;
}

// The warp's inclusive prefix sum of v over lanes.
__device__ __forceinline__ int warp_prefix_sum(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_up_sync(kFull, v, off);
    if (lane >= off) v += o;
  }
  return v;
}

// Appends the entries masked in m (mask_below's layout) to list[n, ...):
// each lane's after those of the lanes below it, in no particular order
// within a lane; key_at(t) recomputes register t's key (register t holds
// point j0 + 32 t).  Returns the new length.  The caller makes sure that
// they fit.
template <class KeyAt>
__device__ __forceinline__ int list_masked(const unsigned (&m)[4], int j0,
                                           KeyAt key_at,
                                           unsigned long long* list, int n) {
  const int count = __popc(m[0]) + __popc(m[1]) + __popc(m[2]) + __popc(m[3]);
  const int end = warp_prefix_sum(count);
  int pos = n + end - count;
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    unsigned bits = m[w];
    while (bits != 0u) {
      const int t = 4 * (__ffs(bits) - 1) + w;
      bits &= bits - 1u;
      list[pos++] = entry(key_at(t), j0 + 32 * t);
    }
  }
  return n + __shfl_sync(kFull, end, 31);
}

// Appends the entries of u whose key equals `key` to list[n, limit), in
// index order: register t, then lane (point j0 + 32 t of a lane whose
// first point is j0).  Positions come from ballot prefix counts; entries
// past `limit` are dropped.  Returns the new length.
template <int W>
__device__ __forceinline__ int compact_equal(const unsigned (&u)[W], int j0,
                                             unsigned key,
                                             unsigned long long* list, int n,
                                             int limit) {
  const unsigned lower = (1u << (threadIdx.x & 31)) - 1u;
#pragma unroll
  for (int t = 0; t < W; ++t) {
    const bool take = u[t] == key;
    const unsigned m = __ballot_sync(kFull, take);
    if (m == 0u) continue;
    const int pos = n + __popc(m & lower);
    if (take && pos < limit) list[pos] = entry(u[t], j0 + 32 * t);
    n += __popc(m);
  }
  return n < limit ? n : limit;
}

// Entries of the sorted list[0, L) below e, L a power of 2: log2(L) + 1
// steps without a branch, so that several searches run side by side.
template <int L>
__device__ __forceinline__ int count_sorted(const unsigned long long* list,
                                            unsigned long long e) {
  int pos = 0;
#pragma unroll
  for (int step = L / 2; step > 0; step >>= 1) {
    if (list[pos + step - 1] < e) pos += step;
  }
  return pos + (list[pos] < e ? 1 : 0);
}

// The k least of the sorted list[0, k) and the candidates cand[0, m)
// (distinct real entries, none listed, m <= 32 CPL), sorted back into
// list[0, k).  list holds 32 KPL slots, those from k on empty (kEmpty).
// A candidate's place is the listed entries below it (a binary search,
// counted into hist[0, k]) plus the candidates below it; a listed
// entry's, its position plus the candidates whose binary search ended at
// or before it (a prefix sum of hist).  Empty slots go last.  hist holds
// at least k + 1 ints.  Called by the whole warp.
template <int KPL, int CPL>
__device__ __forceinline__ void merge_candidates(unsigned long long* list,
                                                 int k,
                                                 const unsigned long long* cand,
                                                 int m, int* hist) {
  const int lane = threadIdx.x & 31;
  for (int i = lane; i <= k; i += 32) hist[i] = 0;
  __syncwarp();
  unsigned long long c[CPL];
  int rc[CPL];
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    const int p = lane + 32 * i;
    c[i] = kEmpty;
    rc[i] = k;
    if (p < m) {
      c[i] = cand[p];
      rc[i] = count_sorted<32 * KPL>(list, c[i]);
      atomicAdd(&hist[rc[i]], 1);  // a count: the order of the adds is moot
    }
  }
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    if (32 * i >= m) break;  // the same for every lane
#pragma unroll 4
    for (int q = 0; q < m; ++q) rc[i] += cand[q] < c[i];
  }
  __syncwarp();  // hist is complete
  unsigned long long a[KPL];
  int ra[KPL];
  int before = 0;  // candidates counted at positions of earlier rows
#pragma unroll
  for (int i = 0; i < KPL; ++i) {
    const int r = lane + 32 * i;
    const int upto = warp_prefix_sum(r < k ? hist[r] : 0);
    a[i] = r < k ? list[r] : kEmpty;
    ra[i] = r + before + upto;
    before += __shfl_sync(kFull, upto, 31);
  }
  __syncwarp();  // every lane has read list
#pragma unroll
  for (int i = 0; i < KPL; ++i) {
    if (lane + 32 * i < k && ra[i] < k) list[ra[i]] = a[i];
  }
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    if (lane + 32 * i < m && rc[i] < k) list[rc[i]] = c[i];
  }
  __syncwarp();
}

}  // namespace knn_core
