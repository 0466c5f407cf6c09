// The backward of the fp32 EVA attention side's attention step and of its
// per-head q/k LayerNorm, for Hopper (sm_90a): given the forward's q^, k^
// (after the LayerNorm), v and the step's output O, and dO, the gradient
// of the loss by the raw q and k (before the LayerNorm), by v, and by the
// LayerNorms' gamma and beta.
//
// Replaces no TPU kernel: the JAX package trains with its Pallas flags
// off (cli/pretrain.py builds Uni3D with use_pallas_* False) and XLA
// differentiates the attention.  On the card the forward is the fp32
// entry of eva_attn_block.cu, which autograd cannot see through, so its
// backward is written here.  The out projection's and the q/k/v
// projections' products around it are large plain GEMMs (cuBLAS, as the
// JAX package leaves them to XLA); this file is what lies between them.
//
// The arithmetic (s = q^.k^T per head, unscaled, as the forward keeps it):
//   m = max_j s, l = sum_j exp((s - m) * scale), P = exp((s - m) * scale) / l,
//   Delta = rowsum(dO o O),
//   dV = P^T.dO, dS = P o (dO.V^T - Delta), dq^ = scale dS.k^, dk^ = scale dS^T.q^;
//   then per (row, head) the LayerNorm's backward over its 64 values:
//   x^ = (x - mu) * (1 / sqrt(var + eps)), dx^ = dy * gamma,
//   dx = rstd (dx^ - mean(dx^) - x^ mean(dx^ x^)), dgamma += dy x^, dbeta += dy,
//   from the raw x (x^ is recomputed, never recovered as (y - beta) / gamma).
//
// Four kernels, one after the other on the caller's stream, no atomics, so
// every sum runs in the same order on every run (a resumed training run
// can equal an uninterrupted one):
//   (1) eva_bwd_dq_kernel, a block per (64 queries, batch, head): the
//       row statistics m, l and Delta in a first pass over the key tiles
//       (online max and sum), stored for (2), then dq^ in a second pass;
//   (2) eva_bwd_dkdv_kernel, a block per (64 keys, batch, head): dk^ and
//       dv over the query tiles, P recomputed from (1)'s statistics;
//   (3) eva_bwd_ln_kernel: a warp per (row, q or k, head), the LayerNorm's
//       backward written over dq^ and dk^ in place, and per-block partial
//       sums of dgamma and dbeta;
//   (4) eva_bwd_ln_sum_kernel: the partial sums added in block order.
//
// What bounds it on the H100: operations.  At Uni3D-L's (B, N, D, H) =
//   (2, 513, 1024, 16), the step's backward is five N x N x 64 products a
//   head (s, dO.V^T, dV, dq^, dk^), 5 * 2 * B*H*N^2*64 = 5.4 GFLOP, 80 us
//   at 67 TFLOP/s fp32, against ~42 MB read and written (13 us at 3.35
//   TB/s); with s recomputed twice more and dO.V^T once, the kernels do
//   eight such products.  This first version is
//   plain FFMA: 4 x 4 outputs a thread from shared memory rows padded to
//   65 floats (column reads by 16 threads hit 16 banks), so its shared
//   memory reads, two a product's four FMAs, bound it well below the FFMA
//   peak.  Split TF32 or wgmma, and sharing the recomputed scores between
//   (1) and (2), are later work.
#include <atomic>
#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kHd = 64;          // head dim
constexpr int kT = 64;           // queries or keys a tile
constexpr int kLd = kT + 1;      // shared-memory row stride, in floats
constexpr int kTile = kT * kLd;  // floats of one tile in shared memory
constexpr int kThreads = 256;    // 16 x 16 threads, 4 x 4 outputs each
constexpr int kLnWarps = 8;      // warps a block of eva_bwd_ln_kernel
constexpr int kLnMaxBlocks = 1024;
constexpr int kDqSmem = 5 * kTile * 4;
constexpr int kDkdvSmem = (6 * kTile + 3 * kT) * 4;

struct BwdArgs {
  const float* qkv;   // (B*N, 3D): q^ | k^ | v, head h at columns 64h
  const float* o;     // (B*N, D): the forward step's output
  const float* dout;  // (B*N, D): dO
  float* dqkv;        // (B*N, 3D): dq^ | dk^ | dv
  float* stats;       // (B*H, N, 3): m, l, Delta
  int N, D, H;
  float scale;
};

// Raise kernel's dynamic shared-memory limit to `bytes`, once per device.
template <typename Kernel>
cudaError_t raise_smem_once(Kernel kernel, int bytes,
                            std::atomic<uint64_t>& raised) {
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  const uint64_t bit = uint64_t{1} << (device & 63);
  if (raised.load(std::memory_order_acquire) & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes);
  if (e == cudaSuccess) raised.fetch_or(bit, std::memory_order_release);
  return e;
}

// Rows [0, 64) x columns [0, 64) of a row-major matrix with row stride ld
// (floats) into a shared tile of row stride kLd; rows at or past
// rows_left are zeros.
__device__ __forceinline__ void load_tile(float* s, const float* g, int ld,
                                          int rows_left) {
  for (int i = threadIdx.x; i < kT * (kHd / 4); i += kThreads) {
    const int r = i / (kHd / 4), c = 4 * (i % (kHd / 4));
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows_left)
      v = *reinterpret_cast<const float4*>(g + static_cast<size_t>(r) * ld + c);
    float* d = s + r * kLd + c;
    d[0] = v.x;
    d[1] = v.y;
    d[2] = v.z;
    d[3] = v.w;
  }
}

// Sum and max over the 16 lanes of a half-warp (the threads of one ty).
__device__ __forceinline__ float sum16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float max16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float sum32(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// s[i][j] = sum_d a[ty + 16i][d] * b[tx + 16j][d] over the head's 64 dims.
__device__ __forceinline__ void tile_dot(float (&s)[4][4], const float* a,
                                         const float* b, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < kHd; ++d) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[(ty + 16 * i) * kLd + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b[(tx + 16 * j) * kLd + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
  }
}

// acc[i][j] += sum_r a[ty + 16i][r] * b[r][tx + 16j] over the tile's 64 rows.
__device__ __forceinline__ void tile_acc(float (&acc)[4][4], const float* a,
                                         const float* b, int ty, int tx) {
#pragma unroll 4
  for (int r = 0; r < kT; ++r) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[(ty + 16 * i) * kLd + r];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b[r * kLd + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// (1) Row statistics and dq^ for 64 queries of one (batch, head).
__global__ void __launch_bounds__(kThreads) eva_bwd_dq_kernel(BwdArgs a) {
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sDO = sQ + kTile;
  float* sK = sDO + kTile;
  float* sV = sK + kTile;
  float* sDS = sV + kTile;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int q0 = blockIdx.x * kT;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int ld3 = 3 * a.D;
  const float* qkv = a.qkv + static_cast<size_t>(b) * a.N * ld3 + h * kHd;
  const size_t row_o = (static_cast<size_t>(b) * a.N + q0) * a.D + h * kHd;
  const int n_kt = (a.N + kT - 1) / kT;

  load_tile(sQ, qkv + static_cast<size_t>(q0) * ld3, ld3, a.N - q0);
  load_tile(sDO, a.dout + row_o, a.D, a.N - q0);
  load_tile(sDS, a.o + row_o, a.D, a.N - q0);  // O, for Delta only
  __syncthreads();
  float delta[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float t = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int at = (ty + 16 * i) * kLd + tx + 16 * j;
      t = fmaf(sDO[at], sDS[at], t);
    }
    delta[i] = sum16(t);
  }

  // pass 1: m and l, online over the key tiles
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
  float s[4][4], dp[4][4];
  for (int kt = 0; kt < n_kt; ++kt) {
    __syncthreads();
    load_tile(sK, qkv + static_cast<size_t>(kt * kT) * ld3 + a.D, ld3,
              a.N - kt * kT);
    __syncthreads();
    tile_dot(s, sQ, sK, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (kt * kT + tx + 16 * j >= a.N) s[i][j] = -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float mn = fmaxf(m[i], max16(mx));
      float t = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) t += expf((s[i][j] - mn) * a.scale);
      l[i] = l[i] * expf((m[i] - mn) * a.scale) + sum16(t);
      m[i] = mn;
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      if (row < a.N) {
        float* st = a.stats + (static_cast<size_t>(bh) * a.N + row) * 3;
        st[0] = m[i];
        st[1] = l[i];
        st[2] = delta[i];
      }
    }
  }

  // pass 2: dq^ = scale * dS . k^
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int kt = 0; kt < n_kt; ++kt) {
    __syncthreads();
    const float* k_rows = qkv + static_cast<size_t>(kt * kT) * ld3;
    load_tile(sK, k_rows + a.D, ld3, a.N - kt * kT);
    load_tile(sV, k_rows + 2 * a.D, ld3, a.N - kt * kT);
    __syncthreads();
    tile_dot(s, sQ, sK, ty, tx);
    tile_dot(dp, sDO, sV, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = kt * kT + tx + 16 * j < a.N
                            ? expf((s[i][j] - m[i]) * a.scale) / l[i]
                            : 0.f;
        sDS[(ty + 16 * i) * kLd + tx + 16 * j] = p * (dp[i][j] - delta[i]);
      }
    __syncthreads();
    tile_acc(acc, sDS, sK, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= a.N) continue;
    float* dq = a.dqkv + (static_cast<size_t>(b) * a.N + row) * ld3 + h * kHd;
#pragma unroll
    for (int j = 0; j < 4; ++j) dq[tx + 16 * j] = acc[i][j] * a.scale;
  }
}

// (2) dk^ and dv for 64 keys of one (batch, head).
__global__ void __launch_bounds__(kThreads) eva_bwd_dkdv_kernel(BwdArgs a) {
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + kTile;
  float* sQ = sV + kTile;
  float* sDO = sQ + kTile;
  float* sP = sDO + kTile;    // P^T: [key][query]
  float* sDS = sP + kTile;    // dS^T
  float* sM = sDS + kTile;
  float* sL = sM + kT;
  float* sDelta = sL + kT;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int k0 = blockIdx.x * kT;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int ld3 = 3 * a.D;
  const float* qkv = a.qkv + static_cast<size_t>(b) * a.N * ld3 + h * kHd;
  const float* dout = a.dout + static_cast<size_t>(b) * a.N * a.D + h * kHd;
  const float* stats = a.stats + static_cast<size_t>(bh) * a.N * 3;
  const int n_qt = (a.N + kT - 1) / kT;

  load_tile(sK, qkv + static_cast<size_t>(k0) * ld3 + a.D, ld3, a.N - k0);
  load_tile(sV, qkv + static_cast<size_t>(k0) * ld3 + 2 * a.D, ld3, a.N - k0);
  float dk[4][4], dv[4][4], s[4][4], dp[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) dk[i][j] = dv[i][j] = 0.f;
  for (int qt = 0; qt < n_qt; ++qt) {
    const int q0 = qt * kT;
    __syncthreads();
    load_tile(sQ, qkv + static_cast<size_t>(q0) * ld3, ld3, a.N - q0);
    load_tile(sDO, dout + static_cast<size_t>(q0) * a.D, a.D, a.N - q0);
    for (int r = threadIdx.x; r < kT; r += kThreads) {
      const bool ok = q0 + r < a.N;
      const float* st = stats + static_cast<size_t>(q0 + r) * 3;
      sM[r] = ok ? st[0] : 0.f;
      sL[r] = ok ? st[1] : 1.f;
      sDelta[r] = ok ? st[2] : 0.f;
    }
    __syncthreads();
    tile_dot(s, sK, sQ, ty, tx);    // s[i][j]: key ty + 16i, query tx + 16j
    tile_dot(dp, sV, sDO, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = tx + 16 * j;
        const bool ok = k0 + ty + 16 * i < a.N && q0 + r < a.N;
        const float p = ok ? expf((s[i][j] - sM[r]) * a.scale) / sL[r] : 0.f;
        sP[(ty + 16 * i) * kLd + r] = p;
        sDS[(ty + 16 * i) * kLd + r] = p * (dp[i][j] - sDelta[r]);
      }
    __syncthreads();
    tile_acc(dv, sP, sDO, ty, tx);
    tile_acc(dk, sDS, sQ, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= a.N) continue;
    float* row = a.dqkv + (static_cast<size_t>(b) * a.N + key) * ld3 + h * kHd;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      row[a.D + tx + 16 * j] = dk[i][j] * a.scale;
      row[2 * a.D + tx + 16 * j] = dv[i][j];
    }
  }
}

struct LnArgs {
  const float* raw;   // (M, 2D): q | k before the LayerNorm
  float* dqkv;        // (M, 3D): dq^ | dk^ in, dq | dk out
  const float* gq;    // (64,)
  const float* gk;
  float* partials;    // (gridDim.x, 4, 64): dgamma_q, dbeta_q, dgamma_k, dbeta_k
  int M, D, H;
  float eps;
};

// (3) The per-head LayerNorm's backward, a warp per (row, q or k, head);
// each lane holds elements lane and lane + 32 of the head.
__global__ void __launch_bounds__(kLnWarps * 32) eva_bwd_ln_kernel(LnArgs a) {
  __shared__ float red[kLnWarps][4][kHd];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t items = static_cast<int64_t>(a.M) * 2 * a.H;
  const float gq0 = a.gq[lane], gq1 = a.gq[lane + 32];
  const float gk0 = a.gk[lane], gk1 = a.gk[lane + 32];
  float acc[4][2] = {};
  for (int64_t it = static_cast<int64_t>(blockIdx.x) * kLnWarps + warp;
       it < items; it += static_cast<int64_t>(gridDim.x) * kLnWarps) {
    const int m = static_cast<int>(it / (2 * a.H));
    const int rem = static_cast<int>(it % (2 * a.H));
    const int seg = rem / a.H, h = rem % a.H;
    const float* x = a.raw + static_cast<size_t>(m) * 2 * a.D + seg * a.D +
                     h * kHd;
    float* dy = a.dqkv + static_cast<size_t>(m) * 3 * a.D + seg * a.D +
                h * kHd;
    const float x0 = x[lane], x1 = x[lane + 32];
    const float mu = sum32(x0 + x1) * (1.f / kHd);
    const float d0 = x0 - mu, d1 = x1 - mu;
    const float var = sum32(d0 * d0 + d1 * d1) * (1.f / kHd);
    const float rstd = 1.f / sqrtf(var + a.eps);
    const float xh0 = d0 * rstd, xh1 = d1 * rstd;
    const float dy0 = dy[lane], dy1 = dy[lane + 32];
    const float dxh0 = dy0 * (seg ? gk0 : gq0);
    const float dxh1 = dy1 * (seg ? gk1 : gq1);
    const float mdx = sum32(dxh0 + dxh1) * (1.f / kHd);
    const float mdxx = sum32(dxh0 * xh0 + dxh1 * xh1) * (1.f / kHd);
    dy[lane] = rstd * (dxh0 - mdx - xh0 * mdxx);
    dy[lane + 32] = rstd * (dxh1 - mdx - xh1 * mdxx);
    if (seg) {
      acc[2][0] += dy0 * xh0;
      acc[2][1] += dy1 * xh1;
      acc[3][0] += dy0;
      acc[3][1] += dy1;
    } else {
      acc[0][0] += dy0 * xh0;
      acc[0][1] += dy1 * xh1;
      acc[1][0] += dy0;
      acc[1][1] += dy1;
    }
  }
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    red[warp][t][lane] = acc[t][0];
    red[warp][t][lane + 32] = acc[t][1];
  }
  __syncthreads();
  for (int t = threadIdx.x; t < 4 * kHd; t += blockDim.x) {
    float v = 0.f;
    for (int w = 0; w < kLnWarps; ++w) v += red[w][t / kHd][t % kHd];
    a.partials[static_cast<size_t>(blockIdx.x) * 4 * kHd + t] = v;
  }
}

// (4) dgamma and dbeta: eva_bwd_ln_kernel's partial sums added in block order.
__global__ void __launch_bounds__(4 * kHd)
    eva_bwd_ln_sum_kernel(const float* partials, int blocks, float* out) {
  float v = 0.f;
  for (int b = 0; b < blocks; ++b)
    v += partials[static_cast<size_t>(b) * 4 * kHd + threadIdx.x];
  out[threadIdx.x] = v;
}

int ln_blocks(int M, int H) {
  const int64_t items = static_cast<int64_t>(M) * 2 * H;
  const int64_t blocks = (items + kLnWarps - 1) / kLnWarps;
  return static_cast<int>(blocks < kLnMaxBlocks ? blocks : kLnMaxBlocks);
}

std::atomic<uint64_t> dq_smem_raised{0}, dkdv_smem_raised{0};

}  // namespace

// The blocks of eva_bwd_ln_kernel for M rows and H heads: the rows of the
// partial-sum workspace that uat_eva_attn_block_bwd takes.
extern "C" int uat_eva_attn_block_bwd_ln_blocks(int M, int H) {
  return ln_blocks(M, H);
}

// qkv: (B*N, 3D) q^ | k^ | v and o: (B*N, D), the fp32 block's workspaces
// after its forward; dout: (B*N, D) dO; raw: (B*N, 2D) q (with its bias)
// | k before the LayerNorm; gq, gk: (64,) the LayerNorms' gammas; dqkv:
// (B*N, 3D) out, dq | dk | dv by the raw q, k and by v; stats: (B*H*N*3)
// and partials: (ln_blocks(B*N, H) * 256) workspaces; dln: (4, 64) out,
// dgamma_q, dbeta_q, dgamma_k, dbeta_k.  All fp32, contiguous, 16-byte
// aligned.  Needs D == 64*H and B*H <= 65535.  Returns cudaGetLastError()
// after the last launch (0 on success).
extern "C" int uat_eva_attn_block_bwd(
    const float* qkv, const float* o, const float* dout, const float* raw,
    const float* gq, const float* gk, float* dqkv, float* stats,
    float* partials, float* dln, int B, int N, int D, int H, float scale,
    float eps, cudaStream_t stream) {
  if (D != H * kHd || B <= 0 || N <= 0 || B * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = raise_smem_once(eva_bwd_dq_kernel, kDqSmem,
                                  dq_smem_raised);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = raise_smem_once(eva_bwd_dkdv_kernel, kDkdvSmem, dkdv_smem_raised);
  if (e != cudaSuccess) return static_cast<int>(e);
  const BwdArgs args{qkv, o, dout, dqkv, stats, N, D, H, scale};
  const dim3 grid((N + kT - 1) / kT, B * H);
  eva_bwd_dq_kernel<<<grid, kThreads, kDqSmem, stream>>>(args);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  eva_bwd_dkdv_kernel<<<grid, kThreads, kDkdvSmem, stream>>>(args);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int M = B * N, blocks = ln_blocks(M, H);
  eva_bwd_ln_kernel<<<blocks, kLnWarps * 32, 0, stream>>>(
      LnArgs{raw, dqkv, gq, gk, partials, M, D, H, eps});
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  eva_bwd_ln_sum_kernel<<<1, 4 * kHd, 0, stream>>>(partials, blocks, dln);
  return static_cast<int>(cudaGetLastError());
}
