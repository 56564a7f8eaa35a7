// Cross-attention block against constant keys and values, for Hopper:
// q = x Wq -> per head softmax(q k^T * scale) v -> att Wp + bp.
//
// Replaces the Pallas kernel smelter_tpu/kernels/vit_block.py::
// cross_attn_block (body _xattn_kernel), which runs one program per image
// with the image's (N, D) rows, both (D, D) weights and the image's k/v in
// VMEM. The roundings are the Pallas kernel's: q rounded to x's type;
// scores as f32 sums times scale; the softmax in f32 as exp(s - max) / sum;
// p rounded; p v as f32 sums; the heads' outputs side by side, rounded; att
// Wp as f32 sums plus bp in f32, one rounding.
//
// What bounds it on an H100: at SD-UNet's (B 8, N 1024, D 128, 8 heads of
// 16, S 16) a call does B (4 N D^2 + 4 N S D) = 0.60 GFLOP (0.6 us at 989
// TFLOP/s dense bf16) against 4.3 MB of x, weights, k, v and output (1.3
// us at 3.35 TB/s); at (B 8, N 256, D 256, 8 heads of 32) 0.57 GFLOP and
// 2.5 MB (0.74 us). Neither is reached: a call is latency, the launch and a
// chain of dependent load -> product -> softmax -> product steps, so the
// design's aim is to run that chain on the whole card, with its loads
// issued at once.
//
// The wgmma form (xattn_wgmma; 16-bit x at D % 64 == 0, where
// kernels/attention_plan.py::cross_plan says "wgmma") takes one warpgroup
// tile of 64 query rows of one image x one group of 64 / hd heads a CTA, so
// a row tile is D / 64 CTAs: 128 CTAs at (N 256, D 256) where one CTA a row
// tile gave 32, 256 at (N 1024, D 128). A group needs only Wq's 64
// columns of its heads and its own k and v; for the output projection the
// groups of a row tile share their attention outputs, and each takes the
// output columns of its group, att Wp[:, group] (Wp's 64 columns).
//   1. One thread issues every TMA load up front, on three mbarriers: the x
//      tile (D / 64 boxes of 64 rows x 64 columns) with Wq's group columns
//      (one box of D rows x 64), then the group's k and v (a box of S
//      rounded up to SP rows x hd x its heads; rows past S and x's rows past
//      N read as zeros), then Wp's group columns (one box of D rows x 64),
//      all with the swizzle of their row width, so the weights' round trip
//      overlaps x's and the first products.
//   2. q = x Wq[:, group] on wgmma m64n64k16 (both operands from shared
//      memory), rounded to T in registers: the scores' A fragments.
//   3. Per head: the scores on wgmma m64nSPk16 (q from registers, k K-major;
//      keys padded to SP score -inf), times scale; the softmax in f32 in
//      registers (a row's max and sum over its thread quad); p rounded to
//      T; p v on wgmma m64n(hd)k16 (p from registers, v MN-major); the
//      head's output rounded to T: att Wp's A fragments. (Issuing up to 4
//      heads' scores, then their p v, as one wgmma group each changed
//      nothing on the card: these round trips are not what a call waits
//      for.)
//   4. The row tile's CTAs are one thread-block cluster (C = D / 64 CTAs,
//      at most 4). Each writes its group's attention output (64 x 64, T)
//      into its own shared memory, K-major with the 128-byte swizzle, as
//      part g of the row tile's att (64 x D, over x, which a cluster
//      barrier, arrived at once q is made, shows free everywhere), and in
//      16-byte stores into the same part of every other rank's copy
//      through distributed shared memory: 8 KB a rank, bf16.
//   5. After a second cluster barrier each CTA computes its group's 64
//      output columns over the whole of D: att (64 x D) Wp[:, group] on
//      wgmma m64n64k16, both operands from shared memory (Wp's columns
//      came by TMA in step 1), plus bp in f32, one rounding. No K split and
//      no atomics: a row's sums are the same in any batch and at any
//      position. (A K split of att Wp over the groups, the groups' f32
//      partials summed in rank order through distributed shared memory,
//      moved 64 KB a CTA at D 256 and spent 6.5 of a 13 us call pushing
//      them; its sum pulled from the other ranks, 3-7 us.)
// A 16-bit shape the plan declines (D not a multiple of 64) keeps the
// mma.sync form (xattn_mma): one block of 4 warps a 64-row tile of one
// image, the weights streamed through shared memory 64 columns at a time,
// the same four steps on mma.sync m16n8k16. f32 activations take a
// CUDA-core kernel in full f32 (no TF32) with the same four steps, one
// block for 16 query rows.
#include "gemm.cuh"
#include "wgmma_attention.cuh"

namespace {

using namespace smelter;

constexpr int XQ_ROWS = 64;      // query rows a block: 4 warps of 16
constexpr int XQ_THREADS = 128;
constexpr int XW_COLS = 64;      // weight columns a pass through shared memory
constexpr int XMAX_D = 256;
constexpr int XMAX_S = 64;

// Shared memory of the 16-bit kernel, in 16-bit elements.
inline size_t xattn_smem_bytes(int D, int heads, int HD, int SP) {
  const size_t tile = static_cast<size_t>(XQ_ROWS) * (D + 8);
  const size_t w = static_cast<size_t>(D) * (XW_COLS + 8);
  const size_t kv = 2 * static_cast<size_t>(heads) * SP * (HD + 8);
  return (2 * tile + w + kv) * 2;
}

// out tile (64, D) = A tile (64, D, shared) @ W (D, D, device memory), the
// warp's 16 rows; `epi(acc, n0)` takes each 64-column pass's f32 sums.
template <typename T, typename Epi>
__device__ __forceinline__ void tile_gemm(const uint16_t* As, uint16_t* Ws,
                                          const uint16_t* __restrict__ W, int D, Epi epi) {
  const int tid = threadIdx.x, lane = tid & 31, wq = (tid >> 5) * 16;
  const int SA = D + 8, SW = XW_COLS + 8;
  for (int n0 = 0; n0 < D; n0 += XW_COLS) {
    __syncthreads();  // the previous pass is done with Ws
    for (int c = tid; c < D * (XW_COLS / 8); c += XQ_THREADS) {
      const int k = c / (XW_COLS / 8), col = (c % (XW_COLS / 8)) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (n0 + col < D)
        v = *reinterpret_cast<const uint4*>(W + static_cast<size_t>(k) * D + n0 + col);
      *reinterpret_cast<uint4*>(&Ws[k * SW + col]) = v;
    }
    __syncthreads();
    float acc[XW_COLS / 8][4];
#pragma unroll
    for (int n = 0; n < XW_COLS / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
    for (int kk = 0; kk < D; kk += 16) {
      uint32_t a[4];
      ldmatrix_x4(a, &As[(wq + (lane & 15)) * SA + kk + (lane >> 4) * 8]);
#pragma unroll
      for (int nj = 0; nj < XW_COLS / 16; ++nj) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, &Ws[(kk + (lane & 15)) * SW + nj * 16 + (lane >> 4) * 8]);
        const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
        mma_16816<T>(acc[2 * nj], a, b0);
        mma_16816<T>(acc[2 * nj + 1], a, b1);
      }
    }
    epi(acc, n0);
  }
}

// x, out (B, N, D); wq, wp (D, D); k, v (Bk, heads, S, HD); bp (D,) in
// p_code. SP: S rounded up to 16, 32 or 64.
template <typename T, int HD, int SP>
__global__ void __launch_bounds__(XQ_THREADS)
xattn_mma(const uint16_t* __restrict__ x, const uint16_t* __restrict__ wq,
          const uint16_t* __restrict__ k, const uint16_t* __restrict__ v,
          const uint16_t* __restrict__ wp, const void* __restrict__ bp, int p_code,
          uint16_t* __restrict__ out, int N, int D, int heads, int S, int bk, float scale) {
  extern __shared__ __align__(16) uint16_t smem[];
  const int SA = D + 8, SK = HD + 8;
  uint16_t* Xs = smem;                   // [64][SA]: x, then the attention output
  uint16_t* Qs = Xs + XQ_ROWS * SA;      // [64][SA]: q
  uint16_t* Ws = Qs + XQ_ROWS * SA;      // [D][72]: a weight pass
  uint16_t* Ks = Ws + D * (XW_COLS + 8); // [heads][SP][SK]
  uint16_t* Vs = Ks + heads * SP * SK;   // [heads][SP][SK]

  const int tid = threadIdx.x, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int wq0 = (tid >> 5) * 16;
  const int b = blockIdx.y, q0 = blockIdx.x * XQ_ROWS;
  const size_t xb = static_cast<size_t>(b) * N * D;

  for (int c = tid; c < XQ_ROWS * (D / 8); c += XQ_THREADS) {
    const int r = c / (D / 8), col = (c % (D / 8)) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < N)
      val = *reinterpret_cast<const uint4*>(x + xb + static_cast<size_t>(q0 + r) * D + col);
    *reinterpret_cast<uint4*>(&Xs[r * SA + col]) = val;
  }
  const size_t kvb = static_cast<size_t>(bk > 1 ? b : 0) * heads * S * HD;
  for (int c = tid; c < heads * SP * (HD / 8); c += XQ_THREADS) {
    const int row = c / (HD / 8), d = (c % (HD / 8)) * 8;  // row = h SP + s
    const int h = row / SP, s = row % SP;
    uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
    if (s < S) {
      const size_t o = kvb + (static_cast<size_t>(h) * S + s) * HD + d;
      kv = *reinterpret_cast<const uint4*>(k + o);
      vv = *reinterpret_cast<const uint4*>(v + o);
    }
    *reinterpret_cast<uint4*>(&Ks[row * SK + d]) = kv;
    *reinterpret_cast<uint4*>(&Vs[row * SK + d]) = vv;
  }
  // (tile_gemm's first __syncthreads publishes these loads)

  // 2. q = x Wq, rounded to T
  tile_gemm<T>(Xs, Ws, wq, D, [&](float (&acc)[XW_COLS / 8][4], int n0) {
#pragma unroll
    for (int n = 0; n < XW_COLS / 8; ++n) {
      const int col = n0 + n * 8 + t * 2;
      if (col >= D) continue;
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<uint32_t*>(&Qs[(wq0 + g + 8 * r) * SA + col]) =
            pack2<T>(acc[n][2 * r], acc[n][2 * r + 1]);
    }
  });
  __syncwarp();

  // 3. per head: the warp's 16 rows against the S keys
  constexpr int NT = SP / 8, KS = HD / 16;
  for (int h = 0; h < heads; ++h) {
    uint32_t qa[KS][4];
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      ldmatrix_x4(qa[kk], &Qs[(wq0 + (lane & 15)) * SA + h * HD + kk * 16 + (lane >> 4) * 8]);
    const uint16_t* kh = Ks + h * SP * SK;
    const uint16_t* vh = Vs + h * SP * SK;
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int j = 0; j < NT; j += 2)
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        // key rows are the B operand's columns: tiles j and j + 1, both k halves
        uint32_t r[4];
        ldmatrix_x4(r, &kh[((j + (lane >> 4)) * 8 + (lane & 7)) * SK + kk * 16 +
                           ((lane >> 3) & 1) * 8]);
        const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
        mma_16816<T>(s[j], qa[kk], b0);
        mma_16816<T>(s[j + 1], qa[kk], b1);
      }
    // s[j][e]: row g + 8 (e >> 1), key 8 j + 2 t + (e & 1)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = j * 8 + t * 2 + (e & 1);
        s[j][e] = key < S ? s[j][e] * scale : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = expf(s[j][e] - mx[e >> 1]);
        sum[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
    }
    float o[HD / 8][4];
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
#pragma unroll
    for (int k2 = 0; k2 < SP / 16; ++k2) {
      const float* s0 = s[2 * k2];
      const float* s1 = s[2 * k2 + 1];
      uint32_t a[4];
      a[0] = pack2<T>(s0[0] / sum[0], s0[1] / sum[0]);
      a[1] = pack2<T>(s0[2] / sum[1], s0[3] / sum[1]);
      a[2] = pack2<T>(s1[0] / sum[0], s1[1] / sum[0]);
      a[3] = pack2<T>(s1[2] / sum[1], s1[3] / sum[1]);
#pragma unroll
      for (int nj = 0; nj < HD / 16; ++nj) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, &vh[(k2 * 16 + (lane & 15)) * SK + nj * 16 + (lane >> 4) * 8]);
        const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
        mma_16816<T>(o[2 * nj], a, b0);
        mma_16816<T>(o[2 * nj + 1], a, b1);
      }
    }
    // the head's output over the warp's own rows of Xs (x is no longer read)
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<uint32_t*>(&Xs[(wq0 + g + 8 * r) * SA + h * HD + n * 8 + t * 2]) =
            pack2<T>(o[n][2 * r], o[n][2 * r + 1]);
  }
  __syncwarp();

  // 4. att Wp + bp, one rounding
  tile_gemm<T>(Xs, Ws, wp, D, [&](float (&acc)[XW_COLS / 8][4], int n0) {
#pragma unroll
    for (int n = 0; n < XW_COLS / 8; ++n) {
      const int col = n0 + n * 8 + t * 2;
      if (col >= D) continue;
      const float b0 = param_at(bp, p_code, col), b1 = param_at(bp, p_code, col + 1);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = q0 + wq0 + g + 8 * r;
        if (row >= N) continue;
        *reinterpret_cast<uint32_t*>(out + xb + static_cast<size_t>(row) * D + col) =
            pack2<T>(acc[n][2 * r] + b0, acc[n][2 * r + 1] + b1);
      }
    }
  });
}

// f32: one block of 256 threads for 16 query rows, CUDA cores in full f32.
constexpr int XF_ROWS = 16;
constexpr int XF_THREADS = 256;

__global__ void __launch_bounds__(XF_THREADS)
xattn_f32(const float* __restrict__ x, const float* __restrict__ wq, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ wp, const void* __restrict__ bp,
          int p_code, float* __restrict__ out, int N, int D, int heads, int S, int bk,
          float scale) {
  __shared__ float Xs[XF_ROWS][XMAX_D];  // x, then the attention output
  __shared__ float Qs[XF_ROWS][XMAX_D];
  __shared__ float Ps[XF_ROWS][XMAX_S];
  const int tid = threadIdx.x, b = blockIdx.y, q0 = blockIdx.x * XF_ROWS;
  const int HD = D / heads;
  const int rows = min(XF_ROWS, N - q0);
  const size_t xb = static_cast<size_t>(b) * N * D;
  const size_t kvb = static_cast<size_t>(bk > 1 ? b : 0) * heads * S * HD;
  for (int i = tid; i < XF_ROWS * D; i += XF_THREADS) {
    const int r = i / D, c = i % D;
    Xs[r][c] = r < rows ? x[xb + static_cast<size_t>(q0 + r) * D + c] : 0.f;
  }
  __syncthreads();
  // q = x Wq
  for (int c = tid; c < D; c += XF_THREADS) {
    float acc[XF_ROWS];
#pragma unroll
    for (int r = 0; r < XF_ROWS; ++r) acc[r] = 0.f;
    for (int kk = 0; kk < D; ++kk) {
      const float w = wq[static_cast<size_t>(kk) * D + c];
#pragma unroll
      for (int r = 0; r < XF_ROWS; ++r) acc[r] = fmaf(Xs[r][kk], w, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < XF_ROWS; ++r) Qs[r][c] = acc[r];
  }
  __syncthreads();
  for (int h = 0; h < heads; ++h) {
    const float* kh = k + kvb + static_cast<size_t>(h) * S * HD;
    const float* vh = v + kvb + static_cast<size_t>(h) * S * HD;
    for (int i = tid; i < XF_ROWS * S; i += XF_THREADS) {
      const int r = i / S, s = i % S;
      float dot = 0.f;
      for (int d = 0; d < HD; ++d) dot = fmaf(Qs[r][h * HD + d], kh[s * HD + d], dot);
      Ps[r][s] = dot * scale;
    }
    __syncthreads();
    if (tid < XF_ROWS) {
      float m = -INFINITY, l = 0.f;
      for (int s = 0; s < S; ++s) m = fmaxf(m, Ps[tid][s]);
      for (int s = 0; s < S; ++s) {
        Ps[tid][s] = expf(Ps[tid][s] - m);
        l += Ps[tid][s];
      }
      for (int s = 0; s < S; ++s) Ps[tid][s] = Ps[tid][s] / l;
    }
    __syncthreads();
    for (int i = tid; i < XF_ROWS * HD; i += XF_THREADS) {
      const int r = i / HD, d = i % HD;
      float acc = 0.f;
      for (int s = 0; s < S; ++s) acc = fmaf(Ps[r][s], vh[s * HD + d], acc);
      Xs[r][h * HD + d] = acc;
    }
    __syncthreads();
  }
  // att Wp + bp
  for (int c = tid; c < D; c += XF_THREADS) {
    float acc[XF_ROWS];
#pragma unroll
    for (int r = 0; r < XF_ROWS; ++r) acc[r] = 0.f;
    for (int kk = 0; kk < D; ++kk) {
      const float w = wp[static_cast<size_t>(kk) * D + c];
#pragma unroll
      for (int r = 0; r < XF_ROWS; ++r) acc[r] = fmaf(Xs[r][kk], w, acc[r]);
    }
    const float bias = param_at(bp, p_code, c);
#pragma unroll
    for (int r = 0; r < XF_ROWS; ++r)
      if (r < rows) out[xb + static_cast<size_t>(q0 + r) * D + c] = acc[r] + bias;
  }
}

// -- the wgmma form -----------------------------------------------------------

namespace cg = cooperative_groups;
using wg::desc;
using wg::fence_regs;
using wg::mbar_expect_tx;
using wg::mbar_fence_init;
using wg::mbar_init;
using wg::mbar_wait;
using wg::wgmma_commit;
using wg::wgmma_fence;
using wg::wgmma_wait;

constexpr int XG_COLS = 64;   // a head group's columns: Wq's columns, Wp's rows
constexpr int XG_ROWS = 64;   // query rows a CTA: the warpgroup's wgmma M
constexpr int XG_THREADS = 128;

// The wgmma form's shared memory, bytes: 1 KB of alignment; x (D / 64
// parts of 64 rows x 128 bytes), Wq's and Wp's group columns (D rows x 128
// bytes each), all with the 128-byte swizzle; the group's k and v (64 / hd heads x SP rows x hd, 128
// SP bytes each); 3 mbarriers. The row tile's attention output (64 rows x
// D, T) takes x's bytes once every CTA of the cluster has made q. Two CTAs
// share an SM at D 256 (103 KB each at S <= 16).
// kernels/attention_plan.py::cross_smem mirrors it.
__host__ __device__ constexpr int xg_smem(int D, int SP) {
  return 1024 + 3 * 128 * D + 2 * 128 * SP + 3 * 8;
}

// The cluster barrier in two halves: arrive (release: this CTA's earlier
// shared-memory reads and writes are done) and wait (acquire: every CTA's
// are). cluster.sync() is both.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// Orders generic-proxy shared-memory stores, this CTA's and (through
// distributed shared memory) other CTAs', with async-proxy reads (wgmma).
__device__ __forceinline__ void fence_proxy_async_cluster() {
  asm volatile("fence.proxy.async.shared::cluster;\n" ::: "memory");
}

// x and out (B, N, D), wq and wp (D, D), k and v (Bk, heads, S, HD) through
// the maps launch_wgmma makes; bp (D,) in p_code. Grid (D / 64 groups, N /
// 64 row tiles, B), a cluster of the D / 64 groups of a row tile.
template <typename T, int HD, int SP>
__global__ void __launch_bounds__(XG_THREADS)
xattn_wgmma(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_wq,
            const __grid_constant__ CUtensorMap map_wp, const __grid_constant__ CUtensorMap map_k,
            const __grid_constant__ CUtensorMap map_v, const void* __restrict__ bp, int p_code,
            uint16_t* __restrict__ out, int N, int D, int heads, int S, int bk, float scale) {
  using G = wa::Geo<HD>;
  constexpr int GH = XG_COLS / HD;       // heads a group
  constexpr int KV_BYTES = 128 * SP;     // GH heads x SP rows x HD halves
  constexpr int QF = XG_COLS / 16;       // the group's k16 slices: q's and att's fragments
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sx = smem_raw + ((1024 - (wg::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* swq = sx + 128 * D;
  uint8_t* swp = swq + 128 * D;
  uint8_t* sk = swp + 128 * D;
  uint8_t* sv = sk + KV_BYTES;
  uint64_t* bar = reinterpret_cast<uint64_t*>(sv + KV_BYTES);

  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int grp = blockIdx.x, q0 = blockIdx.y * XG_ROWS, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, t = lane & 3;
  const int parts = D / 64;
  // bp at this thread's 16 output columns (64 grp + 8 j + 2 t + e), read
  // now so that the loads' round trip hides under the TMA loads'
  float bias[16];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      bias[2 * j + e] = param_at(bp, p_code, XG_COLS * grp + 8 * j + 2 * t + e);

  // 1. every load at once
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 3; ++i) mbar_init(&bar[i], 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(&bar[0], 2 * 128 * D);
    for (int p = 0; p < parts; ++p) wg::tma_load_3d(sx + p * 8192, &map_x, &bar[0], 64 * p, q0, b);
    wg::tma_load_2d(swq, &map_wq, &bar[0], XG_COLS * grp, 0);
    const int h0 = (bk > 1 ? b : 0) * heads + grp * GH;
    mbar_expect_tx(&bar[1], 2 * KV_BYTES);
    wg::tma_load_4d(sk, &map_k, &bar[1], 0, 0, h0, 0);
    wg::tma_load_4d(sv, &map_v, &bar[1], 0, 0, h0, 0);
    mbar_expect_tx(&bar[2], 128 * D);
    wg::tma_load_2d(swp, &map_wp, &bar[2], XG_COLS * grp, 0);
  }

  // 2. q = x Wq[:, group], rounded to T: qa[f] is k16 slice f's A fragment
  uint32_t qa[QF][4];
  {
    float acc[XG_COLS / 2];
#pragma unroll
    for (int i = 0; i < XG_COLS / 2; ++i) acc[i] = 0.f;
    mbar_wait(&bar[0], 0);
    wgmma_fence();
    for (int p = 0; p < parts; ++p)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wg::mma_m64n64k16<T>(acc, desc(sx + p * 8192 + kk * 32, 16, 1024),
                             desc(swq + (64 * p + 16 * kk) * 128, 8192, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
#pragma unroll
    for (int f = 0; f < QF; ++f)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qa[f][i] = wa::pack16<T>(acc[8 * f + 2 * i], acc[8 * f + 2 * i + 1]);
  }
  cluster_arrive();  // this CTA is done with x: the others' att parts may land there

  // 3. per head: scores, softmax, p v; the head's output rounded to T
  uint32_t att[QF][4];
  mbar_wait(&bar[1], 0);
#pragma unroll
  for (int hl = 0; hl < GH; ++hl) {
    const uint8_t* kh = sk + hl * SP * G::RB;
    const uint8_t* vh = sv + hl * SP * G::RB;
    float s[SP / 2];
#pragma unroll
    for (int i = 0; i < SP / 2; ++i) s[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wa::mma_rsk<T, SP>(s, qa[hl * (HD / 16) + kk],
                         desc(kh + kk * 32, 16, G::SBO, G::LAYOUT), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    // s[4 j + 2 h + e]: row 16 warp + lane / 4 + 8 h, key 8 j + 2 t + e
    float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < SP / 2; ++i) {
      const int key = 8 * (i >> 2) + 2 * t + (i & 1);
      s[i] = key < S ? s[i] * scale : -INFINITY;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) mx[h] = wa::quad_max(mx[h]);
#pragma unroll
    for (int i = 0; i < SP / 2; ++i) {
      s[i] = expf(s[i] - mx[(i >> 1) & 1]);
      sum[(i >> 1) & 1] += s[i];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) sum[h] = wa::quad_sum(sum[h]);
    uint32_t pf[SP / 16][4];
#pragma unroll
    for (int kk = 0; kk < SP / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pf[kk][i] =
            wa::pack16<T>(s[8 * kk + 2 * i] / sum[i & 1], s[8 * kk + 2 * i + 1] / sum[i & 1]);
    float o[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < SP / 16; ++kk)
      wa::mma_rs<T, HD>(o, pf[kk], desc(vh + kk * 16 * G::RB, SP * G::RB, G::SBO, G::LAYOUT),
                        kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
#pragma unroll
    for (int f = 0; f < HD / 16; ++f)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        att[hl * (HD / 16) + f][i] = wa::pack16<T>(o[8 * f + 2 * i], o[8 * f + 2 * i + 1]);
  }

  // 4. The row tile's attention output (64 x D, T) in every rank's shared
  // memory, over its x (which every rank has finished reading: the cluster
  // barrier's arrive after q, its wait here), K-major with the 128-byte
  // swizzle, part g from rank g: this CTA's part from its registers, then
  // 16 bytes a thread to each other rank through distributed shared memory.
  uint8_t* satt = sx + grp * 8192;
  cluster_wait();
#pragma unroll
  for (int f = 0; f < QF; ++f)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = warp * 16 + (lane >> 2) + 8 * (i & 1);
      const int col = 16 * f + 8 * (i >> 1) + 2 * t;
      *reinterpret_cast<uint32_t*>(satt + wg::a_offset(row, col >> 3) + (col & 7) * 2) =
          att[f][i];
    }
  __syncthreads();  // the part is whole
  for (int q = 1; q < C; ++q) {
    uint8_t* dst = cluster.map_shared_rank(satt, (rank + q) % C);
#pragma unroll
    for (int k = 0; k < 8192 / 16 / XG_THREADS; ++k) {
      const int o = (tid + k * XG_THREADS) * 16;
      *reinterpret_cast<uint4*>(dst + o) = *reinterpret_cast<const uint4*>(satt + o);
    }
  }
  fence_proxy_async_cluster();  // the stores, before any rank's wgmma reads them
  cluster.sync();               // every part has landed everywhere
  fence_proxy_async_cluster();

  // 5. out[:, group columns] = att Wp[:, group columns] (f32 sums over D on
  // wgmma m64n64k16, both operands from shared memory) + bp in f32, one
  // rounding. Each output column is summed by one CTA over the whole of D:
  // no K split, so a row's result does not depend on its batch position.
  {
    float acc[XG_COLS / 2];
#pragma unroll
    for (int i = 0; i < XG_COLS / 2; ++i) acc[i] = 0.f;
    mbar_wait(&bar[2], 0);
    wgmma_fence();
    for (int p = 0; p < parts; ++p)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wg::mma_m64n64k16<T>(acc, desc(sx + p * 8192 + kk * 32, 16, 1024),
                             desc(swp + (64 * p + 16 * kk) * 128, 8192, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    // acc[4 j + 2 h + e]: row 16 warp + lane / 4 + 8 h, column 8 j + 2 t + e
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = q0 + warp * 16 + (lane >> 2) + 8 * h;
      if (row >= N) continue;
      uint16_t* o = out + (static_cast<size_t>(b) * N + row) * D + XG_COLS * grp + 2 * t;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<uint32_t*>(o + 8 * j) =
            wa::pack16<T>(acc[4 * j + 2 * h] + bias[2 * j],
                          acc[4 * j + 2 * h + 1] + bias[2 * j + 1]);
    }
  }
}

template <typename T, int HD, int SP>
int launch_wgmma(const void* x, const void* wq, const void* k, const void* v, const void* wp,
                 const void* bp, int p_code, void* out, int B, int N, int D, int heads, int S,
                 int bk, float scale, cudaStream_t stream) {
  using G = wa::Geo<HD>;
  constexpr auto type = wg::map_type<T>();
  CUtensorMap map_x, map_wq, map_wp, map_k, map_v;
  const long long row = static_cast<long long>(D) * 2, head = static_cast<long long>(S) * HD * 2;
  int rc = wg::make_map_3d(&map_x, x, type, D, N, B, row, row * N, 64, XG_ROWS,
                           CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc == 0)
    rc = wg::make_map(&map_wq, wq, type, 2, D, D, D, XG_COLS, CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc == 0)
    rc = wg::make_map(&map_wp, wp, type, 2, D, D, D, XG_COLS, CU_TENSOR_MAP_SWIZZLE_128B);
  // k and v as (HD, S, Bk heads, 1): a box is SP rows of a group's heads
  const int kvh = bk * heads;
  if (rc == 0)
    rc = wg::make_map_4d(&map_k, k, type, HD, S, kvh, 1, HD * 2, head, head * kvh, HD, SP,
                         G::SWIZZLE, XG_COLS / HD);
  if (rc == 0)
    rc = wg::make_map_4d(&map_v, v, type, HD, S, kvh, 1, HD * 2, head, head * kvh, HD, SP,
                         G::SWIZZLE, XG_COLS / HD);
  if (rc != 0) return rc;
  const int smem = xg_smem(D, SP);
  static const cudaError_t smem_set = cudaFuncSetAttribute(
      xattn_wgmma<T, HD, SP>, cudaFuncAttributeMaxDynamicSharedMemorySize, xg_smem(XMAX_D, SP));
  if (smem_set != cudaSuccess) return static_cast<int>(smem_set);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(D / XG_COLS, cdiv(N, XG_ROWS), B);
  cfg.blockDim = dim3(XG_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = D / XG_COLS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, xattn_wgmma<T, HD, SP>, map_x, map_wq, map_wp,
                                           map_k, map_v, bp, p_code,
                                           static_cast<uint16_t*>(out), N, D, heads, S, bk, scale);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

template <typename T, int HD, int SP>
int launch_mma(const void* x, const void* wq, const void* k, const void* v, const void* wp,
               const void* bp, int p_code, void* out, int B, int N, int D, int heads, int S,
               int bk, float scale, cudaStream_t stream) {
  const size_t smem = xattn_smem_bytes(D, heads, HD, SP);
  cudaError_t err = cudaFuncSetAttribute(xattn_mma<T, HD, SP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(cdiv(N, XQ_ROWS), B);
  xattn_mma<T, HD, SP><<<grid, XQ_THREADS, smem, stream>>>(
      static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(wq),
      static_cast<const uint16_t*>(k), static_cast<const uint16_t*>(v),
      static_cast<const uint16_t*>(wp), bp, p_code, static_cast<uint16_t*>(out), N, D, heads, S,
      bk, scale);
  return static_cast<int>(cudaGetLastError());
}

// SP: S rounded up to 16, 32 or 64; wgmma: the wgmma form, else mma.sync.
template <typename T, int HD, int SP>
int launch_form(bool wgmma, const void* x, const void* wq, const void* k, const void* v,
                const void* wp, const void* bp, int p_code, void* out, int B, int N, int D,
                int heads, int S, int bk, float scale, cudaStream_t stream) {
  return wgmma ? launch_wgmma<T, HD, SP>(x, wq, k, v, wp, bp, p_code, out, B, N, D, heads, S, bk,
                                         scale, stream)
               : launch_mma<T, HD, SP>(x, wq, k, v, wp, bp, p_code, out, B, N, D, heads, S, bk,
                                       scale, stream);
}

template <typename T, int HD>
int launch_hd(bool wgmma, const void* x, const void* wq, const void* k, const void* v,
              const void* wp, const void* bp, int p_code, void* out, int B, int N, int D,
              int heads, int S, int bk, float scale, cudaStream_t stream) {
  if (S <= 16)
    return launch_form<T, HD, 16>(wgmma, x, wq, k, v, wp, bp, p_code, out, B, N, D, heads, S,
                                  bk, scale, stream);
  if (S <= 32)
    return launch_form<T, HD, 32>(wgmma, x, wq, k, v, wp, bp, p_code, out, B, N, D, heads, S,
                                  bk, scale, stream);
  return launch_form<T, HD, 64>(wgmma, x, wq, k, v, wp, bp, p_code, out, B, N, D, heads, S, bk,
                                scale, stream);
}

template <typename T>
int run(bool wgmma, const void* x, const void* wq, const void* k, const void* v, const void* wp,
        const void* bp, int p_code, void* out, int B, int N, int D, int heads, int S, int bk,
        float scale, cudaStream_t stream) {
  switch (D / heads) {
    case 16:
      return launch_hd<T, 16>(wgmma, x, wq, k, v, wp, bp, p_code, out, B, N, D, heads, S, bk,
                              scale, stream);
    case 32:
      return launch_hd<T, 32>(wgmma, x, wq, k, v, wp, bp, p_code, out, B, N, D, heads, S, bk,
                              scale, stream);
    default:
      return launch_hd<T, 64>(wgmma, x, wq, k, v, wp, bp, p_code, out, B, N, D, heads, S, bk,
                              scale, stream);
  }
}

}  // namespace

extern "C" const char* smelter_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x and out (B, N, D), wq and wp (D, D), k and v (Bk, heads, S, D / heads),
// all row-major in x_dtype and 16-byte aligned; bp (D,) in p_dtype (f32 or
// x_dtype); Bk 1 or B. Head dim 16, 32 or 64; S at most 64; D at most 256.
// form 1: the wgmma form (16-bit x, D % 64 == 0: kernels/attention_plan.py::
// cross_plan); form 0: the mma.sync form (16-bit x) or the f32 kernel.
// Returns a cudaError_t code.
extern "C" int smelter_cross_attn_block(const void* x, const void* wq, const void* k,
                                        const void* v, const void* wp, const void* bp,
                                        void* out, int B, int N, int D, int heads, int S, int bk,
                                        float scale, int x_dtype, int p_dtype, int form,
                                        void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const auto misaligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; };
  if (misaligned(x) || misaligned(wq) || misaligned(k) || misaligned(v) || misaligned(wp) ||
      misaligned(out))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const int hd = heads > 0 ? D / heads : 0;
  if (heads <= 0 || D % heads != 0 || (hd != 16 && hd != 32 && hd != 64) || D > XMAX_D ||
      S < 1 || S > XMAX_S || (bk != 1 && bk != B) || (p_dtype != kF32 && p_dtype != x_dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  if ((form != 0 && form != 1) ||
      (form == 1 && (x_dtype == kF32 || D % XG_COLS != 0 || N > 65535 * XG_ROWS || B > 65535)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || N == 0) return 0;
  switch (x_dtype) {
    case kF32: {
      const dim3 grid(cdiv(N, XF_ROWS), B);
      xattn_f32<<<grid, XF_THREADS, 0, st>>>(
          static_cast<const float*>(x), static_cast<const float*>(wq),
          static_cast<const float*>(k), static_cast<const float*>(v),
          static_cast<const float*>(wp), bp, p_dtype, static_cast<float*>(out), N, D, heads, S,
          bk, scale);
      return static_cast<int>(cudaGetLastError());
    }
    case kBF16:
      return run<__nv_bfloat16>(form == 1, x, wq, k, v, wp, bp, p_dtype, out, B, N, D, heads, S,
                                bk, scale, st);
    case kF16:
      return run<__half>(form == 1, x, wq, k, v, wp, bp, p_dtype, out, B, N, D, heads, S, bk,
                         scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
