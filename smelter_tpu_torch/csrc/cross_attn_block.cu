// Cross-attention block against constant keys and values, for Hopper:
// q = x Wq -> per head softmax(q k^T * scale) v -> att Wp + bp.
//
// Replaces the Pallas kernel smelter_tpu/kernels/vit_block.py::
// cross_attn_block (body _xattn_kernel), which runs one program per image
// with the image's (N, D) rows, both (D, D) weights and the image's k/v in
// VMEM. Here one block of 4 warps takes one image's tile of 64 query rows,
// so nothing of the block crosses device memory but its operands and its
// output:
//
//   1. the x tile (64, D) and this image's k and v for all heads (Bk = B:
//      per image; Bk = 1: the one context for every image) land in shared
//      memory, keys past S as zeros;
//   2. q = x Wq on mma.sync (m16n8k16, f32 accumulators), Wq streamed
//      through shared memory 64 columns at a time, q rounded to x's type
//      into shared memory;
//   3. per head, the warp's 16 rows score against the S keys on mma.sync,
//      times scale, in f32 (keys padded to a multiple of 16 score -inf);
//      the softmax in f32 in registers (exp(s - max) / sum, as the Pallas
//      kernel spells it); p rounded to x's type; p v on mma.sync in f32;
//      the head's output rounded to x's type into shared memory at columns
//      h hd (the Pallas kernel's concatenated attention output);
//   4. att Wp + bp, Wp streamed as Wq, bp added in f32, one rounding.
//
// f32 activations take a CUDA-core kernel in full f32 (no TF32) with the
// same four steps, one block for 16 query rows.
//
// What bounds it on an H100: at SD-UNet's (B 8, N 1024, D 128, 8 heads, S
// 16) a call does B (4 N D^2 + 4 N S D) = 0.60 GFLOP (0.6 us at 989
// TFLOP/s dense bf16) against 4.2 MB of x, weights, k, v and output (1.3
// us at 3.35 TB/s): bytes, and at that size the launch itself. The design
// reads each operand once a block and keeps q, p and the attention output
// on chip. No TMA or wgmma yet.
#include "gemm.cuh"

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

template <typename T, int HD>
int launch_hd(const void* x, const void* wq, const void* k, const void* v, const void* wp,
              const void* bp, int p_code, void* out, int B, int N, int D, int heads, int S,
              int bk, float scale, cudaStream_t stream) {
  if (S <= 16)
    return launch_mma<T, HD, 16>(x, wq, k, v, wp, bp, p_code, out, B, N, D, heads, S, bk,
                                 scale, stream);
  if (S <= 32)
    return launch_mma<T, HD, 32>(x, wq, k, v, wp, bp, p_code, out, B, N, D, heads, S, bk,
                                 scale, stream);
  return launch_mma<T, HD, 64>(x, wq, k, v, wp, bp, p_code, out, B, N, D, heads, S, bk, scale,
                               stream);
}

template <typename T>
int run(const void* x, const void* wq, const void* k, const void* v, const void* wp,
        const void* bp, int p_code, void* out, int B, int N, int D, int heads, int S, int bk,
        float scale, cudaStream_t stream) {
  switch (D / heads) {
    case 16:
      return launch_hd<T, 16>(x, wq, k, v, wp, bp, p_code, out, B, N, D, heads, S, bk, scale,
                              stream);
    case 32:
      return launch_hd<T, 32>(x, wq, k, v, wp, bp, p_code, out, B, N, D, heads, S, bk, scale,
                              stream);
    default:
      return launch_hd<T, 64>(x, wq, k, v, wp, bp, p_code, out, B, N, D, heads, S, bk, scale,
                              stream);
  }
}

}  // namespace

extern "C" const char* smelter_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x and out (B, N, D), wq and wp (D, D), k and v (Bk, heads, S, D / heads),
// all row-major in x_dtype and 16-byte aligned; bp (D,) in p_dtype (f32 or
// x_dtype); Bk 1 or B. Head dim 16, 32 or 64; S at most 64; D at most 256.
// Returns a cudaError_t code.
extern "C" int smelter_cross_attn_block(const void* x, const void* wq, const void* k,
                                        const void* v, const void* wp, const void* bp,
                                        void* out, int B, int N, int D, int heads, int S, int bk,
                                        float scale, int x_dtype, int p_dtype, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const auto misaligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; };
  if (misaligned(x) || misaligned(wq) || misaligned(k) || misaligned(v) || misaligned(wp) ||
      misaligned(out))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const int hd = heads > 0 ? D / heads : 0;
  if (heads <= 0 || D % heads != 0 || (hd != 16 && hd != 32 && hd != 64) || D > XMAX_D ||
      S < 1 || S > XMAX_S || (bk != 1 && bk != B) || (p_dtype != kF32 && p_dtype != x_dtype))
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
      return run<__nv_bfloat16>(x, wq, k, v, wp, bp, p_dtype, out, B, N, D, heads, S, bk, scale,
                                st);
    case kF16:
      return run<__half>(x, wq, k, v, wp, bp, p_dtype, out, B, N, D, heads, S, bk, scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
