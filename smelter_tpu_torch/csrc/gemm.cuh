// The GEMM of the port's transformer kernels: out (M, N) = A (M, K) @ B +
// f32 bias [-> GELU] [* column scale] [+ residual], one rounding to the
// output's type. The QKV and output projections of csrc/vit_block.cu and
// the two products of csrc/mlp_block.cu and csrc/convnext_block.cu.
//
// B(k, n) lies in block n / G of shape (K, G), row-major: the packed QKV
// weight with G = group * hd, a plain (K, N) weight with G = N.
//
// 16-bit types take mma.sync m16n8k16 tiles of 128 x 128 with f32
// accumulators, fed by a 4-stage cp.async ring; f32 takes a register-tiled
// FMA kernel in full f32 (no TF32). The epilogue adds the bias in f32,
// applies the activation in f32 (GELU's exact form as the Pallas MLP kernel
// spells it, smelter_tpu/kernels/mlp_block.py::_mlp_kernel: the
// Abramowitz-Stegun 7.1.26 polynomial over exp; or the tanh form),
// multiplies by a per-column scale in f32 (ConvNeXt's layer scale), adds
// the residual in f32 and rounds once.
#pragma once

#include <type_traits>

#include "layer_norm.cuh"

namespace smelter {

__device__ __forceinline__ size_t b_offset(int k, int n, int K, int G) {
  return static_cast<size_t>(n / G) * K * G + static_cast<size_t>(k) * G + (n % G);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool full) {
  // 16 bytes global -> shared without a register stop; zeros when !full
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(dst), "l"(gmem), "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <typename T> __device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <> __device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <> __device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

constexpr int GEMM_THREADS = 256;

// 128x128 output tiles, K steps of 32 through a ring of 4 shared-memory
// stages filled by cp.async (three steps in flight while the tensor cores
// work on the fourth); 8 warps of 32x64, fragments by ldmatrix; at most 128
// registers a thread, so two blocks share an SM. K, N and G are multiples
// of 8 and A, B 16-byte aligned (the entry points check), so every 16-byte
// chunk lies wholly inside or outside the matrices.
constexpr int BM = 128, BN = 128, BK = 32, STAGES = 4;
constexpr int SA = BK + 8;  // halves per A row in shared memory (80 bytes)
constexpr int SB = BN + 8;  // halves per B row in shared memory (272 bytes)
constexpr int A_STAGE = BM * SA, B_STAGE = BK * SB;
constexpr int GEMM_SMEM = STAGES * (A_STAGE + B_STAGE) * 2;  // 75,776 bytes

// The main loop of gemm_mma: acc = the warp's 32 x 64 sub-tile (rows wm,
// columns wn of the block's 128 x 128 tile at (m0, n0)) of A (M, K) @ B over
// all of K. VEC loads 16-byte chunks by cp.async (K, N and G multiples of 8,
// A and B 16-byte aligned); otherwise each element is loaded on its own, for
// any K, N, G and alignment.
template <typename T, bool VEC>
__device__ __forceinline__ void gemm_mma_mainloop(float (&acc)[2][8][4],
                                                  const uint16_t* __restrict__ A,
                                                  const uint16_t* __restrict__ Bw, int M, int N,
                                                  int K, int G, int m0, int n0, uint16_t* smem) {
  uint16_t* As = smem;                     // [stage][m][k]
  uint16_t* Bs = smem + STAGES * A_STAGE;  // [stage][k][n]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 64;
  const int KT = (K + BK - 1) / BK;

#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  auto load_stage = [&](int stage, int kt) {
    const int k0 = kt * BK;
#pragma unroll
    for (int i = 0; i < BM * BK / 8 / GEMM_THREADS; ++i) {
      const int c = tid + i * GEMM_THREADS;
      const int r = c / (BK / 8), col = (c % (BK / 8)) * 8;
      uint16_t* dst = &As[stage * A_STAGE + r * SA + col];
      if constexpr (VEC) {
        const bool in = m0 + r < M && k0 + col < K;
        cp_async16(dst, in ? A + static_cast<size_t>(m0 + r) * K + k0 + col : A, in);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          dst[j] = m0 + r < M && k0 + col + j < K
                       ? A[static_cast<size_t>(m0 + r) * K + k0 + col + j] : uint16_t(0);
      }
    }
#pragma unroll
    for (int i = 0; i < BK * BN / 8 / GEMM_THREADS; ++i) {
      const int c = tid + i * GEMM_THREADS;
      const int r = c / (BN / 8), col = (c % (BN / 8)) * 8;
      uint16_t* dst = &Bs[stage * B_STAGE + r * SB + col];
      if constexpr (VEC) {
        const bool in = k0 + r < K && n0 + col < N;
        cp_async16(dst, in ? Bw + b_offset(k0 + r, n0 + col, K, G) : Bw, in);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          dst[j] = k0 + r < K && n0 + col + j < N ? Bw[b_offset(k0 + r, n0 + col + j, K, G)]
                                                  : uint16_t(0);
      }
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // step kt has landed; step kt - 1's stage is free
    if (kt + STAGES - 1 < KT) load_stage((kt + STAGES - 1) % STAGES, kt + STAGES - 1);
    cp_async_commit();
    const uint16_t* as = As + (kt % STAGES) * A_STAGE;
    const uint16_t* bs = Bs + (kt % STAGES) * B_STAGE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[2][4], b[8][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldmatrix_x4(a[mi], &as[(wm + mi * 16 + (lane & 15)) * SA + kk + (lane >> 4) * 8]);
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, &bs[(kk + (lane & 15)) * SB + wn + nj * 16 + (lane >> 4) * 8]);
        b[2 * nj][0] = r[0];
        b[2 * nj][1] = r[1];
        b[2 * nj + 1][0] = r[2];
        b[2 * nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 8; ++ni) mma_16816<T>(acc[mi][ni], a[mi], b[ni]);
    }
  }
  cp_async_wait<0>();
}

template <typename T>
__global__ void __launch_bounds__(GEMM_THREADS, 2)
gemm_mma(const uint16_t* __restrict__ A, const uint16_t* __restrict__ Bw,
         const void* __restrict__ bias, int p_code, int act, const T* __restrict__ residual,
         T* __restrict__ out, int M, int N, int K, int G, const void* __restrict__ scale) {
  extern __shared__ __align__(16) uint16_t smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 64;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float acc[2][8][4];
  gemm_mma_mainloop<T, true>(acc, A, Bw, M, N, K, G, m0, n0, smem);

  // Epilogue: the bias in f32, the activation, the residual in f32, one rounding.
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
      const int col = n0 + wn + ni * 8 + t * 2;
      if (col >= N) continue;
      const float b0 = param_at(bias, p_code, col), b1 = param_at(bias, p_code, col + 1);
      const float s0 = scale != nullptr ? param_at(scale, p_code, col) : 1.f;
      const float s1 = scale != nullptr ? param_at(scale, p_code, col + 1) : 1.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm + mi * 16 + g + h * 8;
        if (row >= M) continue;
        const size_t o = static_cast<size_t>(row) * N + col;
        float v0 = activate(acc[mi][ni][h * 2] + b0, act);
        float v1 = activate(acc[mi][ni][h * 2 + 1] + b1, act);
        if (scale != nullptr) {
          v0 *= s0;
          v1 *= s1;
        }
        if (residual != nullptr) {
          v0 = to_float(residual[o]) + v0;
          v1 = to_float(residual[o + 1]) + v1;
        }
        store(&out[o], v0);
        store(&out[o + 1], v1);
      }
    }
}

// f32: register-tiled FMA in full f32, 4x4 outputs a thread.
constexpr int FM = 64, FN = 64, FK = 16;

// The main loop of gemm_f32: acc[i][j] = output (m0 + 4 (tid / 16) + i,
// n0 + 4 (tid % 16) + j) of A (M, K) @ B over all of K, any shapes.
__device__ __forceinline__ void gemm_f32_mainloop(float (&acc)[4][4], const float* __restrict__ A,
                                                  const float* __restrict__ Bw, int M, int N,
                                                  int K, int G, int m0, int n0) {
  __shared__ float As[FK][FM + 4];  // [k][m]
  __shared__ float Bs[FK][FN + 4];  // [k][n]
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += FK) {
    for (int i = tid; i < FM * FK; i += GEMM_THREADS) {
      const int r = i / FK, c = i % FK;
      const int gm = m0 + r, gk = k0 + c;
      As[c][r] = (gm < M && gk < K) ? A[static_cast<size_t>(gm) * K + gk] : 0.f;
    }
    for (int i = tid; i < FK * FN; i += GEMM_THREADS) {
      const int r = i / FN, c = i % FN;
      const int gk = k0 + r, gn = n0 + c;
      Bs[r][c] = (gk < K && gn < N) ? Bw[b_offset(gk, gn, K, G)] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < FK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[k][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[k][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(GEMM_THREADS)
gemm_f32(const float* __restrict__ A, const float* __restrict__ Bw,
         const void* __restrict__ bias, int p_code, int act, const float* __restrict__ residual,
         float* __restrict__ out, int M, int N, int K, int G, const void* __restrict__ scale) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * FM, n0 = blockIdx.x * FN;
  float acc[4][4];
  gemm_f32_mainloop(acc, A, Bw, M, N, K, G, m0, n0);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col >= N) continue;
      const size_t o = static_cast<size_t>(row) * N + col;
      float v = activate(acc[i][j] + param_at(bias, p_code, col), act);
      if (scale != nullptr) v *= param_at(scale, p_code, col);
      if (residual != nullptr) v = residual[o] + v;
      out[o] = v;
    }
  }
}

// static: each kernel library keeps its own copy and its own guard below (a
// template's static local is one symbol for the whole process otherwise, so
// one library's cudaFuncSetAttribute would stand for another's).
// `scale` (N,) in p_code, or nullptr: the per-column scale of the epilogue.
template <typename T>
static void gemm(const T* A, const T* Bw, const void* bias, int p_code, int act,
                 const T* residual, T* out, int M, int N, int K, int G, cudaStream_t stream,
                 const void* scale = nullptr) {
  if constexpr (std::is_same<T, float>::value) {
    const dim3 grid(cdiv(N, FN), cdiv(M, FM));
    gemm_f32<<<grid, GEMM_THREADS, 0, stream>>>(A, Bw, bias, p_code, act, residual, out, M, N,
                                                K, G, scale);
  } else {
    static const cudaError_t smem_set = cudaFuncSetAttribute(
        gemm_mma<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, GEMM_SMEM);
    (void)smem_set;  // a refusal shows as the launch's error
    const dim3 grid(cdiv(N, BN), cdiv(M, BM));
    gemm_mma<T><<<grid, GEMM_THREADS, GEMM_SMEM, stream>>>(
        reinterpret_cast<const uint16_t*>(A), reinterpret_cast<const uint16_t*>(Bw), bias,
        p_code, act, residual, out, M, N, K, G, scale);
  }
}

}  // namespace smelter
