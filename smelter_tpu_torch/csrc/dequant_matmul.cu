// Fused dequant + matmul for Hopper: out = (x @ float(w_q)) * scales[n].
//
// Replaces smelter_tpu/kernels/dequant_matmul.py::_dequant_matmul_impl, the
// Pallas kernel that streams int8 weight tiles into VMEM, upcasts them and
// runs the MXU in the activation dtype with the per-N scale applied once
// after the K loop.
//
// What bounds it on an H100: at the ResNet-50 head (M 128, K 2048, N 1000)
// the bytes (x, the int8 W, the output) are ~2.8 MB, so it is bound by HBM
// (~0.85 us at 3.35 TB/s); at the serving GEMM (M 8192, K 4096, N 4096) it
// is bound by the bf16 tensor cores (~278 us at 989 TFLOP/s).
//
// Design, simple first: one 128x128 output tile per block of 8 warps, each
// warp a 32x64 sub-tile of mma.sync.m16n8k16 with f32 accumulators. Per K
// step of 64 the block copies the activation tile to shared memory, and the
// int8 weight tile is converted to the activation type on its way into
// shared memory (int8 values are exact in bf16 and f16), so W crosses HBM
// as int8 only. B fragments come out of the row-major [k][n] tile through
// ldmatrix.trans. The next step's tiles are loaded into registers while the
// tensor cores work on the current one. M, N and K edges are masked on both
// operands: out-of-range elements load as zero. The scale multiplies the
// accumulator once, after the K sum, then the result is cast.
//
// f32 activations take an FMA kernel in full f32 (no TF32), because the
// reference computes in the activation dtype. A small problem leaves SMs
// idle (the ResNet head makes 8 output tiles for 132 SMs); no split-K,
// cp.async, TMA or wgmma yet.
#include "common.cuh"

namespace {

using namespace smelter;

constexpr int BM = 128, BN = 128, BK = 64, THREADS = 256;
constexpr int SA = BK + 8;  // halves per activation row in shared memory (144 bytes)
constexpr int SB = BN + 8;  // halves per weight row in shared memory (272 bytes)
constexpr int A_CHUNKS = BM * BK / 8 / THREADS;  // 8-half chunks a thread loads
constexpr int B_CHUNKS = BK * BN / 8 / THREADS;  // 8-byte chunks a thread loads

template <typename T, typename OutT>
__global__ void __launch_bounds__(THREADS)
dequant_matmul_mma(const uint16_t* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ scales, OutT* __restrict__ out, int M, int N,
                   int K, bool x_vec, bool w_vec) {
  __shared__ __align__(16) uint16_t As[BM * SA];  // [m][k]
  __shared__ __align__(16) uint16_t Bs[BK * SB];  // [k][n], already in type T

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 64;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  float acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  uint4 ra[A_CHUNKS];
  uint2 rb[B_CHUNKS];

  // Global -> registers for the K step at k0, zero outside [0, M) x [0, K).
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < A_CHUNKS; ++i) {
      const int c = tid + i * THREADS;
      const int r = c / (BK / 8), col = (c % (BK / 8)) * 8;
      const int gm = m0 + r, gk = k0 + col;
      if (x_vec && gm < M && gk + 8 <= K) {
        ra[i] = *reinterpret_cast<const uint4*>(x + static_cast<size_t>(gm) * K + gk);
      } else {
        uint32_t e[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (gm < M && gk + j < K)
            e[j >> 1] |= static_cast<uint32_t>(x[static_cast<size_t>(gm) * K + gk + j])
                         << (16 * (j & 1));
        ra[i] = make_uint4(e[0], e[1], e[2], e[3]);
      }
    }
#pragma unroll
    for (int i = 0; i < B_CHUNKS; ++i) {
      const int c = tid + i * THREADS;
      const int r = c / (BN / 8), col = (c % (BN / 8)) * 8;
      const int gk = k0 + r, gn = n0 + col;
      if (w_vec && gk < K && gn + 8 <= N) {
        rb[i] = *reinterpret_cast<const uint2*>(w + static_cast<size_t>(gk) * N + gn);
      } else {
        uint32_t e[2] = {0u, 0u};
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (gk < K && gn + j < N)
            e[j >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(
                             w[static_cast<size_t>(gk) * N + gn + j]))
                         << (8 * (j & 3));
        rb[i] = make_uint2(e[0], e[1]);
      }
    }
  };
  // Registers -> shared memory, converting the weights to T.
  auto stash = [&]() {
#pragma unroll
    for (int i = 0; i < A_CHUNKS; ++i) {
      const int c = tid + i * THREADS;
      *reinterpret_cast<uint4*>(&As[(c / (BK / 8)) * SA + (c % (BK / 8)) * 8]) = ra[i];
    }
#pragma unroll
    for (int i = 0; i < B_CHUNKS; ++i) {
      const int c = tid + i * THREADS;
      uint32_t p[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t word = j < 2 ? rb[i].x : rb[i].y;
        const int lo = static_cast<int8_t>((word >> (16 * (j & 1))) & 0xff);
        const int hi = static_cast<int8_t>((word >> (16 * (j & 1) + 8)) & 0xff);
        p[j] = static_cast<uint32_t>(int_bits<T>(lo)) |
               (static_cast<uint32_t>(int_bits<T>(hi)) << 16);
      }
      *reinterpret_cast<uint4*>(&Bs[(c / (BN / 8)) * SB + (c % (BN / 8)) * 8]) =
          make_uint4(p[0], p[1], p[2], p[3]);
    }
  };

  if (K > 0) load(0);
  for (int k0 = 0; k0 < K; k0 += BK) {
    stash();
    __syncthreads();
    if (k0 + BK < K) load(k0 + BK);  // in flight while the tensor cores work
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[2][4], b[8][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const uint16_t* pa = &As[(wm + mi * 16 + g) * SA + kk + t * 2];
        a[mi][0] = *reinterpret_cast<const uint32_t*>(pa);
        a[mi][1] = *reinterpret_cast<const uint32_t*>(pa + 8 * SA);
        a[mi][2] = *reinterpret_cast<const uint32_t*>(pa + 8);
        a[mi][3] = *reinterpret_cast<const uint32_t*>(pa + 8 * SA + 8);
      }
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, &Bs[(kk + (lane & 15)) * SB + wn + nj * 16 + (lane >> 4) * 8]);
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
    __syncthreads();
  }

  // Epilogue: the per-N scale once, after the K sum, then the cast.
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
      const int col = n0 + wn + ni * 8 + t * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm + mi * 16 + g + h * 8;
        if (row >= M) continue;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          if (col + j >= N) continue;
          store(&out[static_cast<size_t>(row) * N + col + j],
                __fmul_rn(acc[mi][ni][h * 2 + j], scales[col + j]));
        }
      }
    }
}

// f32 activations: register-tiled FMA in full f32, 4x4 outputs a thread.
constexpr int FM = 64, FN = 64, FK = 16;

template <typename OutT>
__global__ void __launch_bounds__(THREADS)
dequant_matmul_f32(const float* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ scales, OutT* __restrict__ out, int M, int N,
                   int K) {
  __shared__ float As[FK][FM + 4];  // [k][m]
  __shared__ float Bs[FK][FN + 4];  // [k][n]
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * FM, n0 = blockIdx.x * FN;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += FK) {
#pragma unroll
    for (int i = tid; i < FM * FK; i += THREADS) {
      const int r = i / FK, c = i % FK;
      const int gm = m0 + r, gk = k0 + c;
      As[c][r] = (gm < M && gk < K) ? x[static_cast<size_t>(gm) * K + gk] : 0.f;
    }
#pragma unroll
    for (int i = tid; i < FK * FN; i += THREADS) {
      const int r = i / FN, c = i % FN;
      const int gk = k0 + r, gn = n0 + c;
      Bs[r][c] =
          (gk < K && gn < N) ? static_cast<float>(w[static_cast<size_t>(gk) * N + gn]) : 0.f;
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
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col >= N) continue;
      store(&out[static_cast<size_t>(row) * N + col], __fmul_rn(acc[i][j], scales[col]));
    }
  }
}

template <typename OutT>
int run(const void* x, int x_dtype, const int8_t* w, const float* s, OutT* out, int M, int N,
        int K, cudaStream_t stream) {
  if (x_dtype == kF32) {
    const dim3 grid(cdiv(N, FN), cdiv(M, FM));
    dequant_matmul_f32<OutT><<<grid, THREADS, 0, stream>>>(static_cast<const float*>(x), w, s,
                                                            out, M, N, K);
  } else {
    const dim3 grid(cdiv(N, BN), cdiv(M, BM));
    const bool x_vec = (K % 8 == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0);
    const bool w_vec = (N % 8 == 0) && (reinterpret_cast<uintptr_t>(w) % 8 == 0);
    const auto* xs = static_cast<const uint16_t*>(x);
    if (x_dtype == kBF16)
      dequant_matmul_mma<__nv_bfloat16, OutT><<<grid, THREADS, 0, stream>>>(
          xs, w, s, out, M, N, K, x_vec, w_vec);
    else
      dequant_matmul_mma<__half, OutT><<<grid, THREADS, 0, stream>>>(xs, w, s, out, M, N, K,
                                                                     x_vec, w_vec);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* smelter_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x (M, K) row-major in x_dtype, w (K, N) int8 row-major, scales (N,) f32,
// out (M, N) row-major in out_dtype. Returns a cudaError_t code.
extern "C" int smelter_dequant_matmul(const void* x, const void* w, const void* scales, void* out,
                                      int M, int N, int K, int x_dtype, int out_dtype,
                                      void* stream) {
  const auto* wq = static_cast<const int8_t*>(w);
  const auto* s = static_cast<const float*>(scales);
  auto st = static_cast<cudaStream_t>(stream);
  if (x_dtype != kF32 && x_dtype != kBF16 && x_dtype != kF16)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (out_dtype) {
    case kF32:
      return run(x, x_dtype, wq, s, static_cast<float*>(out), M, N, K, st);
    case kBF16:
      return run(x, x_dtype, wq, s, static_cast<__nv_bfloat16*>(out), M, N, K, st);
    case kF16:
      return run(x, x_dtype, wq, s, static_cast<__half*>(out), M, N, K, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
