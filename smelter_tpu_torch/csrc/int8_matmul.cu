// int8 x int8 -> int32 matmul with a scaled epilogue, for Hopper:
// out = float(x_q @ w_q) * s_row[m] * s_col[n].
//
// Replaces smelter_tpu/kernels/int8_matmul.py::_int8_matmul_impl, the Pallas
// kernel that runs the int8 MXU over per-row quantized activations and
// applies the row and column scales once, after the K loop.
//
// What bounds it on an H100: at the ResNet-50 head (M 128, K 2048, N 1000)
// the bytes are ~2.6 MB, so HBM bounds it (~0.77 us at 3.35 TB/s); at the
// serving GEMM (M 8192, K 4096, N 4096) the int8 tensor cores bound it
// (~139 us at 1,979 TOP/s).
//
// Design, simple first: one 128x128 output tile per block of 8 warps, each
// warp a 32x64 sub-tile of mma.sync.m16n8k32 (s8 x s8 -> s32). Per K step of
// 64 bytes the block copies the activation tile to shared memory as it is
// ([m][k]), and lays the weight tile out for the B fragment: W is (K, N)
// row-major, so each thread reads 4x4 byte blocks, transposes them in
// registers with byte permutes and stores them as [n][k]. Both fragments
// are then plain 32-bit shared loads. The next step's tiles are loaded into
// registers while the tensor cores work on the current one. The int32
// accumulator stays in registers; the epilogue computes
// float(acc) * s_row * s_col in that order, then casts (or writes the raw
// int32 sum, for exact checks). M, N and K edges are masked on both
// operands. A small problem leaves SMs idle (the ResNet head makes 8 output
// tiles for 132 SMs); no split-K, cp.async, TMA or wgmma yet.
#include "common.cuh"

#include <type_traits>

namespace {

using namespace smelter;

constexpr int BM = 128, BN = 128, BK = 64, THREADS = 256;
constexpr int SA = BK + 16;  // bytes per activation row in shared memory
constexpr int SB = BK + 16;  // bytes per weight column ([n][k]) in shared memory
constexpr int A_CHUNKS = BM * BK / 16 / THREADS;        // 16-byte chunks a thread loads
constexpr int B_BLOCKS = (BK / 4) * (BN / 4) / THREADS;  // 4x4 byte blocks a thread loads

__device__ __forceinline__ uint32_t load_byte(const int8_t* p) {
  return static_cast<uint32_t>(static_cast<uint8_t>(*p));
}

template <typename OutT>
__device__ __forceinline__ void epilogue(OutT* p, int acc, float sr, float sc) {
  if constexpr (std::is_same<OutT, int>::value) {
    *p = acc;
  } else {
    store(p, __fmul_rn(__fmul_rn(__int2float_rn(acc), sr), sc));
  }
}

template <typename OutT>
__global__ void __launch_bounds__(THREADS)
int8_matmul_mma(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                const float* __restrict__ s_row, const float* __restrict__ s_col,
                OutT* __restrict__ out, int M, int N, int K, bool x_vec, bool w_vec) {
  __shared__ __align__(16) int8_t As[BM * SA];  // [m][k]
  __shared__ __align__(16) int8_t Bs[BN * SB];  // [n][k]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 64;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  int acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

  uint4 ra[A_CHUNKS];
  uint32_t rb[B_BLOCKS][4];

  // Global -> registers for the K step at k0, zero outside [0, M) x [0, K).
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < A_CHUNKS; ++i) {
      const int c = tid + i * THREADS;
      const int r = c / (BK / 16), col = (c % (BK / 16)) * 16;
      const int gm = m0 + r, gk = k0 + col;
      if (x_vec && gm < M && gk + 16 <= K) {
        ra[i] = *reinterpret_cast<const uint4*>(x + static_cast<size_t>(gm) * K + gk);
      } else {
        uint32_t e[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int j = 0; j < 16; ++j)
          if (gm < M && gk + j < K)
            e[j >> 2] |= load_byte(x + static_cast<size_t>(gm) * K + gk + j) << (8 * (j & 3));
        ra[i] = make_uint4(e[0], e[1], e[2], e[3]);
      }
    }
#pragma unroll
    for (int b = 0; b < B_BLOCKS; ++b) {
      const int c = tid + b * THREADS;
      const int kb = c / (BN / 4), nb = c % (BN / 4);
      const int gk = k0 + kb * 4, gn = n0 + nb * 4;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int8_t* row = w + static_cast<size_t>(gk + i) * N + gn;
        if (w_vec && gk + i < K && gn + 4 <= N) {
          rb[b][i] = *reinterpret_cast<const uint32_t*>(row);
        } else {
          rb[b][i] = 0u;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (gk + i < K && gn + j < N) rb[b][i] |= load_byte(row + j) << (8 * j);
        }
      }
    }
  };
  // Registers -> shared memory; the weight blocks transposed into [n][k].
  auto stash = [&]() {
#pragma unroll
    for (int i = 0; i < A_CHUNKS; ++i) {
      const int c = tid + i * THREADS;
      *reinterpret_cast<uint4*>(&As[(c / (BK / 16)) * SA + (c % (BK / 16)) * 16]) = ra[i];
    }
#pragma unroll
    for (int b = 0; b < B_BLOCKS; ++b) {
      const int c = tid + b * THREADS;
      const int kb = c / (BN / 4), nb = c % (BN / 4);
      // rb[b][i] holds bytes (k+i, n..n+3); col[j] gets bytes (k..k+3, n+j).
      const uint32_t t0 = __byte_perm(rb[b][0], rb[b][1], 0x5140);
      const uint32_t t1 = __byte_perm(rb[b][0], rb[b][1], 0x7362);
      const uint32_t t2 = __byte_perm(rb[b][2], rb[b][3], 0x5140);
      const uint32_t t3 = __byte_perm(rb[b][2], rb[b][3], 0x7362);
      const uint32_t col[4] = {__byte_perm(t0, t2, 0x5410), __byte_perm(t0, t2, 0x7632),
                               __byte_perm(t1, t3, 0x5410), __byte_perm(t1, t3, 0x7632)};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<uint32_t*>(&Bs[(nb * 4 + j) * SB + kb * 4]) = col[j];
    }
  };

  if (K > 0) load(0);
  for (int k0 = 0; k0 < K; k0 += BK) {
    stash();
    __syncthreads();
    if (k0 + BK < K) load(k0 + BK);  // in flight while the tensor cores work
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t a[2][4], b[8][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int8_t* pa = &As[(wm + mi * 16 + g) * SA + kk + t * 4];
        a[mi][0] = *reinterpret_cast<const uint32_t*>(pa);
        a[mi][1] = *reinterpret_cast<const uint32_t*>(pa + 8 * SA);
        a[mi][2] = *reinterpret_cast<const uint32_t*>(pa + 16);
        a[mi][3] = *reinterpret_cast<const uint32_t*>(pa + 8 * SA + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const int8_t* pb = &Bs[(wn + ni * 8 + g) * SB + kk + t * 4];
        b[ni][0] = *reinterpret_cast<const uint32_t*>(pb);
        b[ni][1] = *reinterpret_cast<const uint32_t*>(pb + 16);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 8; ++ni) mma_16832_s8(acc[mi][ni], a[mi], b[ni]);
    }
    __syncthreads();
  }

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
          epilogue(&out[static_cast<size_t>(row) * N + col + j], acc[mi][ni][h * 2 + j],
                   s_row[row], s_col[col + j]);
        }
      }
    }
}

template <typename OutT>
int launch(const int8_t* x, const int8_t* w, const float* sr, const float* sc, void* out, int M,
           int N, int K, cudaStream_t stream) {
  const dim3 grid(cdiv(N, BN), cdiv(M, BM));
  const bool x_vec = (K % 16 == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0);
  const bool w_vec = (N % 4 == 0) && (reinterpret_cast<uintptr_t>(w) % 4 == 0);
  int8_matmul_mma<OutT><<<grid, THREADS, 0, stream>>>(x, w, sr, sc, static_cast<OutT*>(out), M,
                                                      N, K, x_vec, w_vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* smelter_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x_q (M, K) int8, w_q (K, N) int8, both row-major; s_row (M,) f32,
// s_col (N,) f32; out (M, N) row-major in out_dtype (kI32: the raw sum).
// Returns a cudaError_t code.
extern "C" int smelter_int8_matmul(const void* x_q, const void* w_q, const void* s_row,
                                   const void* s_col, void* out, int M, int N, int K,
                                   int out_dtype, void* stream) {
  const auto* x = static_cast<const int8_t*>(x_q);
  const auto* w = static_cast<const int8_t*>(w_q);
  const auto* sr = static_cast<const float*>(s_row);
  const auto* sc = static_cast<const float*>(s_col);
  auto st = static_cast<cudaStream_t>(stream);
  switch (out_dtype) {
    case kF32: return launch<float>(x, w, sr, sc, out, M, N, K, st);
    case kBF16: return launch<__nv_bfloat16>(x, w, sr, sc, out, M, N, K, st);
    case kF16: return launch<__half>(x, w, sr, sc, out, M, N, K, st);
    case kI32: return launch<int>(x, w, sr, sc, out, M, N, K, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
