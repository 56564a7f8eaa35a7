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
// are then plain 32-bit shared loads (those pieces are int8_gemm.cuh's,
// shared with int8_matmul_fused.cu). The next step's tiles are loaded into
// registers while the tensor cores work on the current one. The int32
// accumulator stays in registers; the epilogue computes
// float(acc) * s_row * s_col in that order, then casts (or writes the raw
// int32 sum, for exact checks). M, N and K edges are masked on both
// operands. A small problem leaves SMs idle (the ResNet head makes 8 output
// tiles for 132 SMs); no split-K, cp.async, TMA or wgmma yet.
#include "int8_gemm.cuh"

namespace {

using namespace smelter;
using i8::BK;
using i8::SK;

constexpr int BM = 128, BN = 128, THREADS = 256;
constexpr int A_CHUNKS = BM * BK / 16 / THREADS;  // 16-byte chunks a thread loads

template <typename OutT>
__global__ void __launch_bounds__(THREADS)
int8_matmul_mma(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                const float* __restrict__ s_row, const float* __restrict__ s_col,
                OutT* __restrict__ out, int M, int N, int K, bool x_vec, bool w_vec) {
  __shared__ __align__(16) int8_t As[BM * SK];  // [m][k]
  __shared__ __align__(16) int8_t Bs[BN * SK];  // [n][k]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 64;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  int acc[2][8][4];
  i8::zero(acc);
  uint4 ra[A_CHUNKS];
  i8::WTile<BN, THREADS> wt;

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
            e[j >> 2] |= i8::load_byte(x + static_cast<size_t>(gm) * K + gk + j) << (8 * (j & 3));
        ra[i] = make_uint4(e[0], e[1], e[2], e[3]);
      }
    }
    wt.load(w, K, N, k0, n0, w_vec, tid);
  };

  if (K > 0) load(0);
  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int i = 0; i < A_CHUNKS; ++i) {
      const int c = tid + i * THREADS;
      *reinterpret_cast<uint4*>(&As[(c / (BK / 16)) * SK + (c % (BK / 16)) * 16]) = ra[i];
    }
    wt.stash(Bs, tid);
    __syncthreads();
    if (k0 + BK < K) load(k0 + BK);  // in flight while the tensor cores work
    i8::mma_step(acc, &As[wm * SK], SK, Bs, wn, lane);
    __syncthreads();
  }
  i8::store_tile(out, acc, s_row, s_col, M, N, m0 + wm, n0 + wn, lane);
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
