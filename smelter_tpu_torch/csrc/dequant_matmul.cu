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
// Design: bf16/f16 x runs on csrc/wgmma_gemm.cuh, in one of two forms that
// smelter_tpu_torch/kernels/wgmma_plan.py picks from (M, N, K) alone:
//
// - tma (many output tiles; K % 8 == 0, N % 16 == 0): the persistent
//   warp-specialised kernel gemm_tma_ra, 128 x 128 tiles. x and the int8 W
//   tile land by TMA (W as it lies: it crosses HBM as int8 only). The form
//   of a mixed-input GEMM chosen here is "W^T as wgmma's register A
//   operand": each consumer thread converts its A-fragment bytes of W,
//   exactly, in registers, and x's tile is B. The other form, converting W
//   in shared memory into a bf16/f16 tile that wgmma reads as its B, writes
//   W back to shared memory in 16 bits and reads it again: 96 KB through
//   shared memory a K step against 64.
// - cluster (few output tiles, e.g. the head's 8; or any unaligned shape):
//   128 x 64 tiles with K split over a cluster of S <= 8 CTAs, S = min(8,
//   SMs / tiles, K steps): the head runs 16 N tiles x 8 = 128 CTAs, each
//   walking 4 K steps instead of one CTA walking 32. The f32 partials are
//   summed in rank order through distributed shared memory, then scaled and
//   cast once: one launch, no workspace, bit-equal from call to call.
//
// The scale multiplies the f32 sum once, after the whole K sum, then the
// result is cast. f32 activations take an FMA kernel in full f32 (no TF32),
// because the reference computes in the activation dtype.
//
// The earlier 128 x 128 mma.sync kernel (registers for the next step, no
// cp.async, TMA or split) took 0.0595 ms at the head and 1.4349 ms at the
// serving GEMM (NVIDIA H100 80GB HBM3, 700 W; PERF.md row 1).
#include "wgmma_gemm.cuh"

namespace {

using namespace smelter;

constexpr int THREADS = 256;

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

template <typename T>
int run16(const void* x, const int8_t* w, const float* s, void* out, int out_dtype, int M, int N,
          int K, int form, int bn, int split, int k_chunk, int grid, cudaStream_t stream) {
  if (form == wg::kFormTma && bn == wg::RA_BW)
    return wg::launch_tma_ra<T>(x, w, s, out, out_dtype, M, N, K, grid, stream);
  if (form == wg::kFormCluster && bn == wg::CL_BN && split >= 1 && split <= 8 && k_chunk > 0 &&
      k_chunk % wg::BK == 0)
    return wg::launch_cluster<T, true>(x, w, s, nullptr, out, out_dtype, M, N, K, split,
                                          k_chunk, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename OutT>
int run_f32(const float* x, const int8_t* w, const float* s, OutT* out, int M, int N, int K,
            cudaStream_t stream) {
  const dim3 grid(cdiv(N, FN), cdiv(M, FM));
  dequant_matmul_f32<OutT><<<grid, THREADS, 0, stream>>>(x, w, s, out, M, N, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* smelter_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x (M, K) row-major in x_dtype, w (K, N) int8 row-major, scales (N,) f32,
// out (M, N) row-major in out_dtype; form, bn, split, k_chunk and grid are
// kernels/wgmma_plan.py's plan (read for 16-bit x only). Returns a
// cudaError_t code.
extern "C" int smelter_dequant_matmul(const void* x, const void* w, const void* scales, void* out,
                                      int M, int N, int K, int x_dtype, int out_dtype, int form,
                                      int bn, int split, int k_chunk, int grid, void* stream) {
  const auto* wq = static_cast<const int8_t*>(w);
  const auto* s = static_cast<const float*>(scales);
  auto st = static_cast<cudaStream_t>(stream);
  if (out_dtype != kF32 && out_dtype != kBF16 && out_dtype != kF16)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (x_dtype) {
    case kF32: {
      const auto* xf = static_cast<const float*>(x);
      if (out_dtype == kF32) return run_f32(xf, wq, s, static_cast<float*>(out), M, N, K, st);
      if (out_dtype == kBF16)
        return run_f32(xf, wq, s, static_cast<__nv_bfloat16*>(out), M, N, K, st);
      return run_f32(xf, wq, s, static_cast<__half*>(out), M, N, K, st);
    }
    case kBF16:
      return run16<__nv_bfloat16>(x, wq, s, out, out_dtype, M, N, K, form, bn, split, k_chunk,
                                  grid, st);
    case kF16:
      return run16<__half>(x, wq, s, out, out_dtype, M, N, K, form, bn, split, k_chunk, grid, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
