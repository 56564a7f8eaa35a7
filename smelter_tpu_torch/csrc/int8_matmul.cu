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
// Design: the int8 forms of the wgmma GEMM core (csrc/wgmma_gemm.cuh), which
// smelter_tpu_torch/kernels/wgmma_plan.py::int8_plan picks from the shape:
//
// - tma (many output tiles; K % 16 == 0, N % 16 == 0, aligned bases): the
//   persistent warp-specialised gemm_tma_s8, 128 W columns x 128 x rows a
//   tile, K steps of 128 bytes by TMA into 7 mbarrier-guarded stages.
//   8-bit wgmma reads its shared operands K-major only and W (K, N) is not,
//   so the product runs transposed: W^T is the register A operand of
//   wgmma.m64n128k32.s32.s8.s8, each consumer thread gathering its fragment
//   from the W box with 2-byte loads and byte permutes; x's box is B.
// - cluster (few tiles, e.g. the head's 16, or any shape): gemm_cluster_s8,
//   128 x 64 tiles, operands through registers into shared memory (W
//   transposed on the way), SS wgmma.m64n64k32, K split over a cluster of up
//   to 8 CTAs summed in rank order through distributed shared memory: the
//   head runs 16 N tiles x 8 = 128 CTAs of 2 K steps each.
//
// The int32 sum is exact; the epilogue computes float(acc) * s_row * s_col
// in that order and rounds once (or writes the raw int32 sum). The earlier
// mma.sync.m16n8k32 kernel on 128 x 128 tiles took 0.0537 ms at the head and
// 1.1821 ms at the serving GEMM (NVIDIA H100 80GB HBM3, 700 W; PERF.md row 2).
#include "wgmma_gemm.cuh"

namespace {

using namespace smelter;

template <typename OutT>
int run(const int8_t* x, const int8_t* w, const float* sr, const float* sc, void* out, int M,
        int N, int K, int form, int split, int k_chunk, int grid, cudaStream_t stream) {
  if (form == wg::kFormTma && grid > 0)
    return wg::launch_tma_s8<OutT>(x, w, sr, sc, out, M, N, K, grid, stream);
  if (form == wg::kFormCluster && split >= 1 && split <= 8 && k_chunk > 0 &&
      k_chunk % wg::S8_BK == 0)
    return wg::launch_cluster_s8<OutT>(x, w, sr, sc, out, M, N, K, split, k_chunk, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" const char* smelter_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x_q (M, K) int8, w_q (K, N) int8, both row-major; s_row (M,) f32,
// s_col (N,) f32; out (M, N) row-major in out_dtype (kI32: the raw sum);
// form, split, k_chunk and grid are kernels/wgmma_plan.py's int8_plan.
// Returns a cudaError_t code.
extern "C" int smelter_int8_matmul(const void* x_q, const void* w_q, const void* s_row,
                                   const void* s_col, void* out, int M, int N, int K,
                                   int out_dtype, int form, int split, int k_chunk, int grid,
                                   void* stream) {
  const auto* x = static_cast<const int8_t*>(x_q);
  const auto* w = static_cast<const int8_t*>(w_q);
  const auto* sr = static_cast<const float*>(s_row);
  const auto* sc = static_cast<const float*>(s_col);
  auto st = static_cast<cudaStream_t>(stream);
  switch (out_dtype) {
    case kF32: return run<float>(x, w, sr, sc, out, M, N, K, form, split, k_chunk, grid, st);
    case kBF16:
      return run<__nv_bfloat16>(x, w, sr, sc, out, M, N, K, form, split, k_chunk, grid, st);
    case kF16: return run<__half>(x, w, sr, sc, out, M, N, K, form, split, k_chunk, grid, st);
    case kI32: return run<int>(x, w, sr, sc, out, M, N, K, form, split, k_chunk, grid, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
