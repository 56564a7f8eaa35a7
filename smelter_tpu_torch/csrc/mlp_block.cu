// Whole transformer MLP for Hopper: [LN ->] FC1 + f32 bias -> GELU -> FC2 +
// f32 bias [+ residual].
//
// Replaces the Pallas kernel smelter_tpu/kernels/mlp_block.py::mlp_block,
// which holds an image's (N, D) rows, the f32 hidden (N, F) tile and both
// weights (~9.4 MB at ViT-B) in VMEM and runs the MLP in one program per
// image. A ViT-B image's hidden tile alone (197 x 3072 f32, 2.4 MB) is ten
// times a block's shared memory, so the function is computed here as a
// fixed sequence of this library's own launches on the caller's stream (the
// Python wrapper counts the call once), in the Pallas kernel's arithmetic:
//
//   1. pre-LN (skipped when pre_ln is 0): csrc/layer_norm.cuh, statistics in
//      f32, xn rounded to x's type;
//   2. FC1 xn (M, D) @ w1 (D, F), b1 added to the f32 sum, GELU in f32
//      (the exact form's polynomial or the tanh form), h rounded to x's
//      type;
//   3. FC2 h (M, F) @ w2 (F, D), b2 added in f32, and for residual=1 the
//      input x (not its LN) added in f32, one rounding.
//
// What bounds it on an H100: at ViT-B/16's batch 128 (M 25,216 rows, D 768,
// F 3072) a call does 4 M D F = 238 GFLOP, about 241 us at 989 TFLOP/s
// dense bf16, against ~87 MB of x, weights and output (~26 us at 3.35
// TB/s): the tensor cores. So FC1 and FC2 run on the wgmma GEMM core
// (csrc/wgmma_gemm.cuh's gemm_tma: TMA loads into a ring of stages, two
// consumer warpgroups on wgmma, one persistent CTA an SM) wherever
// kernels/wgmma_plan.py::block_plan says "tma" (16-bit x, aligned, D and F
// multiples of 8, no box past its matrix: M >= 128, K >= 64, N >= 128):
// w1 and w2 are the (K, N) row-major B its map reads, FC1's epilogue adds
// b1 and applies GELU in f32 (kEpiBiasGelu / kEpiBiasGeluTanh, the form a
// template parameter) and FC2's adds b2 and the residual (kEpiBiasRes, or
// kEpiBias). Other shapes take csrc/gemm.cuh's mma.sync GEMM, f32 its
// full-f32 FMA kernel (no TF32), with the same epilogue arithmetic. xn and
// the hidden h (155 MB in bf16 at ViT-B) cross device memory between the
// launches.
#include "gemm.cuh"
#include "wgmma_gemm.cuh"

namespace {

using namespace smelter;

// The launches' forms, as the wrapper's plans give them: 1 gemm_tma on
// `grid` CTAs, 0 csrc/gemm.cuh.
struct Forms {
  int fc1, fc1_grid, fc2, fc2_grid;
};

template <typename T>
int run(const void* x, const void* ln_g, const void* ln_b, const void* w1, const void* b1,
        const void* w2, const void* b2, void* xn, void* h, void* out, int M, int D, int F,
        int pre_ln, int act, int residual, float eps, int p_code, const Forms& f,
        cudaStream_t stream) {
  const T* a = static_cast<const T*>(x);
  if (pre_ln) {
    launch_layer_norm<T>(a, nullptr, ln_g, ln_b, p_code, nullptr, static_cast<T*>(xn), M, D,
                         eps, stream);
    a = static_cast<const T*>(xn);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  int rc = 0;
  if constexpr (std::is_same<T, float>::value) {
    if (f.fc1 || f.fc2) return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (f.fc1)
      rc = wg::launch_tma_gelu<T>(a, w1, b1, p_code == kF32, act, h, M, F, D, f.fc1_grid,
                                  stream);
  }
  if (!f.fc1)
    gemm<T>(a, static_cast<const T*>(w1), b1, p_code, act, nullptr, static_cast<T*>(h), M, F, D,
            F, stream);
  if (rc != 0 || (err = cudaGetLastError()) != cudaSuccess)
    return rc != 0 ? rc : static_cast<int>(err);
  if constexpr (!std::is_same<T, float>::value) {
    if (f.fc2)
      return wg::launch_tma_block<T>(h, w2, 0, b2, p_code == kF32, residual ? x : nullptr, out,
                                     M, D, F, f.fc2_grid, stream);
  }
  gemm<T>(static_cast<const T*>(h), static_cast<const T*>(w2), b2, p_code, kActNone,
          residual ? static_cast<const T*>(x) : nullptr, static_cast<T*>(out), M, D, F, D,
          stream);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* smelter_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x and out (M, D), w1 (D, F), w2 (F, D), scratch xn (M, D) (nullptr when
// pre_ln is 0) and h (M, F), all row-major in x_dtype and 16-byte aligned;
// ln_g, ln_b, b2 (D,) and b1 (F,) in p_dtype (f32 or x_dtype). act: 1 the
// exact GELU, 2 the tanh form. D and F multiples of 8; D <= 4096 under
// pre_ln. fc1 / fc2: 1 runs that product on gemm_tma on fc1_grid / fc2_grid
// CTAs (16-bit x; wgmma_plan.block_plan checks the rest), 0 on gemm.cuh.
// Returns a cudaError_t code.
extern "C" int smelter_mlp_block(const void* x, const void* ln_g, const void* ln_b,
                                 const void* w1, const void* b1, const void* w2, const void* b2,
                                 void* xn, void* h, void* out, int M, int D, int F, int pre_ln,
                                 int act, int residual, float eps, int x_dtype, int p_dtype,
                                 int fc1, int fc1_grid, int fc2, int fc2_grid, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const auto misaligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; };
  if (misaligned(x) || misaligned(w1) || misaligned(w2) || misaligned(h) || misaligned(out) ||
      (pre_ln && misaligned(xn)))
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (D % 8 != 0 || F % 8 != 0 || (pre_ln && D > LN_MAX_D) ||
      (act != kActGeluExact && act != kActGeluTanh) || (p_dtype != kF32 && p_dtype != x_dtype) ||
      fc1 < 0 || fc1 > 1 || fc2 < 0 || fc2 > 1 || (fc1 && fc1_grid <= 0) ||
      (fc2 && fc2_grid <= 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return 0;
  const Forms f{fc1, fc1_grid, fc2, fc2_grid};
  switch (x_dtype) {
    case kF32:
      return run<float>(x, ln_g, ln_b, w1, b1, w2, b2, xn, h, out, M, D, F, pre_ln, act,
                        residual, eps, p_dtype, f, st);
    case kBF16:
      return run<__nv_bfloat16>(x, ln_g, ln_b, w1, b1, w2, b2, xn, h, out, M, D, F, pre_ln, act,
                                residual, eps, p_dtype, f, st);
    case kF16:
      return run<__half>(x, ln_g, ln_b, w1, b1, w2, b2, xn, h, out, M, D, F, pre_ln, act,
                         residual, eps, p_dtype, f, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
