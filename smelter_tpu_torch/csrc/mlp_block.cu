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
//   2. FC1 xn (M, D) @ w1 (D, F) on csrc/gemm.cuh's mma.sync GEMM, b1
//      added to the f32 sum, GELU in f32 (the exact form's polynomial or
//      the tanh form), h rounded to x's type;
//   3. FC2 h (M, F) @ w2 (F, D), b2 added in f32, and for residual=1 the
//      input x (not its LN) added in f32, one rounding.
//
// f32 activations take the GEMM's full-f32 FMA kernel (no TF32).
//
// What bounds it on an H100: at ViT-B/16's batch 128 (M 25,216 rows, D 768,
// F 3072) a call does 4 M D F = 238 GFLOP, about 241 us at 989 TFLOP/s
// dense bf16, against ~87 MB of x, weights and output (~26 us at 3.35
// TB/s): the tensor cores. The simple design keeps mma.sync's rate at
// best; xn and the hidden h (155 MB in bf16 at ViT-B) cross device memory
// between the launches. No TMA or wgmma yet.
#include "gemm.cuh"

namespace {

using namespace smelter;

template <typename T>
int run(const void* x, const void* ln_g, const void* ln_b, const void* w1, const void* b1,
        const void* w2, const void* b2, void* xn, void* h, void* out, int M, int D, int F,
        int pre_ln, int act, int residual, float eps, int p_code, cudaStream_t stream) {
  const T* a = static_cast<const T*>(x);
  if (pre_ln) {
    launch_layer_norm<T>(a, nullptr, ln_g, ln_b, p_code, nullptr, static_cast<T*>(xn), M, D,
                         eps, stream);
    a = static_cast<const T*>(xn);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  gemm<T>(a, static_cast<const T*>(w1), b1, p_code, act, nullptr, static_cast<T*>(h), M, F, D,
          F, stream);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
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
// pre_ln.
// Returns a cudaError_t code.
extern "C" int smelter_mlp_block(const void* x, const void* ln_g, const void* ln_b,
                                 const void* w1, const void* b1, const void* w2, const void* b2,
                                 void* xn, void* h, void* out, int M, int D, int F, int pre_ln,
                                 int act, int residual, float eps, int x_dtype, int p_dtype,
                                 void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const auto misaligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; };
  if (misaligned(x) || misaligned(w1) || misaligned(w2) || misaligned(h) || misaligned(out) ||
      (pre_ln && misaligned(xn)))
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (D % 8 != 0 || F % 8 != 0 || (pre_ln && D > LN_MAX_D) ||
      (act != kActGeluExact && act != kActGeluTanh) || (p_dtype != kF32 && p_dtype != x_dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return 0;
  switch (x_dtype) {
    case kF32:
      return run<float>(x, ln_g, ln_b, w1, b1, w2, b2, xn, h, out, M, D, F, pre_ln, act,
                        residual, eps, p_dtype, st);
    case kBF16:
      return run<__nv_bfloat16>(x, ln_g, ln_b, w1, b1, w2, b2, xn, h, out, M, D, F, pre_ln, act,
                                residual, eps, p_dtype, st);
    case kF16:
      return run<__half>(x, ln_g, ln_b, w1, b1, w2, b2, xn, h, out, M, D, F, pre_ln, act,
                         residual, eps, p_dtype, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
