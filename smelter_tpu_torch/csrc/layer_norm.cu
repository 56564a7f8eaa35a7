// LayerNorm over the last axis for Hopper, plain and with a residual add.
//
// Replaces the Pallas kernels smelter_tpu/kernels/layer_norm.py::
// _layer_norm_impl (fused_layer_norm) and ::_residual_layer_norm_impl
// (residual_layer_norm), which read each row tile into VMEM once, reduce on
// the VPU in f32 and write the normalized tile: one HBM pass.
//
// What bounds it on an H100: the bytes. At ViT-B/16's batch 128 (M 25,216
// rows of D 768, bf16) the plain form moves x in and y out, 77.5 MB, about
// 23 us at 3.35 TB/s; the residual form x and skip in, the sum and y out,
// 154.9 MB, about 46 us. The arithmetic (~10 operations an element) is far
// below the tensor-free f32 rate.
//
// Design, simple first: one warp a row, the row held in registers
// (csrc/layer_norm.cuh), so every element crosses HBM once each way; loads
// and stores are 8 bytes a lane (16 for f32), neighbouring lanes on
// neighbouring addresses. Eight rows a block of 256 threads; no shared
// memory. gamma and beta stay in f32 or the activations' type as given and
// are read through the caches.
#include "layer_norm.cuh"

namespace {

using namespace smelter;

template <typename T>
int run(const void* x, const void* skip, const void* gamma, const void* beta, int p_code,
        void* sum_out, void* out, int M, int D, float eps, cudaStream_t stream) {
  launch_layer_norm<T>(static_cast<const T*>(x), static_cast<const T*>(skip), gamma, beta,
                       p_code, static_cast<T*>(sum_out), static_cast<T*>(out), M, D, eps,
                       stream);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* smelter_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x (M, D) row-major in x_dtype; skip and sum_out (M, D) in x_dtype, both
// nullptr for the plain form; gamma (D,) and beta (D,) or nullptr in
// p_dtype (f32 or x_dtype); out (M, D) in x_dtype. D % 4 == 0, D <= 4096,
// rows 8- or 16-byte aligned. Returns a cudaError_t code.
extern "C" int smelter_layer_norm(const void* x, const void* skip, const void* gamma,
                                  const void* beta, void* sum_out, void* out, int M, int D,
                                  float eps, int x_dtype, int p_dtype, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (D % 4 != 0 || D > LN_MAX_D || (p_dtype != kF32 && p_dtype != x_dtype) ||
      (skip == nullptr) != (sum_out == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return 0;
  switch (x_dtype) {
    case kF32:
      return run<float>(x, skip, gamma, beta, p_dtype, sum_out, out, M, D, eps, st);
    case kBF16:
      return run<__nv_bfloat16>(x, skip, gamma, beta, p_dtype, sum_out, out, M, D, eps, st);
    case kF16:
      return run<__half>(x, skip, gamma, beta, p_dtype, sum_out, out, M, D, eps, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
