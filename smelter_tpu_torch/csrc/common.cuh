// Shared helpers for the port's Hopper kernels (sm_90a).
//
// Every kernel library exposes a plain C interface: pointers and the CUDA
// stream arrive as void*, sizes as int, element types as the codes below.
// Each entry point launches on the caller's stream, never synchronises,
// allocates nothing, and returns cudaGetLastError() so the Python wrapper
// can raise on a refused launch.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace smelter {

// Element-type codes shared with smelter_tpu_torch/kernels/_build.py.
enum DType : int { kF32 = 0, kBF16 = 1, kF16 = 2, kI32 = 3, kI8 = 4 };

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }
__device__ __forceinline__ void store(__half* p, float v) { *p = __float2half(v); }

// Bit pattern of a small integer (|v| <= 128, exact in both types) as a
// 16-bit float of type T.
template <typename T> __device__ __forceinline__ uint16_t int_bits(int v);
template <> __device__ __forceinline__ uint16_t int_bits<__nv_bfloat16>(int v) {
  return __bfloat16_as_ushort(__float2bfloat16(static_cast<float>(v)));
}
template <> __device__ __forceinline__ uint16_t int_bits<__half>(int v) {
  return __half_as_ushort(__float2half(static_cast<float>(v)));
}

// D += A * B on one m16n8k16 tile with f32 accumulation.
template <typename T>
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          const uint32_t (&b)[2]);
template <>
__device__ __forceinline__ void mma_16816<__nv_bfloat16>(float (&d)[4], const uint32_t (&a)[4],
                                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
template <>
__device__ __forceinline__ void mma_16816<__half>(float (&d)[4], const uint32_t (&a)[4],
                                                  const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// D += A * B on one m16n8k32 tile of int8 with int32 accumulation.
__device__ __forceinline__ void mma_16832_s8(int (&d)[4], const uint32_t (&a)[4],
                                             const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Four 8x8 b16 matrices from shared memory: the A operand of m16n8k16 from
// a row-major [m][k] tile (or the B operand of two n8 tiles from [n][k]).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* smem) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// Four 8x8 b16 matrices from shared memory, transposed: the B operand of
// mma.m16n8k16 for two n8 tiles from a row-major [k][n] tile.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* smem) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// Activations of the GEMM epilogues (csrc/gemm.cuh, csrc/wgmma_gemm.cuh),
// in f32: GELU's exact form as the Pallas MLP kernel spells it
// (smelter_tpu/kernels/mlp_block.py::_mlp_kernel: the Abramowitz-Stegun
// 7.1.26 polynomial over exp), or the tanh form.
enum Activation : int { kActNone = 0, kActGeluExact = 1, kActGeluTanh = 2 };

__device__ __forceinline__ float activate(float h, int act) {
  if (act == kActGeluTanh)
    return 0.5f * h * (1.f + tanhf(0.7978845608028654f * (h + 0.044715f * h * h * h)));
  if (act == kActGeluExact) {
    const float z = h * 0.7071067811865476f;
    const float az = fabsf(z);
    const float t = 1.f / (1.f + 0.3275911f * az);
    const float poly =
        t * (0.254829592f +
             t * (-0.284496736f + t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
    const float erf_abs = 1.f - poly * expf(-az * az);
    const float erf = z > 0.f ? erf_abs : (z < 0.f ? -erf_abs : 0.f);
    return 0.5f * h * (1.f + erf);
  }
  return h;
}

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

}  // namespace smelter

extern "C" const char* smelter_error_string(int code);
