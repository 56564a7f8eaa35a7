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
enum DType : int { kF32 = 0, kBF16 = 1, kF16 = 2, kI32 = 3 };

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

// Four 8x8 b16 matrices from shared memory, transposed: the B operand of
// mma.m16n8k16 for two n8 tiles from a row-major [k][n] tile.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* smem) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

}  // namespace smelter

extern "C" const char* smelter_error_string(int code);
