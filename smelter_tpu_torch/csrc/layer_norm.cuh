// Row LayerNorm over the last axis, one warp a row: the body of
// csrc/layer_norm.cu (fused_layer_norm, residual_layer_norm) and the
// pre-LN step of csrc/vit_block.cu.
//
// A lane holds 4 elements of each 128-column chunk of its row in registers
// (chunk i, lane l: columns 128 i + 4 l .. +3), so the row is read from
// device memory once. The statistics follow the Pallas kernels
// (smelter_tpu/kernels/layer_norm.py::_kernel, _res_kernel): in f32, the
// mean first, then the variance as the mean of (x - mean)^2, then
// (x - mean) * rsqrt(var + eps) * gamma + beta, rounded once to the
// output's type. The residual form sums x + skip in f32, rounds the sum to
// x's type, writes it, and normalizes the rounded sum.
#pragma once

#include "common.cuh"

namespace smelter {

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }

// A value of T rounded to nearest even and widened back to f32.
template <typename T> __device__ __forceinline__ float round_to(float v);
template <> __device__ __forceinline__ float round_to<float>(float v) { return v; }
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}
template <> __device__ __forceinline__ float round_to<__half>(float v) {
  return __half2float(__float2half(v));
}

// Element i of a small parameter vector held in f32 or in the activations'
// 16-bit type (`code`, csrc/common.cuh's DType).
__device__ __forceinline__ float param_at(const void* p, int code, size_t i) {
  if (code == kF32) return static_cast<const float*>(p)[i];
  if (code == kBF16) return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  return __half2float(static_cast<const __half*>(p)[i]);
}

// Four consecutive elements (8- or 16-byte aligned) to and from f32.
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 r = *reinterpret_cast<const float4*>(p);
  v[0] = r.x; v[1] = r.y; v[2] = r.z; v[3] = r.w;
}
template <typename T>
__device__ __forceinline__ void load4(const T* p, float (&v)[4]) {
  const uint2 r = *reinterpret_cast<const uint2*>(p);
  const T* e = reinterpret_cast<const T*>(&r);
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = to_float(e[j]);
}
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
template <typename T>
__device__ __forceinline__ void store4(T* p, const float (&v)[4]) {
  uint2 r;
  T* e = reinterpret_cast<T*>(&r);
#pragma unroll
  for (int j = 0; j < 4; ++j) store(&e[j], v[j]);
  *reinterpret_cast<uint2*>(p) = r;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

constexpr int LN_ROWS = 8;  // rows (warps) a block

// out = LN(x) (skip == nullptr) or, with skip, sum_out = round(x + skip)
// and out = LN(sum_out). x, skip, sum_out, out (M, D) row-major in T;
// gamma (D,) and beta (D,) or nullptr in `p_code`. D % 4 == 0 and
// D <= 128 * MAXV.
template <typename T, int MAXV>
__global__ void __launch_bounds__(32 * LN_ROWS)
layer_norm_rows(const T* __restrict__ x, const T* __restrict__ skip,
                const void* __restrict__ gamma, const void* __restrict__ beta, int p_code,
                T* __restrict__ sum_out, T* __restrict__ out, int M, int D, float eps) {
  const int row = blockIdx.x * LN_ROWS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const size_t base = static_cast<size_t>(row) * D;
  float v[MAXV][4];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < MAXV; ++i) {
    const int c = i * 128 + lane * 4;
    if (c < D) {
      load4(x + base + c, v[i]);
      if (skip != nullptr) {
        float s[4];
        load4(skip + base + c, s);
#pragma unroll
        for (int j = 0; j < 4; ++j) v[i][j] = round_to<T>(v[i][j] + s[j]);
        store4(sum_out + base + c, v[i]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) sum += v[i][j];
    }
  }
  const float mu = warp_sum(sum) / static_cast<float>(D);
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < MAXV; ++i) {
    if (i * 128 + lane * 4 < D) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[i][j] -= mu;
        sq += v[i][j] * v[i][j];
      }
    }
  }
  const float r = rsqrtf(warp_sum(sq) / static_cast<float>(D) + eps);
#pragma unroll
  for (int i = 0; i < MAXV; ++i) {
    const int c = i * 128 + lane * 4;
    if (c < D) {
      float y[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float b = beta != nullptr ? param_at(beta, p_code, c + j) : 0.f;
        y[j] = v[i][j] * r * param_at(gamma, p_code, c + j) + b;
      }
      store4(out + base + c, y);
    }
  }
}

// Largest row length the register-held rows take.
constexpr int LN_MAX_D = 128 * 32;

template <typename T>
inline void launch_layer_norm(const T* x, const T* skip, const void* gamma, const void* beta,
                              int p_code, T* sum_out, T* out, int M, int D, float eps,
                              cudaStream_t stream) {
  const dim3 grid(cdiv(M, LN_ROWS)), block(32 * LN_ROWS);
  if (D <= 128 * 4)
    layer_norm_rows<T, 4><<<grid, block, 0, stream>>>(x, skip, gamma, beta, p_code, sum_out,
                                                      out, M, D, eps);
  else if (D <= 128 * 8)
    layer_norm_rows<T, 8><<<grid, block, 0, stream>>>(x, skip, gamma, beta, p_code, sum_out,
                                                      out, M, D, eps);
  else if (D <= 128 * 16)
    layer_norm_rows<T, 16><<<grid, block, 0, stream>>>(x, skip, gamma, beta, p_code, sum_out,
                                                       out, M, D, eps);
  else
    layer_norm_rows<T, 32><<<grid, block, 0, stream>>>(x, skip, gamma, beta, p_code, sum_out,
                                                       out, M, D, eps);
}

}  // namespace smelter
