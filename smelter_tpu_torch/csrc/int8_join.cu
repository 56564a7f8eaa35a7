// The residual join of an int8-static network in one pass (sm_90a):
//   r = relu(f32(a) * s_a + f32(b) * s_b)
//   out = clip(rint(r * inv_y), -128, 127) as int8, or r itself as f32,
// over two int8 tensors of one shape and one memory layout (a conv's int8
// output and the block's int8 carry), each product, the sum and the last
// product rounded to f32 on their own (__fmul_rn, __fadd_rn: no
// contraction into a fused multiply-add), as the port's DequantizeLinear,
// Add, Relu and QuantizeLinear lowerings round them one op at a time.
//
// Replaces no Pallas kernel. It stands in for the fusion XLA makes of the
// JAX package's DequantizeLinear, DequantizeLinear -> Add -> Relu [->
// QuantizeLinear] chain under jit (smelter_tpu/quant/static_quant.py::
// _requantize_carries: "the dequant->add->relu->quant chain fuses into one
// int8-in/int8-out XLA kernel"), which the port's eager walk would run as
// about ten elementwise launches and ~75 bytes of HBM traffic an element.
//
// What bounds it on an H100: the bytes, 2 read and 1 written an element
// (int8 out) or 2 read and 4 written (f32 out); a few f32 operations an
// element. The design: a grid-stride loop in which a thread reads 16
// elements of each input with one 16-byte load apiece and writes 16 bytes
// of int8 (or four 16-byte stores of f32); a scalar loop takes the tail
// and, where a base is not 16-byte aligned, every element.
#include "common.cuh"

namespace {

using namespace smelter;

constexpr int THREADS = 256;

__device__ __forceinline__ float join(int8_t a, int8_t b, float sa, float sb) {
  const float r = __fadd_rn(__fmul_rn(static_cast<float>(a), sa),
                            __fmul_rn(static_cast<float>(b), sb));
  return fmaxf(r, 0.f);
}

__device__ __forceinline__ int8_t requant(float r, float inv) {
  return static_cast<int8_t>(__float2int_rn(fminf(fmaxf(rintf(__fmul_rn(r, inv)), -128.f), 127.f)));
}

template <bool F32_OUT>
__global__ void __launch_bounds__(THREADS)
int8_join_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b, float sa, float sb,
                 float inv, void* __restrict__ out, long long n, bool vec) {
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  const long long tid = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  long long done = 0;
  if (vec) {
    const long long chunks = n / 16;
    for (long long i = tid; i < chunks; i += stride) {
      union {
        uint4 v;
        int8_t e[16];
      } va, vb;
      va.v = reinterpret_cast<const uint4*>(a)[i];
      vb.v = reinterpret_cast<const uint4*>(b)[i];
      if constexpr (F32_OUT) {
        float4* o = reinterpret_cast<float4*>(out) + 4 * i;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          o[q] = make_float4(join(va.e[4 * q], vb.e[4 * q], sa, sb),
                             join(va.e[4 * q + 1], vb.e[4 * q + 1], sa, sb),
                             join(va.e[4 * q + 2], vb.e[4 * q + 2], sa, sb),
                             join(va.e[4 * q + 3], vb.e[4 * q + 3], sa, sb));
      } else {
        union {
          uint4 v;
          int8_t e[16];
        } vo;
#pragma unroll
        for (int q = 0; q < 16; ++q) vo.e[q] = requant(join(va.e[q], vb.e[q], sa, sb), inv);
        reinterpret_cast<uint4*>(out)[i] = vo.v;
      }
    }
    done = chunks * 16;
  }
  for (long long i = done + tid; i < n; i += stride) {
    const float r = join(a[i], b[i], sa, sb);
    if constexpr (F32_OUT)
      static_cast<float*>(out)[i] = r;
    else
      static_cast<int8_t*>(out)[i] = requant(r, inv);
  }
}

}  // namespace

extern "C" const char* smelter_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// a, b (n,) int8 and out (n,) int8 (f32_out 0) or f32 (f32_out 1), each
// the dense storage of tensors of one shape and one layout; sa, sb the
// inputs' scales, inv the output's reciprocal scale (int8 out); `blocks`
// CTAs of 256 threads. Returns a cudaError_t code.
extern "C" int smelter_int8_join(const void* a, const void* b, void* out, long long n, float sa,
                                 float sb, float inv, int f32_out, int blocks, void* stream) {
  if (n <= 0) return 0;
  const bool vec = reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(b) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const auto* pa = static_cast<const int8_t*>(a);
  const auto* pb = static_cast<const int8_t*>(b);
  const auto s = static_cast<cudaStream_t>(stream);
  if (f32_out)
    int8_join_kernel<true><<<blocks, THREADS, 0, s>>>(pa, pb, sa, sb, inv, out, n, vec);
  else
    int8_join_kernel<false><<<blocks, THREADS, 0, s>>>(pa, pb, sa, sb, inv, out, n, vec);
  return static_cast<int>(cudaGetLastError());
}
