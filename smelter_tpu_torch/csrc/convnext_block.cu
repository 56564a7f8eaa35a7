// Whole ConvNeXt block for Hopper: depthwise 7x7 (+ f32 bias) -> LayerNorm
// over C -> FC1 + f32 bias -> exact GELU -> FC2 + f32 bias -> * gamma ->
// + x, on NHWC activations.
//
// Replaces the Pallas kernel smelter_tpu/kernels/convnext_block.py::
// convnext_block (body _block_kernel), which holds one whole image, its
// zero-padded copy and both MLP weights in VMEM and runs the block in one
// program per image. On Hopper that does not fit: the padded stage-1 image
// alone (62 x 62 x 96 bf16) is 738 KB and each stage-3 MLP weight 1.18 MB,
// against 227 KB of shared memory a block. So the function is computed
// here as a fixed sequence of this library's own launches on the caller's
// stream (the Python wrapper counts the call once), in the Pallas kernel's
// arithmetic:
//
//   1. dw_ln: one block per (image, output row, tile of TW columns). Each
//      thread computes 4 neighbouring output pixels of 2 channels: the 49
//      taps (dy outer, dx inner) of the x values with the weights in x's
//      type, products and sums in f32, then the bias in f32, into an f32
//      tile (TW, C) in shared memory; then one warp a pixel takes the
//      LayerNorm over C in f32 (the mean, then the mean of squared
//      deviations) and writes xn rounded once to x's type;
//   2. FC1 xn (M, C) @ w1 (C, F) on csrc/gemm.cuh's mma.sync GEMM, b1 added
//      to the f32 sum, GELU's exact form (the Abramowitz-Stegun erf
//      polynomial over exp the Pallas kernel spells), h rounded once;
//   3. FC2 h (M, F) @ w2 (F, C), b2 added in f32, times gamma in f32, x
//      added in f32, one rounding.
//
// f32 activations take the GEMM's full-f32 FMA kernel (no TF32).
//
// What bounds it on an H100: at ConvNeXt-T's batch 64, per stage, FC1 and
// FC2 do 16 M C^2 (29.6 GFLOP at stage 1, ~30 us at 989 TFLOP/s dense
// bf16) against ~77 MB of x, weights and output (~23 us at 3.35 TB/s): the
// tensor cores, with the 49-tap depthwise part (1.9 GFLOP at stage 1) on
// the CUDA cores beside them. The simple design keeps mma.sync's rate at
// best; xn and the hidden h (4 C a pixel) cross device memory between the
// launches. No TMA or wgmma yet.
#include "gemm.cuh"

namespace {

using namespace smelter;

// Two neighbouring channels (4- or 8-byte aligned) in f32.
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load2(const __half* p) {
  return __half22float2(*reinterpret_cast<const __half2*>(p));
}

constexpr int DW_THREADS = 256;
constexpr int DW_STRIP = 4;              // output pixels a thread, along W
constexpr int DW_TILE_FLOATS = 12288;    // the f32 tile's room: 48 KB

// Columns of an output row a block takes: the whole row while its f32 tile
// fits 48 KB, else a multiple of DW_STRIP.
inline int dw_tile_width(int W, int C) {
  const int tw = (DW_TILE_FLOATS / C) / DW_STRIP * DW_STRIP;
  return W < tw ? W : (tw > DW_STRIP ? tw : DW_STRIP);
}

// x (B, H, W, C) NHWC; dw (7, 7, C) tap-major in T; dw_b, gamma, beta (C,)
// in p_code; xn (B, H, W, C) in T. C even.
template <typename T>
__global__ void __launch_bounds__(DW_THREADS)
dw_ln(const T* __restrict__ x, const T* __restrict__ dw, const void* __restrict__ dw_b,
      const void* __restrict__ gamma, const void* __restrict__ beta, int p_code,
      T* __restrict__ xn, int H, int W, int C, int TW, float eps) {
  extern __shared__ float tile[];  // [TW][C] f32: the conv output plus its bias
  const int b = blockIdx.z, y = blockIdx.y, x0 = blockIdx.x * TW;
  const int tw = min(TW, W - x0);
  const int C2 = C / 2, strips = (tw + DW_STRIP - 1) / DW_STRIP;
  const size_t img = static_cast<size_t>(b) * H * W * C;

  for (int item = threadIdx.x; item < strips * C2; item += DW_THREADS) {
    const int c = 2 * (item % C2), xs = x0 + (item / C2) * DW_STRIP;
    float2 acc[DW_STRIP];
#pragma unroll
    for (int o = 0; o < DW_STRIP; ++o) acc[o] = make_float2(0.f, 0.f);
    for (int dy = 0; dy < 7; ++dy) {
      const int iy = y + dy - 3;
      if (iy < 0 || iy >= H) continue;  // the zero padding adds nothing
      const T* row = x + img + static_cast<size_t>(iy) * W * C + c;
      float2 w[7], in[DW_STRIP + 6];
#pragma unroll
      for (int dx = 0; dx < 7; ++dx) w[dx] = load2(dw + (dy * 7 + dx) * C + c);
#pragma unroll
      for (int i = 0; i < DW_STRIP + 6; ++i) {
        const int ix = xs - 3 + i;
        in[i] = (ix >= 0 && ix < W) ? load2(row + static_cast<size_t>(ix) * C)
                                    : make_float2(0.f, 0.f);
      }
#pragma unroll
      for (int o = 0; o < DW_STRIP; ++o)
#pragma unroll
        for (int dx = 0; dx < 7; ++dx) {
          acc[o].x += in[o + dx].x * w[dx].x;
          acc[o].y += in[o + dx].y * w[dx].y;
        }
    }
    const float b0 = param_at(dw_b, p_code, c), b1 = param_at(dw_b, p_code, c + 1);
#pragma unroll
    for (int o = 0; o < DW_STRIP; ++o) {
      const int p = xs + o - x0;
      if (p >= tw) break;
      tile[p * C + c] = acc[o].x + b0;
      tile[p * C + c + 1] = acc[o].y + b1;
    }
  }
  __syncthreads();

  // LayerNorm over C: one warp a pixel.
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int p = warp; p < tw; p += DW_THREADS / 32) {
    const float* v = tile + p * C;
    float sum = 0.f;
    for (int c = lane; c < C; c += 32) sum += v[c];
    const float mu = warp_sum(sum) / static_cast<float>(C);
    float sq = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float d = v[c] - mu;
      sq += d * d;
    }
    const float r = rsqrtf(warp_sum(sq) / static_cast<float>(C) + eps);
    T* dst = xn + img + (static_cast<size_t>(y) * W + x0 + p) * C;
    for (int c = lane; c < C; c += 32)
      store(&dst[c], (v[c] - mu) * r * param_at(gamma, p_code, c) + param_at(beta, p_code, c));
  }
}

template <typename T>
int run(const void* x, const void* dw, const void* dw_b, const void* ln_g, const void* ln_b,
        const void* w1, const void* b1, const void* w2, const void* b2, const void* gm, void* xn,
        void* h, void* out, int B, int H, int W, int C, int F, float eps, int p_code,
        cudaStream_t stream) {
  const int M = B * H * W;
  const int TW = dw_tile_width(W, C);
  const dim3 grid(cdiv(W, TW), H, B);
  dw_ln<T><<<grid, DW_THREADS, TW * C * sizeof(float), stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dw), dw_b, ln_g, ln_b, p_code,
      static_cast<T*>(xn), H, W, C, TW, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  gemm<T>(static_cast<const T*>(xn), static_cast<const T*>(w1), b1, p_code, kActGeluExact,
          nullptr, static_cast<T*>(h), M, F, C, F, stream);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  gemm<T>(static_cast<const T*>(h), static_cast<const T*>(w2), b2, p_code, kActNone,
          static_cast<const T*>(x), static_cast<T*>(out), M, C, F, C, stream, gm);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* smelter_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x and out (B, H, W, C) NHWC, dw (7, 7, 1, C), w1 (C, F), w2 (F, C),
// scratch xn (B H W, C) and h (B H W, F), all row-major in x_dtype and
// 16-byte aligned; dw_b, ln_g, ln_b, b2, gm (C,) and b1 (F,) in p_dtype (f32
// or x_dtype). C and F multiples of 8.
// Returns a cudaError_t code.
extern "C" int smelter_convnext_block(const void* x, const void* dw, const void* dw_b,
                                      const void* ln_g, const void* ln_b, const void* w1,
                                      const void* b1, const void* w2, const void* b2,
                                      const void* gm, void* xn, void* h, void* out, int B, int H,
                                      int W, int C, int F, float eps, int x_dtype, int p_dtype,
                                      void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const auto misaligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; };
  if (misaligned(x) || misaligned(dw) || misaligned(w1) || misaligned(w2) || misaligned(xn) ||
      misaligned(h) || misaligned(out))
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (C % 8 != 0 || F % 8 != 0 || C > DW_TILE_FLOATS / DW_STRIP ||
      (p_dtype != kF32 && p_dtype != x_dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || H == 0 || W == 0) return 0;
  switch (x_dtype) {
    case kF32:
      return run<float>(x, dw, dw_b, ln_g, ln_b, w1, b1, w2, b2, gm, xn, h, out, B, H, W, C, F,
                        eps, p_dtype, st);
    case kBF16:
      return run<__nv_bfloat16>(x, dw, dw_b, ln_g, ln_b, w1, b1, w2, b2, gm, xn, h, out, B, H,
                                W, C, F, eps, p_dtype, st);
    case kF16:
      return run<__half>(x, dw, dw_b, ln_g, ln_b, w1, b1, w2, b2, gm, xn, h, out, B, H, W, C,
                         F, eps, p_dtype, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
