// int8 x int8 -> int32 convolution with QLinearConv's folded requant
// epilogue, for Hopper:
//   out[m, co] = clip(rint(fma(float(acc[m, co]), mul[co], add[co])), lo, 127)
// (without a bias: rint(float(acc) * mul[co])), acc the int32 sum of the
// conv's int8 products, m an output pixel of the channels-last output, lo
// -128, or 0 where the walk folds the conv's only reader, an int8 Relu,
// into it (`relu`).
//
// Stands in for XLA's int8 convolution with an int32 accumulator, which the
// JAX package's QLinearConv lowering (smelter_tpu/ops/quant_ops.py::
// qlinear_conv) calls; it is not a Pallas kernel. Its compiled epilogue
// contracts acc * m + b into one fused multiply-add, so this one writes
// __fmaf_rn (nvcc would contract a * b + c too, but the intrinsic says so
// and is not reordered).
//
// What bounds it on an H100: the int8 tensor cores at ResNet-50's 3x3 and
// wide 1x1 convs at batch 128 (1.05e12 operations a forward, 0.53 ms at
// 1,979 TOP/s); the bytes at the stem and the narrow 1x1 convs.
//
// Two kernels, the form from smelter_tpu_torch/kernels/wgmma_plan.py::
// qconv_plan:
// - the wgmma forms of csrc/wgmma_qconv.cuh (1 "gemm": 1x1 stride 1 on 2-D
//   TMA maps; 2 "im2col": any kernel and stride on an im2col map): both
//   operands K-major in shared memory by TMA, wgmma.s32.s8.s8, persistent
//   CTAs; C_in a multiple of 32 (an RGB stem reads an unfolded copy of its
//   input, the wrapper's, by a weight unfolded alike, the fold's);
// - form 0, the mma.sync kernel below for the shapes and pointers the
//   maps cannot take: an implicit GEMM (csrc/implicit_conv.cuh) with
//   M = N * Ho * Wo, N = C_out, K = kh * kw * C_in; one 128x128 output tile
//   per block of 8 warps, each warp a 32x64 sub-tile of mma.sync.m16n8k32.
//   Per K step of 64 bytes the block gathers A's 128 rows from the NHWC
//   input into shared memory ([m][k], zeros in the padding) and copies the
//   weight tile as it lies (OHWI rows are [n][k], the B fragment's layout);
//   both fragments are then plain 32-bit shared loads. The next step's
//   tiles are loaded into registers while the tensor cores work on the
//   current one. A C_in that is not a multiple of 16 takes byte loads over
//   the flattened K, its last chunk zero-filled.
#include "implicit_conv.cuh"
#include "wgmma_qconv.cuh"

namespace {

using namespace smelter;

constexpr int BM = 128, BN = 128, BK = 64, THREADS = 256;
constexpr int SA = BK + 16;  // bytes per row of either tile in shared memory
constexpr int CHUNKS = BM * BK / 16 / THREADS;  // 16-byte chunks a thread loads per tile

__global__ void __launch_bounds__(THREADS)
qlinear_conv_mma(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                 const float* __restrict__ mul, const float* __restrict__ add,
                 int8_t* __restrict__ out, ConvGeom g, int Cout, int n_tiles, bool vec, float lo) {
  __shared__ __align__(16) int8_t As[BM * SA];  // [m][k]
  __shared__ __align__(16) int8_t Bs[BN * SA];  // [n][k]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, t = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 64;
  const int n0 = (blockIdx.x % n_tiles) * BN, m0 = (blockIdx.x / n_tiles) * BM;
  const int K = g.K;

  int acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

  // The rows this thread loads are the same at every K step.
  PixelAt px[CHUNKS];
#pragma unroll
  for (int i = 0; i < CHUNKS; ++i) px[i] = pixel_at(g, m0 + (tid + i * THREADS) / (BK / 16));

  uint4 ra[CHUNKS], rb[CHUNKS];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < CHUNKS; ++i) {
      const int c = tid + i * THREADS;
      const int r = c / (BK / 16), col = (c % (BK / 16)) * 16;
      ra[i] = gather16(x, g, px[i], k0 + col, vec);
      const int n = n0 + r, k = k0 + col;
      const int8_t* row = w + static_cast<size_t>(n) * K;
      if (vec) {
        rb[i] = (n < Cout && k < K) ? *reinterpret_cast<const uint4*>(row + k)
                                    : make_uint4(0u, 0u, 0u, 0u);
      } else {
        union {
          uint4 v;
          int8_t e[16];
        } u;
#pragma unroll
        for (int j = 0; j < 16; ++j) u.e[j] = (n < Cout && k + j < K) ? row[k + j] : int8_t(0);
        rb[i] = u.v;
      }
    }
  };
  auto stash = [&]() {
#pragma unroll
    for (int i = 0; i < CHUNKS; ++i) {
      const int c = tid + i * THREADS;
      const int off = (c / (BK / 16)) * SA + (c % (BK / 16)) * 16;
      *reinterpret_cast<uint4*>(&As[off]) = ra[i];
      *reinterpret_cast<uint4*>(&Bs[off]) = rb[i];
    }
  };

  load(0);
  for (int k0 = 0; k0 < K; k0 += BK) {
    stash();
    __syncthreads();
    if (k0 + BK < K) load(k0 + BK);  // in flight while the tensor cores work
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t a[2][4], b[8][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int8_t* pa = &As[(wm + mi * 16 + gq) * SA + kk + t * 4];
        a[mi][0] = *reinterpret_cast<const uint32_t*>(pa);
        a[mi][1] = *reinterpret_cast<const uint32_t*>(pa + 8 * SA);
        a[mi][2] = *reinterpret_cast<const uint32_t*>(pa + 16);
        a[mi][3] = *reinterpret_cast<const uint32_t*>(pa + 8 * SA + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const int8_t* pb = &Bs[(wn + ni * 8 + gq) * SA + kk + t * 4];
        b[ni][0] = *reinterpret_cast<const uint32_t*>(pb);
        b[ni][1] = *reinterpret_cast<const uint32_t*>(pb + 16);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 8; ++ni) mma_16832_s8(acc[mi][ni], a[mi], b[ni]);
    }
    __syncthreads();
  }

  // Epilogue: one fused multiply-add (or a multiply), round half to even,
  // clip to [lo, 127].
#pragma unroll
  for (int ni = 0; ni < 8; ++ni) {
    const int col = n0 + wn + ni * 8 + t * 2;
    float mc[2], ac[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      mc[j] = col + j < Cout ? mul[col + j] : 0.f;
      ac[j] = (add != nullptr && col + j < Cout) ? add[col + j] : 0.f;
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm + mi * 16 + gq + h * 8;
        if (row >= g.M) continue;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          if (col + j >= Cout) continue;
          const float f = __int2float_rn(acc[mi][ni][h * 2 + j]);
          const float y = add != nullptr ? __fmaf_rn(f, mc[j], ac[j]) : __fmul_rn(f, mc[j]);
          const float q = fminf(fmaxf(rintf(y), lo), 127.f);
          out[static_cast<size_t>(row) * Cout + col + j] = static_cast<int8_t>(__float2int_rn(q));
        }
      }
  }
}

}  // namespace

extern "C" const char* smelter_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x (N, H, W, C_in) int8; w (C_out, kh, kw, C_in) int8; mul, add (C_out,)
// f32, add may be null; out (N, Ho, Wo, C_out) int8. All contiguous. relu:
// clip at 0, not -128. form: 0 the mma.sync kernel, 1 the wgmma "gemm"
// form, 2 the wgmma "im2col" form, on `grid` CTAs with K steps of bk bytes
// and tiles of bn channels (the plan's). Returns a cudaError_t code.
extern "C" int smelter_qlinear_conv(const void* x, const void* w, const void* mul,
                                    const void* add, void* out, int N, int H, int W, int Cin,
                                    int Ho, int Wo, int Cout, int kh, int kw, int sh, int sw,
                                    int pt, int pl, int relu, int form, int bk, int bn, int grid,
                                    void* stream) {
  if (form == 1 || form == 2)
    return wg::launch_qconv(x, w, static_cast<const float*>(mul), static_cast<const float*>(add),
                            out, N, H, W, Cin, Ho, Wo, Cout, kh, kw, sh, sw, pt, pl, relu,
                            form == 2, bk, bn, grid, static_cast<cudaStream_t>(stream));
  if (form != 0) return static_cast<int>(cudaErrorInvalidValue);
  const ConvGeom g = conv_geom(N, H, W, Cin, Ho, Wo, kh, kw, sh, sw, pt, pl);
  const bool vec = Cin % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const int n_tiles = cdiv(Cout, BN);
  const long long blocks = static_cast<long long>(n_tiles) * cdiv(g.M, BM);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  qlinear_conv_mma<<<static_cast<unsigned>(blocks), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(mul), static_cast<const float*>(add),
      static_cast<int8_t*>(out), g, Cout, n_tiles, vec, relu ? 0.f : -128.f);
  return static_cast<int>(cudaGetLastError());
}
