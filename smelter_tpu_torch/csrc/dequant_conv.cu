// Fused dequant + KxK convolution, for Hopper: NHWC activations x in f32,
// bf16 or f16, int8 HWIO weights, a per-output-channel f32 scale after the
// sum; stride 1, dilation 1, groups 1:
//   out[m, co] = (sum over k of A(m, k) * T(w[k, co])) * s[co]
// with the sum in f32 and one rounding to x's type, A the implicit-GEMM view
// of x (csrc/implicit_conv.cuh).
//
// Replaces smelter_tpu/kernels/dequant_conv.py::_dequant_conv_impl, the
// Pallas kernel that DMAs a halo'd row tile of x into VMEM and accumulates
// one MXU dot per tap with the weight upcast in VMEM, the scale applied
// once after the last tap. The arithmetic is that kernel's: the weight cast
// to x's type (exact for int8), f32 sums, acc * s in f32, one rounding.
//
// What bounds it on an H100: at ResNet-50's stride-1 3x3 convs at batch 128
// in bf16 (3.0e10 operations each, 0.030 ms at 989 TFLOP/s) the bytes tie
// with the tensor cores at 56 x 56 x 64 (103 MB, 0.031 ms at 3.35 TB/s)
// and the tensor cores bound the smaller maps; f32 takes the CUDA cores (67
// TFLOP/s; no TF32).
//
// Design: kernels/wgmma_plan.py::conv_plan picks one of two forms for
// 16-bit x, by shape alone, before the launch:
//
// - wgmma (C_in % 64 == 0, C_out % 16 == 0, aligned bases; all of
//   ResNet-50's stride-1 3x3 convs): csrc/wgmma_gemm.cuh's persistent,
//   warp-specialised gemm_tma_ra with an im2col tensor map of x. The TMA
//   unit gathers A itself: a box is 128 consecutive output pixels x 64
//   channels of one tap (the tap is the load's im2col offset, the padding
//   its zero fill, rows and images crossed by its own walk), landing in the
//   128-byte-swizzled K-major layout wgmma reads, so no thread computes a
//   pixel's address or spends registers on A. That route was taken over a
//   producer warpgroup gathering 16-byte chunks with cp.async: one thread
//   issues a step's loads, and the other producer threads idle. The int8
//   HWIO weight is [k][co] with co fastest; it lands by TMA as it lies and
//   is W^T's register A operand, each consumer converting its fragment's
//   bytes exactly, so the im2col tile is wgmma's K-major B and the
//   epilogue is the core's acc * s[co] in f32, rounded once; W never goes
//   back to shared memory in 16 bits (the core's header counts the bytes).
//   BN follows C_out: 64 (C_out 64: two 128-pixel boxes a tile, one a
//   consumer warpgroup, sharing the W box) or 128.
// - mma (every other stride-1 shape: C_in 3, C_in 37, unaligned bases):
//   one 128x128 output tile per block of 8 warps, each a 32x64 sub-tile of
//   mma.sync.m16n8k16 with f32 accumulators. Per K step of 32 the block
//   gathers A's 128 rows into shared memory ([m][k], zeros in the padding)
//   and converts the int8 weight tile, [k][n] as HWIO lies, to x's type on
//   its way there; fragments by ldmatrix (B transposed). The next step's
//   tiles are loaded into registers while the tensor cores work. It took
//   0.9940 ms for ResNet-50's four stride-1 3x3 convs at b128 (NVIDIA H100
//   80GB HBM3, 700 W; PERF.md row 5).
//
// f32 x takes a register-tiled FMA kernel over 64x64 tiles on the mma
// form's loader. One launch is one kernel.
#include "implicit_conv.cuh"
#include "wgmma_gemm.cuh"

namespace {

using namespace smelter;

constexpr int THREADS = 256;

// -- 16-bit activations: mma.sync m16n8k16 --------------------------------

constexpr int BM = 128, BN = 128, BK = 32;
constexpr int SA = BK + 8;  // halves per A row in shared memory (80 bytes)
constexpr int SB = BN + 8;  // halves per B row in shared memory (272 bytes)
constexpr int A_CHUNKS = BM * BK / 8 / THREADS;  // 8-half chunks of A a thread loads

template <typename T>
__global__ void __launch_bounds__(THREADS)
dequant_conv_mma(const uint16_t* __restrict__ x, const int8_t* __restrict__ w,
                 const float* __restrict__ s, T* __restrict__ out, ConvGeom g, int Cout,
                 int n_tiles, bool x_vec, bool w_vec) {
  __shared__ __align__(16) uint16_t As[BM * SA];  // [m][k]
  __shared__ __align__(16) uint16_t Bs[BK * SB];  // [k][n]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, t = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 64;
  const int n0 = (blockIdx.x % n_tiles) * BN, m0 = (blockIdx.x / n_tiles) * BM;
  const int K = g.K;

  float acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  PixelAt px[A_CHUNKS];
#pragma unroll
  for (int i = 0; i < A_CHUNKS; ++i) px[i] = pixel_at(g, m0 + (tid + i * THREADS) / (BK / 8));
  // The weight chunk this thread converts: row kr of the K step, 16 columns from nc.
  const int kr = tid / (BN / 16), nc = (tid % (BN / 16)) * 16;

  uint4 ra[A_CHUNKS];
  uint4 rw;
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < A_CHUNKS; ++i)
      ra[i] = gather16(x, g, px[i], k0 + ((tid + i * THREADS) % (BK / 8)) * 8, x_vec);
    const int k = k0 + kr, n = n0 + nc;
    const int8_t* row = w + static_cast<size_t>(k) * Cout + n;
    if (w_vec) {
      rw = (k < K && n < Cout) ? *reinterpret_cast<const uint4*>(row)
                               : make_uint4(0u, 0u, 0u, 0u);
    } else {
      union {
        uint4 v;
        int8_t e[16];
      } u;
#pragma unroll
      for (int j = 0; j < 16; ++j) u.e[j] = (k < K && n + j < Cout) ? row[j] : int8_t(0);
      rw = u.v;
    }
  };
  auto stash = [&]() {
#pragma unroll
    for (int i = 0; i < A_CHUNKS; ++i) {
      const int c = tid + i * THREADS;
      *reinterpret_cast<uint4*>(&As[(c / (BK / 8)) * SA + (c % (BK / 8)) * 8]) = ra[i];
    }
    // 16 int8 weights -> 16 values of type T, exact.
    const int8_t* e = reinterpret_cast<const int8_t*>(&rw);
    uint32_t h[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      h[j] = static_cast<uint32_t>(int_bits<T>(e[2 * j])) |
             (static_cast<uint32_t>(int_bits<T>(e[2 * j + 1])) << 16);
    uint4* dst = reinterpret_cast<uint4*>(&Bs[kr * SB + nc]);
    dst[0] = make_uint4(h[0], h[1], h[2], h[3]);
    dst[1] = make_uint4(h[4], h[5], h[6], h[7]);
  };

  load(0);
  for (int k0 = 0; k0 < K; k0 += BK) {
    stash();
    __syncthreads();
    if (k0 + BK < K) load(k0 + BK);  // in flight while the tensor cores work
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[2][4], b[8][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldmatrix_x4(a[mi], &As[(wm + mi * 16 + (lane & 15)) * SA + kk + (lane >> 4) * 8]);
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, &Bs[(kk + (lane & 15)) * SB + wn + nj * 16 + (lane >> 4) * 8]);
        b[2 * nj][0] = r[0];
        b[2 * nj][1] = r[1];
        b[2 * nj + 1][0] = r[2];
        b[2 * nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 8; ++ni) mma_16816<T>(acc[mi][ni], a[mi], b[ni]);
    }
    __syncthreads();
  }

  // Epilogue: the f32 sum times the f32 scale, one rounding to T.
#pragma unroll
  for (int ni = 0; ni < 8; ++ni) {
    const int col = n0 + wn + ni * 8 + t * 2;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm + mi * 16 + gq + h * 8;
        if (row >= g.M) continue;
#pragma unroll
        for (int j = 0; j < 2; ++j)
          if (col + j < Cout)
            store(&out[static_cast<size_t>(row) * Cout + col + j],
                  __fmul_rn(acc[mi][ni][h * 2 + j], s[col + j]));
      }
  }
}

// -- f32 activations: register-tiled FMA, 4x4 outputs a thread ------------

constexpr int FM = 64, FN = 64, FK = 16;

__global__ void __launch_bounds__(THREADS)
dequant_conv_f32(const float* __restrict__ x, const int8_t* __restrict__ w,
                 const float* __restrict__ s, float* __restrict__ out, ConvGeom g, int Cout,
                 int n_tiles) {
  __shared__ float As[FK][FM + 4];  // [k][m]
  __shared__ float Bs[FK][FN + 4];  // [k][n]
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int n0 = (blockIdx.x % n_tiles) * FN, m0 = (blockIdx.x / n_tiles) * FM;
  constexpr int LOADS = FM * FK / THREADS;
  // A element tid + i * THREADS is row (tid / FK + i * THREADS / FK), column tid % FK.
  PixelAt px[LOADS];
#pragma unroll
  for (int i = 0; i < LOADS; ++i) px[i] = pixel_at(g, m0 + (tid + i * THREADS) / FK);
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < g.K; k0 += FK) {
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
      const int c = tid + i * THREADS;
      const long long off = tap_offset(g, px[i], k0 + c % FK);
      As[c % FK][c / FK] = off < 0 ? 0.f : x[off];
    }
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
      const int c = tid + i * THREADS;
      const int k = k0 + c / FN, n = n0 + c % FN;
      Bs[c / FN][c % FN] =
          (k < g.K && n < Cout) ? static_cast<float>(w[static_cast<size_t>(k) * Cout + n]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < FK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[k][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[k][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row >= g.M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col < Cout) out[static_cast<size_t>(row) * Cout + col] = __fmul_rn(acc[i][j], s[col]);
    }
  }
}

// The wgmma form: tiles of bn (64 or 128) output channels on `grid` CTAs.
template <typename T>
int launch_wgmma(const void* x, const void* w, const float* s, void* out, int N, int H, int W,
                 int Cin, int Ho, int Wo, int Cout, int kh, int kw, int ph, int pw, int bn,
                 int grid, cudaStream_t st) {
  if (Cin % 64 != 0 || Cout % 16 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0 || grid < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (bn == 128)
    return wg::launch_conv_ra<T, 128>(x, w, s, out, N, H, W, Cin, Ho, Wo, Cout, kh, kw, ph, pw,
                                      grid, st);
  if (bn == 64)
    return wg::launch_conv_ra<T, 64>(x, w, s, out, N, H, W, Cin, Ho, Wo, Cout, kh, kw, ph, pw,
                                     grid, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" const char* smelter_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x (N, H, W, C_in) in dtype (kF32, kBF16, kF16); w (kh, kw, C_in, C_out)
// int8; s (C_out,) f32; out (N, Ho, Wo, C_out) in dtype. All contiguous;
// ph, pw the top and left pads. form, bn and grid are
// kernels/wgmma_plan.py::conv_plan's (form 1: wgmma, 16-bit x only; 0: the
// mma.sync kernel, or the FMA kernel for f32). Returns a cudaError_t code.
extern "C" int smelter_dequant_conv(const void* x, const void* w, const void* s, void* out,
                                    int N, int H, int W, int Cin, int Ho, int Wo, int Cout,
                                    int kh, int kw, int ph, int pw, int dtype, int form, int bn,
                                    int grid, void* stream) {
  const ConvGeom g = conv_geom(N, H, W, Cin, Ho, Wo, kh, kw, 1, 1, ph, pw);
  auto st = static_cast<cudaStream_t>(stream);
  const auto* wq = static_cast<const int8_t*>(w);
  const auto* sc = static_cast<const float*>(s);
  if (form == 1) {
    if (dtype == kBF16)
      return launch_wgmma<__nv_bfloat16>(x, w, sc, out, N, H, W, Cin, Ho, Wo, Cout, kh, kw, ph,
                                         pw, bn, grid, st);
    if (dtype == kF16)
      return launch_wgmma<__half>(x, w, sc, out, N, H, W, Cin, Ho, Wo, Cout, kh, kw, ph, pw, bn,
                                  grid, st);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (form != 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool f32 = dtype == kF32;
  const int n_tiles = cdiv(Cout, f32 ? FN : BN);
  const long long blocks = static_cast<long long>(n_tiles) * cdiv(g.M, f32 ? FM : BM);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid_mma = static_cast<unsigned>(blocks);
  const bool x_vec = Cin % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool w_vec = Cout % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const auto* xh = static_cast<const uint16_t*>(x);
  switch (dtype) {
    case kF32:
      dequant_conv_f32<<<grid_mma, THREADS, 0, st>>>(static_cast<const float*>(x), wq, sc,
                                                     static_cast<float*>(out), g, Cout, n_tiles);
      break;
    case kBF16:
      dequant_conv_mma<__nv_bfloat16><<<grid_mma, THREADS, 0, st>>>(
          xh, wq, sc, static_cast<__nv_bfloat16*>(out), g, Cout, n_tiles, x_vec, w_vec);
      break;
    case kF16:
      dequant_conv_mma<__half><<<grid_mma, THREADS, 0, st>>>(
          xh, wq, sc, static_cast<__half*>(out), g, Cout, n_tiles, x_vec, w_vec);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
