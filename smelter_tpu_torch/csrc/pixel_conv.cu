// 3x3 / stride 1 / pad 1 convolution for Hopper, on activations whose W is
// contiguous and whose batch, row and channel strides are arguments:
// out[b, h, co, w] = epilogue(sum_{dy,dx,ci} W[co,ci,dy,dx] * x[b, h+dy-1, ci, w+dx-1]).
// (B, H, C, W) "NHCW" has strides (H*C*W, C*W, W), flat NCHW (B, C, H*W)
// has (C*H*W, W, H*W): one device code serves both, with no layout copy.
//
// Replaces smelter_tpu/kernels/pixel_conv.py::pixel_conv_rowdot (f32/bf16)
// and ::pixel_conv_rowdot_q (int8), the Pallas kernels that put the pixels of
// a row on the 128 MXU lanes, run one [3*C_out, 3*C_in] x [3*C_in, W] dot a
// row and fold the dx taps with lane rolls of the partial sums; ::
// pixel_conv_blockdot, which runs one dot a block of rows (here: the taller
// tile, 8 output rows a wgmma tile, or RB = 4 in form 0); and ::
// pixel_conv_patch, which builds a 9*C_in patch matrix of flat NCHW with
// lane rolls (here: NCHW strides).
//
// What bounds it on an H100: ESRGAN's trunk convs (batch 8, 128 x 128, C_in
// 64-192, C_out 32/64) sit near the ridge: the 349 convs of a bf16 forward
// do ~4.7 TFLOP and move ~16 GB, ~4.7 ms of bf16 tensor-core time and ~4.9
// ms of HBM time at the data sheet's peaks. int8 halves both.
//
// Design. 16-bit rowdot where kernels/wgmma_plan.py::pixel_plan takes the
// shape (C_out 32 or 64, 16-byte pixel chunks; all of ESRGAN's): the
// persistent, warp-specialised wgmma implicit GEMM of csrc/wgmma_conv.cuh
// (pixels on M, C_out on N; TMA in, a K-major copy made by the producer
// warpgroup so that the dx taps are 16-byte offsets, the weight resident in
// shared memory where it fits, TMA out), form 1 or 2 below, on tiles of 4
// output rows. 16-bit blockdot takes the same core (pixel_plan(..., tall))
// on the Pallas variant's taller row block: tiles of 8 output rows from 10
// staged input rows (1.25 staged rows an output row against 1.5, and each K
// step's box, copy and weights feed twice the products) at C_out 32 with
// C_in >= 96 where the tile fits; the rest of its shapes the 4-row tile.
// rowdot_q with int8 or 16-bit out where the plan takes the shape (also
// C_out 32 or 64; 16-pixel chunks: all of ESRGAN's) runs the same design on
// int8 wgmma (csrc/wgmma_conv_s8.cuh: K steps of 32 channels, exact int32
// sums, the epilogue below).
//
// Everything else (f32, other C_out, strides TMA cannot take, rowdot_q
// with f32 out, and patch's NCHW strides) takes form 0, an implicit GEMM
// on mma.sync per block of RB = 2 (blockdot: 4) output rows x TW =
// 128 pixels x 64 output channels (M = output channels, N = pixels, K = the
// 9 taps x C_in). Input channels stream in chunks of 64 bytes (32 bf16 or
// 64 int8 channels): the block stages the RB + 2 input rows of the chunk,
// pixels w0-1 .. w0+TW, transposed to [row][pixel][channel] in shared
// memory, so that the dx shift of a tap is a shift of whole staged rows and
// both operands come through ldmatrix (no transposed loads). The weights
// arrive as [3][3][C_out][C_in] (weights.py packs the graph's once) and are
// staged as [tap][co][channel]. 4 * RB warps, each 32 pixels of one output
// row x all 64 channels (32 where C_out <= 32), run mma.sync m16n8k16
// (bf16/f16, f32 accumulators) or m16n8k32 (int8, int32 accumulators) over
// the 9 taps. Rows 80 bytes apart put the 8 rows of an ldmatrix in distinct
// banks. Ragged H, W, C_in and C_out are masked; it loads and computes in
// turn (no cp.async, TMA or wgmma). f32 takes an FMA kernel in full f32 (no
// TF32), of R = 1 (or 4) output rows a block. RB 4 / R 4 halve the weight
// staging a pixel and cut the rows staged per output row from 2 to 1.5.
//
// Epilogues: the float paths add the bias, apply LeakyReLU and round once;
// the int8 path converts the exact int32 sum, multiplies by the scale and
// adds the bias in two roundings (__fmul_rn, __fadd_rn: no contraction),
// applies LeakyReLU and requantizes half to even, clipped to [-127, 127].
#include <type_traits>

#include "common.cuh"
#include "wgmma_conv_s8.cuh"

namespace {

using namespace smelter;

constexpr int TW = 128;               // output pixels a block
constexpr int CO = 64;                // output channels a block (grid.y covers more)
constexpr int KB = 64;                // bytes of input channels a chunk
constexpr int ROWB = KB + 16;         // bytes a staged row (80)
constexpr int XP = TW + 2;
constexpr int W_BYTES = 9 * CO * ROWB;
// RB output rows a block: 4 * RB warps (RB rows x 4 quarters of TW) and
// (RB + 2) staged input rows; RB 2: 87,680 bytes, RB 4: 108,480, two
// blocks an SM either way.
template <int RB> struct Tile {
  static constexpr int THREADS = 128 * RB;
  static constexpr int X_BYTES = (RB + 2) * XP * ROWB;
  static constexpr int SMEM_BYTES = X_BYTES + W_BYTES;
};

// Element strides of the batch, row and channel dims (W is contiguous).
struct Strides {
  long long b, h, c;
  __device__ __forceinline__ size_t at(int bi, int hi, int ci) const {
    return static_cast<size_t>(bi * b + hi * h + ci * c);
  }
};

struct Epilogue {
  const void* bias;
  int bias_dtype;
  const float* scales;  // int8 only: s_x * s_w[co]
  float alpha;
  int has_alpha;
  float inv_sy;
};

__device__ __forceinline__ float bias_at(const Epilogue& ep, int c) {
  switch (ep.bias_dtype) {
    case kBF16: return __bfloat162float(static_cast<const __nv_bfloat16*>(ep.bias)[c]);
    case kF16: return __half2float(static_cast<const __half*>(ep.bias)[c]);
    default: return static_cast<const float*>(ep.bias)[c];
  }
}

__device__ __forceinline__ float leaky(const Epilogue& ep, float f) {
  return (ep.has_alpha && !(f >= 0.f)) ? __fmul_rn(f, ep.alpha) : f;
}

// The epilogue of one output: f32 sums take bias and LeakyReLU; int32 sums
// are dequantized first and requantized when the output is int8.
template <typename OutT, typename Acc>
__device__ __forceinline__ void finish(const Epilogue& ep, Acc v, int c, OutT* p) {
  float f;
  if constexpr (std::is_same<Acc, int>::value) {
    f = wg::q_dequant(v, ep.scales[c], bias_at(ep, c), ep.alpha, ep.has_alpha);
  } else {
    f = leaky(ep, __fadd_rn(v, bias_at(ep, c)));
  }
  if constexpr (std::is_same<OutT, int8_t>::value) {
    *p = wg::q_requant(f, ep.inv_sy);
  } else {
    store(p, f);
  }
}

// Tensor-core element traits: the raw bits a staged element is, the
// accumulator, and one 32-byte deep mma.sync tile.
template <typename T> struct Tc;
template <> struct Tc<__nv_bfloat16> {
  using Raw = uint16_t;
  using Acc = float;
  static __device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                             const uint32_t (&b)[2]) {
    mma_16816<__nv_bfloat16>(d, a, b);
  }
};
template <> struct Tc<__half> {
  using Raw = uint16_t;
  using Acc = float;
  static __device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                             const uint32_t (&b)[2]) {
    mma_16816<__half>(d, a, b);
  }
};
template <> struct Tc<int8_t> {
  using Raw = uint8_t;
  using Acc = int;
  static __device__ __forceinline__ void mma(int (&d)[4], const uint32_t (&a)[4],
                                             const uint32_t (&b)[2]) {
    mma_16832_s8(d, a, b);
  }
};

// Four 8x8 b16 matrices from shared memory (row addresses from lanes 8j..8j+7).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* smem) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// MT: m16 tiles of output channels a warp runs, 2 for C_out <= 32, else 4.
// RB 4 with four tiles keeps one block an SM, so that the accumulators stay
// in registers.
template <typename T, typename OutT, int MT, int RB>
__global__ void __launch_bounds__(Tile<RB>::THREADS, (RB == 2 || MT == 2) ? 2 : 1)
pixel_conv_mma(const T* __restrict__ x, const T* __restrict__ w, Epilogue ep,
               OutT* __restrict__ out, int H, int Cin, int W, int Cout, Strides xs_,
               Strides os_, int ptiles, int row_blocks, bool x_vec, bool w_vec) {
  constexpr int THREADS = Tile<RB>::THREADS, XR = RB + 2, X_BYTES = Tile<RB>::X_BYTES;
  using Raw = typename Tc<T>::Raw;
  using Acc = typename Tc<T>::Acc;
  constexpr int ES = sizeof(Raw);
  constexpr int KE = KB / ES;  // channels a chunk
  constexpr int VE = 16 / ES;  // elements a 16-byte vector
  constexpr int PG = TW / VE;  // vectors a staged row's interior
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* xs = smem;            // [XR][XP][ROWB]
  unsigned char* ws = smem + X_BYTES;  // [9][CO][ROWB]
  const Raw* xr = reinterpret_cast<const Raw*>(x);
  const Raw* wr_ = reinterpret_cast<const Raw*>(w);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wrow = warp >> 2, wq = warp & 3;
  const int pt = blockIdx.x % ptiles, rest = blockIdx.x / ptiles;
  const int w0 = pt * TW, h0 = (rest % row_blocks) * RB, b = rest / row_blocks;
  const int co0 = blockIdx.y * CO;

  Acc acc[MT][4][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = Acc(0);

  for (int c0 = 0; c0 < Cin; c0 += KE) {
    __syncthreads();  // every warp is done with the previous chunk
    // weights [tap][co][ci] -> ws rows (tap, co), KE channels each
    for (int i = tid; i < 9 * CO * (KB / 16); i += THREADS) {
      const int piece = i % (KB / 16), row = i / (KB / 16);
      const int co = row % CO, tap = row / CO, ci = c0 + piece * VE;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (co0 + co < Cout && ci < Cin) {
        const Raw* src = wr_ + (static_cast<size_t>(tap) * Cout + co0 + co) * Cin + ci;
        if (w_vec && ci + VE <= Cin) {
          v = *reinterpret_cast<const uint4*>(src);
        } else {
          Raw* e = reinterpret_cast<Raw*>(&v);
#pragma unroll
          for (int j = 0; j < VE; ++j) e[j] = ci + j < Cin ? src[j] : Raw(0);
        }
      }
      *reinterpret_cast<uint4*>(ws + row * ROWB + piece * 16) = v;
    }
    // input rows h0-1 .. h0+RB, pixels w0 .. w0+TW-1 (staged at 1 .. TW),
    // transposed to [row][pixel][channel]; lanes run over channels
    for (int i = tid; i < XR * KE * PG; i += THREADS) {
      const int c = i % KE, r2 = i / KE;
      const int pg = r2 % PG, r = r2 / PG;
      const int hin = h0 - 1 + r, ci = c0 + c, win = w0 + pg * VE;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      Raw* e = reinterpret_cast<Raw*>(&v);
      if (hin >= 0 && hin < H && ci < Cin) {
        const Raw* src = xr + xs_.at(b, hin, ci) + win;
        if (x_vec && win + VE <= W) {
          v = *reinterpret_cast<const uint4*>(src);
        } else {
#pragma unroll
          for (int j = 0; j < VE; ++j) e[j] = win + j < W ? src[j] : Raw(0);
        }
      }
      unsigned char* dst = xs + (r * XP + 1 + pg * VE) * ROWB + c * ES;
#pragma unroll
      for (int j = 0; j < VE; ++j) *reinterpret_cast<Raw*>(dst + j * ROWB) = e[j];
    }
    // the halo pixels w0-1 and w0+TW
    for (int i = tid; i < XR * KE * 2; i += THREADS) {
      const int c = i % KE, r2 = i / KE;
      const int q = (r2 & 1) ? XP - 1 : 0, r = r2 >> 1;
      const int hin = h0 - 1 + r, ci = c0 + c, win = w0 - 1 + q;
      Raw v = 0;
      if (hin >= 0 && hin < H && ci < Cin && win >= 0 && win < W)
        v = xr[xs_.at(b, hin, ci) + win];
      *reinterpret_cast<Raw*>(xs + (r * XP + q) * ROWB + c * ES) = v;
    }
    __syncthreads();

#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
#pragma unroll
      for (int ks = 0; ks < KB / 32; ++ks) {
        uint32_t bf[4][2];
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t r[4];
          const int q = wq * 32 + np * 16 + ((lane >> 4) & 1) * 8 + (lane & 7) + dx;
          ldsm_x4(r, xs + ((wrow + dy) * XP + q) * ROWB + ks * 32 + ((lane >> 3) & 1) * 16);
          bf[2 * np][0] = r[0];
          bf[2 * np][1] = r[1];
          bf[2 * np + 1][0] = r[2];
          bf[2 * np + 1][1] = r[3];
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          uint32_t a[4];
          ldsm_x4(a, ws + (tap * CO + mt * 16 + (lane & 15)) * ROWB + ks * 32 + (lane >> 4) * 16);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) Tc<T>::mma(acc[mt][nt], a, bf[nt]);
        }
      }
    }
  }

  const int h = h0 + wrow;
  if (h >= H) return;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int co = co0 + mt * 16 + g + hh * 8;
      if (co >= Cout) continue;
      OutT* orow = out + os_.at(b, h, co);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int wo = w0 + wq * 32 + nt * 8 + 2 * t + j;
          if (wo < W) finish(ep, acc[mt][nt][hh * 2 + j], co, orow + wo);
        }
    }
  }
}

// f32: a register-tiled FMA kernel in full f32. A block is R output rows x
// FT pixels x 64 channels; a thread one pixel x 16 channels of each row.
constexpr int FT = 64, FK = 8, FTHREADS = 256;

template <int R>
__global__ void __launch_bounds__(FTHREADS)
pixel_conv_f32(const float* __restrict__ x, const float* __restrict__ w, Epilogue ep,
               float* __restrict__ out, int H, int Cin, int W, int Cout, Strides xs_,
               Strides os_, int ptiles, int row_blocks) {
  __shared__ float xs[R + 2][FK][FT + 2];
  __shared__ __align__(16) float ws[9][FK][CO];
  const int tid = threadIdx.x, px = tid % FT, cq = tid / FT;
  const int pt = blockIdx.x % ptiles, rest = blockIdx.x / ptiles;
  const int w0 = pt * FT, h0 = (rest % row_blocks) * R, b = rest / row_blocks;
  const int co0 = blockIdx.y * CO;
  float acc[R][16];
#pragma unroll
  for (int rr = 0; rr < R; ++rr)
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[rr][j] = 0.f;

  for (int c0 = 0; c0 < Cin; c0 += FK) {
    __syncthreads();
    for (int i = tid; i < (R + 2) * FK * (FT + 2); i += FTHREADS) {
      const int q = i % (FT + 2), r2 = i / (FT + 2);
      const int c = r2 % FK, r = r2 / FK;
      const int hin = h0 - 1 + r, win = w0 - 1 + q, ci = c0 + c;
      xs[r][c][q] = (hin >= 0 && hin < H && win >= 0 && win < W && ci < Cin)
                        ? x[xs_.at(b, hin, ci) + win]
                        : 0.f;
    }
    for (int i = tid; i < 9 * FK * CO; i += FTHREADS) {
      const int co = i % CO, r2 = i / CO;
      const int c = r2 % FK, tap = r2 / FK;
      ws[tap][c][co] = (co0 + co < Cout && c0 + c < Cin)
                           ? w[(static_cast<size_t>(tap) * Cout + co0 + co) * Cin + c0 + c]
                           : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < FK; ++c)
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const float4* wv = reinterpret_cast<const float4*>(&ws[tap][c][cq * 16]);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float4 q = wv[k];
#pragma unroll
          for (int rr = 0; rr < R; ++rr) {
            const float xv = xs[rr + tap / 3][c][px + tap % 3];
            acc[rr][4 * k] = fmaf(xv, q.x, acc[rr][4 * k]);
            acc[rr][4 * k + 1] = fmaf(xv, q.y, acc[rr][4 * k + 1]);
            acc[rr][4 * k + 2] = fmaf(xv, q.z, acc[rr][4 * k + 2]);
            acc[rr][4 * k + 3] = fmaf(xv, q.w, acc[rr][4 * k + 3]);
          }
        }
      }
  }
  const int wo = w0 + px;
  if (wo >= W) return;
#pragma unroll
  for (int rr = 0; rr < R; ++rr) {
    const int h = h0 + rr;
    if (h >= H) break;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int co = co0 + cq * 16 + j;
      if (co < Cout) finish(ep, acc[rr][j], co, out + os_.at(b, h, co) + wo);
    }
  }
}

// Whether 16-byte vectors of VE elements can be loaded along W: W, the
// strides and the base pointer all aligned to them.
bool vec_ok(const void* p, int W, const Strides& s, int VE) {
  return W % VE == 0 && s.b % VE == 0 && s.h % VE == 0 && s.c % VE == 0 &&
         reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

struct Conv {
  const void* x;
  const void* w;
  void* out;
  int B, H, Cin, W, Cout;
  Strides xs, os;
};

template <typename T, typename OutT, int MT, int RB>
int launch_mma_mt(const Conv& c, const Epilogue& ep, cudaStream_t stream) {
  using K = Tile<RB>;
  static bool attr_set = false;  // per instantiation; setting it twice is harmless
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(pixel_conv_mma<T, OutT, MT, RB>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               K::SMEM_BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  constexpr int VE = 16 / static_cast<int>(sizeof(T));
  const int ptiles = cdiv(c.W, TW), row_blocks = cdiv(c.H, RB);
  const long long nx = static_cast<long long>(ptiles) * row_blocks * c.B;
  if (nx > 0x7fffffffLL || cdiv(c.Cout, CO) > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const bool x_vec = vec_ok(c.x, c.W, c.xs, VE);
  const bool w_vec = (c.Cin % VE == 0) && (reinterpret_cast<uintptr_t>(c.w) % 16 == 0);
  const dim3 grid(static_cast<unsigned>(nx), cdiv(c.Cout, CO));
  pixel_conv_mma<T, OutT, MT, RB><<<grid, K::THREADS, K::SMEM_BYTES, stream>>>(
      static_cast<const T*>(c.x), static_cast<const T*>(c.w), ep, static_cast<OutT*>(c.out), c.H,
      c.Cin, c.W, c.Cout, c.xs, c.os, ptiles, row_blocks, x_vec, w_vec);
  return static_cast<int>(cudaGetLastError());
}

// C_out <= 32 (ESRGAN's growth convs) runs two m16 tiles a warp, more four;
// `tall` takes RB 4 (float types only).
template <typename T, typename OutT>
int launch_mma(const Conv& c, const Epilogue& ep, bool tall, cudaStream_t stream) {
  if (tall) {
    if constexpr (std::is_same<T, int8_t>::value) {
      return static_cast<int>(cudaErrorInvalidValue);
    } else {
      return c.Cout <= 32 ? launch_mma_mt<T, OutT, 2, 4>(c, ep, stream)
                          : launch_mma_mt<T, OutT, 4, 4>(c, ep, stream);
    }
  }
  return c.Cout <= 32 ? launch_mma_mt<T, OutT, 2, 2>(c, ep, stream)
                      : launch_mma_mt<T, OutT, 4, 2>(c, ep, stream);
}

template <int R>
int launch_f32_r(const Conv& c, const Epilogue& ep, cudaStream_t stream) {
  const int ptiles = cdiv(c.W, FT), row_blocks = cdiv(c.H, R);
  const long long nx = static_cast<long long>(ptiles) * row_blocks * c.B;
  if (nx > 0x7fffffffLL || cdiv(c.Cout, CO) > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(nx), cdiv(c.Cout, CO));
  pixel_conv_f32<R><<<grid, FTHREADS, 0, stream>>>(
      static_cast<const float*>(c.x), static_cast<const float*>(c.w), ep,
      static_cast<float*>(c.out), c.H, c.Cin, c.W, c.Cout, c.xs, c.os, ptiles, row_blocks);
  return static_cast<int>(cudaGetLastError());
}

int launch_f32(const Conv& c, const Epilogue& ep, bool tall, cudaStream_t stream) {
  return tall ? launch_f32_r<4>(c, ep, stream) : launch_f32_r<1>(c, ep, stream);
}

// The 16-bit wgmma form of RW output rows a consumer warpgroup, by type,
// C_out (32 or 64) and whether the weight stays resident.
template <int RW, typename Run>
int run_pixel_wgmma(Run run, int x_dtype, int Cout, bool res) {
  const bool bf = x_dtype == kBF16;
  if (Cout == 64)
    return res ? (bf ? run(wg::launch_pixel_wgmma<__nv_bfloat16, 64, true, RW>)
                     : run(wg::launch_pixel_wgmma<__half, 64, true, RW>))
               : (bf ? run(wg::launch_pixel_wgmma<__nv_bfloat16, 64, false, RW>)
                     : run(wg::launch_pixel_wgmma<__half, 64, false, RW>));
  if (Cout == 32)
    return res ? (bf ? run(wg::launch_pixel_wgmma<__nv_bfloat16, 32, true, RW>)
                     : run(wg::launch_pixel_wgmma<__half, 32, true, RW>))
               : (bf ? run(wg::launch_pixel_wgmma<__nv_bfloat16, 32, false, RW>)
                     : run(wg::launch_pixel_wgmma<__half, 32, false, RW>));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" const char* smelter_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x (B, H, Cin, W) in x_dtype at element strides (xsb, xsh, xsc) with W
// contiguous; w [3][3][Cout][Cin] in x_dtype (int8 for int8 x); bias
// (Cout,) in bias_dtype (f32, or x's dtype for float x); scales (Cout,) f32
// for int8 x, else unused; out (B, H, Cout, W) at strides (osb, osh, osc)
// in out_dtype: x's dtype for float x; for int8 x int8 when requant, else
// f32, bf16 or f16. form 1: the wgmma kernel of csrc/wgmma_conv.cuh (16-bit
// x) or csrc/wgmma_conv_s8.cuh (int8 x; out int8, bf16 or f16) on `grid`
// CTAs with `stages` stages, each bringing its weights, in tiles of
// `tile_rows` output rows (16-bit: 4, or blockdot's 8; int8: 4); form 2: the
// same with the weight resident (Cout 32 or 64; kernels/wgmma_plan.py::
// pixel_plan checks the rest); form 0 the mma.sync / FMA kernels above,
// where tall takes 4 output rows a block (float x only) instead of 2 (1 for
// f32). Returns a cudaError_t code.
extern "C" int smelter_pixel_conv(const void* x, const void* w, const void* bias,
                                  const void* scales, void* out, int B, int H, int Cin, int W,
                                  int Cout, long long xsb, long long xsh, long long xsc,
                                  long long osb, long long osh, long long osc, int x_dtype,
                                  int bias_dtype, int out_dtype, float alpha, int has_alpha,
                                  float inv_sy, int requant, int tall, int form, int grid,
                                  int stages, int tile_rows, void* stream) {
  const Epilogue ep{bias, bias_dtype, static_cast<const float*>(scales), alpha, has_alpha,
                    inv_sy};
  const Conv c{x, w, out, B, H, Cin, W, Cout, {xsb, xsh, xsc}, {osb, osh, osc}};
  auto st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || W <= 0 || Cout <= 0) return 0;
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (bias_dtype != kF32 && bias_dtype != x_dtype) return bad;
  if ((form == 1 || form == 2) && x_dtype == kI8) {
    // requant: int8 out; else bf16 / f16 out (f32 out keeps form 0)
    if (tall || tile_rows != wg::PC_R || grid <= 0 || scales == nullptr || bias_dtype != kF32)
      return bad;
    if (requant ? out_dtype != kI8 : (out_dtype != kBF16 && out_dtype != kF16)) return bad;
    const wg::PixelQEpi qe{static_cast<const float*>(scales), static_cast<const float*>(bias),
                           alpha, has_alpha, inv_sy, out_dtype};
    auto run = [&](auto launch) {
      return launch(x, w, out, qe, B, H, Cin, W, xsb, xsh, xsc, osb, osh, osc, grid, stages, st);
    };
    const bool q8 = requant != 0, res = form == 2;
    if (Cout == 64)
      return res ? (q8 ? run(wg::launch_pixel_wgmma_s8<64, true, true>)
                       : run(wg::launch_pixel_wgmma_s8<64, true, false>))
                 : (q8 ? run(wg::launch_pixel_wgmma_s8<64, false, true>)
                       : run(wg::launch_pixel_wgmma_s8<64, false, false>));
    if (Cout == 32)
      return res ? (q8 ? run(wg::launch_pixel_wgmma_s8<32, true, true>)
                       : run(wg::launch_pixel_wgmma_s8<32, true, false>))
                 : (q8 ? run(wg::launch_pixel_wgmma_s8<32, false, true>)
                       : run(wg::launch_pixel_wgmma_s8<32, false, false>));
    return bad;
  }
  if (form == 1 || form == 2) {
    if (tall || out_dtype != x_dtype || grid <= 0) return bad;
    if (x_dtype != kBF16 && x_dtype != kF16) return bad;
    const wg::PixelEpi pe{bias, bias_dtype == kF32, alpha, has_alpha};
    auto run = [&](auto launch) {
      return launch(x, w, out, pe, B, H, Cin, W, xsb, xsh, xsc, osb, osh, osc, grid, stages, st);
    };
    if (tile_rows == wg::PixelRows<wg::PC_RW>::R)
      return run_pixel_wgmma<wg::PC_RW>(run, x_dtype, Cout, form == 2);
    if (tile_rows == wg::PixelRows<wg::PC_TALL_RW>::R)
      return run_pixel_wgmma<wg::PC_TALL_RW>(run, x_dtype, Cout, form == 2);
    return bad;
  }
  if (form != 0) return bad;
  switch (x_dtype) {
    case kF32:
      return out_dtype == kF32 ? launch_f32(c, ep, tall, st) : bad;
    case kBF16:
      return out_dtype == kBF16 ? launch_mma<__nv_bfloat16, __nv_bfloat16>(c, ep, tall, st) : bad;
    case kF16:
      return out_dtype == kF16 ? launch_mma<__half, __half>(c, ep, tall, st) : bad;
    case kI8:
      if (scales == nullptr || tall) return bad;
      if (requant) return out_dtype == kI8 ? launch_mma<int8_t, int8_t>(c, ep, false, st) : bad;
      switch (out_dtype) {
        case kF32: return launch_mma<int8_t, float>(c, ep, false, st);
        case kBF16: return launch_mma<int8_t, __nv_bfloat16>(c, ep, false, st);
        case kF16: return launch_mma<int8_t, __half>(c, ep, false, st);
        default: return bad;
      }
    default:
      return bad;
  }
}
