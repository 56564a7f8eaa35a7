// The implicit-GEMM tile loader of the port's convolution kernels
// (csrc/qlinear_conv.cu, csrc/dequant_conv.cu).
//
// A convolution of an NHWC input x (N, H, W, C) with a kh x kw kernel is a
// GEMM over M = N * H_o * W_o output pixels and K = kh * kw * C, with
// element (m, k) of A the input value under tap (ky, kx) = divmod(k / C, kw)
// and channel k % C of output pixel m:
//
//   A(m, k) = x[n, i * sh - pt + ky, j * sw - pl + kx, k % C]
//
// and zero where that position lies in the padding. K runs over (ky, kx, c)
// with c fastest, which is also the order of an OHWI weight's row and of an
// HWIO weight's column. The loader reads A a 16-byte chunk at a time: one
// vector load when the chunk lies inside one tap (C a multiple of the
// chunk's elements and x 16-byte aligned), else an element at a time over
// the flattened K, so a C of 3 (an RGB stem) needs no padded copy.
#pragma once

#include "common.cuh"

namespace smelter {

struct ConvGeom {
  int N, H, W, C;    // input, NHWC
  int Ho, Wo;        // output map
  int kh, kw;        // kernel taps
  int sh, sw;        // strides
  int pt, pl;        // top and left pads (bottom and right follow from Ho, Wo)
  int M, K;          // N * Ho * Wo, kh * kw * C
};

inline ConvGeom conv_geom(int N, int H, int W, int C, int Ho, int Wo, int kh, int kw, int sh,
                          int sw, int pt, int pl) {
  return ConvGeom{N, H, W, C, Ho, Wo, kh, kw, sh, sw, pt, pl, N * Ho * Wo, kh * kw * C};
}

// One output pixel's corner in the input: tap (ky, kx) reads row h0 + ky,
// column w0 + kx of image n. ok is false past the last pixel.
struct PixelAt {
  int n, h0, w0;
  bool ok;
};

__device__ __forceinline__ PixelAt pixel_at(const ConvGeom& g, int m) {
  PixelAt p{0, 0, 0, m < g.M};
  if (p.ok) {
    const int hw = g.Ho * g.Wo;
    p.n = m / hw;
    const int r = m - p.n * hw;
    const int i = r / g.Wo;
    p.h0 = i * g.sh - g.pt;
    p.w0 = (r - i * g.Wo) * g.sw - g.pl;
  }
  return p;
}

// Element offset in x of A(m, k) for pixel p, or -1 where it is zero
// (padding, k past K, or a pixel past M).
__device__ __forceinline__ long long tap_offset(const ConvGeom& g, const PixelAt& p, int k) {
  if (!p.ok || k >= g.K) return -1;
  const int tap = k / g.C;
  const int c = k - tap * g.C;
  const int ky = tap / g.kw;
  const int h = p.h0 + ky, w = p.w0 + (tap - ky * g.kw);
  if (h < 0 || h >= g.H || w < 0 || w >= g.W) return -1;
  return (static_cast<long long>(p.n * g.H + h) * g.W + w) * g.C + c;
}

// 16 bytes of A's row for pixel p from column k on: 16 / sizeof(T)
// elements of type T (int8_t, or a 16-bit float's bits as uint16_t), zeros
// where A is zero. `vec`: the chunk lies inside one tap and x is 16-byte
// aligned, so one vector load reads it.
template <typename T>
__device__ __forceinline__ uint4 gather16(const T* __restrict__ x, const ConvGeom& g,
                                          const PixelAt& p, int k, bool vec) {
  constexpr int E = 16 / sizeof(T);
  if (vec) {
    const long long off = tap_offset(g, p, k);
    return off < 0 ? make_uint4(0u, 0u, 0u, 0u) : *reinterpret_cast<const uint4*>(x + off);
  }
  union {
    uint4 v;
    T e[E];
  } u;
#pragma unroll
  for (int j = 0; j < E; ++j) {
    const long long off = tap_offset(g, p, k + j);
    u.e[j] = off < 0 ? T(0) : x[off];
  }
  return u.v;
}

}  // namespace smelter
