// Pieces of the int8 x int8 -> int32 GEMMs (int8_matmul.cu, int8_matmul_fused.cu).
//
// A K step is 64 bytes deep. The activation tile sits in shared memory as it
// is, [m][k]; the (K, N) row-major weight tile is laid out for the B
// fragment as [n][k]: each thread reads 4x4 byte blocks, transposes them in
// registers with byte permutes and stores them as [n][k]. Both fragments are
// then plain 32-bit shared loads. Rows are 80 bytes apart, so the 8 rows a
// fragment load touches fall in distinct banks. The weight tile's 4-byte
// words are swizzled: word w of row n sits at w ^ ((n / 8) % 16), so that
// the stash's 32 lanes (32 consecutive column blocks, rows 320 bytes apart:
// two banks unswizzled, a 16-way conflict) hit 32 banks, and a fragment
// load's 8 rows (one n / 8) keep their conflict-free pattern.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace smelter {
namespace i8 {

constexpr int BK = 64;       // bytes of K a step
constexpr int SK = BK + 16;  // bytes a staged row, [m][k] or [n][k]

__device__ __forceinline__ uint32_t load_byte(const int8_t* p) {
  return static_cast<uint32_t>(static_cast<uint8_t>(*p));
}

// r[i] holds bytes (k + i, n .. n + 3) of a row-major int8 matrix; col[j]
// gets bytes (k .. k + 3, n + j).
__device__ __forceinline__ void transpose4x4(const uint32_t (&r)[4], uint32_t (&col)[4]) {
  const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140), t1 = __byte_perm(r[0], r[1], 0x7362);
  const uint32_t t2 = __byte_perm(r[2], r[3], 0x5140), t3 = __byte_perm(r[2], r[3], 0x7362);
  col[0] = __byte_perm(t0, t2, 0x5410);
  col[1] = __byte_perm(t0, t2, 0x7632);
  col[2] = __byte_perm(t1, t3, 0x5410);
  col[3] = __byte_perm(t1, t3, 0x7632);
}

// The weight tile [k0, k0 + BK) x [n0, n0 + BN) of a (K, N) row-major int8
// matrix, NB 4x4 byte blocks a thread, zero outside [0, K) x [0, N). `load`
// fills registers (so the next step's loads can be in flight while the
// tensor cores work), `stash` writes them transposed to Bs [BN][SK].
template <int BN, int THREADS>
struct WTile {
  static constexpr int NB = (BK / 4) * (BN / 4) / THREADS;
  static_assert(NB * THREADS == (BK / 4) * (BN / 4), "tile does not split over the threads");
  uint32_t r[NB][4];

  __device__ __forceinline__ void load(const int8_t* __restrict__ w, int K, int N, int k0,
                                       int n0, bool vec, int tid) {
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const int c = tid + b * THREADS;
      const int kb = c / (BN / 4), nb = c % (BN / 4);
      const int gk = k0 + kb * 4, gn = n0 + nb * 4;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int8_t* row = w + static_cast<size_t>(gk + i) * N + gn;
        if (vec && gk + i < K && gn + 4 <= N) {
          r[b][i] = *reinterpret_cast<const uint32_t*>(row);
        } else {
          r[b][i] = 0u;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (gk + i < K && gn + j < N) r[b][i] |= load_byte(row + j) << (8 * j);
        }
      }
    }
  }

  __device__ __forceinline__ void stash(int8_t* Bs, int tid) const {
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const int c = tid + b * THREADS;
      const int kb = c / (BN / 4), nb = c % (BN / 4);
      const int word = kb ^ ((nb >> 1) & 15);  // rows nb * 4 .. + 3 share n / 8
      uint32_t col[4];
      transpose4x4(r[b], col);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<uint32_t*>(&Bs[(nb * 4 + j) * SK + word * 4]) = col[j];
    }
  }
};

// One warp's 32 x 8NT sub-tile over one K step: A from As ([m][k], rows
// `sa` bytes apart, pointing at the warp's first row and the step's first
// byte), B from the swizzled Bs ([n][k]) from column n0 (a multiple of 8).
template <int NT>
__device__ __forceinline__ void mma_step(int (&acc)[2][NT][4], const int8_t* As, int sa,
                                         const int8_t* Bs, int n0, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < BK; kk += 32) {
    uint32_t a[2][4], b[NT][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int8_t* pa = As + (mi * 16 + g) * sa + kk + t * 4;
      a[mi][0] = *reinterpret_cast<const uint32_t*>(pa);
      a[mi][1] = *reinterpret_cast<const uint32_t*>(pa + 8 * sa);
      a[mi][2] = *reinterpret_cast<const uint32_t*>(pa + 16);
      a[mi][3] = *reinterpret_cast<const uint32_t*>(pa + 8 * sa + 16);
    }
#pragma unroll
    for (int ni = 0; ni < NT; ++ni) {
      const int8_t* pb = Bs + (n0 + ni * 8 + g) * SK;
      const int swz = ((n0 >> 3) + ni) & 15, w0 = kk / 4 + t;
      b[ni][0] = *reinterpret_cast<const uint32_t*>(pb + 4 * (w0 ^ swz));
      b[ni][1] = *reinterpret_cast<const uint32_t*>(pb + 4 * ((w0 + 4) ^ swz));
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < NT; ++ni) mma_16832_s8(acc[mi][ni], a[mi], b[ni]);
  }
}

template <int NT>
__device__ __forceinline__ void zero(int (&acc)[2][NT][4]) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;
}

// float(acc) * s_row * s_col in that order, then one rounding to OutT (int:
// the raw sum).
template <typename OutT>
__device__ __forceinline__ void epilogue(OutT* p, int acc, float sr, float sc) {
  if constexpr (std::is_same<OutT, int>::value) {
    *p = acc;
  } else {
    store(p, __fmul_rn(__fmul_rn(__int2float_rn(acc), sr), sc));
  }
}

// Writes a warp's 32 x 8NT sub-tile at (row0, col0) of the (M, N) output,
// masked at the M and N edges.
template <int NT, typename OutT>
__device__ __forceinline__ void store_tile(OutT* __restrict__ out, const int (&acc)[2][NT][4],
                                           const float* __restrict__ s_row,
                                           const float* __restrict__ s_col, int M, int N,
                                           int row0, int col0, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni) {
      const int col = col0 + ni * 8 + t * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + mi * 16 + g + h * 8;
        if (row >= M) continue;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          if (col + j >= N) continue;
          epilogue(&out[static_cast<size_t>(row) * N + col + j], acc[mi][ni][h * 2 + j],
                   s_row[row], s_col[col + j]);
        }
      }
    }
}

}  // namespace i8
}  // namespace smelter
