// Pieces shared by csrc/flash_attention.cu and csrc/attention_short.cu:
// strided (B, H, N, hd) operands, the 64-row tiles both tensor-core kernels
// stage in shared memory, the Q K^T scores of one warp's 16 query rows on
// mma.sync, and a warp-per-query-row kernel for every case the tensor-core
// kernels do not take (f32, head dims other than 16, 32, 64 and 128, rows
// not 16-byte aligned).
//
// An operand is addressed by element strides for its batch, head and row
// axes; the head dim is contiguous. So q, k and v may be (B, H, N, hd) views
// of (B, N, H, hd) tensors, as a graph's Reshape -> Transpose hands them
// over, and the output may be written in (B, N, H, hd) order, so that the
// graph's Transpose -> Reshape back copies nothing.
#pragma once

#include "gemm.cuh"

namespace smelter {

struct Strides {
  int b, h, n;  // elements between batches, heads and rows
};

__device__ __forceinline__ size_t row_at(const Strides& s, int b, int h, int n) {
  return static_cast<size_t>(b) * s.b + static_cast<size_t>(h) * s.h +
         static_cast<size_t>(n) * s.n;
}

constexpr int ATT_ROWS = 64;  // query rows (and keys) a tile: 4 warps of 16 rows
constexpr int ATT_THREADS = 128;

// Rows r0 .. r0 + 63 of head (b, h) into a shared tile of pitch HD + 8
// halves, by cp.async; rows at or past n_valid are zeros.
template <int HD>
__device__ __forceinline__ void load_tile(uint16_t* dst, const uint16_t* src, const Strides& s,
                                          int b, int h, int r0, int n_valid) {
  for (int c = threadIdx.x; c < ATT_ROWS * (HD / 8); c += ATT_THREADS) {
    const int r = c / (HD / 8), d = (c % (HD / 8)) * 8;
    const bool in = r0 + r < n_valid;
    cp_async16(&dst[r * (HD + 8) + d], in ? src + row_at(s, b, h, r0 + r) + d : src, in);
  }
}

// The A fragments of the warp's 16 query rows (from row wq of the tile).
template <int HD>
__device__ __forceinline__ void q_fragments(uint32_t (&qa)[HD / 16][4], const uint16_t* tile,
                                            int wq) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    ldmatrix_x4(qa[kk], &tile[(wq + (lane & 15)) * (HD + 8) + kk * 16 + (lane >> 4) * 8]);
}

// f32 Q K^T of the warp's 16 rows against a 64-key tile: element e of
// tile j is row g + 8 (e >> 1), key 8 j + 2 t + (e & 1) (g = lane / 4,
// t = lane % 4).
template <typename T, int HD>
__device__ __forceinline__ void tile_scores(float (&s)[8][4], const uint32_t (&qa)[HD / 16][4],
                                            const uint16_t* keys) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int j = 0; j < 8; j += 2)
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      // key rows are the B operand's columns: tiles j and j + 1, both k halves
      uint32_t r[4];
      ldmatrix_x4(r, &keys[((j + (lane >> 4)) * 8 + (lane & 7)) * (HD + 8) + kk * 16 +
                           ((lane >> 3) & 1) * 8]);
      const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
      mma_16816<T>(s[j], qa[kk], b0);
      mma_16816<T>(s[j + 1], qa[kk], b1);
    }
}

// o += P V for the warp's 16 rows over 16 keys: `a` holds P's A fragment,
// `vals` the tile's rows from the 16 keys on.
template <typename T, int HD>
__device__ __forceinline__ void pv_step(float (&o)[HD / 8][4], const uint32_t (&a)[4],
                                        const uint16_t* vals) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int nj = 0; nj < HD / 16; ++nj) {
    uint32_t r[4];
    ldmatrix_x4_trans(r, &vals[(lane & 15) * (HD + 8) + nj * 16 + (lane >> 4) * 8]);
    const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
    mma_16816<T>(o[2 * nj], a, b0);
    mma_16816<T>(o[2 * nj + 1], a, b1);
  }
}

// The warp's 16 output rows, o[n][e] * inv[e >> 1], rounded to T.
template <typename T, int HD>
__device__ __forceinline__ void store_rows(uint16_t* out, const Strides& s, int b, int h,
                                           int row0, int n_valid, const float (&o)[HD / 8][4],
                                           const float (&inv)[2]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= n_valid) continue;
    uint16_t* dst = out + row_at(s, b, h, row) + t * 2;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<uint32_t*>(dst + n * 8) =
          pack2<T>(o[n][2 * r] * inv[r], o[n][2 * r + 1] * inv[r]);
  }
}

// Any type and head dim <= 256: a warp per query row, lanes over the head
// dim, keys read straight from device memory. The first pass takes the
// row's max and sum of exp(s - max) in f32; the second accumulates p V in
// f32 with p = exp(s - max) / sum rounded to T (ROUND_P, short_attention)
// or the f32 exp(s - max), divided by the sum at the end (flash_attention).
constexpr int ROWS_HD_MAX = 256;

template <typename T, bool ROUND_P>
__global__ void __launch_bounds__(ATT_THREADS)
attention_rows(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               T* __restrict__ out, Strides qs, Strides ks, Strides vs, Strides os, int Nq,
               int Nk, int HD, float scale) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.z, h = blockIdx.y, row = blockIdx.x * (ATT_THREADS / 32) + warp;
  if (row >= Nq) return;
  constexpr int PER = ROWS_HD_MAX / 32;
  const T* qr = q + row_at(qs, b, h, row);
  float qv[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int d = lane + 32 * i;
    qv[i] = d < HD ? to_float(qr[d]) : 0.f;
  }
  auto score = [&](int key) {
    const T* kr = k + row_at(ks, b, h, key);
    float dot = 0.f;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int d = lane + 32 * i;
      if (d < HD) dot += qv[i] * to_float(kr[d]);
    }
    return warp_sum(dot) * scale;
  };
  float m = -INFINITY, l = 0.f;
  for (int key = 0; key < Nk; ++key) {
    const float sc = score(key);
    const float mn = fmaxf(m, sc);
    l = l * expf(m - mn) + expf(sc - mn);
    m = mn;
  }
  float o[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) o[i] = 0.f;
  for (int key = 0; key < Nk; ++key) {
    const float e = expf(score(key) - m);
    const float p = ROUND_P ? round_to<T>(e / l) : e;
    const T* vr = v + row_at(vs, b, h, key);
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int d = lane + 32 * i;
      if (d < HD) o[i] += p * to_float(vr[d]);
    }
  }
  const float inv = ROUND_P ? 1.f : 1.f / l;
  T* dst = out + row_at(os, b, h, row);
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int d = lane + 32 * i;
    if (d < HD) store(&dst[d], ROUND_P ? o[i] : o[i] * inv);
  }
}

// Whether the tensor-core kernels take these operands: a 16-bit type, a
// head dim of 16, 32, 64 or 128, and every row 16-byte aligned.
inline bool mma_path(int dtype, int hd, const void* const (&ptrs)[4],
                     const Strides (&strides)[4]) {
  if (dtype != kBF16 && dtype != kF16) return false;
  if (hd != 16 && hd != 32 && hd != 64 && hd != 128) return false;
  for (int i = 0; i < 4; ++i) {
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16 != 0) return false;
    if (strides[i].b % 8 != 0 || strides[i].h % 8 != 0 || strides[i].n % 8 != 0) return false;
  }
  return true;
}

template <typename T, bool ROUND_P>
void launch_rows(const void* q, const void* k, const void* v, void* o, const Strides (&s)[4],
                 int B, int H, int Nq, int Nk, int hd, float scale, cudaStream_t stream) {
  const dim3 grid(cdiv(Nq, ATT_THREADS / 32), H, B);
  attention_rows<T, ROUND_P><<<grid, ATT_THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), s[0], s[1], s[2], s[3], Nq, Nk, hd, scale);
}

}  // namespace smelter
