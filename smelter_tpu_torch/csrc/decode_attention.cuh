// GQA decode attention over a KV cache walked in row blocks (split-KV, or
// "flash-decoding"), shared by the paged kernel (paged_decode_attention.cu:
// a block is a run of rows of a pool page found through a page table) and
// the contiguous one (ragged_decode_attention.cu: a block is a run of a
// slot's own cache rows). The two differ only in where block j of slot b
// starts and how many of its rows exist; a `Rows` policy answers both.
//
// q (B, kvh, g*c, hd); K/V rows of kvh*hd elements in q's dtype, or int8
// with one scale a row (f32 or q's dtype). Query row i (chunk offset i % c)
// attends rows <= pos + i % c. Only blocks up to the frontier pos + c - 1
// are read, and of the last one only its rows up to the frontier: rows past
// it (a reused page or slot holds another sequence's values) are neither
// scored nor added, which is what zeroing them before p @ v does in the
// Pallas kernels.
//
// What bounds it: the live K/V bytes, while one CUDA block per (KV head,
// slot) would leave most SMs idle (llama_1b: 64 blocks on 132 SMs; one
// slot, 8) with each block's row blocks in series. So `split_chunk` runs a
// block of 4 warps per (row block, query-row group, KV head, slot), and the
// grid grows with the cache's length and not with pos (a captured CUDA
// graph replays at any position): a block wholly past the frontier reads
// nothing and writes a neutral partial. A block holds up to GMAX query rows
// (16, or 8 at hd 256, where 16 rows of f32 sums would not fit the
// registers); g*c past that runs in further groups, each reading the
// block's K/V rows once. Each warp takes U = 32 / GCP rows a step (GCP:
// the group's rows padded to 4, 8 or 16), lanes over the head dims, K and V
// of the step loaded together; its 32 partial dots (U rows x GCP query
// rows) are summed across the lanes by a transposed butterfly (31 shuffles
// leave lane u GCP + i with the score of row u and query row i). The
// streaming softmax in f32 then advances a pair of rows at a time, the
// pairs of warp w being rows 2w, 2w + 1, then 2w + 8, 2w + 9, ...: which
// rows a warp takes and in what order, and so every rounding, is the same
// at every GCP, so a query row's output does not depend on how many rows
// share its block (a chunk-5 verify gives the tokens single steps give).
// p @ v takes each p by a shuffle. The 4 warps' states are merged in warp
// order into the block's partial (running max, sum, f32 sums over hd) in
// the scratch the wrapper allocates; `split_combine` merges a slot's
// partials in block order and divides. Every sum's order is fixed, so two
// calls agree bit for bit. No tensor cores: at g*c <= 16 query rows a
// block there is nothing for them to do.
#pragma once

#include "common.cuh"

#include <math_constants.h>

namespace smelter {
namespace decode_attention {


__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(int8_t v) { return static_cast<float>(v); }

// N consecutive elements of T at p (N * sizeof(T) bytes, aligned to that
// size up to 16) as floats.
template <typename T, int N>
__device__ __forceinline__ void load_vec(const T* p, float (&f)[N]) {
  constexpr int BYTES = N * static_cast<int>(sizeof(T));
  if constexpr (BYTES >= 16) {
    constexpr int PER = 16 / static_cast<int>(sizeof(T));
#pragma unroll
    for (int c = 0; c < BYTES / 16; ++c) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(p) + c);
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int i = 0; i < PER; ++i) f[c * PER + i] = to_f(e[i]);
    }
  } else if constexpr (BYTES == 8) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int i = 0; i < N; ++i) f[i] = to_f(e[i]);
  } else if constexpr (BYTES == 4) {
    const unsigned u = __ldg(reinterpret_cast<const unsigned*>(p));
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int i = 0; i < N; ++i) f[i] = to_f(e[i]);
  } else if constexpr (BYTES == 2) {
    const unsigned short u = __ldg(reinterpret_cast<const unsigned short*>(p));
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int i = 0; i < N; ++i) f[i] = to_f(e[i]);
  } else {
    static_assert(BYTES == 1, "load_vec: 1, 2, 4, 8 or 16k bytes");
    f[0] = to_f(static_cast<T>(__ldg(reinterpret_cast<const signed char*>(p))));
  }
}

// Rows policies. `block_rows` is the rows of one block; `blocks(b, last)`
// how many blocks slot b reads for the frontier row `last`; `first_row(b,
// j)` the flat row index (into the (rows, kvh*hd) K/V and the (rows,)
// scales) of block j's row 0, which is row j*block_rows of the slot's
// sequence; `rows(j, last)` how many of block j's rows exist up to the
// frontier.

// A pool of (P, ps) rows shared by all slots, each page cut into `split`
// blocks of block_rows = ps / split rows: block j of slot b is the
// (j % split)-th run of page table[b, j / split] (clamped into the pool),
// j < npg * split.
struct PagedRows {
  const int* table;
  int P, npg, ps, split, block_rows;
  __device__ int blocks(int, long long last) const {
    if (last < 0) return 0;
    const long long jmax = static_cast<long long>(npg) * split - 1;
    return static_cast<int>(min(last / block_rows, jmax)) + 1;
  }
  __device__ size_t first_row(int b, int j) const {
    const int page = min(max(table[b * npg + j / split], 0), P - 1);
    return static_cast<size_t>(page) * ps + static_cast<size_t>(j % split) * block_rows;
  }
  __device__ int rows(int j, long long last) const {
    return static_cast<int>(
        min(static_cast<long long>(block_rows), last - static_cast<long long>(j) * block_rows + 1));
  }
};

// Per-slot caches (B, L) laid end to end; block j of slot b is its rows
// j*block_rows ... up to L.
struct ContiguousRows {
  int L, block_rows;
  __device__ int blocks(int, long long last) const {
    if (last < 0) return 0;
    const long long lmax = min(last, static_cast<long long>(L - 1));
    return static_cast<int>(lmax / block_rows) + 1;
  }
  __device__ size_t first_row(int b, int j) const {
    return static_cast<size_t>(b) * L + static_cast<size_t>(j) * block_rows;
  }
  __device__ int rows(int j, long long last) const {
    const long long lo = static_cast<long long>(j) * block_rows;
    return static_cast<int>(min(min(static_cast<long long>(block_rows), last - lo + 1),
                                static_cast<long long>(L) - lo));
  }
};

// -- split-KV -------------------------------------------------------------------

constexpr int SPLIT_WARPS = 4, SPLIT_THREADS = 32 * SPLIT_WARPS;

// N elements of a cache row at p as floats: int8 four bytes at a time
// through the float 2^23 trick (s8 + 128 as the low byte of 0x4B000000,
// then - (2^23 + 128): exact, and full-rate where a conversion is not).
template <typename T, int N>
__device__ __forceinline__ void load_row(const T* p, float (&f)[N]) {
  load_vec<T, N>(p, f);
}
template <>
__device__ __forceinline__ void load_row<int8_t, 4>(const int8_t* p, float (&f)[4]) {
  const uint32_t w = __ldg(reinterpret_cast<const unsigned*>(p)) ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540 + i)) - 8388736.f;
}
template <>
__device__ __forceinline__ void load_row<int8_t, 8>(const int8_t* p, float (&f)[8]) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  const uint32_t w[2] = {u.x ^ 0x80808080u, u.y ^ 0x80808080u};
#pragma unroll
  for (int i = 0; i < 8; ++i)
    f[i] = __uint_as_float(__byte_perm(w[i / 4], 0x4B000000u, 0x7540 + i % 4)) - 8388736.f;
}

// A row's scale, f32 or q's type QT.
template <typename QT>
__device__ __forceinline__ float scale_at(const void* s, int f32, size_t i) {
  return f32 ? __ldg(static_cast<const float*>(s) + i) : to_f(static_cast<const QT*>(s)[i]);
}

// v[t] summed over the warp's 32 lanes for every t at once: lane L ends
// with the sum of v[L] in v[0]. Each round (lane bit O) halves the values a
// lane holds, keeping the half its lane bit names and adding its partner's
// copy of it; the order of every sum is fixed.
template <int O>
__device__ __forceinline__ void warp_sum_transposed(float (&v)[32], int lane) {
  const bool up = (lane & O) != 0;
#pragma unroll
  for (int t = 0; t < O; ++t) {
    const float keep = up ? v[t + O] : v[t];
    const float give = up ? v[t] : v[t + O];
    v[t] = keep + __shfl_xor_sync(0xffffffffu, give, O);
  }
  if constexpr (O > 1) warp_sum_transposed<O / 2>(v, lane);
}

// Pass 1: block (j + nblk grp, h, b) attends query rows i0 ... i0 + GCP - 1
// (i0 = grp GCP, those below gc) of (b, h) over row block j of slot b;
// part_acc (B, kvh, nblk, gc, HD) and part_ml (B, kvh, nblk, gc, 2)
// receive their f32 sums, running max and sum (a neutral partial -inf, 0,
// 0 where the block lies wholly past the frontier). GCP: the group's rows
// rounded up to 4, 8 or 16 (U = 32 / GCP rows a warp's step).
template <typename QT, typename KT, int HD, int GCP, typename Rows>
__global__ void __launch_bounds__(SPLIT_THREADS, HD > 128 ? 1 : GCP * HD <= 1024 ? 4 : 2)
split_chunk(const QT* __restrict__ q, const KT* __restrict__ kp, const KT* __restrict__ vp,
            const void* __restrict__ ksp, const void* __restrict__ vsp, int scale_f32,
            const long long* __restrict__ pos, float* __restrict__ part_acc,
            float* __restrict__ part_ml, Rows src, int kvh, int gc, int c, int nblk,
            float scale) {
  constexpr bool QUANT = sizeof(KT) == 1;
  constexpr int EPL = HD / 32, U = 32 / GCP;
  const float NEG = -CUDART_INF_F;
  __shared__ float s_m[SPLIT_WARPS][GCP], s_l[SPLIT_WARPS][GCP];
  __shared__ float s_acc[SPLIT_WARPS][GCP][HD];
  const int j = blockIdx.x % nblk, i0 = blockIdx.x / nblk * GCP;
  const int h = blockIdx.y, b = blockIdx.z;
  const int gn = min(GCP, gc - i0);  // the group's query rows
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long p = pos[b];
  const long long last = p + c - 1;  // the frontier: last row written
  const size_t part = (static_cast<size_t>(b) * kvh + h) * nblk + j;
  float* const acc_out = part_acc + (part * gc + i0) * HD;
  float* const ml_out = part_ml + (part * gc + i0) * 2;
  const int live = j < src.blocks(b, last) ? src.rows(j, last) : 0;
  if (live <= 0) {  // wholly past the frontier
    for (int e = threadIdx.x; e < gn * HD; e += SPLIT_THREADS) acc_out[e] = 0.f;
    for (int i = threadIdx.x; i < gn; i += SPLIT_THREADS) {
      ml_out[i * 2] = NEG;
      ml_out[i * 2 + 1] = 0.f;
    }
    return;
  }
  const int kvd = kvh * HD, d0 = lane * EPL;
  const size_t base = src.first_row(b, j);                          // flat row of row 0
  const long long lo = static_cast<long long>(j) * src.block_rows;  // its row in the sequence
  const int my_u = lane / GCP, my_i = lane % GCP;  // the (row, query row) this lane scores
  const int my_c = (i0 + my_i) % c;                // its query row's chunk offset

  float qf[GCP][EPL], acc[GCP][EPL];
  const QT* qb = q + ((static_cast<size_t>(b) * kvh + h) * gc + i0) * HD + d0;
#pragma unroll
  for (int i = 0; i < GCP; ++i) {
    if (i < gn) {
      load_vec<QT, EPL>(qb + i * HD, qf[i]);
    } else {
#pragma unroll
      for (int e = 0; e < EPL; ++e) qf[i][e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[i][e] = 0.f;
  }
  float m_run = NEG, l_run = 0.f;  // of query row my_i

  // warp w's row pairs are 2w + 8t, t = 0, 1, ...; a step takes U / 2 of
  // them: row u of the step is 2w + 8 (t0 + u / 2) + u % 2
  for (int t0 = 0; 2 * warp + 8 * t0 < live; t0 += U / 2) {
    const int r_first = 2 * warp + 8 * t0;
    float kf[U][EPL], vf[U][EPL];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = r_first + 8 * (u / 2) + u % 2;
      if (r < live) {
        const size_t row = (base + r) * kvd + h * HD + d0;
        load_row<KT, EPL>(kp + row, kf[u]);
        load_row<KT, EPL>(vp + row, vf[u]);
      } else {
#pragma unroll
        for (int e = 0; e < EPL; ++e) kf[u][e] = vf[u][e] = 0.f;
      }
    }
    const int r = r_first + 8 * (my_u / 2) + my_u % 2;  // this lane's row in the block
    float ks = 1.f, vs = 0.f;
    if (r < live) {
      ks = QUANT ? scale_at<QT>(ksp, scale_f32, base + r) : 1.f;
      vs = QUANT ? scale_at<QT>(vsp, scale_f32, base + r) : 1.f;
    }
    float dot[32];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int i = 0; i < GCP; ++i) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) d = fmaf(qf[i][e], kf[u][e], d);
        dot[u * GCP + i] = d;
      }
    warp_sum_transposed<16>(dot, lane);
    const bool valid = r < live && my_i < gn && lo + r <= p + my_c;
    const float s = valid ? dot[0] * ks * scale : NEG;
    // the streaming softmax of query row my_i, a pair of rows at a time
#pragma unroll
    for (int t = 0; t < U / 2; ++t) {
      const float sa = __shfl_sync(0xffffffffu, s, 2 * t * GCP + my_i);
      const float sb = __shfl_sync(0xffffffffu, s, (2 * t + 1) * GCP + my_i);
      const float m_new = fmaxf(m_run, fmaxf(sa, sb));
      const float pa = sa == NEG ? 0.f : expf(sa - m_new);
      const float pb = sb == NEG ? 0.f : expf(sb - m_new);
      const float alpha = m_new == NEG ? 1.f : expf(m_run - m_new);
      l_run = alpha * l_run + (pa + pb);
      m_run = m_new;
      const float wa = pa * __shfl_sync(0xffffffffu, vs, 2 * t * GCP);
      const float wb = pb * __shfl_sync(0xffffffffu, vs, (2 * t + 1) * GCP);
#pragma unroll
      for (int i = 0; i < GCP; ++i) {
        const float a = __shfl_sync(0xffffffffu, alpha, i);
        const float xa = __shfl_sync(0xffffffffu, wa, i);
        const float xb = __shfl_sync(0xffffffffu, wb, i);
#pragma unroll
        for (int e = 0; e < EPL; ++e)
          acc[i][e] = fmaf(xb, vf[2 * t + 1][e], fmaf(xa, vf[2 * t][e], acc[i][e] * a));
      }
    }
  }

  // the warps' states, merged in warp order into the block's partial
  if (lane < GCP) {
    s_m[warp][lane] = m_run;
    s_l[warp][lane] = l_run;
  }
#pragma unroll
  for (int i = 0; i < GCP; ++i)
#pragma unroll
    for (int e = 0; e < EPL; ++e) s_acc[warp][i][d0 + e] = acc[i][e];
  __syncthreads();
  for (int e = threadIdx.x; e < gn * HD; e += SPLIT_THREADS) {
    const int i = e / HD, d = e % HD;
    float M = NEG;
#pragma unroll
    for (int w = 0; w < SPLIT_WARPS; ++w) M = fmaxf(M, s_m[w][i]);
    float sum = 0.f, l = 0.f;
#pragma unroll
    for (int w = 0; w < SPLIT_WARPS; ++w) {
      const float f = s_m[w][i] == NEG ? 0.f : expf(s_m[w][i] - M);
      sum += s_acc[w][i][d] * f;
      l += s_l[w][i] * f;
    }
    acc_out[e] = sum;
    if (d == 0) {
      ml_out[i * 2] = M;
      ml_out[i * 2 + 1] = l;
    }
  }
}

// Pass 2: block (h, b) merges slot b's nblk partials of KV head h in block
// order and writes out (B, kvh, gc, hd) in QT.
template <typename QT>
__global__ void __launch_bounds__(SPLIT_THREADS)
split_combine(const float* __restrict__ part_acc, const float* __restrict__ part_ml,
              QT* __restrict__ out, int kvh, int gc, int hd, int nblk) {
  const int h = blockIdx.x, b = blockIdx.y;
  const size_t first = (static_cast<size_t>(b) * kvh + h) * nblk;  // partial of block 0
  for (int e = threadIdx.x; e < gc * hd; e += SPLIT_THREADS) {
    const int i = e / hd;
    float M = -CUDART_INF_F;
    for (int j = 0; j < nblk; ++j) M = fmaxf(M, part_ml[((first + j) * gc + i) * 2]);
    float sum = 0.f, l = 0.f;
    for (int j = 0; j < nblk; ++j) {
      const float m = part_ml[((first + j) * gc + i) * 2];
      const float f = m == -CUDART_INF_F ? 0.f : expf(m - M);
      sum += part_acc[(first + j) * gc * hd + e] * f;
      l += part_ml[((first + j) * gc + i) * 2 + 1] * f;
    }
    store(&out[(static_cast<size_t>(b) * kvh + h) * gc * hd + e], sum / l);
  }
}

// Query rows a block holds at head dim HD: 16, or 8 at hd 256 (16 rows of
// f32 sums and q would not fit a thread's 255 registers).
template <int HD>
constexpr int group_max() {
  return HD > 128 ? 8 : 16;
}

// Both passes on the caller's stream: scratch holds B kvh nblk gc (hd + 2)
// floats. Float K/V hold q's type; int8 ones take scales in f32
// (scale_f32) or q's type. g*c rows go in groups of GCP: one group padded
// to 4, 8 or 16 where gc <= group_max, else groups of group_max.
template <typename QT, typename KT, int HD, typename Rows>
int launch_split_hd(const void* q, const void* k, const void* v, const void* ks, const void* vs,
                    int scale_f32, const long long* pos, void* out, float* scratch,
                    const Rows& src, int B, int kvh, int gc, int c, int nblk, float scale,
                    cudaStream_t stream) {
  constexpr int GMAX = group_max<HD>();
  float* part_acc = scratch;
  float* part_ml = scratch + static_cast<size_t>(B) * kvh * nblk * gc * HD;
  const auto* qq = static_cast<const QT*>(q);
  const auto* kk = static_cast<const KT*>(k);
  const auto* vv = static_cast<const KT*>(v);
  const int gcp = gc > GMAX ? GMAX : gc <= 4 ? 4 : gc <= 8 ? 8 : 16;
  const dim3 grid(nblk * cdiv(gc, gcp), kvh, B);
#define SMELTER_CHUNK(GCP_)                                                                    \
  split_chunk<QT, KT, HD, GCP_, Rows><<<grid, SPLIT_THREADS, 0, stream>>>(                     \
      qq, kk, vv, ks, vs, scale_f32, pos, part_acc, part_ml, src, kvh, gc, c, nblk, scale)
  if (gcp == 4) {
    SMELTER_CHUNK(4);
  } else if (gcp == 8) {
    SMELTER_CHUNK(8);
  } else if constexpr (GMAX >= 16) {
    SMELTER_CHUNK(16);
  }
#undef SMELTER_CHUNK
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  split_combine<QT><<<dim3(kvh, B), SPLIT_THREADS, 0, stream>>>(
      part_acc, part_ml, static_cast<QT*>(out), kvh, gc, HD, nblk);
  return static_cast<int>(cudaGetLastError());
}

template <typename QT, typename Rows>
int launch_split(int kv_dtype, int scale_dtype, const void* q, const void* k, const void* v,
                 const void* ks, const void* vs, const void* pos, void* out, void* scratch,
                 const Rows& src, int B, int kvh, int hd, int gc, int c, int nblk, float scale,
                 cudaStream_t st) {
  const auto* p = static_cast<const long long*>(pos);
  auto* sc = static_cast<float*>(scratch);
  const int f32 = scale_dtype == kF32;
#define SMELTER_SPLIT(HD_)                                                                    \
  return kv_dtype == kI8                                                                      \
             ? launch_split_hd<QT, int8_t, HD_>(q, k, v, ks, vs, f32, p, out, sc, src, B, kvh, \
                                                gc, c, nblk, scale, st)                       \
             : launch_split_hd<QT, QT, HD_>(q, k, v, ks, vs, f32, p, out, sc, src, B, kvh, gc, \
                                            c, nblk, scale, st)
  switch (hd) {
    case 32: SMELTER_SPLIT(32);
    case 64: SMELTER_SPLIT(64);
    case 128: SMELTER_SPLIT(128);
    case 256: SMELTER_SPLIT(256);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SMELTER_SPLIT
}

}  // namespace decode_attention
}  // namespace smelter
