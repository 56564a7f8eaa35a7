// Paged GQA decode attention for Hopper: each slot's query rows attend over
// its KV cache, read through a page table from a pool shared by all slots.
//
// Replaces smelter_tpu/kernels/paged_decode_attention.py::
// paged_decode_attention (its Pallas `_kernel`): q (B, kvh, g*c, hd), pools
// (P, ps, kvh*hd) in q's dtype or int8 with per-row scale pools (P, ps, 1),
// page table (B, npg) int32, pos (B,) int64. Query row i (chunk offset
// i % c) attends logical rows <= pos + i % c; logical row j*ps + r of slot b
// lives at row r of pool page table[b, j]. Only pages j <= jmax =
// min((pos + c - 1) // ps, npg - 1) are read, and of the last one only its
// rows up to the frontier pos + c - 1: rows past it (a reused page holds
// another sequence's values) are neither scored nor added, which is what
// zeroing them before p @ v does in the Pallas kernel.
//
// What bounds it on an H100: the live K/V bytes. At llama_1b's decode shape
// (B 8, kvh 8, g 2, hd 128, ps 128, int8 pools) with positions spread over
// 0-511 that is about 4 MB a step, ~1.2 us at 3.35 TB/s; the flops (4 per
// cached element and query row) are far below the tensor-core rate.
//
// Design, simple first: one block of 8 warps per (KV head, slot). The block
// walks the slot's live pages in order with a streaming softmax in f32
// (running max, sum and rescale factor per query row, as the Pallas kernel
// keeps them in scratch). On each page a warp takes every 8th row, and its
// 32 lanes split the row's head dims, so each row is one coalesced load of
// hd elements; a warp keeps 8 rows' loads in flight. Scores: each lane's
// partial dot with the query rows (in shared memory), summed across the
// warp with shuffles and scaled by the row's K scale. One warp per query
// row then takes the page's max and sum. p @ v: each warp adds p * v * (V
// scale) of its rows into its own accumulators (lane = head dims), rescaled
// per page; at the end the 8 warps' sums are added in warp order, so the
// result does not depend on timing. No tensor cores: at g*c = 2 query rows
// a step there is nothing for them to do.
#include "common.cuh"

#include <math_constants.h>

namespace {

using namespace smelter;

constexpr int THREADS = 256, WARPS = THREADS / 32;
constexpr int GC_MAX = 8;    // query rows a block holds (g * c)
constexpr int IN_FLIGHT = 8;  // rows a warp loads before it uses them

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
  } else {
    static_assert(BYTES == 2, "load_vec: 2, 4, 8 or 16k bytes");
    const unsigned short u = __ldg(reinterpret_cast<const unsigned short*>(p));
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int i = 0; i < N; ++i) f[i] = to_f(e[i]);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename QT, typename KT, typename ST, int HD>
__global__ void __launch_bounds__(THREADS)
paged_attention(const QT* __restrict__ q, const KT* __restrict__ kp, const KT* __restrict__ vp,
                const ST* __restrict__ ksp, const ST* __restrict__ vsp,
                const int* __restrict__ table, const long long* __restrict__ pos,
                QT* __restrict__ out, int P, int ps, int kvh, int gc, int c, int npg,
                float scale) {
  constexpr bool QUANT = sizeof(KT) == 1;
  constexpr int EPL = HD / 32;  // head dims a lane owns
  extern __shared__ float smem[];
  float* q_s = smem;               // [gc][HD]: the query rows, at the end the output
  float* s_s = q_s + gc * HD;      // [gc][ps]: scores, then probabilities
  float* m_s = s_s + gc * ps;      // [gc] running max
  float* l_s = m_s + gc;           // [gc] running sum
  float* a_s = l_s + gc;           // [gc] this page's rescale factor

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kvd = kvh * HD, d0 = lane * EPL;
  const long long p = pos[b];
  const long long last = p + c - 1;  // the frontier: last row written
  const int jmax = last < 0 ? -1 : static_cast<int>(min(last / ps, static_cast<long long>(npg - 1)));

  const QT* qb = q + (static_cast<size_t>(b) * kvh + h) * gc * HD;
  for (int i = tid; i < gc * HD; i += THREADS) q_s[i] = to_f(qb[i]);
  for (int i = tid; i < gc; i += THREADS) {
    m_s[i] = -CUDART_INF_F;
    l_s[i] = 0.f;
  }
  float acc[GC_MAX][EPL];
#pragma unroll
  for (int i = 0; i < GC_MAX; ++i)
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[i][e] = 0.f;
  __syncthreads();

  for (int j = 0; j <= jmax; ++j) {
    const int page = min(max(table[b * npg + j], 0), P - 1);
    const size_t base = static_cast<size_t>(page) * ps;  // first pool row of the page
    const long long lo = static_cast<long long>(j) * ps;  // its first logical row
    const int live = static_cast<int>(min(static_cast<long long>(ps), last - lo + 1));
    const KT* kpage = kp + base * kvd + h * HD + d0;
    const KT* vpage = vp + base * kvd + h * HD + d0;

    // Scores: warp per row, lanes over the head dims.
    for (int r0 = warp; r0 < ps; r0 += WARPS * IN_FLIGHT) {
      float kv[IN_FLIGHT][EPL];
      float ks[IN_FLIGHT];
#pragma unroll
      for (int u = 0; u < IN_FLIGHT; ++u) {
        const int r = r0 + u * WARPS;
        if (r < live) {
          load_vec(kpage + static_cast<size_t>(r) * kvd, kv[u]);
          ks[u] = QUANT ? to_f(ksp[base + r]) : 1.f;
        } else {
          ks[u] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < IN_FLIGHT; ++u) {
        const int r = r0 + u * WARPS;  // the same in every lane
        if (r >= ps) break;
#pragma unroll
        for (int i = 0; i < GC_MAX; ++i) {
          if (i >= gc) break;
          float dot = 0.f;
          if (r < live) {
#pragma unroll
            for (int e = 0; e < EPL; ++e) dot = fmaf(q_s[i * HD + d0 + e], kv[u][e], dot);
          }
          dot = warp_sum(dot);
          if (lane == 0)
            s_s[i * ps + r] =
                (r < live && lo + r <= p + i % c) ? dot * ks[u] * scale : -CUDART_INF_F;
        }
      }
    }
    __syncthreads();

    // Softmax statistics: one warp per query row.
    for (int i = warp; i < gc; i += WARPS) {
      float* row = s_s + i * ps;
      float mx = -CUDART_INF_F;
      for (int r = lane; r < ps; r += 32) mx = fmaxf(mx, row[r]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_s[i], m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int r = lane; r < ps; r += 32) {
        const float e = expf(row[r] - m_new);
        row[r] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        l_s[i] = alpha * l_s[i] + sum;
        m_s[i] = m_new;
        a_s[i] = alpha;
      }
    }
    __syncthreads();

    // p @ v: warp per row, lanes over the head dims; only live rows are read.
#pragma unroll
    for (int i = 0; i < GC_MAX; ++i) {
      if (i >= gc) break;
      const float a = a_s[i];
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[i][e] *= a;
    }
    for (int r0 = warp; r0 < live; r0 += WARPS * IN_FLIGHT) {
      float vv[IN_FLIGHT][EPL];
      float vs[IN_FLIGHT];
#pragma unroll
      for (int u = 0; u < IN_FLIGHT; ++u) {
        const int r = r0 + u * WARPS;
        if (r < live) {
          load_vec(vpage + static_cast<size_t>(r) * kvd, vv[u]);
          vs[u] = QUANT ? to_f(vsp[base + r]) : 1.f;
        } else {
          vs[u] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < IN_FLIGHT; ++u) {
        const int r = r0 + u * WARPS;
        if (r >= live) break;
#pragma unroll
        for (int i = 0; i < GC_MAX; ++i) {
          if (i >= gc) break;
          const float pw = s_s[i * ps + r] * vs[u];
#pragma unroll
          for (int e = 0; e < EPL; ++e) acc[i][e] = fmaf(pw, vv[u][e], acc[i][e]);
        }
      }
    }
    __syncthreads();  // s_s is rewritten by the next page
  }

  // The warps' sums, added in warp order into q_s (no longer read).
  for (int w = 0; w < WARPS; ++w) {
    if (warp == w) {
#pragma unroll
      for (int i = 0; i < GC_MAX; ++i) {
        if (i >= gc) break;
#pragma unroll
        for (int e = 0; e < EPL; ++e)
          q_s[i * HD + d0 + e] = (w == 0 ? 0.f : q_s[i * HD + d0 + e]) + acc[i][e];
      }
    }
    __syncthreads();
  }
  QT* ob = out + (static_cast<size_t>(b) * kvh + h) * gc * HD;
  for (int i = tid; i < gc * HD; i += THREADS) store(&ob[i], q_s[i] / l_s[i / HD]);
}

template <typename QT, typename KT, typename ST>
int launch(const void* q, const void* k, const void* v, const void* ks, const void* vs,
           const int* table, const long long* pos, void* out, int B, int P, int ps, int kvh,
           int hd, int gc, int c, int npg, float scale, cudaStream_t stream) {
  const dim3 grid(kvh, B);
  const size_t smem = (static_cast<size_t>(gc) * (hd + ps) + 3 * gc) * sizeof(float);
  const auto* qq = static_cast<const QT*>(q);
  const auto* kk = static_cast<const KT*>(k);
  const auto* vv = static_cast<const KT*>(v);
  const auto* kss = static_cast<const ST*>(ks);
  const auto* vss = static_cast<const ST*>(vs);
  auto* o = static_cast<QT*>(out);
#define SMELTER_PAGED(HD_)                                                                   \
  paged_attention<QT, KT, ST, HD_><<<grid, THREADS, smem, stream>>>(                         \
      qq, kk, vv, kss, vss, table, pos, o, P, ps, kvh, gc, c, npg, scale)
  switch (hd) {
    case 64: SMELTER_PAGED(64); break;
    case 128: SMELTER_PAGED(128); break;
    case 256: SMELTER_PAGED(256); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SMELTER_PAGED
  return static_cast<int>(cudaGetLastError());
}

// Float pools hold q's type; scale pools are f32 or q's type.
template <typename QT>
int dispatch(int kv_dtype, int scale_dtype, const void* q, const void* k, const void* v,
             const void* ks, const void* vs, const int* table, const long long* pos, void* out,
             int B, int P, int ps, int kvh, int hd, int gc, int c, int npg, float scale,
             cudaStream_t st) {
  if (kv_dtype != kI8)
    return launch<QT, QT, QT>(q, k, v, ks, vs, table, pos, out, B, P, ps, kvh, hd, gc, c, npg,
                              scale, st);
  if (scale_dtype == kF32)
    return launch<QT, int8_t, float>(q, k, v, ks, vs, table, pos, out, B, P, ps, kvh, hd, gc, c,
                                     npg, scale, st);
  return launch<QT, int8_t, QT>(q, k, v, ks, vs, table, pos, out, B, P, ps, kvh, hd, gc, c, npg,
                                scale, st);
}

}  // namespace

extern "C" const char* smelter_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q (B, kvh, gc, hd) and out in q_dtype (f32 or bf16); k/v pools
// (P, ps, kvh*hd) in q_dtype or int8 (kv_dtype) with scale pools (P, ps, 1)
// in f32 or q_dtype (scale_dtype); table
// (B, npg) int32; pos (B,) int64. All contiguous, 16-byte aligned. Needs
// hd in {64, 128, 256} and gc <= 8 (the wrapper checks). Returns a
// cudaError_t code.
extern "C" int smelter_paged_decode_attention(const void* q, const void* k, const void* v,
                                              const void* ks, const void* vs, const void* table,
                                              const void* pos, void* out, int B, int P, int ps,
                                              int kvh, int hd, int gc, int c, int npg,
                                              float scale, int q_dtype, int kv_dtype,
                                              int scale_dtype, void* stream) {
  if (gc < 1 || gc > GC_MAX || c < 1 || gc % c || ps < 1 || npg < 1 || P < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || kvh == 0) return 0;
  const auto* tb = static_cast<const int*>(table);
  const auto* ps_ = static_cast<const long long*>(pos);
  auto st = static_cast<cudaStream_t>(stream);
  switch (q_dtype) {
    case kF32:
      return dispatch<float>(kv_dtype, scale_dtype, q, k, v, ks, vs, tb, ps_, out, B, P, ps,
                             kvh, hd, gc, c, npg, scale, st);
    case kBF16:
      return dispatch<__nv_bfloat16>(kv_dtype, scale_dtype, q, k, v, ks, vs, tb, ps_, out, B,
                                     P, ps, kvh, hd, gc, c, npg, scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
