// Whole-block ViT attention for Hopper: [LN ->] packed QKV projection + f32
// bias -> per-head softmax(Q K^T * scale [+ mask]) V -> output projection
// + f32 bias [+ residual].
//
// Replaces the Pallas kernel smelter_tpu/kernels/vit_block.py::
// _vit_block_impl, which holds one image's (N, D) tile and every weight
// (~4.5 MB at ViT-B) in VMEM and runs the whole block in one program per
// image. One ViT-B image is 197 x 768 bf16 = 302 KB, more than the 227 KB
// of shared memory a block can have, so the function is computed here as a
// fixed sequence of four launches, all on the caller's stream (the Python
// wrapper counts the call once):
//
//   1. pre-LN (skipped when pre_ln is 0): csrc/layer_norm.cuh, one warp a
//      row, xn rounded to x's type as the Pallas kernel rounds it;
//   2. the QKV product xn (M, D) @ the packed weight (3 n_groups, D, G)
//      with G = group * hd, read in place as a (D, 3D) matrix whose column
//      block j is weight block j: csrc/wgmma_gemm.cuh's gemm_tma (wgmma fed
//      by TMA, the weight through a 3-D map, G % 64 == 0) with its block
//      epilogue, the f32 bias added and the sum rounded to x's type (q, k
//      and v are each rounded, as in the Pallas kernel);
//   3. attention: csrc/wgmma_attention.cuh's attn_norm, the Pallas kernel's
//      order (each row's exact max and sum of exp(s - max) over all keys,
//      then p = exp(s - max) / sum rounded to x's type before p v, sums in
//      f32; keys past N are -inf, not zero): 128 query rows of an (image,
//      head) a work item, Q, K and V by TMA through 3-D maps of the (B, N,
//      3 D) product, one pass over the keys for N <= 256 (a second
//      128-key tile's scores meet the first tile's exps, staged in shared
//      memory), else K and V resident there for a second pass; the head
//      outputs land side by side at column h * hd, rounded to x's type (the
//      Pallas kernel's concatenated attention output);
//   4. the output projection attn (M, D) @ w_proj (D, D) on gemm_tma, the
//      f32 bias and, for residual=1, x added in f32 (x + (acc + b)) and
//      rounded once.
//
// smelter_tpu_torch/kernels/attention_plan.py and wgmma_plan.py choose each
// launch's form from the shape; what the new forms do not take keeps this
// file's earlier kernels: a GEMM whose shape gemm_tma's maps cannot describe
// (M < 128, N < 128, G % 64 != 0) takes csrc/gemm.cuh (mma.sync tiles of
// 128 x 128, a 4-stage cp.async ring), and attention whose resident K and V
// exceed shared memory (hd 64 past 768 keys, hd 128 past 384) takes
// attention_mma below (mma.sync, two passes over K from device memory).
// f32 activations take FMA kernels in full f32 (no TF32) for both products
// and a warp-per-query-row attention kernel, which also serves head dims
// other than 16, 32, 64 and 128.
//
// What bounds it on an H100: at ViT-B/16's batch 128 (B 128, N 197, D 768,
// 12 heads of 64) a call does B (6 N D^2 + 4 N^2 D + 2 N D^2) = 134.2
// GFLOP, about 136 us at 989 TFLOP/s dense bf16, against ~80 MB of x,
// weights and output (about 24 us at 3.35 TB/s): the tensor cores. The two
// products are 89 % of the operations; on mma.sync they took 0.75 of the
// call's 1.03 ms and attention 0.26 (experiments/torch_vit_block_split.py),
// which is why both moved to wgmma. xn, q/k/v and the attention output
// still cross device memory between the launches (~270 MB at ViT-B).
#include "gemm.cuh"
#include "wgmma_attention.cuh"

namespace {

using namespace smelter;

// ---- attention over the (M, 3D) QKV product -----------------------------
// Row m = b N + i of qkv holds, for head group p (heads p*group ..), the
// group's q, k and v side by side: columns 3 p G + {0, G, 2 G} + hl hd + d
// for head h = p group + hl. The output attn (M, D) holds head h at columns
// h hd .. h hd + hd - 1.

enum MaskKind : int { kNoMask = 0, kKeep2d = 1, kLen1d = 2 };

// The additive mask on key `key` of image b: (1 - keep[b, key]) * filter
// (keep2d) or filter where key >= len[b] (len1d).
__device__ __forceinline__ float mask_add(const float* keep, const int* lens, int kind, int b,
                                          int N, int key, float filter) {
  if (kind == kKeep2d) return (1.f - keep[static_cast<size_t>(b) * N + key]) * filter;
  if (kind == kLen1d) return key < lens[b] ? 0.f : filter;
  return 0.f;
}

constexpr int QT = 64;           // query rows a block: 4 warps of 16
constexpr int ATT_THREADS = 128;

template <typename T, int HD>
__global__ void __launch_bounds__(ATT_THREADS)
attention_mma(const uint16_t* __restrict__ qkv, const float* __restrict__ keep,
              const int* __restrict__ lens, int mask_kind, float filter,
              uint16_t* __restrict__ attn, int N, int D, int group, float scale) {
  constexpr int KC = HD >= 128 ? 32 : 64;  // keys a chunk
  constexpr int S = HD + 8;                // halves per shared row (16-byte multiple)
  constexpr int NT = KC / 8, DT = HD / 8, KS = HD / 16;
  __shared__ __align__(16) uint16_t Qs[QT * S];
  __shared__ __align__(16) uint16_t Ks[KC * S];
  __shared__ __align__(16) uint16_t Vs[KC * S];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * QT;
  const int G = group * HD, pair = h / group, hl = h % group;
  const size_t rs = 3 * static_cast<size_t>(D);
  const uint16_t* base = qkv + static_cast<size_t>(b) * N * rs;
  const int qc = 3 * pair * G + hl * HD, kc = qc + G, vc = qc + 2 * G;

  // rows r0 .. r0 + rows - 1 of column block col into dst, zeros past N
  auto load_rows = [&](uint16_t* dst, int r0, int rows, int col) {
    for (int c = tid; c < rows * (HD / 8); c += ATT_THREADS) {
      const int r = c / (HD / 8), d = (c % (HD / 8)) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r0 + r < N) v = *reinterpret_cast<const uint4*>(base + (r0 + r) * rs + col + d);
      *reinterpret_cast<uint4*>(&dst[r * S + d]) = v;
    }
  };

  load_rows(Qs, q0, QT, qc);
  __syncthreads();
  const int wq = warp * 16;  // the warp's first row in the tile
  const bool active = q0 + wq < N;
  uint32_t qa[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const uint16_t* pa = &Qs[(wq + g) * S + kk * 16 + t * 2];
    qa[kk][0] = *reinterpret_cast<const uint32_t*>(pa);
    qa[kk][1] = *reinterpret_cast<const uint32_t*>(pa + 8 * S);
    qa[kk][2] = *reinterpret_cast<const uint32_t*>(pa + 8);
    qa[kk][3] = *reinterpret_cast<const uint32_t*>(pa + 8 * S + 8);
  }

  // f32 scores of the chunk at c0 for the warp's 16 rows: element e of
  // tile j is row g + 8 (e >> 1), key c0 + 8 j + 2 t + (e & 1).
  float s[NT][4];
  auto scores = [&](int c0) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int j = 0; j < NT; j += 2)
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        // K rows are the B operand's columns: tiles j and j + 1, both k halves
        uint32_t r[4];
        ldmatrix_x4(r, &Ks[((j + (lane >> 4)) * 8 + (lane & 7)) * S + kk * 16 +
                           ((lane >> 3) & 1) * 8]);
        const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
        mma_16816<T>(s[j], qa[kk], b0);
        mma_16816<T>(s[j + 1], qa[kk], b1);
      }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = c0 + j * 8 + t * 2 + (e & 1);
        s[j][e] = key < N ? s[j][e] * scale + mask_add(keep, lens, mask_kind, b, N, key, filter)
                          : -INFINITY;
      }
    }
  };

  // Pass 1: each row's max and sum of exp(s - max), over all keys.
  float mrow[2] = {-INFINITY, -INFINITY}, lrow[2] = {0.f, 0.f};
  for (int c0 = 0; c0 < N; c0 += KC) {
    __syncthreads();
    load_rows(Ks, c0, KC, kc);
    __syncthreads();
    if (!active) continue;
    scores(c0);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < NT; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mn = fmaxf(mrow[r], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j)
        sum += __expf(s[j][2 * r] - mn) + __expf(s[j][2 * r + 1] - mn);
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      lrow[r] = lrow[r] * __expf(mrow[r] - mn) + sum;
      mrow[r] = mn;
    }
  }

  // Pass 2: p = exp(s - max) / sum rounded to T, o += p V in f32.
  const float inv[2] = {1.f / lrow[0], 1.f / lrow[1]};
  float o[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  for (int c0 = 0; c0 < N; c0 += KC) {
    __syncthreads();
    load_rows(Ks, c0, KC, kc);
    load_rows(Vs, c0, KC, vc);
    __syncthreads();
    if (!active) continue;
    scores(c0);
#pragma unroll
    for (int k2 = 0; k2 < KC / 16; ++k2) {
      const float* s0 = s[2 * k2];
      const float* s1 = s[2 * k2 + 1];
      uint32_t a[4];
      a[0] = pack2<T>(__expf(s0[0] - mrow[0]) * inv[0], __expf(s0[1] - mrow[0]) * inv[0]);
      a[1] = pack2<T>(__expf(s0[2] - mrow[1]) * inv[1], __expf(s0[3] - mrow[1]) * inv[1]);
      a[2] = pack2<T>(__expf(s1[0] - mrow[0]) * inv[0], __expf(s1[1] - mrow[0]) * inv[0]);
      a[3] = pack2<T>(__expf(s1[2] - mrow[1]) * inv[1], __expf(s1[3] - mrow[1]) * inv[1]);
#pragma unroll
      for (int nj = 0; nj < HD / 16; ++nj) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, &Vs[(k2 * 16 + (lane & 15)) * S + nj * 16 + (lane >> 4) * 8]);
        const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
        mma_16816<T>(o[2 * nj], a, b0);
        mma_16816<T>(o[2 * nj + 1], a, b1);
      }
    }
  }
  if (!active) return;
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + wq + g + 8 * r;
      if (row >= N) continue;
      const size_t off = (static_cast<size_t>(b) * N + row) * D + h * HD + n * 8 + t * 2;
      *reinterpret_cast<uint32_t*>(attn + off) = pack2<T>(o[n][2 * r], o[n][2 * r + 1]);
    }
}

// Any type and head dim <= 256: a warp per query row, lanes over the head
// dim, the same two passes over the keys read straight from device memory.
constexpr int ROWS_HD_MAX = 256;

template <typename T>
__global__ void __launch_bounds__(ATT_THREADS)
attention_rows(const T* __restrict__ qkv, const float* __restrict__ keep,
               const int* __restrict__ lens, int mask_kind, float filter, T* __restrict__ attn,
               int N, int D, int HD, int group, float scale) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.z, h = blockIdx.y, row = blockIdx.x * (ATT_THREADS / 32) + warp;
  if (row >= N) return;
  const int G = group * HD, pair = h / group, hl = h % group;
  const size_t rs = 3 * static_cast<size_t>(D);
  const T* base = qkv + static_cast<size_t>(b) * N * rs;
  const int qc = 3 * pair * G + hl * HD, kc = qc + G, vc = qc + 2 * G;
  constexpr int PER = ROWS_HD_MAX / 32;
  float q[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int d = lane + 32 * i;
    q[i] = d < HD ? to_float(base[row * rs + qc + d]) : 0.f;
  }
  auto score = [&](int key) {
    float dot = 0.f;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int d = lane + 32 * i;
      if (d < HD) dot += q[i] * to_float(base[key * rs + kc + d]);
    }
    return warp_sum(dot) * scale + mask_add(keep, lens, mask_kind, b, N, key, filter);
  };
  float m = -INFINITY, l = 0.f;
  for (int key = 0; key < N; ++key) {
    const float sc = score(key);
    const float mn = fmaxf(m, sc);
    l = l * expf(m - mn) + expf(sc - mn);
    m = mn;
  }
  float o[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) o[i] = 0.f;
  for (int key = 0; key < N; ++key) {
    const float p = round_to<T>(expf(score(key) - m) / l);
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int d = lane + 32 * i;
      if (d < HD) o[i] += p * to_float(base[key * rs + vc + d]);
    }
  }
  T* dst = attn + (static_cast<size_t>(b) * N + row) * D + h * HD;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int d = lane + 32 * i;
    if (d < HD) store(&dst[d], o[i]);
  }
}

template <typename T>
void attention(const T* qkv, const float* keep, const int* lens, int mask_kind, float filter,
               T* attn, int B, int N, int D, int heads, int group, float scale,
               cudaStream_t stream) {
  const int hd = D / heads;
  if constexpr (!std::is_same<T, float>::value) {
    const dim3 grid(cdiv(N, QT), heads, B);
    const auto* q = reinterpret_cast<const uint16_t*>(qkv);
    auto* a = reinterpret_cast<uint16_t*>(attn);
#define SMELTER_ATTN_MMA(HD_)                                                                 \
  if (hd == HD_) {                                                                            \
    attention_mma<T, HD_><<<grid, ATT_THREADS, 0, stream>>>(q, keep, lens, mask_kind, filter, \
                                                            a, N, D, group, scale);           \
    return;                                                                                   \
  }
    SMELTER_ATTN_MMA(16)
    SMELTER_ATTN_MMA(32)
    SMELTER_ATTN_MMA(64)
    SMELTER_ATTN_MMA(128)
#undef SMELTER_ATTN_MMA
  }
  const dim3 grid(cdiv(N, ATT_THREADS / 32), heads, B);
  attention_rows<T><<<grid, ATT_THREADS, 0, stream>>>(qkv, keep, lens, mask_kind, filter, attn,
                                                     N, D, hd, group, scale);
}

// The launches' forms, as the wrapper's plans give them: a GEMM's 1 is
// gemm_tma (on `grid` CTAs), 0 csrc/gemm.cuh; attention's 1 is attn_norm
// (`tiles` key tiles an item, `buffers` items in flight, `grid` CTAs), 0
// attention_mma / attention_rows.
struct Forms {
  int qkv, qkv_grid, proj, proj_grid, attn, tiles, buffers, attn_grid;
};

template <typename T>
int attention_norm(const T* qkv, const float* keep, const int* lens, int mask_kind,
                   float filter, T* attn, int B, int N, int D, int heads, int group,
                   float scale, const Forms& f, cudaStream_t stream) {
  const int hd = D / heads;
#define SMELTER_ATTN_NORM(HD_)                                                                \
  if (hd == HD_)                                                                              \
    return wa::launch_norm<T, HD_>(qkv, keep, lens, mask_kind, filter, attn, B, N, D, heads,  \
                                   group, scale, f.tiles, f.buffers, f.attn_grid, stream);
  SMELTER_ATTN_NORM(16)
  SMELTER_ATTN_NORM(32)
  SMELTER_ATTN_NORM(64)
  SMELTER_ATTN_NORM(128)
#undef SMELTER_ATTN_NORM
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int run(const void* x, const void* ln_g, const void* ln_b, const void* wqkv, const void* bqkv,
        const void* wp, const void* bp, const void* mask, int mask_kind, const void* residual,
        void* xn, void* qkv, void* attn, void* out, int B, int N, int D, int heads, int group,
        int pre_ln, float scale, float eps, float filter, int p_code, const Forms& f,
        cudaStream_t stream) {
  const int M = B * N;
  const int hd = D / heads;
  const T* a = static_cast<const T*>(x);
  if (pre_ln) {
    launch_layer_norm<T>(a, nullptr, ln_g, ln_b, p_code, nullptr, static_cast<T*>(xn), M, D,
                         eps, stream);
    a = static_cast<const T*>(xn);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* keep = mask_kind == kKeep2d ? static_cast<const float*>(mask) : nullptr;
  const int* lens = mask_kind == kLen1d ? static_cast<const int*>(mask) : nullptr;
  if constexpr (std::is_same<T, float>::value) {
    gemm<T>(a, static_cast<const T*>(wqkv), bqkv, p_code, kActNone, nullptr,
            static_cast<T*>(qkv), M, 3 * D, D, group * hd, stream);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    attention<T>(static_cast<const T*>(qkv), keep, lens, mask_kind, filter,
                 static_cast<T*>(attn), B, N, D, heads, group, scale, stream);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    gemm<T>(static_cast<const T*>(attn), static_cast<const T*>(wp), bp, p_code, kActNone,
            static_cast<const T*>(residual), static_cast<T*>(out), M, D, D, D, stream);
    return static_cast<int>(cudaGetLastError());
  } else {
    int rc = 0;
    if (f.qkv)
      rc = wg::launch_tma_block<T>(a, wqkv, group * hd, bqkv, p_code == kF32, nullptr, qkv, M,
                                   3 * D, D, f.qkv_grid, stream);
    else
      gemm<T>(a, static_cast<const T*>(wqkv), bqkv, p_code, kActNone, nullptr,
              static_cast<T*>(qkv), M, 3 * D, D, group * hd, stream);
    if (rc != 0 || (err = cudaGetLastError()) != cudaSuccess)
      return rc != 0 ? rc : static_cast<int>(err);
    if (f.attn)
      rc = attention_norm<T>(static_cast<const T*>(qkv), keep, lens, mask_kind, filter,
                             static_cast<T*>(attn), B, N, D, heads, group, scale, f, stream);
    else
      attention<T>(static_cast<const T*>(qkv), keep, lens, mask_kind, filter,
                   static_cast<T*>(attn), B, N, D, heads, group, scale, stream);
    if (rc != 0 || (err = cudaGetLastError()) != cudaSuccess)
      return rc != 0 ? rc : static_cast<int>(err);
    if (f.proj)
      return wg::launch_tma_block<T>(attn, wp, 0, bp, p_code == kF32, residual, out, M, D, D,
                                     f.proj_grid, stream);
    gemm<T>(static_cast<const T*>(attn), static_cast<const T*>(wp), bp, p_code, kActNone,
            static_cast<const T*>(residual), static_cast<T*>(out), M, D, D, D, stream);
    return static_cast<int>(cudaGetLastError());
  }
}

}  // namespace

extern "C" const char* smelter_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x (B, N, D) in x_dtype; ln_g, ln_b (D,), bqkv (3 D,) packed as the weight,
// bp (D,) in p_dtype (f32 or x_dtype); wqkv (3 D / G, D, G) with G = group
// * D / heads and wp (D, D) in x_dtype; mask (B, N) f32 keep flags
// (mask_kind 1), (B,) int32 valid lengths (2) or nullptr (0); residual
// (B, N, D) in x_dtype or nullptr; scratch xn (B N, D), qkv (B N, 3 D), attn
// (B N, D) and out (B, N, D) in x_dtype, all 16-byte aligned. D % 8 == 0,
// D <= 4096, hd % 8 == 0. The eight form arguments are Forms' fields (the
// wrapper's plans; all 0 for f32).
// Returns a cudaError_t code.
extern "C" int smelter_vit_block(const void* x, const void* ln_g, const void* ln_b,
                                 const void* wqkv, const void* bqkv, const void* wp,
                                 const void* bp, const void* mask, const void* residual, void* xn,
                                 void* qkv, void* attn, void* out, int B, int N, int D, int heads,
                                 int group, int pre_ln, int mask_kind, float scale, float eps,
                                 float mask_filter, int x_dtype, int p_dtype, int qkv_form,
                                 int qkv_grid, int proj_form, int proj_grid, int attn_form,
                                 int attn_tiles, int attn_buffers, int attn_grid, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const auto misaligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; };
  if (misaligned(x) || misaligned(wqkv) || misaligned(wp) || misaligned(xn) ||
      misaligned(qkv) || misaligned(attn) || misaligned(out))
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (heads <= 0 || D % heads != 0 || D % 8 != 0 || D > LN_MAX_D || (D / heads) % 8 != 0 ||
      (D / heads) > ROWS_HD_MAX || heads % group != 0 ||
      (p_dtype != kF32 && p_dtype != x_dtype) || mask_kind < kNoMask || mask_kind > kLen1d)
    return static_cast<int>(cudaErrorInvalidValue);
  const Forms f{qkv_form, qkv_grid, proj_form, proj_grid, attn_form, attn_tiles, attn_buffers,
                attn_grid};
  if (x_dtype == kF32 && (f.qkv || f.proj || f.attn))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || N == 0) return 0;
  switch (x_dtype) {
    case kF32:
      return run<float>(x, ln_g, ln_b, wqkv, bqkv, wp, bp, mask, mask_kind, residual, xn, qkv,
                        attn, out, B, N, D, heads, group, pre_ln, scale, eps, mask_filter,
                        p_dtype, f, st);
    case kBF16:
      return run<__nv_bfloat16>(x, ln_g, ln_b, wqkv, bqkv, wp, bp, mask, mask_kind, residual, xn,
                                qkv, attn, out, B, N, D, heads, group, pre_ln, scale, eps,
                                mask_filter, p_dtype, f, st);
    case kF16:
      return run<__half>(x, ln_g, ln_b, wqkv, bqkv, wp, bp, mask, mask_kind, residual, xn, qkv,
                         attn, out, B, N, D, heads, group, pre_ln, scale, eps, mask_filter,
                         p_dtype, f, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
