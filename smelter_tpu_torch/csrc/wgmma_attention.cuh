// The port's Hopper attention core (sm_90a): softmax(Q K^T * scale [+ mask])
// V with S = Q K^T on wgmma from shared memory, P V on wgmma with P as the
// register operand, and Q, K and V brought into shared memory by TMA behind
// mbarriers. Raw PTX in the style of csrc/wgmma_gemm.cuh, whose helpers
// (mbarriers, TMA loads and maps, wgmma fences) it shares. Two kernels:
//
// attn_stream (csrc/ring_attention.cu's bf16/f16 merge step, and
//   csrc/flash_attention.cu's bf16/f16 call as a step that is both the first
//   and the last, so no f32 state touches device memory): a CTA takes 128
//   query rows of one (batch, head) and streams K and V through a ring of
//   stages in key tiles of KT 128; a ring step's f32 state (m, l, acc) of
//   its rows is read from device memory at the start (not at the first
//   step) and written at the end (out = acc / l in q's type at the last
//   step, through out's strides). Per tile, in the algebra of the Pallas
//   flash and ring kernels: s = q k^T * scale, m_new = max(m, max_j s), alpha
//   = exp(m - m_new), p = exp(s - m_new), l = alpha l + sum_j p over the f32
//   p, acc = alpha acc + p v with p rounded to the operands' 16-bit type. A
//   positive scale is folded into the exponent (the row max of the unscaled
//   scores times scale), which spares a multiply of every score. At hd <=
//   64 tile j + 1's scores and softmax overlap tile j's P V.
// attn_norm (csrc/vit_block.cu's attention, csrc/attention_short.cu's
//   bf16/f16 call): the Pallas ViT and short-attention kernels' order
//   (smelter_tpu/kernels/vit_block.py, attention_short.py): each row's exact
//   max and sum of exp(s - max) over all keys first, then p = exp(s - max) /
//   sum rounded to x's type before p v. A work item is 128 query rows of one
//   (image, head); its Q and every 128-key tile of its K and V come into one
//   buffer of shared memory at once. Up to 256 keys the form takes one pass
//   over K: one tile's row of scores sits in the warpgroup's accumulators,
//   and with two the first tile's exps (against its own row max) wait in
//   shared memory (64 KB a CTA) while the second's scores fill the
//   registers, p = e exp(m0 - m) / l then. With more tiles K and V stay
//   resident and a second pass recomputes S from shared memory, never
//   reading device memory again. The CTAs are persistent (one an SM) and
//   the producer fills the next item's buffer (two buffers where they fit)
//   while the consumers work. Keys past N are -inf; the additive mask is
//   ORT's key padding (mask_add: keep flags or valid lengths). The
//   operands' source is a template parameter (NormSrc): the ViT block's
//   packed QKV product or short_attention's three (B, H, N, hd) views.
//
// The block: warpgroups 0 and 1 are consumers of 64 query rows each,
// warpgroup 2 the producer, one thread of which issues every TMA load; a
// CTA an SM. A thread may hold 168 registers (65,536 over 384 threads):
// the scores of a 128-key tile (64 f32), P (32) and the output (hd / 2)
// fit. 256 keys of scores (128 registers) do not: ptxas spilled 400-584
// bytes a thread there even with setmaxnreg raising the consumers' budget
// to 232, so two tiles' scores never share the registers.
// Each tile's P V is waited for before the loop goes on: one still in
// flight across the loop's back edge made ptxas serialize every wgmma of
// the loop (its warning C7515); the two consumer warpgroups overlap each
// other's softmax and products, and attn_stream at hd <= 64 issues the next
// tile's scores beside P V and waits for both within the iteration.
//
// Shared memory (what the wgmma descriptors read): a tile of R rows x hd
// columns is stored as hd / 64 parts (hd 128: two) of R rows of the swizzle
// atom's width, 128 bytes (hd 64, 128: the 128-byte swizzle), 64 (hd 32: the
// 64-byte swizzle) or 32 (hd 16: the 32-byte swizzle), written by TMA with
// that swizzle. Q and K are K-major operands (descriptor SBO = 8 rows, a
// k16 step 32 bytes further along the row); V is the MN-major B operand of P
// V (SBO = 8 key rows, LBO = one part, a k16 step 16 rows further).
// Operands are read through 4-D maps (hd, N, H, B) of their element
// strides for attn_stream and short_attention (so the (B, H, N, hd) views
// of (B, N, H, hd) tensors a graph hands over are read in place; the ring's
// packed (BH, N, hd) shards are B 1, H = BH), and through 3-D maps of the
// (B, N, 3 D) QKV product for the ViT block, head h at column 3 pair G +
// {0, G, 2 G} + hl hd (G = group hd); a box that runs past N reads zeros.
// A map needs its base 16-byte aligned and each stride a 16-byte multiple
// (view_ok; kernels/attention_plan.py checks the same before launch).
//
// What bounds it on an H100: the tensor cores for the ring (B 1, H 16, N
// 32,768, hd 128 over 4 ranks: 8.8 TFLOP, 8.9 ms at 989 TFLOP/s dense
// bf16), and, close behind, the exponentials: one a score against 4 hd
// products, about half the tensor cores' time at 16 exps a clock an SM,
// which the two consumer warpgroups hide from each other. ViT-B/16's
// attention (15.3 GFLOP at B 128) is small beside its projections; its 197
// keys fill two 128-key tiles 77 %, and 197 query rows two 128-row items
// as much. Skipping the exps of key blocks and warps wholly past N made
// both forms slower on the card (a branch around the softmax cost the
// registers and the schedule more than the skipped work), so padded keys
// and rows are computed and masked. mma.sync, which this replaces for
// 16-bit types, kept the tensor cores at about a fifth of their rate.
// smelter_tpu_torch/kernels/attention_plan.py mirrors the sizes below and
// picks the form.
#pragma once

#include "wgmma_gemm.cuh"

namespace smelter {
namespace wa {
namespace {  // every kernel library keeps its own copy of each kernel

using wg::desc;
using wg::fence_regs;
using wg::mbar_arrive;
using wg::mbar_expect_tx;
using wg::mbar_fence_init;
using wg::mbar_init;
using wg::mbar_wait;
using wg::smem_u32;
using wg::tma_load_3d;
using wg::tma_load_4d;
using wg::wgmma_commit;
using wg::wgmma_fence;
using wg::wgmma_wait;

constexpr int WG_ROWS = 64;              // query rows a consumer warpgroup
constexpr int NCONS = 2;                 // consumer warpgroups
constexpr int Q_ROWS = WG_ROWS * NCONS;  // query rows a CTA
constexpr int THREADS = 128 * (NCONS + 1);
constexpr int KT = 128;                  // keys a tile: the scores' wgmma N
constexpr int SMEM_LIMIT = 232448;       // 227 KB, what one block may have
constexpr float LOG2E = 1.4426950408889634f;

// A tile's layout for head dim HD.
template <int HD>
struct Geo {
  static_assert(HD == 16 || HD == 32 || HD == 64 || HD == 128, "head dims 16, 32, 64, 128");
  static constexpr int PARTS = HD > 64 ? HD / 64 : 1;  // swizzle atoms across a row
  static constexpr int PART_COLS = HD / PARTS;
  static constexpr int RB = PART_COLS * 2;             // bytes a row of a part
  static constexpr int SBO = 8 * RB;                   // 8 rows
  static constexpr uint64_t LAYOUT = RB == 128 ? 1 : (RB == 64 ? 2 : 3);
  static constexpr CUtensorMapSwizzle SWIZZLE =
      RB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                : (RB == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B);
};

// -- wgmma m64nNk16 with f32 accumulators d[N / 2] ----------------------------
// Accumulator element 4j + 2h + e of warp w's thread (g = lane / 4, t = lane
// % 4) is row 16 w + g + 8 h, column 8 j + 2 t + e.

#define SMELTER_WA_D8(i)                                                                   \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define SMELTER_WA_D16(i) SMELTER_WA_D8(i), SMELTER_WA_D8(i + 8)
#define SMELTER_WA_D32(i) SMELTER_WA_D16(i), SMELTER_WA_D16(i + 16)
#define SMELTER_WA_D64(i) SMELTER_WA_D32(i), SMELTER_WA_D32(i + 32)
#define SMELTER_WA_OUT8 SMELTER_WA_D8(0)
#define SMELTER_WA_OUT16 SMELTER_WA_D16(0)
#define SMELTER_WA_OUT32 SMELTER_WA_D32(0)
#define SMELTER_WA_OUT64 SMELTER_WA_D64(0)

#define SMELTER_WA_S0 "%0, %1, %2, %3, %4, %5, %6, %7"
#define SMELTER_WA_S1 "%8, %9, %10, %11, %12, %13, %14, %15"
#define SMELTER_WA_S2 "%16, %17, %18, %19, %20, %21, %22, %23"
#define SMELTER_WA_S3 "%24, %25, %26, %27, %28, %29, %30, %31"
#define SMELTER_WA_S4 "%32, %33, %34, %35, %36, %37, %38, %39"
#define SMELTER_WA_S5 "%40, %41, %42, %43, %44, %45, %46, %47"
#define SMELTER_WA_S6 "%48, %49, %50, %51, %52, %53, %54, %55"
#define SMELTER_WA_S7 "%56, %57, %58, %59, %60, %61, %62, %63"
#define SMELTER_WA_REGS8 SMELTER_WA_S0
#define SMELTER_WA_REGS16 SMELTER_WA_REGS8 ", " SMELTER_WA_S1
#define SMELTER_WA_REGS32 SMELTER_WA_REGS16 ", " SMELTER_WA_S2 ", " SMELTER_WA_S3
#define SMELTER_WA_REGS64 \
  SMELTER_WA_REGS32 ", " SMELTER_WA_S4 ", " SMELTER_WA_S5 ", " SMELTER_WA_S6 ", " SMELTER_WA_S7

// Both operands from shared memory, B K-major (S = Q K^T): d (+)= A B, or d =
// A B where scale_d is 0. NN: N; R: N / 2, the first operand after d.
#define SMELTER_WA_SS(NN, REGS, OUT, IA, IB, IP)                                               \
  template <typename T>                                                                        \
  __device__ __forceinline__ void ss_##NN(float (&d)[NN / 2], uint64_t da, uint64_t db,        \
                                          int scale_d) {                                       \
    if constexpr (std::is_same<T, __nv_bfloat16>::value)                                       \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" IP ", 0;\n"                            \
                   "wgmma.mma_async.sync.aligned.m64n" #NN "k16.f32.bf16.bf16 {" REGS "}, %" IA \
                   ", %" IB ", p, 1, 1, 0, 0;\n}\n"                                              \
                   : OUT                                                                       \
                   : "l"(da), "l"(db), "r"(scale_d));                                          \
    else                                                                                       \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" IP ", 0;\n"                            \
                   "wgmma.mma_async.sync.aligned.m64n" #NN "k16.f32.f16.f16 {" REGS "}, %" IA   \
                   ", %" IB ", p, 1, 1, 0, 0;\n}\n"                                              \
                   : OUT                                                                       \
                   : "l"(da), "l"(db), "r"(scale_d));                                          \
  }

// A from four registers a thread (mma.m16n8k16's A fragment of the warp's 16
// rows), B from shared memory: MN-major as rs_NN (O += P V; TB "1"), K-major
// as rsk_NN (TB "0": csrc/cross_attn_block.cu's scores, q from registers).
#define SMELTER_WA_RS(NAME, NN, TB, REGS, OUT, I0, I1, I2, I3, IB, IP)                         \
  template <typename T>                                                                        \
  __device__ __forceinline__ void NAME##_##NN(float (&d)[NN / 2], const uint32_t (&a)[4],      \
                                              uint64_t db, int scale_d) {                      \
    if constexpr (std::is_same<T, __nv_bfloat16>::value)                                       \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" IP ", 0;\n"                            \
                   "wgmma.mma_async.sync.aligned.m64n" #NN "k16.f32.bf16.bf16 {" REGS "}, {%" I0 \
                   ", %" I1 ", %" I2 ", %" I3 "}, %" IB ", p, 1, 1, " TB ";\n}\n"                 \
                   : OUT                                                                       \
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));       \
    else                                                                                       \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" IP ", 0;\n"                            \
                   "wgmma.mma_async.sync.aligned.m64n" #NN "k16.f32.f16.f16 {" REGS "}, {%" I0  \
                   ", %" I1 ", %" I2 ", %" I3 "}, %" IB ", p, 1, 1, " TB ";\n}\n"                 \
                   : OUT                                                                       \
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));       \
  }

SMELTER_WA_SS(128, SMELTER_WA_REGS64, SMELTER_WA_OUT64, "64", "65", "66")
SMELTER_WA_RS(rs, 16, "1", SMELTER_WA_REGS8, SMELTER_WA_OUT8, "8", "9", "10", "11", "12", "13")
SMELTER_WA_RS(rs, 32, "1", SMELTER_WA_REGS16, SMELTER_WA_OUT16, "16", "17", "18", "19", "20",
              "21")
SMELTER_WA_RS(rs, 64, "1", SMELTER_WA_REGS32, SMELTER_WA_OUT32, "32", "33", "34", "35", "36",
              "37")
SMELTER_WA_RS(rs, 128, "1", SMELTER_WA_REGS64, SMELTER_WA_OUT64, "64", "65", "66", "67", "68",
              "69")
SMELTER_WA_RS(rsk, 16, "0", SMELTER_WA_REGS8, SMELTER_WA_OUT8, "8", "9", "10", "11", "12", "13")
SMELTER_WA_RS(rsk, 32, "0", SMELTER_WA_REGS16, SMELTER_WA_OUT16, "16", "17", "18", "19", "20",
              "21")
SMELTER_WA_RS(rsk, 64, "0", SMELTER_WA_REGS32, SMELTER_WA_OUT32, "32", "33", "34", "35", "36",
              "37")

#undef SMELTER_WA_SS
#undef SMELTER_WA_RS

template <typename T, int HD>
__device__ __forceinline__ void mma_rs(float (&d)[HD / 2], const uint32_t (&a)[4], uint64_t db,
                                       int acc) {
  if constexpr (HD == 16)
    rs_16<T>(d, a, db, acc);
  else if constexpr (HD == 32)
    rs_32<T>(d, a, db, acc);
  else if constexpr (HD == 64)
    rs_64<T>(d, a, db, acc);
  else
    rs_128<T>(d, a, db, acc);
}

// d (64 x N) (+)= A (registers) B, B K-major: N = 16, 32 or 64.
template <typename T, int N>
__device__ __forceinline__ void mma_rsk(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db,
                                        int acc) {
  if constexpr (N == 16)
    rsk_16<T>(d, a, db, acc);
  else if constexpr (N == 32)
    rsk_32<T>(d, a, db, acc);
  else
    rsk_64<T>(d, a, db, acc);
}

template <int R>
__device__ __forceinline__ void fence_u32(uint32_t (&r)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// s (64 x KT, f32) = the warpgroup's 64 rows of Q (from row `row0` of a Q
// tile of `q_rows` rows) times the KT-key tile k, transposed. Issues the
// hd / 16 steps; the caller commits and waits.
template <typename T, int HD>
__device__ __forceinline__ void scores(float (&s)[KT / 2], const uint8_t* q, int q_rows, int row0,
                                       const uint8_t* k) {
  using G = Geo<HD>;
  constexpr int PER = G::PART_COLS / 16;  // k16 steps a part
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int p = kk / PER, o = (kk % PER) * 32;
    const uint64_t da = desc(q + (p * q_rows + row0) * G::RB + o, 16, G::SBO, G::LAYOUT);
    const uint64_t db = desc(k + p * KT * G::RB + o, 16, G::SBO, G::LAYOUT);
    ss_128<T>(s, da, db, kk > 0);
  }
}

// o (64 x hd, f32) (+)= P (the KT keys' A fragments) times the KT-key V
// tile; o = P V where acc is 0. The caller commits and waits.
template <typename T, int HD>
__device__ __forceinline__ void pv(float (&o)[HD / 2], const uint32_t (&p)[KT / 16][4],
                                   const uint8_t* v, int acc) {
  using G = Geo<HD>;
#pragma unroll
  for (int kk = 0; kk < KT / 16; ++kk)
    mma_rs<T, HD>(o, p[kk], desc(v + kk * 16 * G::RB, KT * G::RB, G::SBO, G::LAYOUT),
                  kk > 0 || acc);
}

// v0 (low half) and v1 rounded to the 16-bit type T, packed.
template <typename T>
__device__ __forceinline__ uint32_t pack16(float v0, float v1) {
  return wg::pack2(std::is_same<T, __nv_bfloat16>::value ? kBF16 : kF16, v0, v1);
}

// P's A fragments from the f32 probabilities (the scores' accumulator
// layout is the A fragment's: keys 16 kk + 2 t (+1), + 8).
template <typename T>
__device__ __forceinline__ void to_fragments(uint32_t (&p)[KT / 16][4], const float (&s)[KT / 2]) {
#pragma unroll
  for (int kk = 0; kk < KT / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) p[kk][i] = pack16<T>(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
}

// 2^x on the SFU (ex2.approx.ftz: about 2 ulp, as __expf's), one
// instruction where exp2f adds a denormal guard around it.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The max or the sum of a row over the quad of threads that holds it.
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// -- the streaming form: one ring step --------------------------------------

template <int HD>
struct StreamCfg {
  static constexpr int Q_BYTES = Q_ROWS * HD * 2;
  static constexpr int KV_BYTES = KT * HD * 2;
  __host__ __device__ static constexpr int fixed() { return 1024 + Q_BYTES + 8; }
  __host__ __device__ static constexpr int stage() { return 2 * KV_BYTES + 16; }
  static constexpr int STAGES = (SMEM_LIMIT - fixed()) / stage() > 4
                                    ? 4
                                    : (SMEM_LIMIT - fixed()) / stage();
  static constexpr int SMEM = fixed() + STAGES * stage();
  static_assert(STAGES >= 2, "two stages at least");
};

// Operand element strides (batch, head, row; the head dim contiguous).
struct View {
  long long b, h, n;
};

// One tile's online softmax, o aside: s = s * scale (keys past Nk -inf),
// m_new = max(m, max_j s), alpha = exp(m - m_new), s = exp(s - m_new), l =
// alpha l + sum_j s. FOLD (scale > 0): s stays unscaled, its row max times
// scale is the scaled max (rounding is monotonic), and the exponent takes
// the scale, s (scale log2 e) - m log2 e: no multiply of the whole tile.
template <bool FOLD>
__device__ __forceinline__ void online_max_sum(float (&s)[KT / 2], float (&m)[2], float (&l)[2],
                                               float (&alpha)[2], float scale, int Nk, int c0) {
  const int t = threadIdx.x & 3;
  if (c0 + KT <= Nk) {
    if (!FOLD) {
#pragma unroll
      for (int i = 0; i < KT / 2; ++i) s[i] *= scale;
    }
  } else {  // the ragged last tile
#pragma unroll
    for (int i = 0; i < KT / 2; ++i) {
      const int key = c0 + 8 * (i >> 2) + 2 * t + (i & 1);
      s[i] = key < Nk ? (FOLD ? s[i] : s[i] * scale) : -INFINITY;
    }
  }
  const float c = FOLD ? scale * LOG2E : LOG2E;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < KT / 8; ++jj)
      mx = fmaxf(mx, fmaxf(s[4 * jj + 2 * h], s[4 * jj + 2 * h + 1]));
    mx = quad_max(mx);
    const float mn = fmaxf(m[h], FOLD ? mx * scale : mx);  // finite: a tile holds a key below Nk
    alpha[h] = ex2((m[h] - mn) * LOG2E);
    const float mb = mn * LOG2E;
    float sum = 0.f;
#pragma unroll
    for (int jj = 0; jj < KT / 8; ++jj)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * jj + 2 * h + e;
        s[i] = ex2(fmaf(s[i], c, -mb));
        sum += s[i];
      }
    l[h] = alpha[h] * l[h] + quad_sum(sum);
    m[h] = mn;
  }
}

// o *= alpha, each row half by its own.
template <int HD>
__device__ __forceinline__ void rescale(float (&o)[HD / 2], const float (&alpha)[2]) {
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      o[4 * n + 2 * h] *= alpha[h];
      o[4 * n + 2 * h + 1] *= alpha[h];
    }
}

// q (B, H, Nq, hd), k and v (B, H, Nk, hd) through 4-D maps (hd, N, H, B)
// of their strides (boxes of 128 rows for q, KT for k and v). A ring step
// (B 1, H = BH, packed operands) reads m, l (BH, Nq) and acc (BH, Nq, hd)
// f32 unless `first` and writes them unless `last`; with `last` the output
// out = acc / l in T goes through out's element strides `os`. One call of
// flash_attention is a step with both set: no state is read or written.
// FOLD: scale > 0, folded into the exponent (online_max_sum). Grid (Nq /
// 128, B H).
template <typename T, int HD, bool FOLD>
__global__ void __launch_bounds__(THREADS, 1)
attn_stream(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
            const __grid_constant__ CUtensorMap map_v, float* __restrict__ m_g,
            float* __restrict__ l_g, float* __restrict__ acc_g, uint16_t* __restrict__ out,
            View os, int H, int Nq, int Nk, float scale, int first, int last) {
  using G = Geo<HD>;
  using Cfg = StreamCfg<HD>;
  constexpr int STAGES = Cfg::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sq = align1024(smem_raw);
  uint8_t* skv = sq + Cfg::Q_BYTES;  // stage s: K at s 2 KV_BYTES, V after it
  uint64_t* qfull = reinterpret_cast<uint64_t*>(skv + STAGES * 2 * Cfg::KV_BYTES);
  uint64_t* full = qfull + 1;
  uint64_t* empty = full + STAGES;
  const int bh = blockIdx.y, hi = bh % H, bi = bh / H;
  const int q0 = blockIdx.x * Q_ROWS, tiles = (Nk + KT - 1) / KT;

  if (threadIdx.x == 0) {
    mbar_init(qfull, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NCONS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128 * NCONS) {  // the producer: one thread issues every load
    if (threadIdx.x == 128 * NCONS) {
      mbar_expect_tx(qfull, Cfg::Q_BYTES);
#pragma unroll
      for (int p = 0; p < G::PARTS; ++p)
        tma_load_4d(sq + p * Q_ROWS * G::RB, &map_q, qfull, p * G::PART_COLS, q0, hi, bi);
      int stage = 0, phase = 0;
      for (int j = 0; j < tiles; ++j) {
        mbar_wait(&empty[stage], phase ^ 1);
        mbar_expect_tx(&full[stage], 2 * Cfg::KV_BYTES);
        uint8_t* kb = skv + stage * 2 * Cfg::KV_BYTES;
#pragma unroll
        for (int p = 0; p < G::PARTS; ++p) {
          tma_load_4d(kb + p * KT * G::RB, &map_k, &full[stage], p * G::PART_COLS, j * KT, hi,
                      bi);
          tma_load_4d(kb + Cfg::KV_BYTES + p * KT * G::RB, &map_v, &full[stage],
                      p * G::PART_COLS, j * KT, hi, bi);
        }
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  const int wgi = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const bool leader = (threadIdx.x & 127) == 0;
  // the thread's rows (h = 0, 1) and their f32 state
  int rows[2];
  float m[2], l[2], o[HD / 2], alpha[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    rows[h] = q0 + wgi * WG_ROWS + warp * 16 + g + 8 * h;
    const size_t at = static_cast<size_t>(bh) * Nq + rows[h];
    const bool load = !first && rows[h] < Nq;
    m[h] = load ? m_g[at] : -INFINITY;
    l[h] = load ? l_g[at] : 0.f;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      const float2 a = load ? *reinterpret_cast<const float2*>(&acc_g[at * HD + n * 8 + t * 2])
                            : make_float2(0.f, 0.f);
      o[4 * n + 2 * h] = a.x;
      o[4 * n + 2 * h + 1] = a.y;
    }
  }
  float s[KT / 2];
#pragma unroll
  for (int i = 0; i < KT / 2; ++i) s[i] = 0.f;
  mbar_wait(qfull, 0);
  int stage = 0, phase = 0;
  if constexpr (HD <= 64) {
    // Pipelined: tile j + 1's scores and tile j's P V are issued together,
    // and tile j + 1's softmax runs while P V (its A fragments p and its
    // accumulator o untouched) is in flight; o takes tile j + 1's alpha once
    // P V is waited for. Nothing is in flight across the loop's back edge
    // (ptxas's C7515). s, p and o take hd / 2 + 96 registers a thread
    // together, which fits at hd 64, not at 128.
    uint32_t p[KT / 16][4];
    mbar_wait(&full[0], 0);
    wgmma_fence();
    scores<T, HD>(s, sq, Q_ROWS, wgi * WG_ROWS, skv);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    online_max_sum<FOLD>(s, m, l, alpha, scale, Nk, 0);
    rescale<HD>(o, alpha);
    to_fragments<T>(p, s);
    for (int j = 0; j < tiles; ++j) {
      const uint8_t* kb = skv + stage * 2 * Cfg::KV_BYTES;
      const int next = stage + 1 == STAGES ? 0 : stage + 1;
      const int next_phase = next != 0 ? phase : phase ^ 1;
      const uint8_t* nkb = skv + next * 2 * Cfg::KV_BYTES;
      if (j + 1 < tiles) {
        mbar_wait(&full[next], next_phase);
        wgmma_fence();
        scores<T, HD>(s, sq, Q_ROWS, wgi * WG_ROWS, nkb);
        wgmma_commit();
        pv<T, HD>(o, p, kb + Cfg::KV_BYTES, 1);
        wgmma_commit();
        wgmma_wait<1>();  // the scores (committed first) are in
        fence_regs(s);
        online_max_sum<FOLD>(s, m, l, alpha, scale, Nk, (j + 1) * KT);
        wgmma_wait<0>();
        fence_regs(o);
        fence_u32(p);
        if (leader) mbar_arrive(&empty[stage]);  // tile j's K and V are read
        rescale<HD>(o, alpha);
        to_fragments<T>(p, s);
      } else {
        wgmma_fence();
        pv<T, HD>(o, p, kb + Cfg::KV_BYTES, 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(o);
        fence_u32(p);
        if (leader) mbar_arrive(&empty[stage]);
      }
      stage = next;
      phase = next_phase;
    }
  } else {
    for (int j = 0; j < tiles; ++j) {
      mbar_wait(&full[stage], phase);
      const uint8_t* kb = skv + stage * 2 * Cfg::KV_BYTES;
      wgmma_fence();
      scores<T, HD>(s, sq, Q_ROWS, wgi * WG_ROWS, kb);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      online_max_sum<FOLD>(s, m, l, alpha, scale, Nk, j * KT);
      rescale<HD>(o, alpha);
      // P V waited for at once: a P V still in flight across the loop's back
      // edge makes ptxas serialize every wgmma of the loop (its C7515)
      uint32_t p[KT / 16][4];
      to_fragments<T>(p, s);
      wgmma_fence();
      pv<T, HD>(o, p, kb + Cfg::KV_BYTES, 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      fence_u32(p);
      if (leader) mbar_arrive(&empty[stage]);  // the tile's K and V are read
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = rows[h];
    if (row >= Nq) continue;
    if (last) {
      const float inv = 1.f / l[h];
      uint16_t* dst = out + bi * os.b + hi * os.h + row * os.n + t * 2;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
        *reinterpret_cast<uint32_t*>(dst + n * 8) =
            pack16<T>(o[4 * n + 2 * h] * inv, o[4 * n + 2 * h + 1] * inv);
      continue;
    }
    const size_t at = static_cast<size_t>(bh) * Nq + row;
    if (t == 0) {
      m_g[at] = m[h];
      l_g[at] = l[h];
    }
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<float2*>(&acc_g[at * HD + n * 8 + t * 2]) =
          make_float2(o[4 * n + 2 * h], o[4 * n + 2 * h + 1]);
  }
}

// -- the normalised form: the ViT block's attention --------------------------

enum MaskKind : int { kNoMask = 0, kKeep2d = 1, kLen1d = 2 };

// The additive mask on key `key` of image b: (1 - keep[b, key]) * filter
// (keep2d) or filter where key >= len[b] (len1d).
__device__ __forceinline__ float mask_add(const float* keep, const int* lens, int kind, int b,
                                          int N, int key, float filter) {
  if (kind == kKeep2d) return (1.f - keep[static_cast<size_t>(b) * N + key]) * filter;
  if (kind == kLen1d) return key < lens[b] ? 0.f : filter;
  return 0.f;
}

template <int HD>
struct NormCfg {
  static constexpr int Q_BYTES = Q_ROWS * HD * 2;
  static constexpr int KV_BYTES = KT * HD * 2;
  // two tiles: the first tile's exps of both warpgroups, f32
  static constexpr int STAGED = NCONS * WG_ROWS * KT * 4;
  // one buffer: Q, then `tiles` K tiles, then `tiles` V tiles
  __host__ __device__ static constexpr int buffer(int tiles) {
    return Q_BYTES + 2 * tiles * KV_BYTES;
  }
  __host__ __device__ static constexpr int smem(int tiles, int buffers) {
    return 1024 + buffers * (buffer(tiles) + 16) + (tiles == 2 ? STAGED : 0);
  }
};

// The scores of the tile from key c0 scaled and masked in place: s * scale
// + the additive mask, keys past N -inf. Each key's mask serves both rows.
__device__ __forceinline__ void mask_tile(float (&s)[KT / 2], float scale, const float* keep,
                                          const int* lens, int kind, int b, int N, int c0,
                                          float filter) {
  if (kind == kNoMask && c0 + KT <= N) {  // a whole tile of keys, no mask
#pragma unroll
    for (int i = 0; i < KT / 2; ++i) s[i] *= scale;
    return;
  }
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int jj = 0; jj < KT / 8; ++jj)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int key = c0 + 8 * jj + 2 * t + e;
      const float add = key < N ? mask_add(keep, lens, kind, b, N, key, filter) : -INFINITY;
      s[4 * jj + e] = fmaf(s[4 * jj + e], scale, add);
      s[4 * jj + 2 + e] = fmaf(s[4 * jj + 2 + e], scale, add);
    }
}

// The operands of the normalised form, chosen at compile time (a runtime
// flag in the loop made cicc take minutes in gemm_tma):
// kPackedQkv: the ViT block's qkv (B, N, 3 D) through two 3-D maps (hd
//   columns at 3 pair G + {0, G, 2 G} + hl hd, G = group hd; map_k serves K
//   and V);
// kViews: short_attention's q, k and v (B, H, N, hd) through a 4-D map
//   (hd, N, H, B) each.
enum NormSrc : int { kPackedQkv = 0, kViews = 1 };

// Per head: out = softmax(q k^T * scale + mask) v, boxes of 128 rows for Q
// and KT for K and V. Work item i: image i / (heads rb), head (i / rb) %
// heads, row block i % rb (rb = N / 128); `tiles` key tiles resident an
// item, `buffers` items in flight. The output goes through its element
// strides `os` (the ViT block's attn (B N, D), head h at columns h hd: N D,
// hd, D). Grid: at most one CTA an SM.
template <typename T, int HD, int SRC>
__global__ void __launch_bounds__(THREADS, 1)
attn_norm(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
          const __grid_constant__ CUtensorMap map_v, const float* __restrict__ keep,
          const int* __restrict__ lens, int mask_kind, float filter, uint16_t* __restrict__ out,
          View os, int B, int N, int heads, int group, float scale, int tiles, int buffers) {
  using G = Geo<HD>;
  using Cfg = NormCfg<HD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sb = align1024(smem_raw);
  const int buf_bytes = Cfg::buffer(tiles);
  float* staged = reinterpret_cast<float*>(sb + buffers * buf_bytes);  // tiles == 2
  uint64_t* full =
      reinterpret_cast<uint64_t*>(sb + buffers * buf_bytes + (tiles == 2 ? Cfg::STAGED : 0));
  uint64_t* empty = full + buffers;
  const int rb = (N + Q_ROWS - 1) / Q_ROWS, items = B * heads * rb;
  const int G_ = group * HD;

  if (threadIdx.x == 0) {
    for (int s = 0; s < buffers; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NCONS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128 * NCONS) {
    if (threadIdx.x == 128 * NCONS) {
      int buf = 0, phase = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        const int r = item % rb, h = (item / rb) % heads, b = item / (rb * heads);
        mbar_wait(&empty[buf], phase ^ 1);
        mbar_expect_tx(&full[buf], buf_bytes);
        uint8_t* qb = sb + buf * buf_bytes;
        uint8_t* kb = qb + Cfg::Q_BYTES;
        uint8_t* vb = kb + tiles * Cfg::KV_BYTES;
        if constexpr (SRC == kViews) {
#pragma unroll
          for (int p = 0; p < G::PARTS; ++p)
            tma_load_4d(qb + p * Q_ROWS * G::RB, &map_q, &full[buf], p * G::PART_COLS,
                        r * Q_ROWS, h, b);
          for (int tt = 0; tt < tiles; ++tt)
#pragma unroll
            for (int p = 0; p < G::PARTS; ++p) {
              tma_load_4d(kb + tt * Cfg::KV_BYTES + p * KT * G::RB, &map_k, &full[buf],
                          p * G::PART_COLS, tt * KT, h, b);
              tma_load_4d(vb + tt * Cfg::KV_BYTES + p * KT * G::RB, &map_v, &full[buf],
                          p * G::PART_COLS, tt * KT, h, b);
            }
        } else {
          const int qc = 3 * (h / group) * G_ + (h % group) * HD;
#pragma unroll
          for (int p = 0; p < G::PARTS; ++p)
            tma_load_3d(qb + p * Q_ROWS * G::RB, &map_q, &full[buf], qc + p * G::PART_COLS,
                        r * Q_ROWS, b);
          for (int tt = 0; tt < tiles; ++tt)
#pragma unroll
            for (int p = 0; p < G::PARTS; ++p) {
              tma_load_3d(kb + tt * Cfg::KV_BYTES + p * KT * G::RB, &map_k, &full[buf],
                          qc + G_ + p * G::PART_COLS, tt * KT, b);
              tma_load_3d(vb + tt * Cfg::KV_BYTES + p * KT * G::RB, &map_v, &full[buf],
                          qc + 2 * G_ + p * G::PART_COLS, tt * KT, b);
            }
        }
        if (++buf == buffers) {
          buf = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  const int wgi = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const bool leader = (threadIdx.x & 127) == 0;
  float s[KT / 2], o[HD / 2];
#pragma unroll
  for (int i = 0; i < KT / 2; ++i) s[i] = 0.f;
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  int buf = 0, phase = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int r = item % rb, h = (item / rb) % heads, b = item / (rb * heads);
    const uint8_t* qb = sb + buf * buf_bytes;
    const uint8_t* kb = qb + Cfg::Q_BYTES;
    const uint8_t* vb = kb + tiles * Cfg::KV_BYTES;
    mbar_wait(&full[buf], phase);
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    if (tiles == 2) {
      // one pass over two tiles: tile 0's exps, taken against its own row
      // max, wait in shared memory (a thread's 64 at stride 128, no bank
      // conflict) while tile 1's scores hold the registers; then p = e
      // exp(m0 - m) / l for tile 0 and e / l for tile 1
      float* st = staged + wgi * WG_ROWS * KT + (threadIdx.x & 127);
      float c0[2];
      wgmma_fence();
      scores<T, HD>(s, qb, Q_ROWS, wgi * WG_ROWS, kb);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      mask_tile(s, scale, keep, lens, mask_kind, b, N, 0, filter);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float mx = -INFINITY;
#pragma unroll
        for (int jj = 0; jj < KT / 8; ++jj)
          mx = fmaxf(mx, fmaxf(s[4 * jj + 2 * hh], s[4 * jj + 2 * hh + 1]));
        m[hh] = quad_max(mx);
        const float mb = m[hh] * LOG2E;
        float sum = 0.f;
#pragma unroll
        for (int jj = 0; jj < KT / 8; ++jj)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * jj + 2 * hh + e;
            s[i] = ex2(fmaf(s[i], LOG2E, -mb));
            sum += s[i];
          }
        l[hh] = quad_sum(sum);
      }
#pragma unroll
      for (int i = 0; i < KT / 2; ++i) st[i * 128] = s[i];
      wgmma_fence();
      scores<T, HD>(s, qb, Q_ROWS, wgi * WG_ROWS, kb + Cfg::KV_BYTES);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      mask_tile(s, scale, keep, lens, mask_kind, b, N, KT, filter);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float mx = -INFINITY;
#pragma unroll
        for (int jj = 0; jj < KT / 8; ++jj)
          mx = fmaxf(mx, fmaxf(s[4 * jj + 2 * hh], s[4 * jj + 2 * hh + 1]));
        const float mn = fmaxf(m[hh], quad_max(mx)), mb = mn * LOG2E;
        float sum = 0.f;
#pragma unroll
        for (int jj = 0; jj < KT / 8; ++jj)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * jj + 2 * hh + e;
            s[i] = ex2(fmaf(s[i], LOG2E, -mb));
            sum += s[i];
          }
        const float a0 = ex2((m[hh] - mn) * LOG2E);
        l[hh] = l[hh] * a0 + quad_sum(sum);
        const float inv = 1.f / l[hh];
        c0[hh] = a0 * inv;
#pragma unroll
        for (int jj = 0; jj < KT / 8; ++jj) {
          s[4 * jj + 2 * hh] *= inv;
          s[4 * jj + 2 * hh + 1] *= inv;
        }
      }
      uint32_t p1[KT / 16][4], p0[KT / 16][4];
      to_fragments<T>(p1, s);
      wgmma_fence();
      pv<T, HD>(o, p1, vb + Cfg::KV_BYTES, 0);
      wgmma_commit();
#pragma unroll
      for (int i = 0; i < KT / 2; ++i) s[i] = st[i * 128] * c0[(i >> 1) & 1];
      to_fragments<T>(p0, s);
      wgmma_fence();
      pv<T, HD>(o, p0, vb, 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      fence_u32(p1);
      fence_u32(p0);
    } else {
      if (tiles > 1) {  // pass 1: each row's max and sum over all keys
        for (int tt = 0; tt < tiles; ++tt) {
          wgmma_fence();
          scores<T, HD>(s, qb, Q_ROWS, wgi * WG_ROWS, kb + tt * Cfg::KV_BYTES);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(s);
          mask_tile(s, scale, keep, lens, mask_kind, b, N, tt * KT, filter);
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            float mx = -INFINITY;
#pragma unroll
            for (int jj = 0; jj < KT / 8; ++jj)
              mx = fmaxf(mx, fmaxf(s[4 * jj + 2 * hh], s[4 * jj + 2 * hh + 1]));
            const float mn = fmaxf(m[hh], quad_max(mx));
            const float mb = mn * LOG2E;
            float sum = 0.f;
#pragma unroll
            for (int jj = 0; jj < KT / 8; ++jj)
              sum += ex2(fmaf(s[4 * jj + 2 * hh], LOG2E, -mb)) +
                     ex2(fmaf(s[4 * jj + 2 * hh + 1], LOG2E, -mb));
            l[hh] = l[hh] * ex2((m[hh] - mn) * LOG2E) + quad_sum(sum);
            m[hh] = mn;
          }
        }
      }
      // pass 2 (or the only pass): p = exp(s - max) / sum rounded to T, o += p
      // v, each tile's P V waited for at once
      for (int tt = 0; tt < tiles; ++tt) {
        wgmma_fence();
        scores<T, HD>(s, qb, Q_ROWS, wgi * WG_ROWS, kb + tt * Cfg::KV_BYTES);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
        mask_tile(s, scale, keep, lens, mask_kind, b, N, tt * KT, filter);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          if (tiles == 1) {
            float mx = -INFINITY;
#pragma unroll
            for (int jj = 0; jj < KT / 8; ++jj)
              mx = fmaxf(mx, fmaxf(s[4 * jj + 2 * hh], s[4 * jj + 2 * hh + 1]));
            m[hh] = quad_max(mx);
            const float mb = m[hh] * LOG2E;
            float sum = 0.f;
#pragma unroll
            for (int jj = 0; jj < KT / 8; ++jj)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int i = 4 * jj + 2 * hh + e;
                s[i] = ex2(fmaf(s[i], LOG2E, -mb));
                sum += s[i];
              }
            l[hh] = quad_sum(sum);
            const float inv = 1.f / l[hh];
#pragma unroll
            for (int jj = 0; jj < KT / 8; ++jj) {
              s[4 * jj + 2 * hh] *= inv;
              s[4 * jj + 2 * hh + 1] *= inv;
            }
          } else {
            const float mb = m[hh] * LOG2E, inv = 1.f / l[hh];
#pragma unroll
            for (int jj = 0; jj < KT / 8; ++jj)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int i = 4 * jj + 2 * hh + e;
                s[i] = ex2(fmaf(s[i], LOG2E, -mb)) * inv;
              }
          }
        }
        uint32_t p[KT / 16][4];
        to_fragments<T>(p, s);
        wgmma_fence();
        pv<T, HD>(o, p, vb + tt * Cfg::KV_BYTES, tt > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(o);
        fence_u32(p);
      }
    }
    if (leader) mbar_arrive(&empty[buf]);  // the item's buffer is read
    if (++buf == buffers) {
      buf = 0;
      phase ^= 1;
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = r * Q_ROWS + wgi * WG_ROWS + warp * 16 + g + 8 * hh;
      if (row >= N) continue;
      uint16_t* dst = out + b * os.b + h * os.h + row * os.n + t * 2;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
        *reinterpret_cast<uint32_t*>(dst + n * 8) =
            pack16<T>(o[4 * n + 2 * hh], o[4 * n + 2 * hh + 1]);
    }
  }
}

// -- host side ----------------------------------------------------------------

// The 4-D map (hd, N, H, B) of a (B, H, N, hd) operand at its element
// strides, boxes of `rows` rows of one part.
template <typename T, int HD>
static int view_map(CUtensorMap* map, const void* base, const View& v, int B, int H, int N,
                    int rows) {
  using G = Geo<HD>;
  return wg::make_map_4d(map, base, wg::map_type<T>(), HD, N, H, B, v.n * 2, v.h * 2, v.b * 2,
                         G::PART_COLS, rows, G::SWIZZLE);
}

// Whether the 4-D maps take a (B, H, N, hd) operand: its base 16-byte
// aligned, each stride a positive 16-byte multiple below 2^40 (the plans'
// condition, checked again here before any map is encoded).
inline bool view_ok(const void* base, const View& v) {
  const auto ok = [](long long s) { return s > 0 && s % 8 == 0 && s < (1LL << 39); };
  return reinterpret_cast<uintptr_t>(base) % 16 == 0 && ok(v.b) && ok(v.h) && ok(v.n);
}

// The streaming form over (B, H, N, hd) operands at element strides q, k,
// v and out; m, l, acc the ring's f32 state (nullptr when first and last).
// hd 32, 64 or 128. Returns a cudaError_t code.
template <typename T, int HD>
static int launch_stream(const void* q, const void* k, const void* v, float* m, float* l,
                         float* acc, void* out, const View (&vw)[4], int B, int H, int Nq,
                         int Nk, float scale, bool first, bool last, cudaStream_t stream) {
  using Cfg = StreamCfg<HD>;
  if (!view_ok(q, vw[0]) || !view_ok(k, vw[1]) || !view_ok(v, vw[2]) ||
      (!(first && last) && (m == nullptr || l == nullptr || acc == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mq, mk, mv;
  int rc = view_map<T, HD>(&mq, q, vw[0], B, H, Nq, Q_ROWS);
  if (rc == 0) rc = view_map<T, HD>(&mk, k, vw[1], B, H, Nk, KT);
  if (rc == 0) rc = view_map<T, HD>(&mv, v, vw[2], B, H, Nk, KT);
  if (rc != 0) return rc;
  const dim3 grid((Nq + Q_ROWS - 1) / Q_ROWS, B * H);
  if (scale > 0.f) {
    static const cudaError_t smem_set = cudaFuncSetAttribute(
        attn_stream<T, HD, true>, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::SMEM);
    (void)smem_set;  // a refusal shows as the launch's error
    attn_stream<T, HD, true><<<grid, THREADS, Cfg::SMEM, stream>>>(
        mq, mk, mv, m, l, acc, static_cast<uint16_t*>(out), vw[3], H, Nq, Nk, scale, first,
        last);
  } else {
    static const cudaError_t smem_set = cudaFuncSetAttribute(
        attn_stream<T, HD, false>, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::SMEM);
    (void)smem_set;
    attn_stream<T, HD, false><<<grid, THREADS, Cfg::SMEM, stream>>>(
        mq, mk, mv, m, l, acc, static_cast<uint16_t*>(out), vw[3], H, Nq, Nk, scale, first,
        last);
  }
  return static_cast<int>(cudaGetLastError());
}

// One ring step on the streaming form: q (BH, Nq, hd), k, v (BH, Nk, hd)
// and out packed, 16-byte aligned, hd 32, 64 or 128.
template <typename T, int HD>
static int launch_ring_step(const void* q, const void* k, const void* v, float* m, float* l,
                            float* acc, void* out, int BH, int Nq, int Nk, float scale,
                            bool first, bool last, cudaStream_t stream) {
  const View qv{1LL * BH * Nq * HD, 1LL * Nq * HD, HD}, kv{1LL * BH * Nk * HD, 1LL * Nk * HD, HD};
  const View vw[4] = {qv, kv, kv, qv};
  return launch_stream<T, HD>(q, k, v, m, l, acc, out, vw, 1, BH, Nq, Nk, scale, first, last,
                              stream);
}

template <typename T, int HD, int SRC>
static int launch_norm_kernel(const CUtensorMap& mq, const CUtensorMap& mk,
                              const CUtensorMap& mv, const float* keep, const int* lens,
                              int mask_kind, float filter, void* out, const View& os, int B,
                              int N, int heads, int group, float scale, int tiles, int buffers,
                              int grid, cudaStream_t stream) {
  static const cudaError_t smem_set = cudaFuncSetAttribute(
      attn_norm<T, HD, SRC>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
  (void)smem_set;
  attn_norm<T, HD, SRC><<<grid, THREADS, NormCfg<HD>::smem(tiles, buffers), stream>>>(
      mq, mk, mv, keep, lens, mask_kind, filter, static_cast<uint16_t*>(out), os, B, N, heads,
      group, scale, tiles, buffers);
  return static_cast<int>(cudaGetLastError());
}

// Whether a plan's tiles and buffers fit shared memory and cover N keys.
inline bool norm_fits(int smem, int N, int tiles, int buffers) {
  return tiles >= 1 && buffers >= 1 && smem <= SMEM_LIMIT && (N + KT - 1) / KT == tiles;
}

// The ViT block's attention on the normalised form: qkv (B N, 3 D) and attn
// (B N, D) in T, 16-byte aligned, D % 8 == 0; `tiles` key tiles a work item,
// `buffers` items in flight, `grid` CTAs (the plan's). Returns a cudaError_t
// code.
template <typename T, int HD>
static int launch_norm(const void* qkv, const float* keep, const int* lens, int mask_kind,
                       float filter, void* attn, int B, int N, int D, int heads, int group,
                       float scale, int tiles, int buffers, int grid, cudaStream_t stream) {
  using G = Geo<HD>;
  if (!norm_fits(NormCfg<HD>::smem(tiles, buffers), N, tiles, buffers))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto type = wg::map_type<T>();
  const long long row = 3LL * D * 2;
  CUtensorMap mq, mkv;
  int rc = wg::make_map_3d(&mq, qkv, type, 3 * D, N, B, row, row * N, G::PART_COLS, Q_ROWS,
                           G::SWIZZLE);
  if (rc == 0)
    rc = wg::make_map_3d(&mkv, qkv, type, 3 * D, N, B, row, row * N, G::PART_COLS, KT,
                         G::SWIZZLE);
  if (rc != 0) return rc;
  const View os{1LL * N * D, HD, D};
  return launch_norm_kernel<T, HD, kPackedQkv>(mq, mkv, mkv, keep, lens, mask_kind, filter,
                                               attn, os, B, N, heads, group, scale, tiles,
                                               buffers, grid, stream);
}

// short_attention on the normalised form: q, k, v and out (B, H, N, hd) in
// T at element strides vw (q, k, v, out), no mask; `tiles`, `buffers` and
// `grid` the plan's. Returns a cudaError_t code.
template <typename T, int HD>
static int launch_norm_views(const void* q, const void* k, const void* v, void* out,
                             const View (&vw)[4], int B, int H, int N, float scale, int tiles,
                             int buffers, int grid, cudaStream_t stream) {
  if (!norm_fits(NormCfg<HD>::smem(tiles, buffers), N, tiles, buffers) || !view_ok(q, vw[0]) ||
      !view_ok(k, vw[1]) || !view_ok(v, vw[2]))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mq, mk, mv;
  int rc = view_map<T, HD>(&mq, q, vw[0], B, H, N, Q_ROWS);
  if (rc == 0) rc = view_map<T, HD>(&mk, k, vw[1], B, H, N, KT);
  if (rc == 0) rc = view_map<T, HD>(&mv, v, vw[2], B, H, N, KT);
  if (rc != 0) return rc;
  return launch_norm_kernel<T, HD, kViews>(mq, mk, mv, nullptr, nullptr, kNoMask, 0.f, out,
                                           vw[3], B, N, H, 1, scale, tiles, buffers, grid,
                                           stream);
}

}  // namespace
}  // namespace wa
}  // namespace smelter
