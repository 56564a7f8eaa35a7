// Grouped int4 dequant + matmul for Hopper, over half-split packed nibbles:
//   out = sum_kb (x_lo[:, kb] @ lo_kb) * s[kb] + (x_hi[:, kb] @ hi_kb) * s[ngh + kb]
//
// Replaces smelter_tpu/kernels/int4_matmul.py::int4_matmul (its Pallas
// `_kernel`): x rounded to bf16 (even when it arrives as f32), the packed
// (K/2, N) int8 weight whose row r holds w[r] in its low nibble and
// w[r + K/2] in its high nibble, and grouped (K/g, N) f32 scales, row kb for
// the low half's group kb and row ngh + kb for the high half's. Each group's
// dot is taken in f32 and scaled there, not on the weights.
//
// What bounds it on an H100: the weight bytes. At decode (M = 8 slots, or 1
// for a single stream; N x K from 1024 x 2048 to 32000 x 2048) that is
// K*N/2 of nibbles plus K*N/g*4 of scales: 1.1 MB to 35 MB a call, 0.3-10.6
// us at 3.35 TB/s, while the tensor-core work is a few hundredths of that.
//
// Two forms, picked by kernels/wgmma_plan.py::int4_plan from (N, K, g)
// alone (never from M, so a row's result does not depend on the others):
//
// int4_matmul_wgmma (N % 128 == 0, g % 64 == 0; all of llama_1b's shapes):
//   a persistent weight stream. A work item is a tile of 128 W columns x a
//   chunk of whole groups of packed rows (the plan's `chunks` a tile, groups
//   [c ngh / chunks, (c + 1) ngh / chunks)); up to two CTAs an SM walk the
//   work units. One producer thread a CTA issues TMA loads into a ring of 8
//   mbarrier-guarded stages, a stage being 64 packed rows x 128 columns of W
//   (8 KB through a 2-D map with the 128-byte swizzle: each row read is 128
//   contiguous bytes), the two x boxes of those rows (8 x rows x 64 of each
//   half, bf16, K-major, zero-filled past M) and, at a group's last stage,
//   the group's two scale rows of the tile: 64 KB of W in flight a CTA, 128
//   an SM. Two consumer warpgroups own 64 W columns each and compute the
//   product transposed, out^T = W^T x^T, so W is wgmma's register operand A
//   (m64n8k16, n = 8 x rows) and x^T its B from shared memory: a thread
//   reads its A-fragment bytes with two ldmatrix.x4.trans a stage (A rows g
//   and g + 8 of a warp are W columns 2g and 2g + 1, so each register holds
//   a k pair of both), and each byte gives two bf16 values by a mask, an xor
//   and a subtraction: the low nibbles feed the product with x[:, kb g..]
//   and the high nibbles the one with x[:, K/2 + kb g..]. A group's dots
//   accumulate in f32, one accumulator a k16 slice and half, so a stage's 8
//   wgmma depend on none of the others;
//   at the group's end the slices are added in order and acc += lo s_lo +
//   hi s_hi, rounded as written (no contraction). M is cut into slabs of 8
//   rows, and a work unit is (tile, K chunk, slab), slabs fastest, spread
//   over the CTAs, so every row takes the same arithmetic at every M and a
//   prefill's slabs share each W chunk through L2. (Four slabs a CTA pass,
//   converting each stage once for 32 rows, was slower in a diagnostic
//   build: 128 accumulators a thread.) A unit of a one-chunk tile stores
//   its rows;
//   otherwise each stores its f32 partial into scratch (chunks, M, N), and
//   the (tile, slab)'s last CTA, found by a counter a (tile, slab) (the only
//   atomic, one acquire-release add a unit: it picks who sums, not the
//   order), adds the partials in chunk order, stores, and resets the
//   counter to 0 for the next call. (A __threadfence in every thread before the add, and a sum
//   in a thread-block cluster through distributed shared memory, were both
//   slower in diagnostic builds.)
//
// int4_matmul_mma (any other shape the wrapper takes): one block of 8
//   warps per 32 output columns and per 16 rows of x, walking all of K. The
//   warps share out the K groups and add their partial sums in shared
//   memory in a fixed order. Nibbles go from global memory straight into
//   mma.sync.m16n8k16 B fragments: a thread reads 4 bytes (4 columns) of
//   each of 4 packed rows, pairs the bytes of one column with byte permutes,
//   and turns two nibbles into a bf16x2 as above. The mma's k and n orders
//   are permuted to match what a thread loads (logical k 2t, 2t+1, 2t+8,
//   2t+9 are packed rows 4t..4t+3; logical column j of n-tile t is physical
//   column 4j + t), and the x fragments follow the same k order, so a
//   thread's 4 x values are one 8-byte load.
#include "wgmma_gemm.cuh"

namespace {

using namespace smelter;

constexpr int WARPS = 8, THREADS = WARPS * 32;
constexpr int BN = 32;  // output columns per block
constexpr int BM = 16;  // rows of x per block (the mma's M)

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// Four consecutive x values as two bf16 pairs (x is rounded to bf16).
__device__ __forceinline__ uint2 load_x4(const __nv_bfloat16* x, size_t off) {
  return __ldg(reinterpret_cast<const uint2*>(x + off));
}
__device__ __forceinline__ uint2 load_x4(const float* x, size_t off) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(x + off));
  return make_uint2(bits(__floats2bfloat162_rn(v.x, v.y)), bits(__floats2bfloat162_rn(v.z, v.w)));
}

// Two signed nibbles, at bits 0-3 and 16-19 of `v`, as an exact bf16x2:
// 0x4300 | u is bf16 128 + u, and n ^ 8 = n + 8 for a two's-complement nibble.
__device__ __forceinline__ uint32_t nibbles_bf16x2(uint32_t v) {
  const uint32_t u = (v & 0x000F000Fu) ^ 0x43084308u;
  const uint32_t off = 0x43084308u;  // bf16x2 (136, 136)
  return bits(__hsub2(*reinterpret_cast<const __nv_bfloat162*>(&u),
                      *reinterpret_cast<const __nv_bfloat162*>(&off)));
}

template <typename XT, typename OutT>
__global__ void __launch_bounds__(THREADS)
int4_matmul_mma(const XT* __restrict__ x, const int8_t* __restrict__ pk,
                const float* __restrict__ s, OutT* __restrict__ out, int M, int N, int K,
                int g) {
  __shared__ float red[WARPS][BM][BN];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gi = lane >> 2, tig = lane & 3;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int kh = K / 2, ngh = kh / g;
  const int row0 = m0 + gi, row1 = m0 + gi + 8;
  const bool has0 = row0 < M, has1 = row1 < M;

  float acc[4][4];
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;

  for (int kb = warp; kb < ngh; kb += WARPS) {
    float dlo[4][4], dhi[4][4];
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) dlo[t][e] = dhi[t][e] = 0.f;

#pragma unroll 4
    for (int ks = 0; ks < g; ks += 16) {
      const int kr = kb * g + ks + tig * 4;  // this thread's first packed row
      const int8_t* wp = pk + static_cast<size_t>(kr) * N + n0 + gi * 4;
      uint32_t w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        w[i] = __ldg(reinterpret_cast<const uint32_t*>(wp + static_cast<size_t>(i) * N));
      const uint2 z = make_uint2(0u, 0u);
      const uint2 l0 = has0 ? load_x4(x, static_cast<size_t>(row0) * K + kr) : z;
      const uint2 h0 = has0 ? load_x4(x, static_cast<size_t>(row0) * K + kh + kr) : z;
      const uint2 l1 = has1 ? load_x4(x, static_cast<size_t>(row1) * K + kr) : z;
      const uint2 h1 = has1 ? load_x4(x, static_cast<size_t>(row1) * K + kh + kr) : z;
      const uint32_t alo[4] = {l0.x, l1.x, l0.y, l1.y};
      const uint32_t ahi[4] = {h0.x, h1.x, h0.y, h1.y};
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        // byte t of rows kr, kr+1 (and kr+2, kr+3) at bytes 0 and 2
        const uint32_t sel = t | ((4 + t) << 8);
        const uint32_t p01 = __byte_perm(w[0], w[1], sel);
        const uint32_t p23 = __byte_perm(w[2], w[3], sel);
        const uint32_t blo[2] = {nibbles_bf16x2(p01), nibbles_bf16x2(p23)};
        const uint32_t bhi[2] = {nibbles_bf16x2(p01 >> 4), nibbles_bf16x2(p23 >> 4)};
        mma_16816<__nv_bfloat16>(dlo[t], alo, blo);
        mma_16816<__nv_bfloat16>(dhi[t], ahi, bhi);
      }
    }
    // The group's scales on its f32 partial dots.
    const float* slo = s + static_cast<size_t>(kb) * N + n0;
    const float* shi = s + static_cast<size_t>(ngh + kb) * N + n0;
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = (tig * 2 + (e & 1)) * 4 + t;
        acc[t][e] += dlo[t][e] * __ldg(slo + col) + dhi[t][e] * __ldg(shi + col);
      }
  }

  // The warps' partial sums, added in warp order.
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      red[warp][gi + (e >> 1) * 8][(tig * 2 + (e & 1)) * 4 + t] = acc[t][e];
  __syncthreads();
  for (int i = threadIdx.x; i < BM * BN; i += THREADS) {
    const int rl = i / BN, cl = i % BN, row = m0 + rl;
    if (row >= M) continue;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) sum += red[w][rl][cl];
    store(&out[static_cast<size_t>(row) * N + n0 + cl], sum);
  }
}

template <typename XT>
int run(const XT* x, const int8_t* pk, const float* s, void* out, int out_dtype, int M, int N,
        int K, int g, cudaStream_t stream) {
  const dim3 grid(N / BN, cdiv(M, BM));
  switch (out_dtype) {
    case kF32:
      int4_matmul_mma<XT, float><<<grid, THREADS, 0, stream>>>(
          x, pk, s, static_cast<float*>(out), M, N, K, g);
      break;
    case kBF16:
      int4_matmul_mma<XT, __nv_bfloat16><<<grid, THREADS, 0, stream>>>(
          x, pk, s, static_cast<__nv_bfloat16*>(out), M, N, K, g);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// -- the wgmma form ------------------------------------------------------------
// kernels/wgmma_plan.py mirrors these numbers (I4_*).

constexpr int Q_ROWS = 64;    // packed rows a stage: the W box's rows
constexpr int Q_COLS = 128;   // W columns a tile: the W box's columns
constexpr int Q_MT = 8;       // x rows a slab: the wgmma's n
constexpr int Q_W_BYTES = Q_ROWS * Q_COLS;                    // 8,192
constexpr int Q_X_BYTES = Q_MT * Q_ROWS * 2;                  // 1,024: one x box
constexpr int Q_S_BYTES = 2 * Q_COLS * 4;                     // a group's scale rows
constexpr int Q_STAGE = Q_W_BYTES + 2 * Q_X_BYTES + Q_S_BYTES;  // 11,264
constexpr int Q_STAGES = 8;
constexpr int Q_SMEM = 1024 + Q_STAGES * (Q_STAGE + 16) + 16;  // 91,280
constexpr int Q_CTAS = 2;     // CTAs an SM
constexpr int Q_SMS = 132;    // SMs of an H100 SXM
constexpr int Q_CONSUMERS = 2, Q_THREADS = 128 * Q_CONSUMERS + 32;  // + a producer warp
static_assert(Q_STAGE % 1024 == 0, "stages keep the 128-byte swizzle's 1024-byte alignment");
static_assert(Q_CTAS * Q_SMEM <= 228 * 1024, "more shared memory than an SM has");

// D (64 x 8, f32) += A (64 x 16, mma.m16n8k16's A fragment a warp) * B (16 x
// 8, shared, K-major with the 128-byte swizzle) on the warpgroup.
__device__ __forceinline__ void mma_rs_m64n8k16(float (&d)[4], const uint32_t (&a)[4],
                                                uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <int R, int C>
__device__ __forceinline__ void fence_regs2(float (&d)[R][C]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) asm volatile("" : "+f"(d[i][j])::"memory");
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
  *reinterpret_cast<uint2*>(p) = make_uint2(bits(lo), bits(hi));
}

// out (M, N) = x (M, K) bf16 @ dequant(pk (K/2, N), s (K/g, N)) through
// three maps: x (M, K) bf16 in boxes of 8 rows x 64, pk (K/2, N) uint8 in
// boxes of 64 rows x 128 (both with the 128-byte swizzle), s (K/g, N) f32
// in boxes of 1 row x 128. A work unit is (tile, K chunk, slab of 8 x
// rows), or with `whole` (tile, slab) over all K chunks in order; slabs
// fastest, so the CTAs at work at once share W through L2 at a prefill's
// M. Split tiles (chunks > 1, not `whole`) take `part` (chunks, M, N) f32
// and `counters` (N / 128 x ceil(M / 8)) int32, zero at entry and left zero.
template <typename OutT>
__global__ void __launch_bounds__(Q_THREADS, Q_CTAS)
int4_matmul_wgmma(const __grid_constant__ CUtensorMap map_x,
                  const __grid_constant__ CUtensorMap map_w,
                  const __grid_constant__ CUtensorMap map_s, OutT* __restrict__ out,
                  float* __restrict__ part, int* __restrict__ counters, int M, int N, int K,
                  int g, int chunks, int whole) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* st0 = smem_raw + ((1024 - (wg::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(st0 + Q_STAGES * Q_STAGE);
  uint64_t* empty = full + Q_STAGES;
  int* last_flag = reinterpret_cast<int*>(empty + Q_STAGES);
  const int kh = K / 2, ngh = kh / g, sg_n = g / Q_ROWS;
  const int slabs = wg::div_up(M, Q_MT), per_tile = whole ? 1 : chunks;
  const int units = N / Q_COLS * per_tile * slabs;

  if (threadIdx.x == 0) {
    for (int i = 0; i < Q_STAGES; ++i) {
      wg::mbar_init(&full[i], 1);
      wg::mbar_init(&empty[i], Q_CONSUMERS * 4);  // one arrival a consumer warp
    }
    wg::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128 * Q_CONSUMERS) {  // the producer warp: one thread issues every load
    if (threadIdx.x == 128 * Q_CONSUMERS) {
      int stage = 0, phase = 0;
      for (int unit = blockIdx.x; unit < units; unit += gridDim.x) {
        const int slab = unit % slabs, item = unit / slabs, n0 = item / per_tile * Q_COLS;
        const int c0 = whole ? 0 : item % chunks, c1 = whole ? chunks : c0 + 1;
        for (int gi = c0 * ngh / chunks; gi < c1 * ngh / chunks; ++gi)
          for (int sg = 0; sg < sg_n; ++sg) {
            const int kp = gi * g + sg * Q_ROWS;  // the stage's first packed row
            const bool last = sg == sg_n - 1;
            wg::mbar_wait(&empty[stage], phase ^ 1);
            uint8_t* sp = st0 + stage * Q_STAGE;
            wg::mbar_expect_tx(&full[stage], Q_W_BYTES + 2 * Q_X_BYTES + (last ? Q_S_BYTES : 0));
            wg::tma_load_2d(sp, &map_w, &full[stage], n0, kp);
            wg::tma_load_2d(sp + Q_W_BYTES, &map_x, &full[stage], kp, slab * Q_MT);
            wg::tma_load_2d(sp + Q_W_BYTES + Q_X_BYTES, &map_x, &full[stage], kh + kp,
                            slab * Q_MT);
            if (last) {
              uint8_t* ss = sp + Q_W_BYTES + 2 * Q_X_BYTES;
              wg::tma_load_2d(ss, &map_s, &full[stage], n0, gi);
              wg::tma_load_2d(ss + Q_COLS * 4, &map_s, &full[stage], n0, ngh + gi);
            }
            if (++stage == Q_STAGES) {
              stage = 0;
              phase ^= 1;
            }
          }
      }
    }
    return;
  }

  const int ct = threadIdx.x, wgi = ct >> 7, warp = (ct >> 5) & 3, lane = ct & 31;
  const int t = lane & 3;
  const int cb = wgi * 64 + warp * 16 + 2 * (lane >> 2);  // this thread's two W columns
  // ldmatrix.trans rows: lane 8i + r names row r of 8 x 8 b16 matrix i, whose
  // 16-byte rows are the warp's chunk (W columns wgi*64 + warp*16 ..) of box
  // rows k: matrices 0-3 are rows 0-7 and 8-15 of two k16 slices.
  const int chunk16 = wgi * 4 + warp;
  const int lrow = ((lane >> 4) << 4) + (((lane >> 3) & 1) << 3) + (lane & 7);
  int stage = 0, phase = 0;

  for (int unit = blockIdx.x; unit < units; unit += gridDim.x) {
    const int slab = unit % slabs, item = unit / slabs, tile = item / per_tile;
    const int n0 = tile * Q_COLS, c0 = whole ? 0 : item % chunks, c1 = whole ? chunks : c0 + 1;
    // each chunk's f32 partial, folded into `sum` in chunk order (as the
    // last CTA of a split tile adds them)
    float sum[4];
    for (int c = c0; c < c1; ++c) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int gi = c * ngh / chunks; gi < (c + 1) * ngh / chunks; ++gi) {
        // the group's f32 dots, one accumulator a k16 slice of the stage and a
        // half, so that none of a stage's 8 wgmma waits on another
        float plo[Q_ROWS / 16][4], phi[Q_ROWS / 16][4];
#pragma unroll
        for (int kk = 0; kk < Q_ROWS / 16; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e) plo[kk][e] = phi[kk][e] = 0.f;
        for (int sg = 0; sg < sg_n; ++sg) {
          const bool last = sg == sg_n - 1;
          wg::mbar_wait(&full[stage], phase);
          const uint8_t* sp = st0 + stage * Q_STAGE;
          // W^T's A fragments (A rows g and g + 8 of a warp are columns cb and
          // cb + 1): each ldmatrix.x4.trans register holds bytes (k, cb),
          // (k, cb + 1), (k + 1, cb), (k + 1, cb + 1) for k = 2t (+ 8) of a
          // slice, and each byte gives the low half's and the high half's value.
          uint32_t alo[Q_ROWS / 16][4], ahi[Q_ROWS / 16][4];
#pragma unroll
          for (int pr = 0; pr < Q_ROWS / 32; ++pr) {
            const int k = pr * 32 + lrow;
            uint32_t v[4];
            ldmatrix_x4_trans(v, sp + k * 128 + ((chunk16 ^ (k & 7)) << 4));
#pragma unroll
            for (int i = 0; i < 4; ++i) {  // slice 2 pr + i / 2, k pair 2t (+ 8 for odd i)
              const int kk = 2 * pr + (i >> 1), h = i & 1;
              alo[kk][2 * h] = nibbles_bf16x2(v[i]);
              alo[kk][2 * h + 1] = nibbles_bf16x2(v[i] >> 8);
              ahi[kk][2 * h] = nibbles_bf16x2(v[i] >> 4);
              ahi[kk][2 * h + 1] = nibbles_bf16x2(v[i] >> 12);
            }
          }
          float2 slo = make_float2(0.f, 0.f), shi = slo;
          if (last) {
            const float* ss = reinterpret_cast<const float*>(sp + Q_W_BYTES + 2 * Q_X_BYTES);
            slo = *reinterpret_cast<const float2*>(ss + cb);
            shi = *reinterpret_cast<const float2*>(ss + Q_COLS + cb);
          }
          wg::wgmma_fence();
          const uint64_t dlo = wg::desc(sp + Q_W_BYTES, 16, 1024);
          const uint64_t dhi = wg::desc(sp + Q_W_BYTES + Q_X_BYTES, 16, 1024);
#pragma unroll
          for (int kk = 0; kk < Q_ROWS / 16; ++kk) {
            mma_rs_m64n8k16(plo[kk], alo[kk], dlo + 2 * kk);
            mma_rs_m64n8k16(phi[kk], ahi[kk], dhi + 2 * kk);
          }
          wg::wgmma_commit();
          wg::wgmma_wait<0>();
          fence_regs2(plo);
          fence_regs2(phi);
          if (last) {  // the group's scales on its f32 dots, rounded as written
#pragma unroll
            for (int e = 0; e < 4; ++e) {  // e >> 1: column cb + 1
              const float sl = (e >> 1) ? slo.y : slo.x, sh = (e >> 1) ? shi.y : shi.x;
              float dl = plo[0][e], dh = phi[0][e];
#pragma unroll
              for (int kk = 1; kk < Q_ROWS / 16; ++kk) {
                dl = __fadd_rn(dl, plo[kk][e]);
                dh = __fadd_rn(dh, phi[kk][e]);
              }
              acc[e] = __fadd_rn(acc[e], __fadd_rn(__fmul_rn(dl, sl), __fmul_rn(dh, sh)));
            }
          }
          __syncwarp();
          if (lane == 0) wg::mbar_arrive(&empty[stage]);
          if (++stage == Q_STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) sum[e] = c == c0 ? acc[e] : __fadd_rn(sum[e], acc[e]);
    }
    // sum[e]: out row 8 slab + 2t + (e & 1), column n0 + cb + (e >> 1)
    const bool split = chunks > 1 && !whole;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = slab * Q_MT + 2 * t + r;
      if (row >= M) continue;
      if (!split)
        store2(out + static_cast<size_t>(row) * N + n0 + cb, sum[r], sum[2 + r]);
      else
        store2(part + (static_cast<size_t>(c0) * M + row) * N + n0 + cb, sum[r], sum[2 + r]);
    }
    if (!split) continue;
    // the (tile, slab)'s last chunk to finish adds the partials in chunk
    // order: the consumers' barrier, then one thread's acquire-release add
    // (it releases this CTA's partial and, for the last, acquires the
    // others'), then the barrier again, as a semaphore after __syncthreads does
    int* counter = counters + tile * slabs + slab;
    wg::named_sync(1, 128 * Q_CONSUMERS);
    if (ct == 0) {
      int old;
      asm volatile("atom.add.acq_rel.gpu.global.s32 %0, [%1], 1;\n"
                   : "=r"(old)
                   : "l"(counter)
                   : "memory");
      *last_flag = old == chunks - 1;
    }
    wg::named_sync(1, 128 * Q_CONSUMERS);
    if (!*last_flag) continue;
    const int rows = min(Q_MT, M - slab * Q_MT);
    for (int i = ct; i < rows * (Q_COLS / 4); i += 128 * Q_CONSUMERS) {
      const int row = slab * Q_MT + i / (Q_COLS / 4), col = n0 + 4 * (i % (Q_COLS / 4));
      const float* pp = part + static_cast<size_t>(row) * N + col;
      const size_t cs = static_cast<size_t>(M) * N;
      float4 sum = __ldcg(reinterpret_cast<const float4*>(pp));
      for (int c = 1; c < chunks; ++c) {
        const float4 v = __ldcg(reinterpret_cast<const float4*>(pp + c * cs));
        sum = make_float4(__fadd_rn(sum.x, v.x), __fadd_rn(sum.y, v.y), __fadd_rn(sum.z, v.z),
                          __fadd_rn(sum.w, v.w));
      }
      store4(out + static_cast<size_t>(row) * N + col, sum);
    }
    if (ct == 0) *counter = 0;
  }
}

template <typename OutT>
int run_wgmma(const void* x, const void* pk, const void* s, void* out, float* part, int* counters,
              int M, int N, int K, int g, int chunks, int whole, cudaStream_t stream) {
  CUtensorMap map_x, map_w, map_s;
  int rc = wg::make_map(&map_x, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, M, K, Q_MT, Q_ROWS,
                        CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc == 0)
    rc = wg::make_map(&map_w, pk, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, K / 2, N, Q_ROWS, Q_COLS,
                      CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc == 0)
    rc = wg::make_map(&map_s, s, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, K / g, N, 1, Q_COLS,
                      CU_TENSOR_MAP_SWIZZLE_NONE);
  if (rc != 0) return rc;
  static const cudaError_t smem_set = cudaFuncSetAttribute(
      int4_matmul_wgmma<OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize, Q_SMEM);
  (void)smem_set;
  const long long units = static_cast<long long>(N / Q_COLS) * (whole ? 1 : chunks) * cdiv(M, Q_MT);
  const int grid = static_cast<int>(units < Q_CTAS * Q_SMS ? units : Q_CTAS * Q_SMS);
  int4_matmul_wgmma<OutT><<<grid, Q_THREADS, Q_SMEM, stream>>>(
      map_x, map_w, map_s, static_cast<OutT*>(out), part, counters, M, N, K, g, chunks, whole);
  return static_cast<int>(cudaGetLastError());
}
}  // namespace

extern "C" const char* smelter_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x (M, K) row-major in x_dtype (f32 or bf16), pk (K/2, N) int8 row-major,
// scales (K/g, N) f32 row-major, out (M, N) row-major in out_dtype (f32 or
// bf16); 16-byte aligned pointers (the wrapper checks). `form` 1 is the
// wgmma form (bf16 x, g % 64 == 0, N % 128 == 0; `chunks` K chunks a tile,
// each a work unit of its own unless `whole`; then `part` (chunks, M, N) f32
// scratch and `counters` (N / 128 x ceil(M / 8)) int32 zeros where chunks
// > 1), 0 the mma.sync form (g % 16 == 0, N % 32 == 0). Both need K % (2g)
// == 0. Returns a cudaError_t code.
extern "C" int smelter_int4_matmul(const void* x, const void* pk, const void* scales, void* out,
                                   void* part, void* counters, int M, int N, int K, int g,
                                   int x_dtype, int out_dtype, int form, int chunks, int whole,
                                   void* stream) {
  const auto* w = static_cast<const int8_t*>(pk);
  const auto* s = static_cast<const float*>(scales);
  auto st = static_cast<cudaStream_t>(stream);
  if (g <= 0 || K <= 0 || K % (2 * g)) return static_cast<int>(cudaErrorInvalidValue);
  if (form == 1) {
    const int ngh = K / 2 / g;
    if (g % Q_ROWS || N % Q_COLS || x_dtype != kBF16 || chunks < 1 || chunks > ngh ||
        (chunks > 1 && !whole && (part == nullptr || counters == nullptr)))
      return static_cast<int>(cudaErrorInvalidValue);
    if (M == 0 || N == 0) return 0;
    auto* pp = static_cast<float*>(part);
    auto* cn = static_cast<int*>(counters);
    switch (out_dtype) {
      case kF32:
        return run_wgmma<float>(x, pk, scales, out, pp, cn, M, N, K, g, chunks, whole, st);
      case kBF16:
        return run_wgmma<__nv_bfloat16>(x, pk, scales, out, pp, cn, M, N, K, g, chunks, whole,
                                        st);
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (form != 0 || g % 16 || N % BN) return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0 || N == 0) return 0;
  switch (x_dtype) {
    case kF32:
      return run(static_cast<const float*>(x), w, s, out, out_dtype, M, N, K, g, st);
    case kBF16:
      return run(static_cast<const __nv_bfloat16*>(x), w, s, out, out_dtype, M, N, K, g, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
