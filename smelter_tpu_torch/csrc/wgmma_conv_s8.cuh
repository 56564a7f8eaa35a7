// pixel_conv_rowdot_q's int8 form on the wgmma core (sm_90a): the 3x3 /
// stride 1 / pad 1 convolution of int8 NHCW (B, H, C, W) activations by an
// int8 weight as an implicit GEMM with the pixels on M and the output
// channels on N, summed exactly in int32,
//   out[b, h, co, w] = epi(sum_{dy,dx,ci} W[co,ci,dy,dx] x[b, h+dy-1, ci, w+dx-1]),
// epi the dequantize -> bias -> LeakyReLU -> requantize (or round to a
// 16-bit type) of csrc/pixel_conv.cu (q_dequant and q_requant below, which
// that file's mma.sync kernel calls too). csrc/pixel_conv.cu's entry point
// launches it for int8 x where kernels/wgmma_plan.py::pixel_plan says
// "wgmma".
//
// It is csrc/wgmma_conv.cuh's design on 8-bit operands: tiles of R = 4
// output rows x 64 pixels x C_out (32 or 64), two consumer warpgroups of two
// output rows each, a producer warpgroup, persistent CTAs. What 8 bits
// change:
// - wgmma .s32.s8.s8 reads both shared operands K-major only and takes K in
//   32-byte (32-channel) steps: per step a consumer warpgroup issues 9 taps
//   x 2 rows m64nC_outk32 as one group.
// - The x box of a step is 6 rows x 32 channels x 96 pixels (18,432 bytes,
//   pixels w0 - 16 .. w0 + 79): its first pixel must sit on a 16-byte
//   boundary (the TMA unit faults otherwise), which in int8 is 16 pixels.
//   Zeros outside the map and past C_in come from the TMA fill.
// - Producer warps 1-3 transpose it into [row][16-channel group][pixel row]
//   [16 channels]: 16-byte rows, core matrices of 8 pixels x 16 channels.
//   Row p holds pixel w0 - 4 + p (p 0..71), so tap dx starts its A operand
//   dx + 3 rows (16 (dx + 3) bytes) in and all three taps read one copy. A
//   thread takes 4 consecutive pixels x 16 channels: 16 4-byte loads (4
//   pixels of a channel each; the box offset of its first pixel, 4q + 12, is
//   4-byte aligned), four 4 x 4 byte transposes by `prmt`, four 16-byte
//   stores. Unit u's stores start at pixel (u >> 1) & 3 of its four (the
//   first transpose's selectors rotate), so that a warp's 16-byte stores
//   spread over all 32 banks: 4 wavefronts a store, where 16 without.
// - The weight, packed [3][3][C_out][C_in] int8, is K-major for B as it
//   lies. Resident (RES): loaded once a CTA as [64-channel chunk][tap]
//   [C_out][64 channels] with the 64-byte swizzle, a chunk ahead of the
//   first tile's steps that read it; else each stage brings its 32
//   channels as [tap][C_out][32 channels] with the 32-byte swizzle.
// - The epilogue takes the int32 accumulators through q_dequant (and
//   q_requant for int8 out, Q8) and stages the tile for a TMA store: int8
//   as [C_out][64 pixels] rows (the 64-byte swizzle; byte stores, a lane's
//   channel pair picks its chunk, so no two lanes' words share a bank), a
//   16-bit type as in csrc/wgmma_conv.cuh (stmatrix.trans, the 128-byte
//   swizzle). f32 out keeps the mma.sync kernel.
//
// Sizes (bytes; a stage is the x box, 18,432, its copy, 6 x 2 x 72 x 16 =
// 13,824 padded to 14,336, without RES the weights, 9 x C_out x 32, and 24
// of mbarriers; the staging 2 warpgroups x 2 rows x C_out x 64 (int8 out) or
// x 128 (16-bit out); with RES the weight, C_in / 64 (rounded up) chunks of
// 9 x C_out x 64 and an mbarrier each):
//   C_out 64, int8 out: 4 stages, 222,304; 16-bit out: 3 stages, 187,464
//   C_out 32, int8 out: 5 stages, 219,256; 16-bit out: 5 stages, 227,448
//   resident, C_in 64 -> C_out 32, int8 out: 6 stages, 224,408
//   resident, C_in 160 -> C_out 32, int8 out: 5 stages, 228,496
//   resident, C_in 64 -> C_out 64, int8 out: 5 stages, 218,240
// (the plan takes RES where 4 stages or more fit beside the weight; not
// ESRGAN's 192 -> 64 conv, whose 110,592-byte weight leaves room for 3)
// smelter_tpu_torch/kernels/wgmma_plan.py::pixel_plan mirrors these numbers.
#pragma once

#include "wgmma_conv.cuh"

namespace smelter {
namespace wg {
namespace {

constexpr int PQ_CK = 32;             // input channels a K step (wgmma's k32 of s8)
constexpr int PQ_RAWPX = 96;          // pixels of a step's x box: w0 - 16 .. w0 + 79
constexpr int PQ_XPX = 72;            // pixel rows of the copy: pixels w0 - 4 .. w0 + 67
constexpr int PQ_LEAD = 3;            // copy row of pixel w0 - 1, where tap dx 0 starts
constexpr int PQ_RAW = PC_XROWS * PQ_CK * PQ_RAWPX;   // 18,432
constexpr int PQ_XCOPY = PC_XROWS * 2 * PQ_XPX * 16;  // 13,824
constexpr int PQ_QUADS = PQ_XPX / 4;                  // 4-pixel units a copy row
constexpr int PQ_UNITS = PC_XROWS * 2 * PQ_QUADS;     // 216 units a stage
constexpr int PQ_CHUNK = 64;          // channels a resident weight chunk (64-byte rows)

// pixel_conv_rowdot_q's epilogue of one exact int32 sum: the sum converted
// to f32, multiplied by the channel's scale (s_x s_w[co]) and the bias added
// as two roundings (no contraction), then LeakyReLU (f >= 0 ? f : f alpha;
// has_alpha 0 is linear).
__device__ __forceinline__ float q_dequant(int v, float scale, float bias, float alpha,
                                           int has_alpha) {
  const float f = __fadd_rn(__fmul_rn(__int2float_rn(v), scale), bias);
  return (has_alpha && !(f >= 0.f)) ? __fmul_rn(f, alpha) : f;
}
// f requantized: f inv_sy rounded half to even, clipped to [-127, 127].
__device__ __forceinline__ int8_t q_requant(float f, float inv_sy) {
  const int q = __float2int_rn(__fmul_rn(f, inv_sy));
  return static_cast<int8_t>(max(-127, min(127, q)));
}

// Q8: int8 out (requant); else a 16-bit out (PixelQEpi::out_code).
template <int CO, bool RES, bool Q8>
struct PixelQCfg {
  static_assert(CO == 32 || CO == 64, "C_out 32 or 64");
  static constexpr int X_BYTES = (PQ_XCOPY + 1023) / 1024 * 1024;
  static constexpr int W_BYTES = RES ? 0 : 9 * CO * PQ_CK;
  static constexpr int STAGE = PQ_RAW + X_BYTES + W_BYTES;  // box, copy, weights
  static constexpr int ROW = Q8 ? 64 : 128;                 // bytes a staged channel row
  static constexpr int EPI = CONSUMERS * PC_RW * CO * ROW;
  static constexpr int FIT = (SMEM_BUDGET - 1024 - EPI) / STAGE;
  static constexpr int STAGES = FIT > 8 ? 8 : FIT;  // without RES
  static constexpr int SMEM = 1024 + STAGES * (STAGE + 24) + EPI;
  static constexpr int CHUNK_BYTES = 9 * CO * PQ_CHUNK;
  static_assert(RES || SMEM <= 232448, "more shared memory than a block may have");
};

// The int8 epilogue's operands: scales (s_x s_w) and bias (C_out,) in f32,
// LeakyReLU's alpha when has_alpha, the requant's 1 / s_y (Q8), and the
// 16-bit out's DType code (kBF16 or kF16; without Q8).
struct PixelQEpi {
  const float* scales;
  const float* bias;
  float alpha;
  int has_alpha;
  float inv_sy;
  int out_code;
};

// D (64 x N, s32) += A (64 x 32 s8, shared, K-major) * B (32 x N s8,
// shared, K-major), N = 64 or 32.
template <int N>
__device__ __forceinline__ void mma_s8_kk(int (&d)[N / 2], uint64_t desc_a, uint64_t desc_b) {
  static_assert(N == 64 || N == 32, "n64 or n32");
  if constexpr (N == 64) {
    mma_s8_ss_m64n64k32(d, desc_a, desc_b);
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
          "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
        : "l"(desc_a), "l"(desc_b), "r"(1));
  }
}

// The `prmt` selector of bytes p of lo and hi (low half) and bytes p2 of lo
// and hi (high half): two pixels of two channel words.
__device__ __forceinline__ uint32_t pair_sel(int p, int p2) {
  return p | ((4 + p) << 4) | (p2 << 8) | ((4 + p2) << 12);
}

template <int CO, bool RES, bool Q8>
__global__ void __launch_bounds__(128 * (CONSUMERS + 1), 1)
pixel_conv_wgmma_s8(const __grid_constant__ CUtensorMap map_x,
                    const __grid_constant__ CUtensorMap map_w,
                    const __grid_constant__ CUtensorMap map_o, PixelGeo geo, PixelQEpi ep) {
  using Cfg = PixelQCfg<CO, RES, Q8>;
  const int STAGES = RES ? geo.stages : Cfg::STAGES;
  const int w_res = RES ? geo.chunks * Cfg::CHUNK_BYTES : 0;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sx = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);  // stages
  uint8_t* se = sx + STAGES * Cfg::STAGE;  // the staging tiles
  uint8_t* sw = se + Cfg::EPI;             // RES: the weight
  uint64_t* full = reinterpret_cast<uint64_t*>(sw + w_res);
  uint64_t* empty = full + STAGES;
  uint64_t* landed = empty + STAGES;
  uint64_t* wfull = landed + STAGES;  // RES: chunk c of the weight landed
  const int tiles = geo.B * geo.row_blocks * geo.pixel_tiles, KT = div_up(geo.Cin, PQ_CK);

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], PC_TRANSPOSERS + (RES ? 0 : 1));
      mbar_init(&empty[s], CONSUMERS);
      mbar_init(&landed[s], 1);
    }
    for (int c = 0; c < (RES ? geo.chunks : 0); ++c) mbar_init(&wfull[c], 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 32) {  // the producer's first warp: one thread issues every load
    if (threadIdx.x == 0) {
      int stage = 0, phase = 0, wc = 0;  // wc: the weight's chunks issued
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int pt = tile % geo.pixel_tiles, rest = tile / geo.pixel_tiles;
        const int h0 = (rest % geo.row_blocks) * PC_R, b = rest / geo.row_blocks;
        for (int kt = 0; kt < KT; ++kt) {
          if (RES && wc < geo.chunks && kt == 2 * wc) {  // the chunk this step starts
            mbar_expect_tx(&wfull[wc], Cfg::CHUNK_BYTES);
            tma_load_4d(sw + wc * Cfg::CHUNK_BYTES, &map_w, &wfull[wc], PQ_CHUNK * wc, 0, 0, 0);
            ++wc;
          }
          mbar_wait(&empty[stage], phase ^ 1);
          uint8_t* s = sx + stage * Cfg::STAGE;
          mbar_expect_tx(&landed[stage], PQ_RAW);
          tma_load_4d(s, &map_x, &landed[stage], pt * PC_PX - 16, kt * PQ_CK, h0 - 1, b);
          if constexpr (!RES) {
            mbar_expect_tx(&full[stage], Cfg::W_BYTES);
            tma_load_4d(s + PQ_RAW + Cfg::X_BYTES, &map_w, &full[stage], kt * PQ_CK, 0, 0, 0);
          }
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }
  if (threadIdx.x < 128) {  // producer warps 1-3: the K-major copy of each stage's x box
    const int tt = threadIdx.x - 32;
    int stage = 0, phase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      for (int kt = 0; kt < KT; ++kt) {
        mbar_wait(&landed[stage], phase);
        const uint8_t* raw = sx + stage * Cfg::STAGE;  // [row][channel][96 pixels]
        uint8_t* cp = sx + stage * Cfg::STAGE + PQ_RAW;
        for (int u = tt; u < PQ_UNITS; u += PC_TRANSPOSERS) {
          // unit: copy rows 4q .. 4q + 3 (box pixels 4q + 12 ..) of channel
          // group g of input row r; consecutive threads, consecutive q
          const int q = u % PQ_QUADS, gr = u / PQ_QUADS, g = gr & 1, r = gr >> 1;
          const uint8_t* src = raw + (r * PQ_CK + g * 16) * PQ_RAWPX + 4 * q + 12;
          uint32_t v[16];
#pragma unroll
          for (int c = 0; c < 16; ++c)
            v[c] = *reinterpret_cast<const uint32_t*>(src + c * PQ_RAWPX);
          // slot i of the thread's four stores is pixel (i + rot) & 3
          const int rot = (u >> 1) & 3;
          const uint32_t s01 = pair_sel(rot, (rot + 1) & 3);
          const uint32_t s23 = pair_sel((rot + 2) & 3, (rot + 3) & 3);
          uint32_t o[4][4];  // o[slot][word]: word j holds channels 4j .. 4j + 3
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const uint32_t t0 = __byte_perm(v[4 * j], v[4 * j + 1], s01);
            const uint32_t t1 = __byte_perm(v[4 * j], v[4 * j + 1], s23);
            const uint32_t t2 = __byte_perm(v[4 * j + 2], v[4 * j + 3], s01);
            const uint32_t t3 = __byte_perm(v[4 * j + 2], v[4 * j + 3], s23);
            o[0][j] = __byte_perm(t0, t2, 0x5410);
            o[1][j] = __byte_perm(t0, t2, 0x7632);
            o[2][j] = __byte_perm(t1, t3, 0x5410);
            o[3][j] = __byte_perm(t1, t3, 0x7632);
          }
          uint8_t* dst = cp + ((r * 2 + g) * PQ_XPX + 4 * q) * 16;
#pragma unroll
          for (int i = 0; i < 4; ++i)
            *reinterpret_cast<uint4*>(dst + ((i + rot) & 3) * 16) =
                make_uint4(o[i][0], o[i][1], o[i][2], o[i][3]);
        }
        fence_proxy_async();  // the copy, before wgmma reads it
        mbar_arrive(&full[stage]);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  const int ct = threadIdx.x - 128, wgi = ct >> 7, warp = (ct >> 5) & 3, lane = ct & 31;
  const int g = lane >> 2, t = lane & 3;
  const bool leader = (ct & 127) == 0;
  // this thread's scales and bias: columns 8j + 2t + e of the accumulators
  float scale[CO / 4], bias[CO / 4];
#pragma unroll
  for (int j = 0; j < CO / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int co = 8 * j + 2 * t + e;
      scale[2 * j + e] = ep.scales[co];
      bias[2 * j + e] = ep.bias[co];
    }
  int acc[PC_RW][CO / 2];
  int stage = 0, phase = 0, wready = 0;  // wready: the weight's chunks seen landed
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int pt = tile % geo.pixel_tiles, rest = tile / geo.pixel_tiles;
    const int h0 = (rest % geo.row_blocks) * PC_R, b = rest / geo.row_blocks;
#pragma unroll
    for (int r = 0; r < PC_RW; ++r)
#pragma unroll
      for (int i = 0; i < CO / 2; ++i) acc[r][i] = 0;
    int prev = -1;
    for (int kt = 0; kt < KT; ++kt) {
      if (RES && (kt >> 1) >= wready) mbar_wait(&wfull[wready++], 0);  // first tile only
      mbar_wait(&full[stage], phase);
      const uint8_t* s = sx + stage * Cfg::STAGE;
      wgmma_fence();
#pragma unroll
      for (int r = 0; r < PC_RW; ++r)
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          const int dy = tap / 3, dx = tap % 3, ir = wgi * PC_RW + r + dy;
          // A: copy rows dx + 3 .. dx + 66 of input row ir (K-major, no
          // swizzle: LBO the channel groups' stride, SBO 8 pixel rows). B:
          // the tap's C_out rows, K-major; RES, rows of 64 channels (the
          // 64-byte swizzle) from the step's 32 bytes, else the stage's rows
          // of 32 (the 32-byte swizzle)
          const uint64_t db =
              RES ? desc(sw + ((kt >> 1) * 9 + tap) * CO * PQ_CHUNK + (kt & 1) * 32, 16, 512, 2)
                  : desc(s + PQ_RAW + Cfg::X_BYTES + tap * CO * PQ_CK, 16, 256, 3);
          mma_s8_kk<CO>(acc[r],
                        desc(s + PQ_RAW + (ir * 2 * PQ_XPX + dx + PQ_LEAD) * 16, PQ_XPX * 16, 128,
                             0),
                        db);
        }
      wgmma_commit();
      wgmma_wait<1>();  // the step before retired: its stage is free
      if (prev >= 0 && leader) mbar_arrive(&empty[prev]);
      prev = stage;
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int r = 0; r < PC_RW; ++r) fence_regs(acc[r]);
    if (prev >= 0 && leader) mbar_arrive(&empty[prev]);

    // the epilogue: the last tile's stores have read the staging tiles
    if (leader) bulk_wait_read();
    named_sync(1 + wgi, 128);
#pragma unroll
    for (int r = 0; r < PC_RW; ++r) {
      uint8_t* stg = se + (wgi * PC_RW + r) * CO * Cfg::ROW;
      // acc[r][4j + 2h + e] = out (pixel 16 warp + g + 8h, channel 8j + 2t + e)
      if constexpr (Q8) {
        // [C_out][64 pixels] int8, the 64-byte swizzle: chunk c of row co
        // at (c ^ ((co >> 1) & 3)) * 16
#pragma unroll
        for (int j = 0; j < CO / 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int co = 8 * j + 2 * t + e, px = 16 * warp + g + 8 * h;
              const float f = q_dequant(acc[r][4 * j + 2 * h + e], scale[2 * j + e],
                                        bias[2 * j + e], ep.alpha, ep.has_alpha);
              stg[co * 64 + (((px >> 4) ^ ((co >> 1) & 3)) << 4) + (px & 15)] =
                  static_cast<uint8_t>(q_requant(f, ep.inv_sy));
            }
      } else {
        // as csrc/wgmma_conv.cuh stages 16-bit out: matrix m of a store is
        // pixels 8 (2 warp + (m & 1)).., channels 8 (2 jp + (m >> 1))..
        const int mi = lane >> 3, qq = lane & 7;
#pragma unroll
        for (int jp = 0; jp < CO / 16; ++jp) {
          uint32_t v[4];
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            const int j = 2 * jp + (m >> 1), i = 4 * j + 2 * (m & 1);
            const float f0 = q_dequant(acc[r][i], scale[2 * j], bias[2 * j], ep.alpha,
                                       ep.has_alpha);
            const float f1 = q_dequant(acc[r][i + 1], scale[2 * j + 1], bias[2 * j + 1],
                                       ep.alpha, ep.has_alpha);
            v[m] = pack2(ep.out_code, f0, f1);
          }
          const int co = 8 * (2 * jp + (mi >> 1)) + qq, c = 2 * warp + (mi & 1);
          stmatrix_x4_trans(stg + co * 128 + ((c ^ (co & 7)) << 4), v[0], v[1], v[2], v[3]);
        }
      }
    }
    fence_proxy_async();  // the staging tiles before the TMA unit reads them
    named_sync(1 + wgi, 128);
    if (leader) {
#pragma unroll
      for (int r = 0; r < PC_RW; ++r)
        tma_store_4d(&map_o, se + (wgi * PC_RW + r) * CO * Cfg::ROW, pt * PC_PX, 0,
                     h0 + wgi * PC_RW + r, b);
      bulk_commit();
    }
  }
  if (leader) bulk_wait();
}

// The dynamic shared memory pixel_conv_wgmma_s8<CO, RES, Q8> takes with
// `stages` stages (RES: and the resident weight's 64-channel chunks).
template <int CO, bool RES, bool Q8>
constexpr int pixel_q_smem(int stages, int Cin) {
  using Cfg = PixelQCfg<CO, RES, Q8>;
  return RES ? 1024 + stages * (Cfg::STAGE + 24) + Cfg::EPI +
                   (Cin + PQ_CHUNK - 1) / PQ_CHUNK * (Cfg::CHUNK_BYTES + 8)
             : Cfg::SMEM;
}

// pixel_conv_wgmma_s8 on `grid` CTAs: x (B, H, Cin, W) int8 at element
// strides (xsb, xsh, xsc), W contiguous; w the packed [3][3][CO][Cin] int8
// weight; out (B, H, CO, W) at (osb, osh, osc), int8 (Q8) or in the 16-bit
// type ep.out_code names; RES: the weight resident, with `stages` stages
// (the plan's). The plan's checks: 16-byte aligned bases, x's strides and W
// multiples of 16, Cin % 16 == 0, and no box past its tensor: Cin >= 32
// (RES: 64), H >= 6, W >= 96.
template <int CO, bool RES, bool Q8>
static int launch_pixel_wgmma_s8(const void* x, const void* w, void* out, const PixelQEpi& ep,
                                 int B, int H, int Cin, int W, long long xsb, long long xsh,
                                 long long xsc, long long osb, long long osh, long long osc,
                                 int grid, int stages, cudaStream_t stream) {
  const int smem = pixel_q_smem<CO, RES, Q8>(stages, Cin);
  if (smem > 232448 || (RES && stages < 2)) return static_cast<int>(cudaErrorInvalidValue);
  if (!Q8 && ep.out_code != kBF16 && ep.out_code != kF16)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto u8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  CUtensorMap map_x, map_w, map_o;
  int rc = make_map_4d(&map_x, x, u8, W, Cin, H, B, xsc, xsh, xsb, PQ_RAWPX, PQ_CK,
                       CU_TENSOR_MAP_SWIZZLE_NONE, PC_XROWS);
  // the weight as (Cin, CO, 9 taps), in boxes of (64, CO, 9) with the
  // 64-byte swizzle (RES) or (32, CO, 9) with the 32-byte one
  const long long row = Cin;
  if (rc == 0)
    rc = make_map_4d(&map_w, w, u8, Cin, CO, 9, 1, row, row * CO, row * CO * 9,
                     RES ? PQ_CHUNK : PQ_CK, CO,
                     RES ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B, 9);
  if (rc == 0) {
    if constexpr (Q8)
      rc = make_map_4d(&map_o, out, u8, W, CO, H, B, osc, osh, osb, PC_PX, CO,
                       CU_TENSOR_MAP_SWIZZLE_64B);
    else
      rc = make_map_4d(&map_o, out,
                       ep.out_code == kBF16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                            : CU_TENSOR_MAP_DATA_TYPE_FLOAT16,
                       W, CO, H, B, osc * 2, osh * 2, osb * 2, PC_PX, CO,
                       CU_TENSOR_MAP_SWIZZLE_128B);
  }
  if (rc != 0) return rc;
  static const cudaError_t smem_set = cudaFuncSetAttribute(
      pixel_conv_wgmma_s8<CO, RES, Q8>, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
  (void)smem_set;
  const PixelGeo geo{B, H, Cin, W, cdiv(H, PC_R), cdiv(W, PC_PX), stages, cdiv(Cin, PQ_CHUNK)};
  pixel_conv_wgmma_s8<CO, RES, Q8><<<grid, 128 * (CONSUMERS + 1), smem, stream>>>(
      map_x, map_w, map_o, geo, ep);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace wg
}  // namespace smelter
