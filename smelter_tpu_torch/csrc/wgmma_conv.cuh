// pixel_conv_rowdot's (and pixel_conv_blockdot's) 16-bit form on the wgmma
// core (sm_90a): a 3x3 / stride 1 / pad 1 convolution of NHCW (B, H, C, W)
// activations as an implicit GEMM with the pixels on M and the output
// channels on N,
//   out[b, h, co, w] = leaky(bias[co] + sum_{dy,dx,ci} W[co,ci,dy,dx] x[b, h+dy-1, ci, w+dx-1]),
// summed in f32 and rounded once to x's type (csrc/pixel_conv.cu's entry
// point launches it where kernels/wgmma_plan.py::pixel_plan says "wgmma").
//
// A tile is R = 4 output rows (blockdot: 8, below) x 64 pixels x C_out (32
// or 64, wgmma's N): each of the two consumer warpgroups owns RW = 2 (4)
// output rows, an m64 x C_out f32 accumulator each. K runs over C_in in
// steps of 16 channels. The dx
// taps are what shapes the design: NHCW rows hold the pixels contiguous, a
// TMA box of them is an MN-major operand, and neither an MN-major
// descriptor nor a swizzled TMA box can start one pixel off (the TMA unit
// faults on a box whose first pixel is not 16-byte aligned). So per step
// the TMA unit brings the R + 2 = 6 input rows' pixels w0 - 8 .. w0 + 71 of
// 16 channels (a 4-D box over (W, C_in, H, B) at x's strides, no swizzle,
// zeros outside the map and past C_in), and three producer warps transpose
// them into K-major [row][channel group of 8][pixel][8 channels] (16-byte
// rows, core matrices of 8 pixels x 8 channels: 128 contiguous bytes), a
// thread a pixel row of 8 channels (2-byte loads of consecutive pixels,
// one 16-byte store: no bank conflict either way). Row p holds pixel
// w0 - 1 + p, so tap dx starts its A operand dx rows (16 * dx bytes) in, and
// all three taps read one copy. The weights come by TMA from the packed
// [3][3][C_out][C_in] weight (zeros past C_in), K-major. Where the whole
// weight fits beside the ring (the "resident" variant, RES: ESRGAN's C_out
// 32 convs and its 64 x 64 ones) it stays in shared memory, loaded once a
// CTA as [64-channel chunk][tap][C_out][64 channels] with the 128-byte
// swizzle (boxes of 128-byte rows), a chunk ahead of the first tile's steps
// that need it; otherwise each stage brings its 16 channels as [tap][C_out]
// [16 channels] with the 32-byte swizzle (a box of 32-byte rows, which the
// TMA unit moves more slowly). Per step a consumer
// warpgroup issues 9 taps x 2 rows wgmma m64nC_outk16 (A and B from shared
// memory) as one group; a stage is released once the next step's group is
// issued and it has retired.
//
// The kernel is persistent and warp-specialised: one CTA an SM walks tiles
// (pixel tile fastest, then row block, then image). In the producer
// warpgroup one thread issues both TMA loads of every stage as soon as it
// is free, into a ring of as many stages as fit 225 KB (at most 8), so the
// loads run stages ahead, across tile boundaries and under the epilogues;
// warps 1-3 transpose each stage once its x box has landed ("landed"
// mbarrier), fence their stores for the async proxy and arrive on its
// "full" mbarrier, which also counts the weights' bytes. The epilogue adds
// the bias in f32, applies LeakyReLU (f >= 0 ? f : f * alpha, alpha 0 is
// ReLU; none: linear), rounds once, stores each 8 x 8 block transposed
// (stmatrix.trans) into a [C_out][64 pixels] staging tile (the 128-byte
// swizzle), and a TMA store of a (64 pixels, C_out) box writes it to out's
// NHCW rows, clipped at H and W.
//
// Sizes (bytes; a stage is the x box, 6 x 16 x 80 x 2 = 15,360, its copy,
// 6 x 2 x 72 x 16 = 13,824 padded to 14,336, without RES the weights, 9 x 2
// x C_out x 16, and 24 of mbarriers; the staging 2 warpgroups x 2 rows x
// C_out x 128; with RES the weight, C_in / 64 (rounded up) chunks of 9 x
// C_out x 128 and an mbarrier each):
//   C_out 64: 4 stages, 226,400
//   C_out 32: 5 stages, 212,088
//   resident, C_in 64 -> C_out 32: 5 stages, 202,880
//   resident, C_in 160 -> C_out 32: 3 stages, 217,184
//   resident, C_in 64 -> C_out 64: 4 stages, 226,408
// (the plan takes RES where 4 stages or more fit beside the weight: with 3,
// the 160 -> 32 conv ran slower than with its weights a stage at a time)
//
// pixel_conv_blockdot's taller tile (RW = PC_TALL_RW: 4 output rows a
// consumer warpgroup, R = 8, the Pallas variant's row block) stages R + 2 =
// 10 input rows a step, 1.25 an output row against the 4-row tile's 1.5,
// and each step's box, copy and weights feed 9 taps x 4 rows of products a
// warpgroup instead of 9 x 2. Its accumulators (4 x C_out / 2 a thread, 128
// at C_out 64) leave no room for the bias in registers, which the epilogue
// reads instead, and its rows leave PC_EPI_RW = 2 a warpgroup at a time
// through the same staging tiles. Its x boxes, 10 x 16 x 80 x 2 = 25,600
// bytes, land in a ring of PC_RAW_SLOTS = 2 of their own (51,200 and two
// mbarriers each), each freed once copied, so that a stage is the copy, 10 x
// 2 x 72 x 16 = 23,040 padded to 23,552, and without RES the weights (with
// the box in each stage, 2 stages fit at C_out 64 and the tall tile ran
// 1.5x the 4-row one there):
//   tall, C_out 64: 3 stages, 211,048
//   tall, C_out 32: 4 stages, 199,808
//   tall, resident, C_in 64 -> C_out 32: 5 stages, 223,392
//   tall, resident, C_in 64 -> C_out 64: 3 stages, 229,488
// (the plan keeps the weight resident where that leaves as many stages as
// streaming it would, and takes the tall tile where 2 stages or more fit
// and the shape is one where it ran faster on the card: C_out 32 with C_in
// >= 96)
// smelter_tpu_torch/kernels/wgmma_plan.py::pixel_plan mirrors these numbers.
#pragma once

#include "wgmma_gemm.cuh"

namespace smelter {
namespace wg {
namespace {

constexpr int PC_PX = 64;             // output pixels a tile (wgmma's M)
constexpr int PC_CK = 16;             // input channels a K step (wgmma's k16)
constexpr int PC_RW = 2;              // output rows a consumer warpgroup (rowdot's tile)
constexpr int PC_TALL_RW = 4;         // the same, blockdot's taller tile
constexpr int PC_R = CONSUMERS * PC_RW;  // output rows a tile
constexpr int PC_XROWS = PC_R + 2;       // input rows a stage
constexpr int PC_XPX = 72;            // pixel rows of a step's copy: pixels w0 - 1 .. w0 + 70
constexpr int PC_RAWPX = 80;          // pixels of a step's x box: w0 - 8 .. w0 + 71
constexpr int PC_RAW = PC_XROWS * PC_CK * PC_RAWPX * 2;  // 15,360
constexpr int PC_XCOPY = PC_XROWS * 2 * PC_XPX * 16;      // 13,824
constexpr int PC_TRANSPOSERS = 96;    // producer warps 1-3
constexpr int PC_EPI_RW = 2;          // rows a warpgroup stages for one TMA store
constexpr int PC_RAW_SLOTS = 2;       // the taller tile's ring of x boxes

// A tile of RW output rows a consumer warpgroup: R = 2 RW output rows from
// R + 2 staged input rows (rowdot's RW 2: 6 for 4; blockdot's RW 4: 10 for
// 8, 1.25 staged rows an output row instead of 1.5).
template <int RW>
struct PixelRows {
  static_assert(RW == PC_RW || RW == PC_TALL_RW, "2 or 4 rows a warpgroup");
  static constexpr int R = CONSUMERS * RW;
  static constexpr int XROWS = R + 2;
  static constexpr int RAW = XROWS * PC_CK * PC_RAWPX * 2;         // 15,360 / 25,600
  static constexpr int XCOPY = XROWS * 2 * PC_XPX * 16;             // 13,824 / 23,040
  static constexpr int UNITS = XROWS * 2 * PC_XPX / PC_TRANSPOSERS;  // 9 / 15 a transposer
  static_assert(XROWS * 2 * PC_XPX % PC_TRANSPOSERS == 0, "whole units a transposer");
};

// RES: the whole weight stays in shared memory ([64-channel chunk][tap]
// [C_out][64 channels], the 128-byte swizzle, loaded once a CTA, a chunk
// at a time ahead of the first tile's steps that need it) and a stage holds
// x alone; otherwise each stage brings its 16 channels' weights too.
// RW: output rows a consumer warpgroup (PixelRows); the staging holds
// PC_EPI_RW of them a warpgroup, so a taller tile stores in turns. SPLIT
// (the taller tile): the x boxes land in a ring of PC_RAW_SLOTS of their
// own, each freed once the producer warps have copied it ("rawfree"
// mbarriers), so a stage holds the copy and the weights alone and more
// stages fit.
template <int CO, bool RES, int RW = PC_RW>
struct PixelCfg {
  static_assert(CO == 32 || CO == 64, "C_out 32 or 64");
  using Rows = PixelRows<RW>;
  static constexpr bool SPLIT = RW != PC_RW;
  static constexpr int RING = SPLIT ? PC_RAW_SLOTS * Rows::RAW : 0;  // the boxes' ring
  static constexpr int RING_BARS = SPLIT ? PC_RAW_SLOTS * 16 : 0;    // landed, rawfree
  static constexpr int COPY_AT = SPLIT ? 0 : Rows::RAW;  // the copy's offset in a stage
  static constexpr int X_BYTES = (Rows::XCOPY + 1023) / 1024 * 1024;
  static constexpr int W_BYTES = RES ? 0 : 9 * CO * PC_CK * 2;
  static constexpr int STAGE = COPY_AT + X_BYTES + W_BYTES;  // [box,] copy, weights
  static constexpr int EPI = CONSUMERS * PC_EPI_RW * CO * 128;
  static constexpr int FIT = (SMEM_BUDGET - 1024 - EPI - RING) / STAGE;
  static constexpr int STAGES = FIT > 8 ? 8 : FIT;  // without RES
  static constexpr int SMEM = 1024 + RING + STAGES * (STAGE + 24) + EPI + RING_BARS;
  static_assert(RES || SMEM <= 232448, "more shared memory than a block may have");
};

// D (64 x N, f32) += A (64 x 16, shared, K-major) * B (16 x N, shared,
// K-major), N = 64 or 32.
template <typename T, int N>
__device__ __forceinline__ void mma_kk(float (&d)[N / 2], uint64_t desc_a, uint64_t desc_b) {
  static_assert(N == 64 || N == 32, "n64 or n32");
  if constexpr (N == 64) {
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      asm volatile(
          "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
          "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
          "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
          "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
          : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
            "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
            "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
            "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
            "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
            "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
            "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
            "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
          : "l"(desc_a), "l"(desc_b), "r"(1));
    } else {
      asm volatile(
          "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 {"
          "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
          "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
          "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
          : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
            "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
            "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
            "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
            "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
            "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
            "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
            "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
          : "l"(desc_a), "l"(desc_b), "r"(1));
    }
  } else {
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      asm volatile(
          "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
          "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
          "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
          : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
            "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
            "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
            "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
          : "l"(desc_a), "l"(desc_b), "r"(1));
    } else {
      asm volatile(
          "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n32k16.f32.f16.f16 {"
          "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
          "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
          : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
            "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
            "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
            "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
          : "l"(desc_a), "l"(desc_b), "r"(1));
    }
  }
}

// One TMA store of the box at (c0 innermost, c1, c2, c3) of a 4-D map from
// shared memory, in this thread's bulk group; coordinates past the map's
// dims are not written.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Waits until this thread's bulk groups have read their shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// Waits until this thread's bulk groups are complete.
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// The epilogue's operands: bias (C_out,) in f32 (bias_f32) or T; LeakyReLU's
// alpha when has_alpha.
struct PixelEpi {
  const void* bias;
  int bias_f32;
  float alpha;
  int has_alpha;
};

// The conv's geometry: B images of H rows, C_in channels, W pixels; tiles of
// R rows x PC_PX pixels (pixel tiles fastest).
struct PixelGeo {
  int B, H, Cin, W, row_blocks, pixel_tiles;
  int stages;  // the ring's stages (RES: the plan's, from what the weight leaves)
  int chunks;  // RES: 64-channel chunks the resident weight holds (C_in / 64, rounded up)
};

template <typename T, int CO, bool RES, int RW = PC_RW>
__global__ void __launch_bounds__(128 * (CONSUMERS + 1), 1)
pixel_conv_wgmma(const __grid_constant__ CUtensorMap map_x,
                 const __grid_constant__ CUtensorMap map_w,
                 const __grid_constant__ CUtensorMap map_o, PixelGeo geo, PixelEpi ep) {
  using Cfg = PixelCfg<CO, RES, RW>;
  using Rows = PixelRows<RW>;
  const int STAGES = RES ? geo.stages : Cfg::STAGES;
  const int w_res = RES ? geo.chunks * 9 * CO * 128 : 0;
  constexpr int RAWS = Cfg::SPLIT ? PC_RAW_SLOTS : 0;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);  // SPLIT: boxes
  uint8_t* sx = ring + Cfg::RING;          // stages
  uint8_t* se = sx + STAGES * Cfg::STAGE;  // the staging tiles
  uint8_t* sw = se + Cfg::EPI;             // RES: the weight
  uint64_t* full = reinterpret_cast<uint64_t*>(sw + w_res);
  uint64_t* empty = full + STAGES;
  uint64_t* landed = empty + STAGES;                     // a stage's box (SPLIT: a slot's)
  uint64_t* rawfree = landed + (RAWS ? RAWS : STAGES);   // SPLIT: slot r copied
  uint64_t* wfull = rawfree + RAWS;  // RES: chunk c of the weight landed
  const int tiles = geo.B * geo.row_blocks * geo.pixel_tiles, KT = div_up(geo.Cin, PC_CK);

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], PC_TRANSPOSERS + (RES ? 0 : 1));
      mbar_init(&empty[s], CONSUMERS);
      if (!RAWS) mbar_init(&landed[s], 1);
    }
    for (int r = 0; r < RAWS; ++r) {
      mbar_init(&landed[r], 1);
      mbar_init(&rawfree[r], PC_TRANSPOSERS);
    }
    for (int c = 0; c < (RES ? geo.chunks : 0); ++c) mbar_init(&wfull[c], 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 32) {  // the producer's first warp: one thread issues every load
    if (threadIdx.x == 0) {
      int stage = 0, phase = 0, wc = 0;  // wc: the weight's chunks issued
      int slot = 0, sphase = 0;          // SPLIT: the boxes' ring
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int pt = tile % geo.pixel_tiles, rest = tile / geo.pixel_tiles;
        const int h0 = (rest % geo.row_blocks) * Rows::R, b = rest / geo.row_blocks;
        for (int kt = 0; kt < KT; ++kt) {
          if (RES && wc < geo.chunks && kt == 4 * wc) {  // the chunk this step starts
            mbar_expect_tx(&wfull[wc], 9 * CO * 128);
            tma_load_4d(sw + wc * 9 * CO * 128, &map_w, &wfull[wc], 64 * wc, 0, 0, 0);
            ++wc;
          }
          mbar_wait(&empty[stage], phase ^ 1);  // the stage's copy is free
          uint8_t* s = sx + stage * Cfg::STAGE;
          uint8_t* box = s;
          uint64_t* land = &landed[stage];
          if constexpr (Cfg::SPLIT) {
            mbar_wait(&rawfree[slot], sphase ^ 1);  // the slot's last box is copied
            box = ring + slot * Rows::RAW;
            land = &landed[slot];
            if (++slot == RAWS) {
              slot = 0;
              sphase ^= 1;
            }
          }
          mbar_expect_tx(land, Rows::RAW);
          tma_load_4d(box, &map_x, land, pt * PC_PX - 8, kt * PC_CK, h0 - 1, b);
          if constexpr (!RES) {
            mbar_expect_tx(&full[stage], Cfg::W_BYTES);
            tma_load_4d(s + Cfg::COPY_AT + Cfg::X_BYTES, &map_w, &full[stage], kt * PC_CK, 0,
                        0, 0);
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
    int stage = 0, phase = 0, slot = 0, sphase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      for (int kt = 0; kt < KT; ++kt) {
        // [row][channel][80 pixels]: the stage's box, or (SPLIT) the slot's
        const uint8_t* raw = Cfg::SPLIT ? ring + slot * Rows::RAW : sx + stage * Cfg::STAGE;
        mbar_wait(Cfg::SPLIT ? &landed[slot] : &landed[stage], Cfg::SPLIT ? sphase : phase);
        uint8_t* cp = sx + stage * Cfg::STAGE + Cfg::COPY_AT;
#pragma unroll
        for (int k = 0; k < Rows::UNITS; ++k) {
          // unit: pixel row p (pixel w0 - 1 + p, box pixel p + 7) of channel
          // group g of input row r; consecutive threads, consecutive p
          const int u = tt + k * PC_TRANSPOSERS, p = u % PC_XPX, g = (u / PC_XPX) & 1,
                    r = u / (2 * PC_XPX);
          const uint16_t* src = reinterpret_cast<const uint16_t*>(raw) +
                                (r * PC_CK + g * 8) * PC_RAWPX + p + 7;
          uint32_t v[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] = src[e * PC_RAWPX];
          *reinterpret_cast<uint4*>(cp + ((r * 2 + g) * PC_XPX + p) * 16) =
              make_uint4(__byte_perm(v[0], v[1], 0x5410), __byte_perm(v[2], v[3], 0x5410),
                         __byte_perm(v[4], v[5], 0x5410), __byte_perm(v[6], v[7], 0x5410));
        }
        if constexpr (Cfg::SPLIT) {
          mbar_arrive(&rawfree[slot]);  // this thread's reads of the box are done
          if (++slot == RAWS) {
            slot = 0;
            sphase ^= 1;
          }
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
  const int t = lane & 3;
  const bool leader = (ct & 127) == 0;
  // this thread's bias: columns 8j + 2t + e of the accumulators, held in
  // registers for the 2-row tile (the taller tile's accumulators take them:
  // it reads the bias in the epilogue)
  float bias[RW == PC_RW ? CO / 4 : 1];
  if constexpr (RW == PC_RW) {
#pragma unroll
    for (int j = 0; j < CO / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        bias[2 * j + e] = bias_at<T>(ep.bias, ep.bias_f32, 8 * j + 2 * t + e);
  }
  auto bias_of = [&](int j, int e) -> float {
    if constexpr (RW == PC_RW)
      return bias[2 * j + e];
    else
      return bias_at<T>(ep.bias, ep.bias_f32, 8 * j + 2 * t + e);
  };
  constexpr int code = std::is_same<T, __nv_bfloat16>::value ? kBF16 : kF16;
  float acc[RW][CO / 2];
  int stage = 0, phase = 0, wready = 0;  // wready: the weight's chunks seen landed
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int pt = tile % geo.pixel_tiles, rest = tile / geo.pixel_tiles;
    const int h0 = (rest % geo.row_blocks) * Rows::R, b = rest / geo.row_blocks;
#pragma unroll
    for (int r = 0; r < RW; ++r)
#pragma unroll
      for (int i = 0; i < CO / 2; ++i) acc[r][i] = 0.f;
    int prev = -1;
    for (int kt = 0; kt < KT; ++kt) {
      if (RES && (kt >> 2) >= wready) mbar_wait(&wfull[wready++], 0);  // first tile only
      mbar_wait(&full[stage], phase);
      const uint8_t* s = sx + stage * Cfg::STAGE;
      wgmma_fence();
#pragma unroll
      for (int r = 0; r < RW; ++r)
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          const int dy = tap / 3, dx = tap % 3, ir = wgi * RW + r + dy;
          // A: pixel rows dx .. dx + 63 of input row ir's copy (K-major, no
          // swizzle: LBO the channel groups' stride, SBO 8 pixel rows). B:
          // the tap's C_out rows, K-major; RES, rows of 64 channels (the
          // 128-byte swizzle) from the step's 32 bytes, else the stage's rows
          // of 16 (the 32-byte swizzle)
          const uint64_t db =
              RES ? desc(sw + ((kt >> 2) * 9 + tap) * CO * 128 + (kt & 3) * 32, 16, 1024)
                  : desc(s + Cfg::COPY_AT + Cfg::X_BYTES + tap * CO * 32, 16, 256, 3);
          mma_kk<T, CO>(acc[r],
                        desc(s + Cfg::COPY_AT + (ir * 2 * PC_XPX + dx) * 16, PC_XPX * 16, 128, 0),
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
    for (int r = 0; r < RW; ++r) fence_regs(acc[r]);
    if (prev >= 0 && leader) mbar_arrive(&empty[prev]);

    // the epilogue, PC_EPI_RW rows a warpgroup a turn
    const int mi = lane >> 3, q = lane & 7;
#pragma unroll
    for (int r0 = 0; r0 < RW; r0 += PC_EPI_RW) {
      if (leader) bulk_wait_read();  // the last turn's stores have read the staging tiles
      named_sync(1 + wgi, 128);
#pragma unroll
      for (int rr = 0; rr < PC_EPI_RW; ++rr) {
        const int r = r0 + rr;
        uint8_t* stg = se + (wgi * PC_EPI_RW + rr) * CO * 128;
        // acc[r][4j + 2h + e] = out (pixel 16 warp + g + 8h, channel 8j + 2t + e);
        // matrix m of a store: pixels 8 (2 warp + (m & 1)).., channels 8 (2 jp + (m >> 1))..
#pragma unroll
        for (int jp = 0; jp < CO / 16; ++jp) {
          uint32_t v[4];
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            const int j = 2 * jp + (m >> 1), i = 4 * j + 2 * (m & 1);
            float f0 = __fadd_rn(acc[r][i], bias_of(j, 0));
            float f1 = __fadd_rn(acc[r][i + 1], bias_of(j, 1));
            if (ep.has_alpha) {
              if (!(f0 >= 0.f)) f0 = __fmul_rn(f0, ep.alpha);
              if (!(f1 >= 0.f)) f1 = __fmul_rn(f1, ep.alpha);
            }
            v[m] = pack2(code, f0, f1);
          }
          const int co = 8 * (2 * jp + (mi >> 1)) + q, c = 2 * warp + (mi & 1);
          stmatrix_x4_trans(stg + co * 128 + ((c ^ (co & 7)) << 4), v[0], v[1], v[2], v[3]);
        }
      }
      fence_proxy_async();  // the staging tiles before the TMA unit reads them
      named_sync(1 + wgi, 128);
      if (leader) {
#pragma unroll
        for (int rr = 0; rr < PC_EPI_RW; ++rr)
          tma_store_4d(&map_o, se + (wgi * PC_EPI_RW + rr) * CO * 128, pt * PC_PX, 0,
                       h0 + wgi * RW + r0 + rr, b);
        bulk_commit();
      }
    }
  }
  if (leader) bulk_wait();
}

// The dynamic shared memory pixel_conv_wgmma<T, CO, RES, RW> takes with
// `stages` stages (RES: and the resident weight's 64-channel chunks).
template <int CO, bool RES, int RW = PC_RW>
constexpr int pixel_smem(int stages, int Cin) {
  using Cfg = PixelCfg<CO, RES, RW>;
  return RES ? 1024 + Cfg::RING + stages * (Cfg::STAGE + 24) + Cfg::EPI + Cfg::RING_BARS +
                   (Cin + 63) / 64 * (9 * CO * 128 + 8)
             : Cfg::SMEM;
}

// pixel_conv_wgmma on `grid` CTAs: x (B, H, Cin, W) in T at element strides
// (xsb, xsh, xsc), W contiguous; w the packed [3][3][CO][Cin] weight in T;
// out (B, H, CO, W) in T at (osb, osh, osc); RES: the weight resident, with
// `stages` stages (the plan's); RW output rows a consumer warpgroup (PC_RW,
// or blockdot's PC_TALL_RW). The plan's checks: 16-byte aligned bases, x's
// strides and W multiples of 8 elements, Cin % 8 == 0, and no box past its
// tensor: Cin >= 16, H >= 2 RW + 2, W >= 80.
template <typename T, int CO, bool RES, int RW = PC_RW>
static int launch_pixel_wgmma(const void* x, const void* w, void* out, const PixelEpi& ep, int B,
                              int H, int Cin, int W, long long xsb, long long xsh, long long xsc,
                              long long osb, long long osh, long long osc, int grid, int stages,
                              cudaStream_t stream) {
  using Rows = PixelRows<RW>;
  const int smem = pixel_smem<CO, RES, RW>(stages, Cin);
  if (smem > 232448 || (RES && stages < 2)) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map_x, map_w, map_o;
  int rc = make_map_4d(&map_x, x, map_type<T>(), W, Cin, H, B, xsc * 2, xsh * 2, xsb * 2, PC_RAWPX,
                       PC_CK, CU_TENSOR_MAP_SWIZZLE_NONE, Rows::XROWS);
  // the weight as (Cin, CO, 9 taps), in boxes of (64, CO, 9) with the
  // 128-byte swizzle (RES) or (16, CO, 9) with the 32-byte one
  const long long row = static_cast<long long>(Cin) * 2;
  if (rc == 0)
    rc = make_map_4d(&map_w, w, map_type<T>(), Cin, CO, 9, 1, row, row * CO, row * CO * 9,
                     RES ? 64 : PC_CK, CO,
                     RES ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_32B, 9);
  if (rc == 0)
    rc = make_map_4d(&map_o, out, map_type<T>(), W, CO, H, B, osc * 2, osh * 2, osb * 2, PC_PX,
                     CO, CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc != 0) return rc;
  static const cudaError_t smem_set = cudaFuncSetAttribute(
      pixel_conv_wgmma<T, CO, RES, RW>, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
  (void)smem_set;
  const PixelGeo geo{B, H, Cin, W, cdiv(H, Rows::R), cdiv(W, PC_PX), stages, cdiv(Cin, 64)};
  pixel_conv_wgmma<T, CO, RES, RW><<<grid, 128 * (CONSUMERS + 1), smem, stream>>>(map_x, map_w,
                                                                                 map_o, geo, ep);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace wg
}  // namespace smelter
