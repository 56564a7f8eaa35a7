// qlinear_conv's wgmma forms (sm_90a): the int8 x int8 -> int32
// convolution of an NHWC input by an OHWI weight, as an implicit GEMM with
// the output pixels on M (M = N Ho Wo) and the output channels on N, and
// QLinearConv's folded requant epilogue,
//   out[m, co] = clip(rint(fma(float(acc[m, co]), mul[co], add[co])), lo, 127)
// (without a bias rint(float(acc) * mul[co])), lo -128, or 0 when the
// conv's only reader is an int8 Relu (`relu`). csrc/qlinear_conv.cu's entry
// point launches it where kernels/wgmma_plan.py::qconv_plan says "gemm" or
// "im2col"; the other shapes keep that file's mma.sync kernel.
//
// Both operands are K-major as they lie: row m of A is output pixel m's
// window, K running over (ky, kx, c) with c fastest, and row co of B, the
// OHWI weight, is (ky, kx, c) too. 8-bit wgmma reads both shared operands
// K-major, so both come from shared memory (SS) by TMA, and no thread
// touches an operand byte:
// - "gemm" (1x1, stride 1, no pads): A is the NHWC input viewed as the
//   (M, C) matrix, a 2-D map;
// - "im2col" (any kernel, strides 1-8): A comes from an im2col map of the
//   NHWC input (cuTensorMapEncodeIm2col): a box is 128 consecutive output
//   pixels x BK channels of one tap, the tap (ky, kx) is the load's offset,
//   the conv's stride is the map's traversal stride, rows and images are
//   crossed by the TMA unit's own walk of the pixels, and the padding is its
//   zero fill. A K step lies inside one tap (C % BK == 0).
// A K step is BK bytes (128, 64 or 32: the largest that divides C), the box
// rows BK bytes with the BK-byte swizzle, which is wgmma's K-major layout of
// the same name (descriptor SBO 8 rows, layout 1, 2 or 3); a step issues
// BK / 32 wgmma m64nBNk32.s32.s8.s8 a consumer warpgroup, advancing both
// descriptors 32 bytes. An RGB stem (C 3, 7x7 stride 2) runs as a 7x1 conv
// (stride (2, 1)) over an unfolded copy of its input, the 7 pixels of a
// window row side by side as 21 channels zero-padded to 32, by a weight
// laid out alike once (the wrapper's and the fold's): zero products keep
// the int32 sums exact, and a tile takes 7 K steps, not 49.
//
// Tiles of 128 pixels x BN channels (BN 128, or 64 for C_out < 128), a
// producer warpgroup (one thread issues every load into a ring of STAGES
// stages behind full/empty mbarriers) and two consumer warpgroups of 64
// pixels each; persistent CTAs, grid = min(tiles, SMs), tiles N-fastest so
// a wave reads one box of pixels for several weight tiles. A step's stage
// is released once the next step's group is issued and it has retired. The
// epilogue runs the mma.sync kernel's arithmetic on each int32 sum, with
// the tile's multipliers and addends brought into shared memory while its
// K loop runs and every value computed before the first staging store (so
// that no load waits behind a store), stages the int8 tile in shared memory (a
// warpgroup's 64 rows of BN bytes, 16-byte chunks swizzled: 2-byte stores
// of a channel pair hit distinct banks) and stores whole 16-byte chunks of
// output rows (C_out % 16 == 0), while the producer already loads the next
// tile.
//
// Sizes (bytes; a stage = A 128 x BK + B BN x BK + 16 of mbarriers, the
// epilogue 2 x 64 x BN of staging + 2 x 2 x BN x 4 of multipliers and
// addends, 1 KB for alignment, stages at most 16):
//   BK 128, BN 128: 6 stages, 216,160; BK 128, BN 64: 8 stages, 206,976
//   BK 64, BN 128: 12 stages, 216,256; BK 64, BN 64: 16 stages, 207,104
//   BK 32, BN 128: 16 stages, 150,784; BK 32, BN 64: 16 stages, 108,800
// smelter_tpu_torch/kernels/wgmma_plan.py::qconv_plan mirrors them.
#pragma once

#include "wgmma_gemm.cuh"

namespace smelter {
namespace wg {
namespace {

constexpr int QC_MAX_STAGES = 16;

template <int BK, int BN>
struct QcCfg {
  static_assert(BK == 128 || BK == 64 || BK == 32, "K steps of 128, 64 or 32 bytes");
  static_assert(BN == 128 || BN == 64, "tiles of 128 or 64 output channels");
  static constexpr int A_BYTES = BM * BK;
  static constexpr int B_BYTES = BN * BK;
  // the int8 staging tiles, then each warpgroup's copy of the tile's
  // per-channel multipliers and addends
  static constexpr int STG = CONSUMERS * 64 * BN + CONSUMERS * 2 * BN * 4;
  static constexpr int FIT = (SMEM_BUDGET - 1024 - STG) / (A_BYTES + B_BYTES + 16);
  static constexpr int STAGES = FIT > QC_MAX_STAGES ? QC_MAX_STAGES : FIT;
  static constexpr int SMEM = 1024 + STAGES * (A_BYTES + B_BYTES + 16) + STG;
  static constexpr uint64_t LAYOUT = BK == 128 ? 1 : BK == 64 ? 2 : 3;  // the descriptor's swizzle
  static_assert(SMEM <= 232448, "more shared memory than a block may have");
};

// D (64 x 128, s32) += A (64 x 32 s8, shared, K-major) * B (32 x 128 s8,
// shared, K-major).
__device__ __forceinline__ void mma_s8_ss_m64n128k32(int (&d)[64], uint64_t desc_a,
                                                     uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

template <int BN>
__device__ __forceinline__ void mma_qc(int (&d)[BN / 2], uint64_t da, uint64_t db) {
  if constexpr (BN == 128)
    mma_s8_ss_m64n128k32(d, da, db);
  else
    mma_s8_ss_m64n64k32(d, da, db);
}

// The implicit-GEMM view of the conv for the im2col form: output pixel m =
// (n, i, j) = (m / hw, (m % hw) / Wo, m % Wo) has its window at input row
// i sh - pt, column j sw - pl; K step kt reads channels [c0, c0 + BK) of tap
// (ky, kx), kt BK = (ky kw + kx) C + c0.
struct QcGeo {
  int hw, Wo, sh, sw, pt, pl, kw, C;
};

// Byte (r, c) of a warpgroup's staging tile: 64 rows of BN bytes, 16-byte
// chunk q of row r at (q ^ (r & 7)) * 16 (BN 128) or (q ^ ((r >> 1) & 3)) *
// 16 (BN 64), so that a warp's 2-byte stores of one (j, h) (8 rows, 4
// channel pairs) land in distinct banks.
template <int BN>
__device__ __forceinline__ int stg_at(int r, int c) {
  const int q = c >> 4;
  const int sq = BN == 128 ? (q ^ (r & 7)) : (q ^ ((r >> 1) & 3));
  return r * BN + (sq << 4) + (c & 15);
}

// out (M, Cout) int8 = the conv of x (through map_x) by w (Cout, K) int8
// (through map_w) with the requant epilogue; K = kh kw C, K % BK == 0.
template <int BK, int BN, bool IM2COL>
__global__ void __launch_bounds__(128 * (CONSUMERS + 1), 1)
qconv_wgmma(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_w,
            QcGeo geo, const float* __restrict__ mul, const float* __restrict__ add,
            int8_t* __restrict__ out, int M, int Cout, int K, int relu) {
  using Cfg = QcCfg<BK, BN>;
  constexpr int STAGES = Cfg::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sa = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sb = sa + STAGES * Cfg::A_BYTES;
  uint8_t* se = sb + STAGES * Cfg::B_BYTES;  // the staging tiles
  uint64_t* full = reinterpret_cast<uint64_t*>(se + Cfg::STG);
  uint64_t* empty = full + STAGES;
  const int nt = div_up(Cout, BN), tiles = div_up(M, BM) * nt, KT = K / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // the producer warpgroup: one thread issues every load
    if (threadIdx.x == 0) {
      int stage = 0, phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile / nt) * BM, n0 = (tile % nt) * BN;
        int wx = 0, hx = 0, img = 0;  // the window of pixel m0
        if constexpr (IM2COL) {
          img = m0 / geo.hw;
          const int r = m0 - img * geo.hw, i = r / geo.Wo;
          wx = (r - i * geo.Wo) * geo.sw - geo.pl;
          hx = i * geo.sh - geo.pt;
        }
        for (int kt = 0; kt < KT; ++kt) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], Cfg::A_BYTES + Cfg::B_BYTES);
          uint8_t* a = sa + stage * Cfg::A_BYTES;
          if constexpr (IM2COL) {
            const int k0 = kt * BK, tap = k0 / geo.C, ky = tap / geo.kw;
            tma_load_im2col(a, &map_x, &full[stage], k0 - tap * geo.C, wx, hx, img,
                            static_cast<uint16_t>(tap - ky * geo.kw), static_cast<uint16_t>(ky));
          } else {
            tma_load_2d(a, &map_x, &full[stage], kt * BK, m0);
          }
          tma_load_2d(sb + stage * Cfg::B_BYTES, &map_w, &full[stage], kt * BK, n0);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  const int ct = threadIdx.x - 128, wgi = ct >> 7, warp = (ct >> 5) & 3, lane = ct & 31;
  const int g = lane >> 2, t = lane & 3, wt = ct & 127;
  uint8_t* stg = se + wgi * 64 * BN;
  float* sv = reinterpret_cast<float*>(se + CONSUMERS * 64 * BN) + wgi * 2 * BN;  // mul, add
  const float lo = relu ? 0.f : -128.f;
  int acc[BN / 2];
  int stage = 0, phase = 0;

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = (tile / nt) * BM, n0 = (tile % nt) * BN;
    if (wt < BN) {  // the tile's multipliers and addends, read while the tensor cores work
      const int col = n0 + wt;
      sv[wt] = col < Cout ? mul[col] : 0.f;
      sv[BN + wt] = (add != nullptr && col < Cout) ? add[col] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    int prev = -1;
    for (int kt = 0; kt < KT; ++kt) {
      mbar_wait(&full[stage], phase);
      const uint8_t* a = sa + stage * Cfg::A_BYTES + wgi * 64 * BK;  // this warpgroup's 64 rows
      const uint8_t* b = sb + stage * Cfg::B_BYTES;
      const uint64_t da = desc(a, 16, 8 * BK, Cfg::LAYOUT);
      const uint64_t db = desc(b, 16, 8 * BK, Cfg::LAYOUT);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk) mma_qc<BN>(acc, da + 2 * kk, db + 2 * kk);
      wgmma_commit();
      wgmma_wait<1>();  // the step before retired: its stage is free
      if (prev >= 0 && (ct & 127) == 0) mbar_arrive(&empty[prev]);
      prev = stage;
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (prev >= 0 && (ct & 127) == 0) mbar_arrive(&empty[prev]);
    named_sync(1 + wgi, 128);  // sv written
    // acc[4j + 2h + e] = the sum of tile row 16 warp + g + 8h (of this
    // warpgroup's 64), tile column 8j + 2t + e. First every value (no store
    // between the loads, so they overlap), then the staging stores.
    uint32_t pk[BN / 8];  // columns 8j + 2t, + 1 of row g (low half) and g + 8
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = 8 * j + 2 * t;
      const float2 mc = *reinterpret_cast<const float2*>(sv + c);
      const float2 ac = *reinterpret_cast<const float2*>(sv + BN + c);
      uint32_t v = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {  // i = 2h + e
        const float f = __int2float_rn(acc[4 * j + i]);
        const float m = (i & 1) ? mc.y : mc.x, a = (i & 1) ? ac.y : ac.x;
        const float y = add != nullptr ? __fmaf_rn(f, m, a) : __fmul_rn(f, m);
        const float q = fminf(fmaxf(rintf(y), lo), 127.f);
        v |= (static_cast<uint32_t>(__float2int_rn(q)) & 0xFFu) << (8 * i);
      }
      pk[j] = v;
    }
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<uint16_t*>(stg + stg_at<BN>(16 * warp + g + 8 * h, 8 * j + 2 * t)) =
            static_cast<uint16_t>(pk[j] >> (16 * h));
    named_sync(1 + wgi, 128);
    constexpr int CHUNKS = BN / 16;  // 16-byte chunks a row
#pragma unroll
    for (int i = 0; i < 64 * CHUNKS / 128; ++i) {
      const int q = (ct & 127) + i * 128, r = q / CHUNKS, c = (q % CHUNKS) * 16;
      const int row = m0 + wgi * 64 + r, col = n0 + c;
      if (row < M && col < Cout)
        *reinterpret_cast<uint4*>(out + static_cast<size_t>(row) * Cout + col) =
            *reinterpret_cast<const uint4*>(stg + stg_at<BN>(r, c));
    }
    named_sync(1 + wgi, 128);
  }
}

// The im2col map of the conv's NHWC int8 input x (N, H, W, C): boxes of 128
// output pixels x BK channels (the BK-byte swizzle), traversal strides (sw,
// sh). The window starts run from (-pl, -pt) to ((Wo - 1) sw - pl, (Ho - 1)
// sh - pt), the corners given as offsets from the map's first and last
// pixel, W first; positions outside the map read as zeros (the padding).
static int make_qconv_im2col_map(CUtensorMap* map, const void* x, int N, int H, int W, int C,
                                 int Ho, int Wo, int sh, int sw, int pt, int pl, int bk) {
  static const auto fn =
      reinterpret_cast<EncodeIm2col>(entry_point("cuTensorMapEncodeIm2col"));
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(C), static_cast<cuuint64_t>(W),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(N)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(C),
                                 static_cast<cuuint64_t>(C) * W,
                                 static_cast<cuuint64_t>(C) * W * H};
  const int lower[2] = {-pl, -pt};
  const int upper[2] = {(Wo - 1) * sw - pl - (W - 1), (Ho - 1) * sh - pt - (H - 1)};
  const cuuint32_t step[4] = {1, static_cast<cuuint32_t>(sw), static_cast<cuuint32_t>(sh), 1};
  const CUtensorMapSwizzle swz = bk == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : bk == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                            : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<void*>(x), dims,
                        strides, lower, upper, bk, BM, step, CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <int BK, int BN, bool IM2COL>
static int launch_qconv_t(const CUtensorMap& map_x, const void* w, QcGeo geo, const float* mul,
                          const float* add, void* out, int M, int Cout, int K, int relu,
                          int grid, cudaStream_t stream) {
  using Cfg = QcCfg<BK, BN>;
  CUtensorMap map_w;
  const CUtensorMapSwizzle swz = BK == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : BK == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                            : CU_TENSOR_MAP_SWIZZLE_32B;
  const int rc = make_map(&map_w, w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, Cout, K, BN, BK, swz);
  if (rc != 0) return rc;
  static const cudaError_t smem_set = cudaFuncSetAttribute(
      qconv_wgmma<BK, BN, IM2COL>, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::SMEM);
  (void)smem_set;  // a refusal shows as the launch's error
  qconv_wgmma<BK, BN, IM2COL><<<grid, 128 * (CONSUMERS + 1), Cfg::SMEM, stream>>>(
      map_x, map_w, geo, mul, add, static_cast<int8_t*>(out), M, Cout, K, relu);
  return static_cast<int>(cudaGetLastError());
}

template <int BK, bool IM2COL>
static int launch_qconv_bn(const CUtensorMap& map_x, const void* w, QcGeo geo, const float* mul,
                           const float* add, void* out, int M, int Cout, int K, int relu, int bn,
                           int grid, cudaStream_t stream) {
  if (bn == 128)
    return launch_qconv_t<BK, 128, IM2COL>(map_x, w, geo, mul, add, out, M, Cout, K, relu, grid,
                                           stream);
  return launch_qconv_t<BK, 64, IM2COL>(map_x, w, geo, mul, add, out, M, Cout, K, relu, grid,
                                        stream);
}

// The wgmma forms on `grid` CTAs: x (N, H, W, C) int8 NHWC, w (Cout, kh kw
// C) int8 OHWI, out (N Ho Wo, Cout) int8; im2col 0 for the "gemm" form (1x1,
// stride 1, no pads). The plan's checks: C % bk == 0, Cout % 16 == 0, Cout
// >= bn, N Ho Wo >= 128, 16-byte aligned bases, corners and strides the
// im2col map can hold. Returns a cudaError_t code.
static int launch_qconv(const void* x, const void* w, const float* mul, const float* add,
                        void* out, int N, int H, int W, int C, int Ho, int Wo, int Cout, int kh,
                        int kw, int sh, int sw, int pt, int pl, int relu, int im2col, int bk,
                        int bn, int grid, cudaStream_t stream) {
  const int M = N * Ho * Wo, K = kh * kw * C;
  CUtensorMap map_x;
  const CUtensorMapSwizzle swz = bk == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : bk == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                            : CU_TENSOR_MAP_SWIZZLE_32B;
  const int rc = im2col ? make_qconv_im2col_map(&map_x, x, N, H, W, C, Ho, Wo, sh, sw, pt, pl, bk)
                        : make_map(&map_x, x, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, M, C, BM, bk, swz);
  if (rc != 0) return rc;
  const QcGeo geo{Ho * Wo, Wo, sh, sw, pt, pl, kw, C};
  if (im2col) {
    if (bk == 128)
      return launch_qconv_bn<128, true>(map_x, w, geo, mul, add, out, M, Cout, K, relu, bn, grid,
                                        stream);
    if (bk == 64)
      return launch_qconv_bn<64, true>(map_x, w, geo, mul, add, out, M, Cout, K, relu, bn, grid,
                                       stream);
    return launch_qconv_bn<32, true>(map_x, w, geo, mul, add, out, M, Cout, K, relu, bn, grid,
                                     stream);
  }
  if (bk == 128)
    return launch_qconv_bn<128, false>(map_x, w, geo, mul, add, out, M, Cout, K, relu, bn, grid,
                                       stream);
  if (bk == 64)
    return launch_qconv_bn<64, false>(map_x, w, geo, mul, add, out, M, Cout, K, relu, bn, grid,
                                      stream);
  return launch_qconv_bn<32, false>(map_x, w, geo, mul, add, out, M, Cout, K, relu, bn, grid,
                                    stream);
}

}  // namespace
}  // namespace wg
}  // namespace smelter
