// The port's Hopper GEMM core (sm_90a): wgmma.mma_async with f32 (int8:
// s32) accumulators, TMA loads (cp.async.bulk.tensor) into a ring of
// shared-memory stages guarded by mbarriers, and thread-block clusters that
// sum a K split through distributed shared memory. Raw PTX in the style of
// common.cuh. Five kernels, shared by csrc/dequant_matmul.cu,
// csrc/collective_matmul.cu, csrc/dequant_conv.cu, csrc/vit_block.cu,
// csrc/mlp_block.cu and csrc/int8_matmul.cu (csrc/wgmma_conv.cuh and
// csrc/wgmma_conv_s8.cuh build pixel_conv's on them):
//
// gemm_tma (the "tma" form, 16-bit A and B): a persistent, warp-specialised
//   kernel. Tiles of BM 128 x BN 128 (a template parameter) walk K in steps
//   of BK 64. Warpgroup 0 is the producer: one thread issues the TMA
//   loads of a step (A: a 128 x 64 box, B: 64 x 64 boxes, both with the
//   128-byte swizzle) into a ring of STAGES stages (as many as fit 225 KB, at
//   most 8), each behind a "full" mbarrier (expect-tx bytes) and an "empty"
//   one (one thread of each consumer warpgroup arrives, after its
//   wait_group). Warpgroups 1 and 2 are consumers, 64 rows each: per step
//   four wgmma m64nBNk16, committed as one group; a step's stage is released
//   once two later steps' groups are issued and it has retired (wait_group
//   2), so three groups overlap. One CTA an SM, grid = min(tiles, SMs);
//   tiles go N-fastest, so a wave shares A rows and B stays in L2. The
//   epilogue stages 64 x 64 sub-tiles in shared memory and stores whole
//   16-byte chunks, the next tile's loads already in flight. TMA needs
//   16-byte global strides: K % 8 == 0 for A, N % 8 (bf16 B) or N % 16 (int8
//   W) and 16-byte aligned bases; the plan also keeps every box inside its
//   matrix (M >= BM, K >= BK, N >= BN).
//   With an f32 `recv` (collective_matmul_rs's travelling sum) the kernel
//   computes out = recv + A @ B. Those bytes bound the step where K is short
//   (ViT-B/16's MLP down over 4 ranks: 7.4 GFLOP, 7.5 us at 989 TFLOP/s,
//   against 38.7 MB of recv and out, 11.6 us at 3.35 TB/s), and loads of
//   recv in the epilogue stall every SM at once, so a second producer
//   thread brings each tile's recv (128 x 128 f32, 64 KB, in place of the
//   sub-tiles and one stage) into shared memory by TMA while the tile's K
//   loop runs, a tile ahead at most (its own full/empty mbarriers). The
//   epilogue adds the f32 accumulators into it there, then stores the sums
//   in 16-byte chunks, rounded once to out's type. (A TMA store of the f32
//   sums, tried too, gained too little to keep a second store path.) recv
//   and out may be one buffer (the sum updated in place): a tile's recv is
//   read before its out is written, and tiles are disjoint.
//   The block epilogues (template-chosen: runtime flags there made cicc
//   take minutes) serve csrc/vit_block.cu's projections and csrc/
//   mlp_block.cu's FC1 and FC2: an f32 or 16-bit bias added to the f32
//   sums, kEpiBiasRes also the residual x (x + (acc + b), staged in f32),
//   kEpiBiasGelu / kEpiBiasGeluTanh GELU of the biased sum in f32, one
//   rounding; kEpiQkv reads B, the packed QKV weight (3 n_groups, K, G), in
//   place through a 3-D map (G % 64 == 0). csrc/convnext_block.cu's FC2
//   takes kEpiBiasScaleRes, x + gamma (acc + b) with a per-column layer
//   scale; its N may be as narrow as one 64-column box (ConvNeXt-T's C 96:
//   the tile's second box lies partly past N, TMA fills it with zeros, and
//   the stores stop at N).
//
// gemm_tma_ra (the "tma" form for an int8 B: dequant_matmul's W, and
//   dequant_conv's HWIO weight): the same pipeline with the product
//   transposed. The int8 W box (64 K rows of WC bytes, WC 128 with the
//   128-byte swizzle or 64 with the 64-byte one) is W^T's A operand: each
//   consumer thread loads its bytes of mma.m16n8k16's A fragment (4 rows x 2
//   words a load, no bank conflict) and converts them in registers (two
//   register sets, one per step in flight); the x box is B, K-major. The
//   accumulator is out^T, 64 W columns x 128 x rows a warpgroup: with WC
//   128 the two consumers split the W columns of one x box, with WC 64
//   (C_out 64) they take one x box each, so no tile is half empty. Two
//   steps' groups overlap, each with its own register set. W never goes
//   back to shared memory in 16 bits: a K step moves 64 KB through shared
//   memory (TMA 24, W loads 8, wgmma's B 32), where converting W into a
//   16-bit B tile there moves 96 KB (TMA 24, conversion 24, wgmma 48).
//   x comes from a 2-D map (a matrix) or, for a stride-1 conv, from an
//   im2col map of the NHWC input (cuTensorMapEncodeIm2col): a box is 128
//   consecutive output pixels x 64 channels of one tap, the tap (ky, kx) is
//   the load's im2col offset, rows and images are crossed by the TMA unit's
//   own walk of the pixels, and the padding is its zero fill. With C % 64 ==
//   0 a K step of 64 lies inside one tap. The epilogue multiplies by the
//   scales in f32 and, for a 16-bit out, rounds once and stores each 8 x 8
//   block transposed (stmatrix.trans) into a staging tile in shared memory,
//   whence rows go out in 16-byte chunks; out^T's own layout would store 2
//   bytes a thread. An f32 out is stored from the accumulators.
//
// gemm_cluster (the "cluster" form): any shape and alignment. A 128 x 64
//   output tile a CTA, 256 threads (two consumer warpgroups, no producer);
//   operands go global -> registers -> shared (the loads of the next two
//   steps in flight while the tensor cores work), three stages, one
//   __syncthreads a step; an int8 B is converted on its way into shared memory. The K range
//   is split over a cluster of S <= 8 CTAs (grid z, the portable limit);
//   each CTA writes its f32 partial tile to its own shared memory, and after
//   a cluster barrier CTA rank r sums rows [r BM / S, (r + 1) BM / S) of all
//   S partials in rank order 0..S-1 through distributed shared memory,
//   applies the epilogue (the scales, or recv's add) and stores. One launch,
//   no global workspace, and the sum's order is fixed, so two calls agree
//   bit for bit.
//
// gemm_tma_s8 and gemm_cluster_s8 (int8 x (M, K) and W (K, N), int32 sums,
//   csrc/int8_matmul.cu): the same two forms on wgmma's .s32.s8.s8 shapes,
//   K steps of S8_BK = 128 bytes. 8-bit wgmma reads shared-memory operands
//   K-major only, and W (K, N) row-major is not. The tma form takes W^T as
//   the register A operand of m64n128k32 (tiles of 128 W columns x 128 x
//   rows; x's TMA box, K-major, is B): each consumer thread gathers its
//   fragment bytes from the TMA-loaded W box with 2-byte loads (A row g of a
//   warp is W column 2g, row g + 8 column 2g + 1) and byte permutes, in a
//   row order rotated by its lane so that no two lanes of a load share a
//   bank; its epilogue stores two adjacent columns a thread from the
//   accumulators (no staging). The cluster form transposes W into [n][k] on
//   its way into shared memory (4 x 4 byte blocks) and runs SS m64n64k32;
//   its partials are int32, summed in rank order. Its x may also be floats
//   that it quantizes per row as it loads them (csrc/int8_matmul_fused.cu).
//
// Shared-memory layouts (what wgmma's descriptors read):
//   K-major with the 128-byte swizzle (A; x as gemm_tma_ra's B): row r of 64
//     halves at r * 128 bytes, its 16-byte chunk c at ((c ^ (r & 7)) * 16);
//     descriptor SBO 1024 (8 rows), K advanced 16 halves by adding 32 bytes
//     to the address.
//   MN-major with the 128-byte swizzle (B, wgmma's transposed B): atoms of 64
//     columns x BK rows, 8 KB apart (LBO); row k of an atom at k * 128 bytes,
//     chunk c (columns 8c..8c+7) at ((c ^ (k & 7)) * 16); SBO 1024 (8 rows of
//     K), K advanced 16 rows by adding 2048 bytes.
//   int8 W box of 64-byte rows (the 64-byte swizzle): row k at k * 64, chunk
//     c at ((c ^ ((k >> 1) & 3)) * 16).
//   int8 -> bf16/f16 is exact: s8 + 128 as the low byte of a float 2^23
//     (bf16: then - (2^23 + 128) and cvt.rn.bf16x2), or of a half 1024 (f16:
//     then - 1152 in f16x2).
//
// Sizes (bytes): tma form, a stage = A 16,384 + B (bf16: BN x 128; int8:
// BN x 64); gemm_tma adds 32,768 for the epilogue's two 64 x 64 sub-tiles:
//   BN 128 bf16: 6 stages, 230,496
//   BN 128 bf16 with recv (its 65,536-byte tile in place of the sub-tiles):
//     5 stages, 230,496; the GELU epilogues' f32 tile the same
//   BN 128 int8 (and 32,768 for its staged 16-bit output): 8 stages, 230,528
//   WC 64 int8 (two x boxes a stage): 5 stages, 218,192
// Cluster form: 3 stages of 16,384 + 8,192 and 1 KB for alignment, 74,752;
// the f32 partials (128 x 72 floats, 36,864) reuse the stages.
// int8 tma form: a stage = x box 16,384 + W box 16,384: 7 stages, 230,512;
// int8 cluster form: 3 stages of 16,384 + 8,192, 74,752 (int32 partials).
// smelter_tpu_torch/kernels/wgmma_plan.py mirrors these numbers and picks
// the form, BN and S for a shape (plan; int8_plan for the int8 forms), and a
// conv's form (conv_plan).
#pragma once

#include <cooperative_groups.h>
#include <cuda.h>

#include <type_traits>

#include "common.cuh"
#include "int8_gemm.cuh"

namespace smelter {
namespace wg {
namespace {  // every kernel library keeps its own copy of each kernel

namespace cg = cooperative_groups;

constexpr int BM = 128, BK = 64, ATOM = 64;  // tile rows; K a step; columns an atom
constexpr int CONSUMERS = 2;                 // consumer warpgroups, 64 rows each
constexpr int SMEM_BUDGET = 225 * 1024;

__host__ __device__ __forceinline__ int div_up(int a, int b) { return (a + b - 1) / b; }

// -- PTX helpers --------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// Spins until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}
// One TMA load of the box at (c0 innermost, c1) into shared memory, its
// bytes counted on `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}
// One TMA load of the box at (c0 innermost, c1, c2) of a 3-D map.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
// One TMA load of the box at (c0 innermost, c1, c2, c3) of a 4-D map.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}
// One TMA im2col load: the box of the map's pixels (128 output pixels from
// the one whose window starts at input column w, row h of image n) x its
// channels from c, each pixel read at (w + ow, h + oh): the tap's offset.
__device__ __forceinline__ void tma_load_im2col(void* dst, const CUtensorMap* map, uint64_t* bar,
                                                int c, int w, int h, int n, uint16_t ow,
                                                uint16_t oh) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.im2col.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2], {%7, %8};\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c), "r"(w), "r"(h), "r"(n),
      "h"(ow), "h"(oh)
      : "memory");
}
// Orders this thread's generic-proxy shared-memory writes before later
// async-proxy reads (wgmma, TMA).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving accumulator reads or writes across a wait.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// A shared-memory matrix descriptor; layout type 1 is the 128-byte swizzle,
// 2 the 64-byte and 3 the 32-byte one.
__device__ __forceinline__ uint64_t desc(const void* smem, uint32_t lbo, uint32_t sbo,
                                         uint64_t layout = 1) {
  return static_cast<uint64_t>((smem_u32(smem) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) | (layout << 62);
}
__device__ __forceinline__ uint32_t a_offset(int r, int c) {  // K-major A, 16-byte chunk c of row r
  return r * 128 + ((c ^ (r & 7)) << 4);
}
__device__ __forceinline__ uint32_t b_offset(int k, int c) {  // MN-major B, chunk c of row k
  return (c >> 3) * (BK * 128) + k * 128 + (((c & 7) ^ (k & 7)) << 4);
}

// D (64 x 64, f32) += A (64 x 16, shared, K-major) * B (16 x 64, shared,
// MN-major) on the warpgroup.
template <typename T>
__device__ __forceinline__ void mma_m64n64k16(float (&d)[32], uint64_t desc_a, uint64_t desc_b) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
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
        "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
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
}

// D (64 x 128, f32) += A (64 x 16, shared, K-major) * B (16 x 128, shared,
// MN-major) on the warpgroup.
template <typename T>
__device__ __forceinline__ void mma_m64n128k16(float (&d)[64], uint64_t desc_a, uint64_t desc_b) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(desc_a), "l"(desc_b), "r"(1));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(desc_a), "l"(desc_b), "r"(1));
  }
}

// D (64 x 128, f32) += A (64 x 16, four registers a thread: mma.m16n8k16's A
// fragment for each warp's 16 rows) * B (16 x 128, shared, K-major).
template <typename T>
__device__ __forceinline__ void mma_rs_m64n128k16(float (&d)[64], const uint32_t (&a)[4],
                                                uint64_t desc_b) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
  }
}

template <typename T, int BN>
__device__ __forceinline__ void mma_step(float (&d)[BN / 2], uint64_t desc_a, uint64_t desc_b) {
  if constexpr (BN == 128)
    mma_m64n128k16<T>(d, desc_a, desc_b);
  else
    mma_m64n64k16<T>(d, desc_a, desc_b);
}

// One K step (BK = 64: four k16 slices) of a warpgroup's 64 rows.
template <typename T, int BN>
__device__ __forceinline__ void mma_bk(float (&d)[BN / 2], const uint8_t* a, const uint8_t* b) {
  const uint64_t da = desc(a, 16, 1024), db = desc(b, BK * 128, 1024);
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) mma_step<T, BN>(d, da + 2 * kk, db + 128 * kk);
}

// -- int8 -> bf16 / f16, exact ------------------------------------------------

template <typename T> __device__ __forceinline__ uint2 i8x4_to(uint32_t w);
template <>
__device__ __forceinline__ uint2 i8x4_to<__nv_bfloat16>(uint32_t w) {
  const uint32_t u = w ^ 0x80808080u;  // s + 128, as unsigned bytes
  float f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + i)) - 8388736.f;
  uint32_t lo, hi;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(lo) : "f"(f[1]), "f"(f[0]));
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(hi) : "f"(f[3]), "f"(f[2]));
  return make_uint2(lo, hi);
}
template <>
__device__ __forceinline__ uint2 i8x4_to<__half>(uint32_t w) {
  const uint32_t u = w ^ 0x80808080u;
  uint32_t lo = __byte_perm(u, 0x64646464u, 0x5140), hi = __byte_perm(u, 0x64646464u, 0x5342);
  asm("sub.f16x2 %0, %0, %1;\n" : "+r"(lo) : "r"(0x64806480u));  // - 1152
  asm("sub.f16x2 %0, %0, %1;\n" : "+r"(hi) : "r"(0x64806480u));
  return make_uint2(lo, hi);
}
template <typename T>
__device__ __forceinline__ uint4 i8x8_to(uint2 v) {
  const uint2 a = i8x4_to<T>(v.x), b = i8x4_to<T>(v.y);
  return make_uint4(a.x, a.y, b.x, b.y);
}

// -- epilogue -----------------------------------------------------------------

// v, times scales[col] when there are scales.
__device__ __forceinline__ float scaled(float v, const float* scales, int col) {
  return scales != nullptr ? __fmul_rn(v, scales[col]) : v;
}

// out[o] = v rounded once to the output's type (a DType code: the type is a
// run-time argument, so one kernel serves every output type).
__device__ __forceinline__ void put(void* out, int out_dtype, size_t o, float v) {
  if (out_dtype == kF32)
    store(static_cast<float*>(out) + o, v);
  else if (out_dtype == kBF16)
    store(static_cast<__nv_bfloat16*>(out) + o, v);
  else
    store(static_cast<__half*>(out) + o, v);
}

// v0 (low half) and v1 rounded once to the 16-bit type `out_dtype` names.
__device__ __forceinline__ uint32_t pack2(int out_dtype, float v0, float v1) {
  if (out_dtype == kBF16) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
    return *reinterpret_cast<const uint32_t*>(&h);
  }
  const __half2 h = __floats2half2_rn(v0, v1);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Four 8x8 b16 matrices in mma's accumulator layout (thread 4g + t holds
// row g, columns 2t and 2t + 1 of each) stored transposed: lane 8i + q
// names the address of row q of matrix i's transpose (column q of matrix i).
__device__ __forceinline__ void stmatrix_x4_trans(void* smem, uint32_t r0, uint32_t r1,
                                                  uint32_t r2, uint32_t r3) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(
                   smem_u32(smem)),
               "r"(r0), "r"(r1), "r"(r2), "r"(r3)
               : "memory");
}

// gemm_tma's epilogue stages each warpgroup's output in 64 x 64 sub-tiles
// of the output type in shared memory (rows of 64 elements, 16-byte chunks
// swizzled by row & 7), then stores a row's 16-byte chunks from consecutive
// threads: whole 32-byte sectors, where the accumulator's own layout (4
// bytes a thread, 8 rows a warp instruction) writes half-sectors.
constexpr int EPI_WG = 64 * 64 * 4;  // a warpgroup's sub-tile, sized for f32

__device__ __forceinline__ int elem_bytes(int out_dtype) { return out_dtype == kF32 ? 4 : 2; }

__device__ __forceinline__ uint8_t* epi_at(uint8_t* epi, int es, int r, int c) {
  const int b = c * es;
  return epi + r * 64 * es + ((((b >> 4) ^ (r & 7))) << 4) + (b & 15);
}
// Sub-tile elements (r, c), (r, c + 1) = v0, v1; c even.
__device__ __forceinline__ void epi_put2(uint8_t* epi, int out_dtype, int r, int c, float v0,
                                         float v1) {
  uint8_t* p = epi_at(epi, elem_bytes(out_dtype), r, c);
  if (out_dtype == kF32)
    *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
  else
    *reinterpret_cast<uint32_t*>(p) = pack2(out_dtype, v0, v1);
}
// The sub-tile to out rows [row0, row0 + 64) x columns [col0, col0 + 64),
// masked at M and N, by the warpgroup's 128 threads (t its thread).
__device__ __forceinline__ void epi_flush(const uint8_t* epi, void* out, int out_dtype, int M,
                                          int N, int row0, int col0, int t) {
  const int es = elem_bytes(out_dtype), per = 16 / es, chunks = 64 / per;
  for (int q = t; q < 64 * chunks; q += 128) {
    const int r = q / chunks, cq = q % chunks, row = row0 + r, col = col0 + cq * per;
    if (row >= M || col >= N) continue;
    const uint4 v = *reinterpret_cast<const uint4*>(epi + r * 64 * es + ((cq ^ (r & 7)) << 4));
    uint8_t* dst = static_cast<uint8_t*>(out) + (static_cast<size_t>(row) * N + col) * es;
    if (col + per <= N && reinterpret_cast<uintptr_t>(dst) % 16 == 0) {
      *reinterpret_cast<uint4*>(dst) = v;
    } else {
      const uint8_t* src = reinterpret_cast<const uint8_t*>(&v);
      for (int e = 0; e < per && col + e < N; ++e)
        for (int b = 0; b < es; ++b) dst[e * es + b] = src[e * es + b];
    }
  }
}
// gemm_tma's epilogues: kEpiNone stores A @ B [+ recv] in the type
// `out_dtype` names; the block epilogues of csrc/vit_block.cu's and
// csrc/mlp_block.cu's products add an f32 bias (kEpiBias; kEpiQkv also
// reads B, the packed QKV weight, through a 3-D map) and, kEpiBiasRes, the
// residual x in f32, x + (acc + b) as the Pallas kernels order it
// (smelter_tpu/kernels/vit_block.py, mlp_block.py), or apply GELU to acc + b
// in f32 (kEpiBiasGelu the exact form, kEpiBiasGeluTanh the tanh form:
// `activate`, as csrc/gemm.cuh's epilogue), and round once to out's type T.
// kEpiBiasScaleRes (csrc/convnext_block.cu's FC2) takes a per-column scale
// too: x + gamma (acc + b), as the Pallas ConvNeXt kernel orders it
// (smelter_tpu/kernels/convnext_block.py), each f32 operation rounded on
// its own (__fadd_rn, __fmul_rn: nothing contracted into an FMA).
enum Epilogue : int {
  kEpiNone = 0,
  kEpiQkv = 1,
  kEpiBias = 2,
  kEpiBiasRes = 3,
  kEpiBiasGelu = 4,
  kEpiBiasGeluTanh = 5,
  kEpiBiasScaleRes = 6
};
// A block epilogue's activation.
__host__ __device__ constexpr int epi_act(int epi) {
  return epi == kEpiBiasGelu ? kActGeluExact : epi == kEpiBiasGeluTanh ? kActGeluTanh : kActNone;
}
// Whether gemm_tma stores a block epilogue's tile under the next tile's K
// loop (the GELU epilogues: see gemm_tma).
__host__ __device__ constexpr bool epi_deferred(int epi) { return epi_act(epi) != kActNone; }

// The block epilogues' operands: bias (N,) in f32 (bias_f32) or T; residual
// (M, N) in T (kEpiBiasRes, kEpiBiasScaleRes); group, kEpiQkv's block width:
// B is (N / group, K, group), column n of the (K, N) product column n %
// group of block n / group (group % 64 == 0, so an atom never straddles
// blocks); scale (N,) in the bias's type (kEpiBiasScaleRes).
struct BlockEpi {
  const void* bias;
  int bias_f32;
  const void* residual;
  int group;
  const void* scale;
};

template <typename T>
__device__ __forceinline__ float bias_at(const void* p, int f32, int i) {
  if (f32) return static_cast<const float*>(p)[i];
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  else
    return __half2float(static_cast<const __half*>(p)[i]);
}
// A T value's bits (the low half of v) in f32.
template <typename T>
__device__ __forceinline__ float t_bits(uint32_t v) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return __uint_as_float((v & 0xFFFFu) << 16);
  else
    return __half2float(__ushort_as_half(static_cast<unsigned short>(v)));
}
// The f32 sub-tile (staged as epi_put2 stages kF32) to out rows [row0, row0 +
// 64) x columns [col0, col0 + 64) of out in T, each sum added to the
// residual's element in f32 and rounded once: 16-byte chunks of 4 sums, 8
// bytes of out and of the residual each. N % 4 == 0.
template <typename T>
__device__ __forceinline__ void epi_flush_res(const uint8_t* epi, void* out, const void* residual,
                                              int M, int N, int row0, int col0, int t) {
  constexpr int code = std::is_same<T, __nv_bfloat16>::value ? kBF16 : kF16;
  for (int q = t; q < 64 * 16; q += 128) {
    const int r = q >> 4, cq = q & 15, row = row0 + r, col = col0 + cq * 4;
    if (row >= M || col >= N) continue;
    const float4 s = *reinterpret_cast<const float4*>(epi + r * 256 + ((cq ^ (r & 7)) << 4));
    const size_t o = static_cast<size_t>(row) * N + col;
    const uint2 x = *reinterpret_cast<const uint2*>(static_cast<const uint16_t*>(residual) + o);
    *reinterpret_cast<uint2*>(static_cast<uint16_t*>(out) + o) =
        make_uint2(pack2(code, __fadd_rn(t_bits<T>(x.x), s.x),
                         __fadd_rn(t_bits<T>(x.x >> 16), s.y)),
                   pack2(code, __fadd_rn(t_bits<T>(x.y), s.z),
                         __fadd_rn(t_bits<T>(x.y >> 16), s.w)));
  }
}

// -- the tma form -------------------------------------------------------------

// TILE: a whole BM x BN f32 tile in shared memory (and RECV's two
// mbarriers), in place of the epilogue's sub-tiles and one stage: RECV's (out = recv + A @
// B with an f32 recv (M, N): a second producer thread brings each tile's
// recv into shared memory by TMA, boxes of 64 rows x 32 f32 columns with the
// 128-byte swizzle, while the tile's K loop runs; the epilogue adds the f32
// accumulators into it there and flushes the sums), or the GELU epilogues'
// (the consumers stage acc + bias there and store it, GELU applied, under
// the next tile's K loop).
template <int BN, bool TILE>
struct TmaCfg {
  static constexpr int THREADS = 128 * (CONSUMERS + 1);
  static constexpr int A_BYTES = BM * BK * 2;
  static constexpr int B_BYTES = BK * BN * 2;
  static constexpr int EPI = TILE ? BM * BN * 4 : CONSUMERS * EPI_WG;
  static constexpr int FIT = (SMEM_BUDGET - 1024 - EPI) / (A_BYTES + B_BYTES);
  static constexpr int STAGES = FIT > 8 ? 8 : FIT;
  static constexpr int SMEM =
      1024 + STAGES * (A_BYTES + B_BYTES) + EPI + 16 * STAGES + (TILE ? 16 : 0);
  static_assert(SMEM <= 232448, "more shared memory than a block may have");
};
constexpr int RECV_BOX = 64 * 32 * 4;  // one recv box: 64 rows of 128 bytes

// out (M, N) = [recv +] A (M, K) @ B, A a (M, K) T map (box 64 x 128,
// swizzled), B a (K, N) T map (box 64 x 64, swizzled) or, kEpiQkv, the
// packed weight's 3-D map (box 64 x 64 x 1); with RECV, map_r an f32 (M,
// N) map of recv (box 32 x 64, swizzled); out in the type `out_dtype` names.
// recv and out may be one buffer: a tile's recv is read (by TMA) before its
// out is written, and tiles are disjoint. EPI (without RECV): a block
// epilogue of `epi`'s operands, out in T. The GELU epilogues' arithmetic
// (exp, a division, ~40 instructions a value) stalled the tensor cores
// between tiles for as long as FC1's K loop at ViT-B/16 (K 768), and three
// idle producer warps given it ran slower still (latency-bound), so each
// consumer warpgroup stages its rows' acc + bias in f32 into the TILE (a
// 16-byte chunk c of row r at (c ^ ((r & 3) << 1)) * 16: no bank conflicts
// either way) and stores them, GELU applied and rounded, a slice after each
// K step's wgmma group of the next tile, while the tensor cores run it.
template <typename T, int BN, bool RECV, int EPI = kEpiNone>
__global__ void __launch_bounds__(TmaCfg<BN, RECV || epi_deferred(EPI)>::THREADS, 1)
gemm_tma(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
         const __grid_constant__ CUtensorMap map_r, void* out, int out_dtype, int M, int N,
         int K, BlockEpi epi) {
  constexpr bool DEFER = epi_deferred(EPI);
  static_assert(!(DEFER && RECV), "a recv tile or a GELU tile, not both");
  using Cfg = TmaCfg<BN, RECV || DEFER>;
  constexpr int STAGES = Cfg::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sa = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sb = sa + STAGES * Cfg::A_BYTES;
  uint8_t* se = sb + STAGES * Cfg::B_BYTES;  // epilogue sub-tiles, or the recv or GELU tile
  uint64_t* full = reinterpret_cast<uint64_t*>(se + Cfg::EPI);
  uint64_t* empty = full + STAGES;
  uint64_t* rfull = empty + STAGES;  // RECV: the tile's recv landed / was flushed
  uint64_t* rempty = rfull + 1;
  const int nt = div_up(N, BN), tiles = div_up(M, BM) * nt, KT = div_up(K, BK);

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    if constexpr (RECV) {
      mbar_init(rfull, 1);
      mbar_init(rempty, CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // the producer warpgroup: one thread issues every stage's loads
    if (threadIdx.x == 0) {
      int stage = 0, phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile / nt) * BM, n0 = (tile % nt) * BN;
        for (int kt = 0; kt < KT; ++kt) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], Cfg::A_BYTES + Cfg::B_BYTES);
          tma_load_2d(sa + stage * Cfg::A_BYTES, &map_a, &full[stage], kt * BK, m0);
          uint8_t* b = sb + stage * Cfg::B_BYTES;
#pragma unroll
          for (int j = 0; j < BN / ATOM; ++j) {
            const int n = n0 + j * ATOM;
            if constexpr (EPI == kEpiQkv)
              tma_load_3d(b + j * BK * 128, &map_b, &full[stage], n % epi.group, kt * BK,
                          n / epi.group);
            else
              tma_load_2d(b + j * BK * 128, &map_b, &full[stage], n, kt * BK);
          }
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    } else if (RECV && threadIdx.x == 32) {  // and one the recv tiles', a tile ahead at most
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++it) {
        const int m0 = (tile / nt) * BM, n0 = (tile % nt) * BN;
        mbar_wait(rempty, (it & 1) ^ 1);
        mbar_expect_tx(rfull, Cfg::EPI);
#pragma unroll
        for (int b = 0; b < (BM / 64) * (BN / 32); ++b)
          tma_load_2d(se + b * RECV_BOX, &map_r, rfull, n0 + (b % (BN / 32)) * 32,
                      m0 + (b / (BN / 32)) * 64);
      }
    }
    return;
  }

  const int ct = threadIdx.x - 128, wgi = ct >> 7, warp = (ct >> 5) & 3, lane = ct & 31;
  float acc[BN / 2];
  int stage = 0, phase = 0, it = 0;
  // DEFER: the warpgroup's staged rows of the last tile (at pend_m0,
  // pend_n0; none while pend_m0 < 0), `done` of this thread's DEFER_ITEMS
  // 16-byte chunks of them stored, DEFER_STEP after each K step's wgmma
  // group and the rest after the K loop (at ViT-B/16's FC1, 12 K steps, 2 a
  // step ran faster than 1 or 4, than all 16 after one step and than an
  // even spread)
  constexpr int DEFER_ITEMS = 64 * (BN / 4) / 128, DEFER_STEP = 2;
  int pend_m0 = -1, pend_n0 = 0, done = 0;
  const auto deferred_store = [&](int upto) {
    constexpr int code = std::is_same<T, __nv_bfloat16>::value ? kBF16 : kF16;
    for (; done < upto; ++done) {
      const int q = (ct & 127) + 128 * done, r = q / (BN / 4), cq = q % (BN / 4);
      const int row = pend_m0 + wgi * 64 + r, col = pend_n0 + cq * 4;
      if (row >= M || col >= N) continue;
      const float4 v = *reinterpret_cast<const float4*>(
          se + (wgi * 64 + r) * (BN * 4) + ((cq ^ ((r & 3) << 1)) << 4));
      constexpr int act = epi_act(EPI);
      *reinterpret_cast<uint2*>(static_cast<uint16_t*>(out) + static_cast<size_t>(row) * N +
                                col) =
          make_uint2(pack2(code, activate(v.x, act), activate(v.y, act)),
                     pack2(code, activate(v.z, act), activate(v.w, act)));
    }
  };
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++it) {
    const int m0 = (tile / nt) * BM, n0 = (tile % nt) * BN;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    int prev1 = -1, prev2 = -1;  // the stages of the last two steps
    for (int kt = 0; kt < KT; ++kt) {
      mbar_wait(&full[stage], phase);
      wgmma_fence();
      mma_bk<T, BN>(acc, sa + stage * Cfg::A_BYTES + wgi * 64 * 128, sb + stage * Cfg::B_BYTES);
      wgmma_commit();
      if constexpr (DEFER) {
        if (pend_m0 >= 0) deferred_store(min(DEFER_ITEMS, DEFER_STEP * (kt + 1)));
      }
      wgmma_wait<2>();  // two steps back has retired: its stage is free
      if (prev2 >= 0 && (ct & 127) == 0) mbar_arrive(&empty[prev2]);
      prev2 = prev1;
      prev1 = stage;
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    if constexpr (DEFER) {
      if (pend_m0 >= 0) deferred_store(DEFER_ITEMS);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if ((ct & 127) == 0) {
      if (prev2 >= 0) mbar_arrive(&empty[prev2]);
      if (prev1 >= 0) mbar_arrive(&empty[prev1]);
    }
    // acc[4j + 2h + e] = out (row 16 warp + g + 8h, column 8j + 2t + e)
    const int g = lane >> 2, t = lane & 3;
    if constexpr (RECV) {
      // recv + acc in place, in f32: the warpgroup's 64 rows are boxes
      // wgi (BN / 32) .. of 64 rows x 32 columns (row r at r * 128 bytes,
      // 16-byte chunk c at (c ^ (r & 7)) * 16)
      uint8_t* rt = se + wgi * (BN / 32) * RECV_BOX;
      mbar_wait(rfull, it & 1);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = warp * 16 + g + 8 * h, col = 8 * j + 2 * t;
          float2* p = reinterpret_cast<float2*>(rt + (col >> 5) * RECV_BOX + r * 128 +
                                                ((((col & 31) >> 2) ^ (r & 7)) << 4) +
                                                ((col & 3) << 2));
          const float2 v = *p;
          *p = make_float2(v.x + acc[4 * j + 2 * h], v.y + acc[4 * j + 2 * h + 1]);
        }
      named_sync(1 + wgi, 128);
      // the sums to out, 16-byte chunks of f32 (8 bytes of T): a warp a row
      const int row0 = m0 + wgi * 64;
      for (int q = ct & 127; q < 64 * (BN / 4); q += 128) {
        const int r = q / (BN / 4), cq = q % (BN / 4), row = row0 + r, col = n0 + cq * 4;
        if (row >= M || col >= N) continue;
        const float4 s = *reinterpret_cast<const float4*>(
            rt + (cq >> 3) * RECV_BOX + r * 128 + (((cq & 7) ^ (r & 7)) << 4));
        if (out_dtype == kF32)
          *reinterpret_cast<float4*>(static_cast<float*>(out) + static_cast<size_t>(row) * N +
                                     col) = s;
        else
          *reinterpret_cast<uint2*>(static_cast<uint16_t*>(out) + static_cast<size_t>(row) * N +
                                    col) =
              make_uint2(pack2(out_dtype, s.x, s.y), pack2(out_dtype, s.z, s.w));
      }
      fence_proxy_async();  // these reads before the next tile's TMA writes
      named_sync(1 + wgi, 128);
      if ((ct & 127) == 0) mbar_arrive(rempty);
    } else if constexpr (DEFER) {
      // acc + bias in f32 into the warpgroup's rows of the tile, once all
      // its threads have stored the last one's: row r = this thread's
      // accumulator row, f32 columns 8j + 2t, + 1 in 16-byte chunk 2j + (t
      // >> 1), swizzled; stored under the next tile's K loop (or below)
      named_sync(1 + wgi, 128);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * t;
        const float b0 = col < N ? bias_at<T>(epi.bias, epi.bias_f32, col) : 0.f;
        const float b1 = col < N ? bias_at<T>(epi.bias, epi.bias_f32, col + 1) : 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = wgi * 64 + warp * 16 + g + 8 * h, cq = 2 * j + (t >> 1);
          *reinterpret_cast<float2*>(se + r * (BN * 4) + ((cq ^ ((r & 3) << 1)) << 4) +
                                     (t & 1) * 8) =
              make_float2(acc[4 * j + 2 * h] + b0, acc[4 * j + 2 * h + 1] + b1);
        }
      }
      named_sync(1 + wgi, 128);
      pend_m0 = m0;
      pend_n0 = n0;
      done = 0;
    } else if constexpr (EPI != kEpiNone) {
      // acc + bias in f32 (kEpiBiasScaleRes: times the scale), staged as
      // the f32 sums (the residual added at the flush) or rounded once to T
      constexpr int code = std::is_same<T, __nv_bfloat16>::value ? kBF16 : kF16;
      constexpr bool RES = EPI == kEpiBiasRes || EPI == kEpiBiasScaleRes;
      constexpr int stg_dtype = RES ? kF32 : code;
      uint8_t* stg = se + wgi * EPI_WG;
#pragma unroll
      for (int c = 0; c < BN / 64; ++c) {
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int col = n0 + 64 * c + 8 * jj + 2 * t;
          const float b0 = col < N ? bias_at<T>(epi.bias, epi.bias_f32, col) : 0.f;
          const float b1 = col < N ? bias_at<T>(epi.bias, epi.bias_f32, col + 1) : 0.f;
          float g0 = 1.f, g1 = 1.f;
          if constexpr (EPI == kEpiBiasScaleRes) {
            g0 = col < N ? bias_at<T>(epi.scale, epi.bias_f32, col) : 0.f;
            g1 = col < N ? bias_at<T>(epi.scale, epi.bias_f32, col + 1) : 0.f;
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = 4 * (8 * c + jj) + 2 * h;
            if constexpr (EPI == kEpiBiasScaleRes)
              epi_put2(stg, kF32, warp * 16 + g + 8 * h, 8 * jj + 2 * t,
                       __fmul_rn(__fadd_rn(acc[i], b0), g0),
                       __fmul_rn(__fadd_rn(acc[i + 1], b1), g1));
            else
              epi_put2(stg, stg_dtype, warp * 16 + g + 8 * h, 8 * jj + 2 * t, acc[i] + b0,
                       acc[i + 1] + b1);
          }
        }
        named_sync(1 + wgi, 128);
        if constexpr (RES)
          epi_flush_res<T>(stg, out, epi.residual, M, N, m0 + wgi * 64, n0 + 64 * c, ct & 127);
        else
          epi_flush(stg, out, code, M, N, m0 + wgi * 64, n0 + 64 * c, ct & 127);
        named_sync(1 + wgi, 128);
      }
    } else {
      uint8_t* epi_ = se + wgi * EPI_WG;
#pragma unroll
      for (int c = 0; c < BN / 64; ++c) {
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = 4 * (8 * c + jj) + 2 * h;
            epi_put2(epi_, out_dtype, warp * 16 + g + 8 * h, 8 * jj + 2 * t, acc[i], acc[i + 1]);
          }
        named_sync(1 + wgi, 128);
        epi_flush(epi_, out, out_dtype, M, N, m0 + wgi * 64, n0 + 64 * c, ct & 127);
        named_sync(1 + wgi, 128);
      }
    }
  }
  if constexpr (DEFER) {
    if (pend_m0 >= 0) deferred_store(DEFER_ITEMS);  // the last tile's
  }
}

// -- the tma form with int8 W as the register operand --------------------------

// Two int8 bytes (lo, hi: values 0..255 holding s8 bit patterns) as a T pair.
template <typename T> __device__ __forceinline__ uint32_t i8_pair(uint32_t lo, uint32_t hi);
template <>
__device__ __forceinline__ uint32_t i8_pair<__nv_bfloat16>(uint32_t lo, uint32_t hi) {
  const float f0 = __uint_as_float(0x4B000080u ^ lo) - 8388736.f;  // 2^23 + s + 128 - (2^23 + 128)
  const float f1 = __uint_as_float(0x4B000080u ^ hi) - 8388736.f;
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(f1), "f"(f0));
  return r;
}
template <>
__device__ __forceinline__ uint32_t i8_pair<__half>(uint32_t lo, uint32_t hi) {
  uint32_t r = (0x6480u ^ lo) | ((0x6480u ^ hi) << 16);  // 1024 + s + 128, a half each
  asm("sub.f16x2 %0, %0, %1;\n" : "+r"(r) : "r"(0x64806480u));
  return r;
}

constexpr int RA_BW = 128;  // W columns of dequant_matmul's tile: two warpgroups of 64

// gemm_tma_ra's tile: WC W columns (128, or 64 for C_out 64) x XR x rows
// (one 128-row x box both consumers read, or one box each).
// The epilogue stages a warpgroup's 16-bit output (128 x rows x 64 W
// columns) in shared memory: 16 KB each.
constexpr int RA_EPI_WG = BM * 64 * 2;

template <int WC>
struct RaCfg {
  static_assert(WC == 128 || WC == 64, "W tiles of 128 or 64 columns");
  static constexpr int XR = WC == 128 ? BM : 2 * BM;
  static constexpr int W_BYTES = BK * WC;    // the int8 W box, swizzled
  static constexpr int X_BYTES = XR * BK * 2;
  static constexpr int EPI = CONSUMERS * RA_EPI_WG;
  static constexpr int FIT = (SMEM_BUDGET - 1024 - EPI) / (X_BYTES + W_BYTES);
  static constexpr int STAGES = FIT > 8 ? 8 : FIT;
  static constexpr int SMEM = 1024 + STAGES * (X_BYTES + W_BYTES) + EPI + 16 * STAGES;
  static_assert(SMEM <= 232448, "more shared memory than a block may have");
};

// The implicit-GEMM view of a stride-1 conv for gemm_tma_ra's im2col form:
// x row m is output pixel (n, i, j) = (m / hw, (m % hw) / Wo, m % Wo), whose
// window starts at input row i - pt, column j - pl; K step kt reads
// channels [c0, c0 + 64) of tap (ky, kx), kt BK = (ky kw + kx) C + c0 (K
// runs over (ky, kx, c), c fastest, as an HWIO weight's rows do).
struct Im2col {
  int hw, Wo, pt, pl, kw, C;
};

// out (M, N) = x (M, K) @ W (K, N) * scales, computed as its transpose: each
// consumer warpgroup's wgmma takes 64 W columns as its A operand, converted
// from the int8 box straight into mma.m16n8k16's A-fragment registers, and
// 128 x rows (K-major in shared memory) as B; its accumulator is out^T (64
// W columns x 128 x rows). W is never written back to shared memory in 16
// bits. IM2COL: x is the im2col view `geo` of an NHWC map (M output
// pixels); otherwise a (M, K) matrix.
template <typename T, int WC, bool IM2COL>
__global__ void __launch_bounds__(128 * (CONSUMERS + 1), 1)
gemm_tma_ra(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_w,
            Im2col geo, const float* __restrict__ scales, void* __restrict__ out, int out_dtype,
            int M, int N, int K) {
  using Cfg = RaCfg<WC>;
  constexpr int STAGES = Cfg::STAGES, XR = Cfg::XR;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sx = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sw = sx + STAGES * Cfg::X_BYTES;
  uint8_t* se = sw + STAGES * Cfg::W_BYTES;  // the epilogue's staged output
  uint64_t* full = reinterpret_cast<uint64_t*>(se + Cfg::EPI);
  uint64_t* empty = full + STAGES;
  const int nt = div_up(N, WC), tiles = div_up(M, XR) * nt, KT = div_up(K, BK);

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
        const int m0 = (tile / nt) * XR, n0 = (tile % nt) * WC;
        int px[XR / BM][3] = {};  // each x box's first pixel: window column, row, image
        if constexpr (IM2COL) {
#pragma unroll
          for (int b = 0; b < XR / BM; ++b) {
            const int m = m0 + b * BM, n = m / geo.hw, r = m - n * geo.hw, i = r / geo.Wo;
            px[b][0] = r - i * geo.Wo - geo.pl;
            px[b][1] = i - geo.pt;
            px[b][2] = n;
          }
        }
        // x boxes that start past the last row are not loaded: their rows'
        // outputs are never stored
        const int boxes = min(XR / BM, div_up(M - m0, BM));
        for (int kt = 0; kt < KT; ++kt) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], boxes * BM * BK * 2 + Cfg::W_BYTES);
          uint8_t* x = sx + stage * Cfg::X_BYTES;
          if constexpr (IM2COL) {
            const int k0 = kt * BK, tap = k0 / geo.C, ky = tap / geo.kw;
            for (int b = 0; b < boxes; ++b)
              tma_load_im2col(x + b * BM * BK * 2, &map_x, &full[stage], k0 - tap * geo.C,
                              px[b][0], px[b][1], px[b][2],
                              static_cast<uint16_t>(tap - ky * geo.kw), static_cast<uint16_t>(ky));
          } else {
            for (int b = 0; b < boxes; ++b)
              tma_load_2d(x + b * BM * BK * 2, &map_x, &full[stage], kt * BK, m0 + b * BM);
          }
          tma_load_2d(sw + stage * Cfg::W_BYTES, &map_w, &full[stage], n0, kt * BK);
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
  const int g = lane >> 2, t = lane & 3;
  // this thread's first W column in the tile, and its warpgroup's first x row
  const int nr = (WC == 128 ? wgi * 64 : 0) + warp * 16 + g;
  const int xr = WC == 128 ? 0 : wgi * BM;
  float acc[64];
  uint32_t ra0[BK / 16][4], ra1[BK / 16][4];  // A fragments of two steps in flight
  int stage = 0, phase = 0;

  // One K step: W's fragments from the int8 box (bytes (k, n) of a WC-byte
  // swizzled row: 4 rows x 2 words a load, no bank conflict), then four
  // wgmma k16 on them.
  auto step = [&](uint32_t (&a)[BK / 16][4], const uint8_t* w, const uint8_t* x) {
    auto byte = [&](int k, int n) -> uint32_t {
      if constexpr (WC == 128)
        return w[k * 128 + (((n >> 4) ^ (k & 7)) << 4) + (n & 15)];
      else
        return w[k * 64 + (((n >> 4) ^ ((k >> 1) & 3)) << 4) + (n & 15)];
    };
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const int k0 = kk * 16 + 2 * t;
      a[kk][0] = i8_pair<T>(byte(k0, nr), byte(k0 + 1, nr));
      a[kk][1] = i8_pair<T>(byte(k0, nr + 8), byte(k0 + 1, nr + 8));
      a[kk][2] = i8_pair<T>(byte(k0 + 8, nr), byte(k0 + 9, nr));
      a[kk][3] = i8_pair<T>(byte(k0 + 8, nr + 8), byte(k0 + 9, nr + 8));
    }
    wgmma_fence();
    const uint64_t db = desc(x, 16, 1024);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) mma_rs_m64n128k16<T>(acc, a[kk], db + 2 * kk);
    wgmma_commit();
  };

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = (tile / nt) * XR, n0 = (tile % nt) * WC;
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    int prev = -1;
    for (int kt = 0; kt < KT; ++kt) {
      mbar_wait(&full[stage], phase);
      const uint8_t* w = sw + stage * Cfg::W_BYTES;
      const uint8_t* x = sx + stage * Cfg::X_BYTES + xr * BK * 2;
      if (kt & 1)
        step(ra1, w, x);
      else
        step(ra0, w, x);
      wgmma_wait<1>();  // the step before retired: its stage and registers are free
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
    // acc[4j + 2h + e] = out^T (W column nr + 8h, x row 8j + 2t + e)
    if (out_dtype != kF32) {
      // 16-bit out (N % 8 == 0, the plans'): acc * s rounded once, each 8 x 8
      // block stored transposed by stmatrix into the warpgroup's staging
      // tile (x row r's 64 W columns at r * 128 bytes, 16-byte chunk c at
      // (c ^ (r & 7)) * 16), then 16-byte stores, a warp 4 rows of 128 bytes
      uint8_t* stg = se + wgi * RA_EPI_WG;
      const float s0 = n0 + nr < N ? scales[n0 + nr] : 0.f;
      const float s1 = n0 + nr + 8 < N ? scales[n0 + nr + 8] : 0.f;
      const int mi = lane >> 3, q = lane & 7;
#pragma unroll
      for (int jp = 0; jp < BM / 16; ++jp) {
        uint32_t r[4];
#pragma unroll
        for (int m = 0; m < 4; ++m) {  // matrix m: x rows 8 (2 jp + m / 2).., W columns 8 (m & 1)..
          const int i = 4 * (2 * jp + (m >> 1)) + 2 * (m & 1);
          const float sc = (m & 1) ? s1 : s0;
          r[m] = pack2(out_dtype, __fmul_rn(acc[i], sc), __fmul_rn(acc[i + 1], sc));
        }
        const int row = 8 * (2 * jp + (mi >> 1)) + q;
        stmatrix_x4_trans(stg + row * 128 + (((warp * 2 + (mi & 1)) ^ (row & 7)) << 4), r[0],
                          r[1], r[2], r[3]);
      }
      named_sync(1 + wgi, 128);
      const int col0 = n0 + (WC == 128 ? wgi * 64 : 0);
#pragma unroll
      for (int i = 0; i < BM * 8 / 128; ++i) {
        const int qq = (ct & 127) + i * 128, r = qq >> 3, c = qq & 7;
        const int row = m0 + xr + r, col = col0 + c * 8;
        if (row < M && col < N)
          *reinterpret_cast<uint4*>(static_cast<uint16_t*>(out) + static_cast<size_t>(row) * N +
                                    col) =
              *reinterpret_cast<const uint4*>(stg + r * 128 + ((c ^ (r & 7)) << 4));
      }
      named_sync(1 + wgi, 128);
    } else {
      // f32 out: for a fixed (j, h, e) a warp stores 4 rows of 32 contiguous bytes
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = n0 + nr + 8 * h;
        if (col >= N) continue;
        const float sc = scales[col];
#pragma unroll
        for (int j = 0; j < BM / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int row = m0 + xr + 8 * j + 2 * t + e;
            if (row < M)
              put(out, out_dtype, static_cast<size_t>(row) * N + col,
                  __fmul_rn(acc[4 * j + 2 * h + e], sc));
          }
      }
    }
  }
}

// -- the cluster form ---------------------------------------------------------

constexpr int CL_BN = 64, CL_STAGES = 3, CL_THREADS = 256;
constexpr int CL_A = BM * BK * 2, CL_B = BK * CL_BN * 2;
constexpr int CL_SMEM = 1024 + CL_STAGES * (CL_A + CL_B);
constexpr int CL_PART = CL_BN + 8;  // floats a row of the f32 partial tile
static_assert(BM * CL_PART * 4 <= CL_STAGES * (CL_A + CL_B), "partials do not fit the stages");

// out (M, N) = [recv +] A (M, K) @ B [* scales] for any shape: A (M, K)
// row-major in T; B (K, N) row-major, T or (INT8_B) int8; recv (M, N) f32
// or nullptr, which may alias out (the same thread reads and writes an
// element). Grid (N / 64, M / 128, S), a cluster of (1, 1, S); CTA z takes
// K rows [z k_chunk, (z + 1) k_chunk). A_VEC / B_VEC: 16-byte (int8:
// 8-byte) loads, when K (N) and the base allow; otherwise one element at a
// time.
template <typename T, bool INT8_B>
__global__ void __launch_bounds__(CL_THREADS)
gemm_cluster(const uint16_t* __restrict__ A, const void* __restrict__ Bv,
             const float* __restrict__ scales, const float* recv, void* out, int out_dtype,
             int M, int N, int K, int k_chunk, bool a_vec, bool b_vec) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  cg::cluster_group cluster = cg::this_cluster();
  const int S = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, wgi = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * CL_BN;
  const int k_begin = blockIdx.z * k_chunk, k_end = min(K, k_begin + k_chunk);
  const int steps = k_end > k_begin ? div_up(k_end - k_begin, BK) : 0;

  constexpr int A_CH = BM * BK / 8 / CL_THREADS;     // 16-byte A chunks a thread: 4
  constexpr int B_CH = BK * CL_BN / 8 / CL_THREADS;  // 8-element B chunks a thread: 2
  using BReg = typename std::conditional<INT8_B, uint2, uint4>::type;
  uint4 ra0[A_CH], ra1[A_CH];  // two steps' operands in flight
  BReg rb0[B_CH], rb1[B_CH];
  auto load = [&](uint4 (&ra)[A_CH], BReg (&rb)[B_CH], int k0) {
#pragma unroll
    for (int i = 0; i < A_CH; ++i) {
      const int q = tid + i * CL_THREADS, r = q >> 3, gm = m0 + r, gk = k0 + (q & 7) * 8;
      const uint16_t* p = A + static_cast<size_t>(gm) * K + gk;
      if (a_vec && gm < M && gk + 8 <= k_end) {
        ra[i] = *reinterpret_cast<const uint4*>(p);
      } else {
        uint32_t e[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (gm < M && gk + j < k_end) e[j >> 1] |= static_cast<uint32_t>(p[j]) << (16 * (j & 1));
        ra[i] = make_uint4(e[0], e[1], e[2], e[3]);
      }
    }
#pragma unroll
    for (int i = 0; i < B_CH; ++i) {
      const int q = tid + i * CL_THREADS, gk = k0 + (q >> 3), gn = n0 + (q & 7) * 8;
      const bool row_in = gk < k_end;
      if constexpr (INT8_B) {
        const uint8_t* p = static_cast<const uint8_t*>(Bv) + static_cast<size_t>(gk) * N + gn;
        if (b_vec && row_in && gn + 8 <= N) {
          rb[i] = *reinterpret_cast<const uint2*>(p);
        } else {
          uint32_t e[2] = {0u, 0u};
#pragma unroll
          for (int j = 0; j < 8; ++j)
            if (row_in && gn + j < N) e[j >> 2] |= static_cast<uint32_t>(p[j]) << (8 * (j & 3));
          rb[i] = make_uint2(e[0], e[1]);
        }
      } else {
        const uint16_t* p = static_cast<const uint16_t*>(Bv) + static_cast<size_t>(gk) * N + gn;
        if (b_vec && row_in && gn + 8 <= N) {
          rb[i] = *reinterpret_cast<const uint4*>(p);
        } else {
          uint32_t e[4] = {0u, 0u, 0u, 0u};
#pragma unroll
          for (int j = 0; j < 8; ++j)
            if (row_in && gn + j < N) e[j >> 1] |= static_cast<uint32_t>(p[j]) << (16 * (j & 1));
          rb[i] = make_uint4(e[0], e[1], e[2], e[3]);
        }
      }
    }
  };
  auto stash = [&](const uint4 (&ra)[A_CH], const BReg (&rb)[B_CH], int stage) {
    uint8_t* a = sm + stage * (CL_A + CL_B);
    uint8_t* b = a + CL_A;
#pragma unroll
    for (int i = 0; i < A_CH; ++i) {
      const int q = tid + i * CL_THREADS;
      *reinterpret_cast<uint4*>(a + a_offset(q >> 3, q & 7)) = ra[i];
    }
#pragma unroll
    for (int i = 0; i < B_CH; ++i) {
      const int q = tid + i * CL_THREADS;
      if constexpr (INT8_B)
        *reinterpret_cast<uint4*>(b + b_offset(q >> 3, q & 7)) = i8x8_to<T>(rb[i]);
      else
        *reinterpret_cast<uint4*>(b + b_offset(q >> 3, q & 7)) = rb[i];
    }
  };

  float acc[CL_BN / 2];
#pragma unroll
  for (int i = 0; i < CL_BN / 2; ++i) acc[i] = 0.f;
  // Step s: its operands to shared memory, step s + 2's loads issued, the
  // tensor cores on step s.
  auto step = [&](int s, uint4 (&ra)[A_CH], BReg (&rb)[B_CH]) {
    const int stage = s % CL_STAGES;
    stash(ra, rb, stage);
    fence_proxy_async();
    __syncthreads();  // every thread has passed step s - 1's wait: step s - 3's stage is free
    if (s + 2 < steps) load(ra, rb, k_begin + (s + 2) * BK);  // in flight for two steps
    const uint8_t* a = sm + stage * (CL_A + CL_B);
    wgmma_fence();
    mma_bk<T, CL_BN>(acc, a + wgi * 64 * 128, a + CL_A);
    wgmma_commit();
    wgmma_wait<1>();
  };
  if (steps > 0) load(ra0, rb0, k_begin);
  if (steps > 1) load(ra1, rb1, k_begin + BK);
  for (int s = 0; s < steps; s += 2) {
    step(s, ra0, rb0);
    if (s + 1 < steps) step(s + 1, ra1, rb1);
  }
  wgmma_wait<0>();
  fence_regs(acc);
  __syncthreads();  // every warpgroup is done with the stages: they hold the partials now

  float* part = reinterpret_cast<float*>(sm);
  {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int j = 0; j < CL_BN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wgi * 64 + warp * 16 + g + 8 * h;
        *reinterpret_cast<float2*>(&part[r * CL_PART + 8 * j + 2 * t]) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
  }
  cluster.sync();  // every rank's partial is written
  const int r0 = rank * BM / S, r1 = (rank + 1) * BM / S;
  for (int e = tid; e < (r1 - r0) * CL_BN; e += CL_THREADS) {
    const int r = r0 + e / CL_BN, c = e % CL_BN;
    const int row = m0 + r, col = n0 + c;
    float v = 0.f;
    for (int q = 0; q < S; ++q) v += cluster.map_shared_rank(part, q)[r * CL_PART + c];
    if (row < M && col < N) {
      const size_t o = static_cast<size_t>(row) * N + col;
      v = scaled(v, scales, col);
      put(out, out_dtype, o, recv != nullptr ? recv[o] + v : v);
    }
  }
  cluster.sync();  // no rank leaves while another still reads its partial
}

// -- int8: x (M, K) and W (K, N) int8, exact int32 sums ------------------------

constexpr int S8_BK = 128;  // K bytes a step: one 128-byte swizzled row
constexpr int S8_BOX = BM * S8_BK;  // a 128 x 128-byte x or W box, 16,384 bytes
constexpr int S8_FIT = (SMEM_BUDGET - 1024) / (2 * S8_BOX);
constexpr int S8_STAGES = S8_FIT > 8 ? 8 : S8_FIT;
constexpr int S8_SMEM = 1024 + S8_STAGES * (2 * S8_BOX + 16);
static_assert(S8_SMEM <= 232448, "more shared memory than a block may have");
constexpr int S8_CL_A = BM * S8_BK, S8_CL_B = CL_BN * S8_BK;
constexpr int S8_CL_SMEM = 1024 + CL_STAGES * (S8_CL_A + S8_CL_B);
static_assert(BM * CL_PART * 4 <= CL_STAGES * (S8_CL_A + S8_CL_B), "partials do not fit the stages");

// D (64 x 128, s32) += A (64 x 32 s8, four registers a thread: mma.m16n8k32's
// A fragment for each warp's 16 rows) * B (32 x 128 s8, shared, K-major).
__device__ __forceinline__ void mma_s8_rs_m64n128k32(int (&d)[64], const uint32_t (&a)[4],
                                                     uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D (64 x 64, s32) += A (64 x 32 s8, shared, K-major) * B (32 x 64 s8,
// shared, K-major).
__device__ __forceinline__ void mma_s8_ss_m64n64k32(int (&d)[32], uint64_t desc_a,
                                                    uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}
template <int R>
__device__ __forceinline__ void fence_regs(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// Elements o and o + 1 (o even) of one row, columns of scales sc0 and sc1,
// as one 4-byte (16-bit OutT) or 8-byte store.
template <typename OutT>
__device__ __forceinline__ void put_s8_pair(OutT* out, size_t o, int v0, int v1, float sr,
                                            float sc0, float sc1) {
  if constexpr (std::is_same<OutT, int>::value) {
    *reinterpret_cast<int2*>(out + o) = make_int2(v0, v1);
  } else {
    const float f0 = __fmul_rn(__fmul_rn(__int2float_rn(v0), sr), sc0);
    const float f1 = __fmul_rn(__fmul_rn(__int2float_rn(v1), sr), sc1);
    if constexpr (std::is_same<OutT, float>::value)
      *reinterpret_cast<float2*>(out + o) = make_float2(f0, f1);
    else
      *reinterpret_cast<uint32_t*>(out + o) =
          pack2(std::is_same<OutT, __half>::value ? kF16 : kBF16, f0, f1);
  }
}

// The tma form for int8: out (M, N) = float(x @ W) * s_row * s_col, computed
// as its transpose on wgmma.m64n128k32.s32.s8.s8. A tile is 128 W columns
// (64 a consumer warpgroup, W^T its register A operand) x 128 x rows (the x
// box, K-major, wgmma's B). A K step is 128 bytes: an x box of 128 rows x
// 128 K bytes and a W box of 128 K rows x 128 columns, both by TMA with the
// 128-byte swizzle. 8-bit wgmma reads shared operands K-major only, and W
// (K, N) row-major is not, so each consumer thread builds its A fragment from
// the W box: A row g of a warp is W column 2g of the warp's 16, row g + 8
// column 2g + 1, so one 2-byte load of a K row gives both rows' bytes, and
// byte permutes gather 4 K rows into a register. Lane t reads its 4 K rows in
// the order 4t + ((i + t) & 3): the 4 t-lanes then hit 4 distinct swizzled
// chunks (rows 8 apart share one), and a permute by t restores the K order.
// The same pairing makes the epilogue's stores 4 bytes (16-bit out) or 8
// (f32, int32) of two adjacent columns a thread, whole 32-byte sectors a warp.
template <typename OutT>
__global__ void __launch_bounds__(128 * (CONSUMERS + 1), 1)
gemm_tma_s8(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_w,
            const float* __restrict__ s_row, const float* __restrict__ s_col,
            OutT* __restrict__ out, int M, int N, int K) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sx = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sw = sx + S8_STAGES * S8_BOX;
  uint64_t* full = reinterpret_cast<uint64_t*>(sw + S8_STAGES * S8_BOX);
  uint64_t* empty = full + S8_STAGES;
  const int nt = div_up(N, RA_BW), tiles = div_up(M, BM) * nt, KT = div_up(K, S8_BK);

  if (threadIdx.x == 0) {
    for (int s = 0; s < S8_STAGES; ++s) {
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
        const int m0 = (tile / nt) * BM, n0 = (tile % nt) * RA_BW;
        for (int kt = 0; kt < KT; ++kt) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], 2 * S8_BOX);
          tma_load_2d(sx + stage * S8_BOX, &map_x, &full[stage], kt * S8_BK, m0);
          tma_load_2d(sw + stage * S8_BOX, &map_w, &full[stage], n0, kt * S8_BK);
          if (++stage == S8_STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  const int ct = threadIdx.x - 128, wgi = ct >> 7, warp = (ct >> 5) & 3, lane = ct & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nb = wgi * 64 + warp * 16 + 2 * g;  // this thread's W column pair in the tile
  uint32_t rot = 0;  // byte i <- byte (i - t) & 3: undoes the rotated row order
#pragma unroll
  for (int i = 0; i < 4; ++i) rot |= static_cast<uint32_t>((i - t) & 3) << (4 * i);
  int acc[64];
  uint32_t ra0[S8_BK / 32][4], ra1[S8_BK / 32][4];  // A fragments of two steps in flight
  int stage = 0, phase = 0;

  auto step = [&](uint32_t (&a)[S8_BK / 32][4], const uint8_t* w, const uint8_t* x) {
#pragma unroll
    for (int kk = 0; kk < S8_BK / 32; ++kk)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        uint32_t h[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int k = kk * 32 + half * 16 + 4 * t + ((i + t) & 3);
          h[i] = *reinterpret_cast<const uint16_t*>(w + k * 128 + (((nb >> 4) ^ (k & 7)) << 4) +
                                                   (nb & 15));
        }
        const uint32_t p01 = __byte_perm(h[0], h[1], 0x5410), p23 = __byte_perm(h[2], h[3], 0x5410);
        a[kk][2 * half] = __byte_perm(__byte_perm(p01, p23, 0x6420), 0, rot);      // column nb
        a[kk][2 * half + 1] = __byte_perm(__byte_perm(p01, p23, 0x7531), 0, rot);  // nb + 1
      }
    wgmma_fence();
    const uint64_t db = desc(x, 16, 1024);
#pragma unroll
    for (int kk = 0; kk < S8_BK / 32; ++kk) mma_s8_rs_m64n128k32(acc, a[kk], db + 2 * kk);
    wgmma_commit();
  };

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = (tile / nt) * BM, n0 = (tile % nt) * RA_BW;
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0;
    int prev = -1;
    for (int kt = 0; kt < KT; ++kt) {
      mbar_wait(&full[stage], phase);
      const uint8_t* w = sw + stage * S8_BOX;
      const uint8_t* x = sx + stage * S8_BOX;
      if (kt & 1)
        step(ra1, w, x);
      else
        step(ra0, w, x);
      wgmma_wait<1>();  // the step before retired: its stage and registers are free
      if (prev >= 0 && (ct & 127) == 0) mbar_arrive(&empty[prev]);
      prev = stage;
      if (++stage == S8_STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (prev >= 0 && (ct & 127) == 0) mbar_arrive(&empty[prev]);
    // acc[4j + 2h + e] = the sum for W column n0 + nb + h, x row m0 + 8j + 2t + e
    const int col = n0 + nb;
    if (col >= N) continue;  // N % 16 == 0: col + 1 < N with it
    const float sc0 = s_col[col], sc1 = s_col[col + 1];
#pragma unroll
    for (int j = 0; j < BM / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = m0 + 8 * j + 2 * t + e;
        if (row < M)
          put_s8_pair(out, static_cast<size_t>(row) * N + col, acc[4 * j + e],
                      acc[4 * j + 2 + e], s_row[row], sc0, sc1);
      }
  }
}

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <> __device__ __forceinline__ float to_f32<__half>(__half v) { return __half2float(v); }

// The int8 byte of one activation at its row's scale, as quantize_rows:
// IEEE division (no reciprocal), round half to even, clip to [-127, 127].
__device__ __forceinline__ uint32_t quant(float v, float s) {
  const int q = __float2int_rn(__fdiv_rn(v, s));
  return static_cast<uint32_t>(max(-127, min(127, q))) & 0xffu;
}

// The four activations at e quantized at scale s, as four bytes.
template <typename T>
__device__ __forceinline__ uint32_t quant4(const T* e, float s) {
  return quant(to_f32(e[0]), s) | quant(to_f32(e[1]), s) << 8 | quant(to_f32(e[2]), s) << 16 |
         quant(to_f32(e[3]), s) << 24;
}

// The cluster form for int8, any shape: a 128 x 64 tile a CTA, two consumer
// warpgroups of 64 rows; x and W go global -> registers -> shared (the next
// two steps' loads in flight), W transposed to [n][k] on its way (4 x 4 byte
// blocks through byte permutes), both read K-major by wgmma.m64n64k32 s8.
// The K range is split over a cluster of S <= 8 CTAs; the int32 partials are
// summed in rank order through distributed shared memory and the epilogue
// runs once. X_VEC: 16-byte loads of x's rows (K sizeof(TX) % 16, aligned
// base); W_VEC: 4-byte loads of W's rows (N % 4, aligned base); otherwise
// element by element. x is int8 (int8_matmul), or f32/bf16/f16 quantized at
// its row's scale s_row as it loads (dequant_matmul_int8_fused): a thread's
// chunk is 16 values of one row, quantized to 16 bytes, and since that
// computes, the loads of step s + 2 are issued under step s's wgmma group
// rather than before it.
template <typename OutT, typename TX>
__global__ void __launch_bounds__(CL_THREADS)
gemm_cluster_s8(const TX* __restrict__ x, const int8_t* __restrict__ w,
                const float* __restrict__ s_row, const float* __restrict__ s_col, OutT* out,
                int M, int N, int K, int k_chunk, bool x_vec, bool w_vec) {
  constexpr bool QX = !std::is_same<TX, int8_t>::value;  // quantize x as it loads
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  cg::cluster_group cluster = cg::this_cluster();
  const int S = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, wgi = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * CL_BN;
  const int k_begin = blockIdx.z * k_chunk, k_end = min(K, k_begin + k_chunk);
  const int steps = k_end > k_begin ? div_up(k_end - k_begin, S8_BK) : 0;

  constexpr int A_CH = BM * S8_BK / 16 / CL_THREADS;         // 16-byte x chunks a thread: 4
  constexpr int W_BL = S8_BK * CL_BN / 16 / CL_THREADS;      // 4 x 4 W blocks a thread: 2
  uint4 ra0[A_CH], ra1[A_CH];
  uint32_t rw0[W_BL][4], rw1[W_BL][4];
  auto load = [&](uint4 (&ra)[A_CH], uint32_t (&rw)[W_BL][4], int k0) {
#pragma unroll
    for (int i = 0; i < A_CH; ++i) {
      const int q = tid + i * CL_THREADS, gm = m0 + (q >> 3), gk = k0 + (q & 7) * 16;
      const TX* p = x + static_cast<size_t>(gm) * K + gk;
      if constexpr (QX) {
        uint32_t e[4] = {0u, 0u, 0u, 0u};
        if (gm < M) {
          const float s = s_row[gm];
          if (x_vec && gk + 16 <= k_end) {
            alignas(16) TX v[16];
#pragma unroll
            for (int u = 0; u < static_cast<int>(sizeof(TX)); ++u)
              reinterpret_cast<uint4*>(v)[u] = reinterpret_cast<const uint4*>(p)[u];
#pragma unroll
            for (int j = 0; j < 4; ++j) e[j] = quant4(v + 4 * j, s);
          } else {
#pragma unroll
            for (int j = 0; j < 16; ++j)
              if (gk + j < k_end) e[j >> 2] |= quant(to_f32(p[j]), s) << (8 * (j & 3));
          }
        }
        ra[i] = make_uint4(e[0], e[1], e[2], e[3]);
      } else if (x_vec && gm < M && gk + 16 <= k_end) {
        ra[i] = *reinterpret_cast<const uint4*>(p);
      } else {
        uint32_t e[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int j = 0; j < 16; ++j)
          if (gm < M && gk + j < k_end)
            e[j >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(p[j])) << (8 * (j & 3));
        ra[i] = make_uint4(e[0], e[1], e[2], e[3]);
      }
    }
#pragma unroll
    for (int b = 0; b < W_BL; ++b) {
      const int q = tid + b * CL_THREADS;
      const int gk = k0 + (q >> 4) * 4, gn = n0 + (q & 15) * 4;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int8_t* p = w + static_cast<size_t>(gk + i) * N + gn;
        const bool row_in = gk + i < k_end;
        if (w_vec && row_in && gn + 4 <= N) {
          rw[b][i] = *reinterpret_cast<const uint32_t*>(p);
        } else {
          rw[b][i] = 0u;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (row_in && gn + j < N)
              rw[b][i] |= static_cast<uint32_t>(static_cast<uint8_t>(p[j])) << (8 * j);
        }
      }
    }
  };
  auto stash = [&](const uint4 (&ra)[A_CH], const uint32_t (&rw)[W_BL][4], int stage) {
    uint8_t* a = sm + stage * (S8_CL_A + S8_CL_B);
    uint8_t* b = a + S8_CL_A;
#pragma unroll
    for (int i = 0; i < A_CH; ++i) {
      const int q = tid + i * CL_THREADS;
      *reinterpret_cast<uint4*>(a + a_offset(q >> 3, q & 7)) = ra[i];
    }
#pragma unroll
    for (int bb = 0; bb < W_BL; ++bb) {
      const int q = tid + bb * CL_THREADS, k = (q >> 4) * 4, n = (q & 15) * 4;
      uint32_t col[4];
      i8::transpose4x4(rw[bb], col);
#pragma unroll
      for (int j = 0; j < 4; ++j)  // W^T row n + j, K-major, 128-byte swizzled
        *reinterpret_cast<uint32_t*>(b + a_offset(n + j, k >> 4) + (k & 15)) = col[j];
    }
  };

  int acc[CL_BN / 2];
#pragma unroll
  for (int i = 0; i < CL_BN / 2; ++i) acc[i] = 0;
  auto step = [&](int s, uint4 (&ra)[A_CH], uint32_t (&rw)[W_BL][4]) {
    const int stage = s % CL_STAGES;
    stash(ra, rw, stage);
    fence_proxy_async();
    __syncthreads();  // every thread has passed step s - 1's wait: step s - 3's stage is free
    if (!QX && s + 2 < steps) load(ra, rw, k_begin + (s + 2) * S8_BK);  // in flight two steps
    const uint8_t* a = sm + stage * (S8_CL_A + S8_CL_B);
    const uint64_t da = desc(a + wgi * 64 * S8_BK, 16, 1024), db = desc(a + S8_CL_A, 16, 1024);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < S8_BK / 32; ++kk) mma_s8_ss_m64n64k32(acc, da + 2 * kk, db + 2 * kk);
    wgmma_commit();
    if (QX && s + 2 < steps) load(ra, rw, k_begin + (s + 2) * S8_BK);  // under the group
    wgmma_wait<1>();
  };
  if (steps > 0) load(ra0, rw0, k_begin);
  if (steps > 1) load(ra1, rw1, k_begin + S8_BK);
  for (int s = 0; s < steps; s += 2) {
    step(s, ra0, rw0);
    if (s + 1 < steps) step(s + 1, ra1, rw1);
  }
  wgmma_wait<0>();
  fence_regs(acc);
  __syncthreads();  // every warpgroup is done with the stages: they hold the partials now

  int* part = reinterpret_cast<int*>(sm);
  {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int j = 0; j < CL_BN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wgi * 64 + warp * 16 + g + 8 * h;
        *reinterpret_cast<int2*>(&part[r * CL_PART + 8 * j + 2 * t]) =
            make_int2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
  }
  cluster.sync();  // every rank's partial is written
  const int r0 = rank * BM / S, r1 = (rank + 1) * BM / S;
  for (int e = tid; e < (r1 - r0) * CL_BN; e += CL_THREADS) {
    const int r = r0 + e / CL_BN, c = e % CL_BN;
    const int row = m0 + r, col = n0 + c;
    int v = 0;
    for (int q = 0; q < S; ++q) v += cluster.map_shared_rank(part, q)[r * CL_PART + c];
    if (row < M && col < N)
      i8::epilogue(out + static_cast<size_t>(row) * N + col, v, s_row[row], s_col[col]);
  }
  cluster.sync();  // no rank leaves while another still reads its partial
}

// -- host side ----------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
using EncodeIm2col = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const int*, const int*,
                                  cuuint32_t, cuuint32_t, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The CUDA 12.0 version of the entry point `name`, found through the
// runtime (no -lcuda at build time); nullptr where it is missing.
static void* entry_point(const char* name) {
  void* p = nullptr;
  cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
  cudaGetDriverEntryPointByVersion(name, &p, 12000, cudaEnableDefault, &found);
#else
  cudaGetDriverEntryPoint(name, &p, cudaEnableDefault, &found);
#endif
  return found == cudaDriverEntryPointSuccess ? p : nullptr;
}

// A map of the row-major (rows, cols) matrix at `base`, boxes of (box_rows,
// box_cols), swizzled as `swizzle` says. Returns a cudaError_t code.
static int make_map(CUtensorMap* map, const void* base, CUtensorMapDataType type,
                    int elem_bytes, int rows, int cols, int box_rows, int box_cols,
                    CUtensorMapSwizzle swizzle) {
  static const auto fn = reinterpret_cast<EncodeTiled>(entry_point("cuTensorMapEncodeTiled"));
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * elem_bytes};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t step[2] = {1, 1};
  const CUresult r = fn(map, type, 2, const_cast<void*>(base), dims, strides, box, step,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// A map of the 3-D tensor at `base`: dims (d0 innermost, d1, d2) elements,
// d1 and d2 strided by s1 and s2 bytes, boxes of (b0, b1, 1); positions past
// the dims read as zeros. Returns a cudaError_t code.
static int make_map_3d(CUtensorMap* map, const void* base, CUtensorMapDataType type, int d0,
                       int d1, int d2, long long s1, long long s2, int b0, int b1,
                       CUtensorMapSwizzle swizzle) {
  static const auto fn = reinterpret_cast<EncodeTiled>(entry_point("cuTensorMapEncodeTiled"));
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d0), static_cast<cuuint64_t>(d1),
                              static_cast<cuuint64_t>(d2)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(s1), static_cast<cuuint64_t>(s2)};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(b0), static_cast<cuuint32_t>(b1), 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult r = fn(map, type, 3, const_cast<void*>(base), dims, strides, box, step,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// A map of the 4-D tensor at `base`: dims (d0 innermost, d1, d2, d3)
// elements, d1, d2 and d3 strided by s1, s2 and s3 bytes in any order (a
// (B, H, N, hd) view of a (B, N, H, hd) tensor has s2 < s1), boxes of (b0,
// b1, b2, b3); positions past the dims read as zeros (a store skips them).
// The base must be 16-byte aligned and each stride a 16-byte multiple below
// 2^40, which the callers' plans check before launch. Returns a cudaError_t
// code.
static int make_map_4d(CUtensorMap* map, const void* base, CUtensorMapDataType type, int d0,
                       int d1, int d2, int d3, long long s1, long long s2, long long s3, int b0,
                       int b1, CUtensorMapSwizzle swizzle, int b2 = 1, int b3 = 1) {
  static const auto fn = reinterpret_cast<EncodeTiled>(entry_point("cuTensorMapEncodeTiled"));
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d0), static_cast<cuuint64_t>(d1),
                              static_cast<cuuint64_t>(d2), static_cast<cuuint64_t>(d3)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(s1), static_cast<cuuint64_t>(s2),
                                 static_cast<cuuint64_t>(s3)};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(b0), static_cast<cuuint32_t>(b1),
                             static_cast<cuuint32_t>(b2), static_cast<cuuint32_t>(b3)};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, type, 4, const_cast<void*>(base), dims, strides, box, step,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// The im2col map of a stride-1 conv's NHWC input x (N, H, W, C) in T: boxes
// of 128 output pixels x 64 channels (128 bytes, the 128-byte swizzle).
// The bounding box of window starts runs from (-pl, -pt) to (Wo - 1 - pl,
// Ho - 1 - pt), its corners given as offsets from the map's first and last
// pixel, W first; positions outside the map read as zeros (the padding).
static int make_im2col_map(CUtensorMap* map, const void* x, CUtensorMapDataType type, int N,
                           int H, int W, int C, int Ho, int Wo, int pt, int pl) {
  static const auto fn =
      reinterpret_cast<EncodeIm2col>(entry_point("cuTensorMapEncodeIm2col"));
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(C), static_cast<cuuint64_t>(W),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(N)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(C) * 2,
                                 static_cast<cuuint64_t>(C) * 2 * W,
                                 static_cast<cuuint64_t>(C) * 2 * W * H};
  const int lower[2] = {-pl, -pt};
  const int upper[2] = {Wo - W - pl, Ho - H - pt};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, type, 4, const_cast<void*>(x), dims, strides, lower, upper, BK, BM,
                        step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
constexpr CUtensorMapDataType map_type() {
  return std::is_same<T, __half>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                        : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

// The tma form on `grid` CTAs: a (M, K) and b (K, N) in T; recv (M, N) f32
// or nullptr. Returns a cudaError_t code.
template <typename T, int BN>
static int launch_tma(const void* a, const void* b, const float* recv, void* out, int out_dtype,
                      int M, int N, int K, int grid, cudaStream_t stream) {
  CUtensorMap map_a, map_b, map_r;
  int rc = make_map(&map_a, a, map_type<T>(), 2, M, K, BM, BK, CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc == 0) rc = make_map(&map_b, b, map_type<T>(), 2, K, N, BK, ATOM, CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc == 0 && recv != nullptr)
    rc = make_map(&map_r, recv, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, M, N, 64, 32,
                  CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc != 0) return rc;
  if (recv != nullptr) {
    using Cfg = TmaCfg<BN, true>;
    static const cudaError_t smem_set = cudaFuncSetAttribute(
        gemm_tma<T, BN, true>, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::SMEM);
    (void)smem_set;  // a refusal shows as the launch's error
    gemm_tma<T, BN, true><<<grid, Cfg::THREADS, Cfg::SMEM, stream>>>(
        map_a, map_b, map_r, out, out_dtype, M, N, K, BlockEpi{});
  } else {
    using Cfg = TmaCfg<BN, false>;
    static const cudaError_t smem_set = cudaFuncSetAttribute(
        gemm_tma<T, BN, false>, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::SMEM);
    (void)smem_set;
    gemm_tma<T, BN, false><<<grid, Cfg::THREADS, Cfg::SMEM, stream>>>(
        map_a, map_b, map_a, out, out_dtype, M, N, K, BlockEpi{});
  }
  return static_cast<int>(cudaGetLastError());
}

// The tma form with a block epilogue on `grid` CTAs: out (M, N) in T =
// [residual +] (a (M, K) @ b + bias); b a (K, N) matrix, or with group > 0
// the packed (N / group, K, group) weight (group % 64 == 0); bias f32
// (bias_f32) or T, residual T or nullptr. The plan's checks: 16-byte
// aligned bases, K % 8 == 0, N % 8 == 0, M >= BM, K >= BK, N >= 128.
template <typename T, int EPI>
static int launch_block_epi(const CUtensorMap& map_a, const CUtensorMap& map_b, void* out,
                            int M, int N, int K, const BlockEpi& epi, int grid,
                            cudaStream_t stream) {
  using Cfg = TmaCfg<128, epi_deferred(EPI)>;
  static const cudaError_t smem_set = cudaFuncSetAttribute(
      gemm_tma<T, 128, false, EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::SMEM);
  (void)smem_set;
  const int o = std::is_same<T, __half>::value ? kF16 : kBF16;
  gemm_tma<T, 128, false, EPI><<<grid, Cfg::THREADS, Cfg::SMEM, stream>>>(
      map_a, map_b, map_a, out, o, M, N, K, epi);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int launch_tma_block(const void* a, const void* b, int group, const void* bias,
                            int bias_f32, const void* residual, void* out, int M, int N, int K,
                            int grid, cudaStream_t stream) {
  CUtensorMap map_a, map_b;
  int rc = make_map(&map_a, a, map_type<T>(), 2, M, K, BM, BK, CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc == 0)
    rc = group > 0 ? make_map_3d(&map_b, b, map_type<T>(), group, K, N / group,
                                 static_cast<long long>(group) * 2,
                                 static_cast<long long>(group) * K * 2, ATOM, BK,
                                 CU_TENSOR_MAP_SWIZZLE_128B)
                   : make_map(&map_b, b, map_type<T>(), 2, K, N, BK, ATOM,
                              CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc != 0) return rc;
  const BlockEpi epi{bias, bias_f32, residual, group};
  if (group > 0) return launch_block_epi<T, kEpiQkv>(map_a, map_b, out, M, N, K, epi, grid, stream);
  if (residual != nullptr)
    return launch_block_epi<T, kEpiBiasRes>(map_a, map_b, out, M, N, K, epi, grid, stream);
  return launch_block_epi<T, kEpiBias>(map_a, map_b, out, M, N, K, epi, grid, stream);
}

// csrc/convnext_block.cu's FC2 on `grid` CTAs: out (M, N) in T = residual
// + scale * (a (M, K) @ b (K, N) + bias), bias and scale f32 (bias_f32) or
// T. The plan (wgmma_plan.layer_scale_plan) checks the shape: as
// launch_tma_block's, but N >= 64 (one box of B inside the matrix).
template <typename T>
static int launch_tma_scale_res(const void* a, const void* b, const void* bias,
                                const void* scale, int bias_f32, const void* residual,
                                void* out, int M, int N, int K, int grid, cudaStream_t stream) {
  CUtensorMap map_a, map_b;
  int rc = make_map(&map_a, a, map_type<T>(), 2, M, K, BM, BK, CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc == 0)
    rc = make_map(&map_b, b, map_type<T>(), 2, K, N, BK, ATOM, CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc != 0) return rc;
  const BlockEpi epi{bias, bias_f32, residual, 0, scale};
  return launch_block_epi<T, kEpiBiasScaleRes>(map_a, map_b, out, M, N, K, epi, grid, stream);
}

// The tma form with bias and GELU in the epilogue (csrc/mlp_block.cu's
// FC1) on `grid` CTAs: out (M, N) in T = activate(a (M, K) @ b (K, N) +
// bias, act), act kActGeluExact or kActGeluTanh; bias f32 (bias_f32) or T.
// The plan's checks as launch_tma_block's.
template <typename T>
static int launch_tma_gelu(const void* a, const void* b, const void* bias, int bias_f32, int act,
                           void* out, int M, int N, int K, int grid, cudaStream_t stream) {
  CUtensorMap map_a, map_b;
  int rc = make_map(&map_a, a, map_type<T>(), 2, M, K, BM, BK, CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc == 0)
    rc = make_map(&map_b, b, map_type<T>(), 2, K, N, BK, ATOM, CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc != 0) return rc;
  const BlockEpi epi{bias, bias_f32, nullptr, 0};
  if (act == kActGeluExact)
    return launch_block_epi<T, kEpiBiasGelu>(map_a, map_b, out, M, N, K, epi, grid, stream);
  if (act == kActGeluTanh)
    return launch_block_epi<T, kEpiBiasGeluTanh>(map_a, map_b, out, M, N, K, epi, grid, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// gemm_tma_ra on `grid` CTAs once its maps are made; w (K, N) int8.
template <typename T, int WC, bool IM2COL>
static int launch_ra(const CUtensorMap& map_x, const void* w, Im2col geo, const float* scales,
                     void* out, int out_dtype, int M, int N, int K, int grid,
                     cudaStream_t stream) {
  using Cfg = RaCfg<WC>;
  CUtensorMap map_w;
  const int rc = make_map(&map_w, w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, K, N, BK, WC,
                          WC == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B);
  if (rc != 0) return rc;
  static const cudaError_t smem_set = cudaFuncSetAttribute(
      gemm_tma_ra<T, WC, IM2COL>, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::SMEM);
  (void)smem_set;
  gemm_tma_ra<T, WC, IM2COL><<<grid, 128 * (CONSUMERS + 1), Cfg::SMEM, stream>>>(
      map_x, map_w, geo, scales, out, out_dtype, M, N, K);
  return static_cast<int>(cudaGetLastError());
}

// The tma form with int8 W as the register operand, on `grid` CTAs.
template <typename T>
static int launch_tma_ra(const void* x, const void* w, const float* scales, void* out,
                         int out_dtype, int M, int N, int K, int grid, cudaStream_t stream) {
  CUtensorMap map_x;
  const int rc = make_map(&map_x, x, map_type<T>(), 2, M, K, BM, BK, CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc != 0) return rc;
  return launch_ra<T, RA_BW, false>(map_x, w, Im2col{}, scales, out, out_dtype, M, N, K, grid,
                                    stream);
}

// A stride-1 conv on gemm_tma_ra's im2col form: x (N, H, W, C) in T, w
// (kh kw C, Cout) int8 (HWIO), out (N Ho Wo, Cout) in T; tiles of WC
// output channels, `grid` CTAs. C % 64 == 0, Cout % 16 == 0, both bases
// 16-byte aligned (the plan's checks).
template <typename T, int WC>
static int launch_conv_ra(const void* x, const void* w, const float* scales, void* out, int N,
                          int H, int W, int C, int Ho, int Wo, int Cout, int kh, int kw, int pt,
                          int pl, int grid, cudaStream_t stream) {
  CUtensorMap map_x;
  const int rc = make_im2col_map(&map_x, x, map_type<T>(), N, H, W, C, Ho, Wo, pt, pl);
  if (rc != 0) return rc;
  const int o = std::is_same<T, __half>::value ? kF16 : kBF16;
  return launch_ra<T, WC, true>(map_x, w, Im2col{Ho * Wo, Wo, pt, pl, kw, C}, scales, out, o,
                                N * Ho * Wo, Cout, kh * kw * C, grid, stream);
}

// The cluster form with a K split of `split` CTAs of `k_chunk` rows each;
// recv (M, N) f32 or nullptr.
template <typename T, bool INT8_B>
static int launch_cluster(const void* a, const void* b, const float* scales, const float* recv,
                          void* out, int out_dtype, int M, int N, int K, int split, int k_chunk,
                          cudaStream_t stream) {
  static const cudaError_t smem_set = cudaFuncSetAttribute(
      gemm_cluster<T, INT8_B>, cudaFuncAttributeMaxDynamicSharedMemorySize, CL_SMEM);
  (void)smem_set;
  const bool a_vec = K % 8 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0;
  const bool b_vec = N % 8 == 0 && reinterpret_cast<uintptr_t>(b) % (INT8_B ? 8 : 16) == 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cdiv(N, CL_BN), cdiv(M, BM), split);
  cfg.blockDim = dim3(CL_THREADS);
  cfg.dynamicSmemBytes = CL_SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = split;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, gemm_cluster<T, INT8_B>,
                                           static_cast<const uint16_t*>(a), b, scales, recv, out,
                                           out_dtype, M, N, K, k_chunk, a_vec, b_vec);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

// The int8 tma form on `grid` CTAs: x (M, K) and w (K, N) int8, both
// 16-byte aligned, K % 16 == 0, N % 16 == 0 (the plan's checks).
template <typename OutT>
static int launch_tma_s8(const void* x, const void* w, const float* s_row, const float* s_col,
                         void* out, int M, int N, int K, int grid, cudaStream_t stream) {
  CUtensorMap map_x, map_w;
  int rc = make_map(&map_x, x, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, M, K, BM, S8_BK,
                    CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc == 0)
    rc = make_map(&map_w, w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, K, N, S8_BK, RA_BW,
                  CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc != 0) return rc;
  static const cudaError_t smem_set = cudaFuncSetAttribute(
      gemm_tma_s8<OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize, S8_SMEM);
  (void)smem_set;
  gemm_tma_s8<OutT><<<grid, 128 * (CONSUMERS + 1), S8_SMEM, stream>>>(
      map_x, map_w, s_row, s_col, static_cast<OutT*>(out), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

// The int8 cluster form with a K split of `split` CTAs of `k_chunk` rows
// each; x int8, or f32/bf16/f16 quantized at s_row as it loads.
template <typename OutT, typename TX>
static int launch_cluster_s8(const TX* x, const int8_t* w, const float* s_row,
                             const float* s_col, void* out, int M, int N, int K, int split,
                             int k_chunk, cudaStream_t stream) {
  static const cudaError_t smem_set = cudaFuncSetAttribute(
      gemm_cluster_s8<OutT, TX>, cudaFuncAttributeMaxDynamicSharedMemorySize, S8_CL_SMEM);
  (void)smem_set;
  const bool x_vec = K * static_cast<int>(sizeof(TX)) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool w_vec = N % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 4 == 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cdiv(N, CL_BN), cdiv(M, BM), split);
  cfg.blockDim = dim3(CL_THREADS);
  cfg.dynamicSmemBytes = S8_CL_SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = split;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, gemm_cluster_s8<OutT, TX>, x, w, s_row, s_col,
                         static_cast<OutT*>(out), M, N, K, k_chunk, x_vec, w_vec);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

// The form a plan names (smelter_tpu_torch/kernels/wgmma_plan.py).
enum Form : int { kFormTma = 1, kFormCluster = 2 };

}  // namespace
}  // namespace wg
}  // namespace smelter
