// The port's Hopper GEMM core (sm_90a): wgmma.mma_async with f32
// accumulators, TMA loads (cp.async.bulk.tensor) into a ring of shared-memory
// stages guarded by mbarriers, and thread-block clusters that sum a K split
// through distributed shared memory. Raw PTX in the style of common.cuh.
// Three kernels, shared by csrc/dequant_matmul.cu and csrc/collective_matmul.cu:
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
//
// gemm_tma_ra (the "tma" form for an int8 B, dequant_matmul's W): the same
//   pipeline with the product transposed. The int8 W box (64 x 128 bytes,
//   128-byte swizzled) is W^T's A operand: each consumer thread loads its
//   bytes of mma.m16n8k16's A fragment (4 rows x 2 words a load, no bank
//   conflict) and converts them in registers (two register sets, one per
//   step in flight); the x box is B, K-major. The accumulator is out^T, 64 W
//   columns x 128 x rows a warpgroup; two steps' groups overlap, each with
//   its own register set. W never goes back to shared memory in
//   16 bits: a K step moves 64 KB through shared memory (TMA 24, W loads 8,
//   wgmma's B 32), where converting W into a 16-bit B tile there moves 96 KB
//   (TMA 24, conversion 24, wgmma 48).
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
//   applies the epilogue and stores. One launch, no global workspace, and
//   the sum's order is fixed, so two calls agree bit for bit.
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
//   int8 -> bf16/f16 is exact: s8 + 128 as the low byte of a float 2^23
//     (bf16: then - (2^23 + 128) and cvt.rn.bf16x2), or of a half 1024 (f16:
//     then - 1152 in f16x2).
//
// Sizes (bytes): tma form, a stage = A 16,384 + B (bf16: BN x 128; int8:
// BN x 64); gemm_tma adds 32,768 for the epilogue's two 64 x 64 sub-tiles:
//   BN 128 bf16: 6 stages, 230,496
//   BN 128 int8: 8 stages, 197,760
// Cluster form: 3 stages of 16,384 + 8,192 and 1 KB for alignment, 74,752;
// the f32 partials (128 x 72 floats, 36,864) reuse the stages.
// smelter_tpu_torch/kernels/wgmma_plan.py mirrors these numbers and picks
// the form, BN and S for a shape.
#pragma once

#include <cooperative_groups.h>
#include <cuda.h>

#include <type_traits>

#include "common.cuh"

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

// A shared-memory matrix descriptor with the 128-byte swizzle (layout type 1).
__device__ __forceinline__ uint64_t desc(const void* smem, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(smem) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
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

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
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
// Sub-tile element (r, c) = v, in the output type.
__device__ __forceinline__ void epi_put(uint8_t* epi, int out_dtype, int r, int c, float v) {
  uint8_t* p = epi_at(epi, elem_bytes(out_dtype), r, c);
  if (out_dtype == kF32)
    *reinterpret_cast<float*>(p) = v;
  else if (out_dtype == kBF16)
    *reinterpret_cast<__nv_bfloat16*>(p) = __float2bfloat16(v);
  else
    *reinterpret_cast<__half*>(p) = __float2half(v);
}
// Sub-tile elements (r, c), (r, c + 1) = v0, v1; c even.
__device__ __forceinline__ void epi_put2(uint8_t* epi, int out_dtype, int r, int c, float v0,
                                         float v1) {
  uint8_t* p = epi_at(epi, elem_bytes(out_dtype), r, c);
  if (out_dtype == kF32)
    *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
  else if (out_dtype == kBF16)
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
  else
    *reinterpret_cast<__half2*>(p) = __floats2half2_rn(v0, v1);
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

// -- the tma form -------------------------------------------------------------

template <int BN>
struct TmaCfg {
  static constexpr int THREADS = 128 * (CONSUMERS + 1);
  static constexpr int A_BYTES = BM * BK * 2;
  static constexpr int B_BYTES = BK * BN * 2;
  static constexpr int FIT = (SMEM_BUDGET - 1024 - CONSUMERS * EPI_WG) / (A_BYTES + B_BYTES);
  static constexpr int STAGES = FIT > 8 ? 8 : FIT;
  static constexpr int SMEM =
      1024 + STAGES * (A_BYTES + B_BYTES) + CONSUMERS * EPI_WG + 16 * STAGES;
  static_assert(SMEM <= 232448, "more shared memory than a block may have");
};

// out (M, N) = A (M, K) @ B, A a (M, K) T map (box 64 x 128, swizzled), B a
// (K, N) T map (box 64 x 64, swizzled); out in the type `out_dtype` names.
template <typename T, int BN>
__global__ void __launch_bounds__(TmaCfg<BN>::THREADS, 1)
gemm_tma(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
         void* __restrict__ out, int out_dtype, int M, int N, int K) {
  using Cfg = TmaCfg<BN>;
  constexpr int STAGES = Cfg::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sa = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sb = sa + STAGES * Cfg::A_BYTES;
  uint8_t* se = sb + STAGES * Cfg::B_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(se + CONSUMERS * EPI_WG);
  uint64_t* empty = full + STAGES;
  const int nt = div_up(N, BN), tiles = div_up(M, BM) * nt, KT = div_up(K, BK);

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
        for (int kt = 0; kt < KT; ++kt) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], Cfg::A_BYTES + Cfg::B_BYTES);
          tma_load_2d(sa + stage * Cfg::A_BYTES, &map_a, &full[stage], kt * BK, m0);
          uint8_t* b = sb + stage * Cfg::B_BYTES;
#pragma unroll
          for (int j = 0; j < BN / ATOM; ++j)
            tma_load_2d(b + j * BK * 128, &map_b, &full[stage], n0 + j * ATOM, kt * BK);
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
  float acc[BN / 2];
  int stage = 0, phase = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = (tile / nt) * BM, n0 = (tile % nt) * BN;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    int prev1 = -1, prev2 = -1;  // the stages of the last two steps
    for (int kt = 0; kt < KT; ++kt) {
      mbar_wait(&full[stage], phase);
      wgmma_fence();
      mma_bk<T, BN>(acc, sa + stage * Cfg::A_BYTES + wgi * 64 * 128, sb + stage * Cfg::B_BYTES);
      wgmma_commit();
      wgmma_wait<2>();  // two steps back has retired: its stage is free
      if (prev2 >= 0 && (ct & 127) == 0) mbar_arrive(&empty[prev2]);
      prev2 = prev1;
      prev1 = stage;
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if ((ct & 127) == 0) {
      if (prev2 >= 0) mbar_arrive(&empty[prev2]);
      if (prev1 >= 0) mbar_arrive(&empty[prev1]);
    }
    // acc[4j + 2h + e] = out (row 16 warp + g + 8h, column 8j + 2t + e)
    uint8_t* epi = se + wgi * EPI_WG;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int c = 0; c < BN / 64; ++c) {
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 4 * (8 * c + jj) + 2 * h;
          epi_put2(epi, out_dtype, warp * 16 + g + 8 * h, 8 * jj + 2 * t, acc[i], acc[i + 1]);
        }
      named_sync(1 + wgi, 128);
      epi_flush(epi, out, out_dtype, M, N, m0 + wgi * 64, n0 + 64 * c, ct & 127);
      named_sync(1 + wgi, 128);
    }
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

constexpr int RA_BW = 128;                  // W columns a tile: two warpgroups of 64
constexpr int RA_W_BYTES = BK * RA_BW;      // the int8 W box, 128-byte swizzled
constexpr int RA_A_BYTES = BM * BK * 2;     // the x box
constexpr int RA_STAGES_FIT = (SMEM_BUDGET - 1024) / (RA_A_BYTES + RA_W_BYTES);
constexpr int RA_STAGES = RA_STAGES_FIT > 8 ? 8 : RA_STAGES_FIT;
constexpr int RA_SMEM = 1024 + RA_STAGES * (RA_A_BYTES + RA_W_BYTES) + 16 * RA_STAGES;

// out (M, N) = x (M, K) @ W (K, N) * scales, computed as its transpose: each
// consumer warpgroup's wgmma takes 64 W columns as its A operand, converted
// from the int8 box straight into mma.m16n8k16's A-fragment registers, and
// the x tile (128 rows, K-major in shared memory) as B; its accumulator is
// out^T (64 W columns x 128 x rows). W is never written back to shared
// memory in 16 bits.
template <typename T>
__global__ void __launch_bounds__(128 * (CONSUMERS + 1), 1)
gemm_tma_ra(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_w,
            const float* __restrict__ scales, void* __restrict__ out, int out_dtype, int M,
            int N, int K) {
  constexpr int STAGES = RA_STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sx = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sw = sx + STAGES * RA_A_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(sw + STAGES * RA_W_BYTES);
  uint64_t* empty = full + STAGES;
  const int nt = div_up(N, RA_BW), tiles = div_up(M, BM) * nt, KT = div_up(K, BK);

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
        const int m0 = (tile / nt) * BM, n0 = (tile % nt) * RA_BW;
        for (int kt = 0; kt < KT; ++kt) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], RA_A_BYTES + RA_W_BYTES);
          tma_load_2d(sx + stage * RA_A_BYTES, &map_x, &full[stage], kt * BK, m0);
          tma_load_2d(sw + stage * RA_W_BYTES, &map_w, &full[stage], n0, kt * BK);
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
  const int nr = wgi * 64 + warp * 16 + g;  // this thread's first W column in the tile
  float acc[RA_BW / 2];
  uint32_t ra0[BK / 16][4], ra1[BK / 16][4];  // A fragments of two steps in flight
  int stage = 0, phase = 0;

  // One K step: W's fragments from the int8 box (bytes (k, n) of a 128-byte
  // swizzled row: 4 rows x 2 words a load, no bank conflict), then four
  // wgmma k16 on them.
  auto step = [&](uint32_t (&a)[BK / 16][4], const uint8_t* w, const uint8_t* x) {
    auto byte = [&](int k, int n) -> uint32_t {
      return w[k * 128 + (((n >> 4) ^ (k & 7)) << 4) + (n & 15)];
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
    const int m0 = (tile / nt) * BM, n0 = (tile % nt) * RA_BW;
#pragma unroll
    for (int i = 0; i < RA_BW / 2; ++i) acc[i] = 0.f;
    int prev = -1;
    for (int kt = 0; kt < KT; ++kt) {
      mbar_wait(&full[stage], phase);
      const uint8_t* w = sw + stage * RA_W_BYTES;
      const uint8_t* x = sx + stage * RA_A_BYTES;
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
    // acc[4j + 2h + e] = out^T (W column nr + 8h, x row 8j + 2t + e); for a
    // fixed (j, h, e) a warp stores 4 rows of 16 contiguous bytes
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = n0 + nr + 8 * h;
      if (col >= N) continue;
      const float sc = scales[col];
#pragma unroll
      for (int j = 0; j < BM / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int row = m0 + 8 * j + 2 * t + e;
          if (row < M)
            put(out, out_dtype, static_cast<size_t>(row) * N + col,
                __fmul_rn(acc[4 * j + 2 * h + e], sc));
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

// out (M, N) = A (M, K) @ B [* scales] for any shape: A (M, K) row-major in T;
// B (K, N) row-major, T or (INT8_B) int8. Grid (N / 64, M / 128, S), a
// cluster of (1, 1, S); CTA z takes K rows [z k_chunk, (z + 1) k_chunk).
// A_VEC / B_VEC: 16-byte (int8: 8-byte) loads, when K (N) and the base
// allow; otherwise one element at a time.
template <typename T, bool INT8_B>
__global__ void __launch_bounds__(CL_THREADS)
gemm_cluster(const uint16_t* __restrict__ A, const void* __restrict__ Bv,
             const float* __restrict__ scales, void* __restrict__ out, int out_dtype, int M,
             int N, int K, int k_chunk, bool a_vec, bool b_vec) {
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
    if (row < M && col < N)
      put(out, out_dtype, static_cast<size_t>(row) * N + col, scaled(v, scales, col));
  }
  cluster.sync();  // no rank leaves while another still reads its partial
}

// -- host side ----------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime (no
// -lcuda at build time).
static EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                     &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// A map of the row-major (rows, cols) matrix at `base`, boxes of (box_rows,
// box_cols); `swizzle`: the 128-byte swizzle. Returns a cudaError_t code.
static int make_map(CUtensorMap* map, const void* base, CUtensorMapDataType type,
                    int elem_bytes, int rows, int cols, int box_rows, int box_cols,
                    bool swizzle) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * elem_bytes};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t step[2] = {1, 1};
  const CUresult r = fn(map, type, 2, const_cast<void*>(base), dims, strides, box, step,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
constexpr CUtensorMapDataType map_type() {
  return std::is_same<T, __half>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                        : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

// The tma form on `grid` CTAs: a (M, K) and b (K, N) in T. Returns a
// cudaError_t code.
template <typename T, int BN>
static int launch_tma(const void* a, const void* b, void* out, int out_dtype, int M, int N,
                      int K, int grid, cudaStream_t stream) {
  using Cfg = TmaCfg<BN>;
  CUtensorMap map_a, map_b;
  int rc = make_map(&map_a, a, map_type<T>(), 2, M, K, BM, BK, true);
  if (rc == 0) rc = make_map(&map_b, b, map_type<T>(), 2, K, N, BK, ATOM, true);
  if (rc != 0) return rc;
  static const cudaError_t smem_set = cudaFuncSetAttribute(
      gemm_tma<T, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::SMEM);
  (void)smem_set;  // a refusal shows as the launch's error
  gemm_tma<T, BN><<<grid, Cfg::THREADS, Cfg::SMEM, stream>>>(map_a, map_b, out, out_dtype, M, N,
                                                            K);
  return static_cast<int>(cudaGetLastError());
}

// The tma form with int8 W as the register operand, on `grid` CTAs.
template <typename T>
static int launch_tma_ra(const void* x, const void* w, const float* scales, void* out,
                         int out_dtype, int M, int N, int K, int grid, cudaStream_t stream) {
  CUtensorMap map_x, map_w;
  int rc = make_map(&map_x, x, map_type<T>(), 2, M, K, BM, BK, true);
  if (rc == 0) rc = make_map(&map_w, w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, K, N, BK, RA_BW, true);
  if (rc != 0) return rc;
  static const cudaError_t smem_set = cudaFuncSetAttribute(
      gemm_tma_ra<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, RA_SMEM);
  (void)smem_set;
  gemm_tma_ra<T><<<grid, 128 * (CONSUMERS + 1), RA_SMEM, stream>>>(map_x, map_w, scales, out,
                                                                 out_dtype, M, N, K);
  return static_cast<int>(cudaGetLastError());
}

// The cluster form with a K split of `split` CTAs of `k_chunk` rows each.
template <typename T, bool INT8_B>
static int launch_cluster(const void* a, const void* b, const float* scales, void* out,
                          int out_dtype, int M, int N, int K, int split, int k_chunk,
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
                                           static_cast<const uint16_t*>(a), b, scales, out,
                                           out_dtype, M, N, K, k_chunk, a_vec, b_vec);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

// The form a plan names (smelter_tpu_torch/kernels/wgmma_plan.py).
enum Form : int { kFormTma = 1, kFormCluster = 2 };

}  // namespace
}  // namespace wg
}  // namespace smelter
