// Float activations quantized per row inside an int8 GEMM, for Hopper:
// out = float(q(x) @ w_q) * s_row[m] * s_col[n], with
// q(x)[m, k] = clamp(round_half_even(x[m, k] / s_row[m]), -127, 127).
//
// Replaces smelter_tpu/kernels/int8_matmul.py::_int8_matmul_fused_impl
// (dequant_matmul_int8_fused: manual DMA of x into a VMEM int8 panel that
// every N block of the row panel reuses) and ::_int8_matmul_fused2_impl
// (dequant_matmul_int8_fused2: quantize-on-revisit). Both compute
// quantize_rows -> the int8 GEMM -> acc * s_row * s_col, the function of
// the two-pass dequant_matmul_int8, without x_q in device memory.
//
// What bounds them on an H100: at the serving GEMM (M 8192, K 4096, N 4096)
// the int8 tensor cores (~139 us at 1,979 TOP/s), with the CUDA-core work
// of quantizing x (once a 256-column tile in the revisit form: 537 M
// values, four instructions each) behind it and, on the card, ahead of it;
// at the ResNet-50 head (M 128, K 2048, N 1000) HBM (~2.8 MB, ~0.85 us at
// 3.35 TB/s).
//
// Design:
// - dequant_matmul_int8_fused: the panel form where it fits, else
//   _fused2's forms; kernels/wgmma_plan.py::fused_plan picks from the
//   shape, three of the forms on the int8 wgmma core (csrc/wgmma_gemm.cuh):
//   * panel (gemm_panel_qx; aligned shapes with work units enough to fill
//     the card's clusters: the serving GEMM): the Pallas kernel's point, x read from device memory once as
//     floats and quantized once, kept for every N tile. A CTA holds the
//     quantized rows of a 128-row panel resident in shared memory; a 128 x
//     4,096 int8 panel is 512 KB, so the panel's K is split over a cluster
//     of S = 4 or 8 CTAs (rank r holds K bytes [r kc, (r + 1) kc), 128 KB at
//     K 4,096 and S 4). The producer thread TMA-loads x's float boxes (64
//     rows x 128 bf16/f16, or 32 rows x 128 f32: 16 KB, no swizzle) into the
//     ring of W stages; the two consumer warpgroups divide each element by
//     its row's scale (__fdiv_rn), round half to even, clip to [-127, 127]
//     and write the bytes K-major with the 128-byte swizzle, the layout
//     wgmma reads as its B operand. Then the cluster sweeps N tiles of 128 W
//     columns against the panel as gemm_tma_s8 does: W's box (128 K rows x
//     128 columns) by TMA, W^T wgmma.m64n128k32's register operand, the
//     stage freed as soon as W is in registers. Rank r stores x rows
//     [128 r / S, 128 (r + 1) / S) of each tile: every CTA adds the int32
//     sums of the others' rows into their shared memory (64-bit adds of two
//     biased sums through distributed shared memory, into two buffers a
//     tile apart), keeps its own in registers, and after a cluster barrier
//     applies the epilogue to its rows. Integer addition is exact in any
//     order, so the result is bit for bit the two-pass path's. The clusters
//     are persistent, as many as fit the card at once (30 of 4 on an H100
//     SXM), each a run of (panel, N tile) units: one CTA a panel left 64
//     panels in 3 waves. 0.752 ms at the serving GEMM, 8 ranks 1.121 (NVIDIA
//     H100 80GB HBM3, 700 W; experiments/torch_patch_fused_timing.py). The
//     exchange and its barrier take about a third of it (diagnostic builds
//     without them); exchanging through device memory instead ran slower.
//   * cluster (few output tiles, any alignment: the ResNet-50 head, whose N
//     1,000 is no TMA stride): gemm_cluster_s8 of wgmma_gemm.cuh with x in
//     its float type, which it quantizes as each 128 x 64 tile loads it. K
//     split over up to 8 CTAs, int32 partials summed in rank order through
//     distributed shared memory. Each N tile quantizes the x rows it stages.
//   * revisit and mma: shapes the panel form turns down (K 4,097-4,480 or
//     past 9,216, N % 16, an unaligned base) take _fused2's forms below.
//     The cluster form on one rank took 5.01 ms at the serving GEMM against
//     the mma.sync kernel's 1.89 (NVIDIA H100 80GB HBM3, 700 W; experiments/
//     torch_patch_fused_timing.py), so many tiles never take it. No K is
//     refused.
// - dequant_matmul_int8_fused2, quantize-on-revisit: a row's int32
//   accumulator across N (2 MB at 128 rows, N 4,096) fits no SM, so each
//   output tile quantizes the x boxes it stages and x is reread through L2.
//   wgmma_plan.revisit_plan picks the form:
//   * revisit (gemm_revisit_qx below, form 3; aligned shapes with tiles
//     enough: the serving GEMM): persistent, one CTA an SM, gemm_tma_s8's
//     tile order. TMA brings each K step's x float box and W boxes into a
//     ring; the warps quantize the x box into wgmma's K-major int8 B
//     operand with no division (Markstein's correction of x fl(1/s): the
//     IEEE quotient quantize_rows takes, bit for bit), then the consumers
//     run gemm_tma_s8's product, W^T the register A operand. 256-column
//     tiles (two W boxes, 128 int32 accumulators a thread, setmaxnreg
//     moving the producer's registers to the consumers) halve the x reads
//     and the quantizing of 128-column ones, which the plan takes where
//     256-column tiles are too few to fill the card; a step's quantizing
//     runs under the step before's wgmma groups. 0.583 ms at the serving
//     GEMM with the row scales' pass, 0.139 its bound: the quantizing sets
//     the pace (NVIDIA H100 80GB HBM3, 700 W;
//     experiments/torch_patch_fused_timing.py).
//   * cluster (few tiles: the head), as for _fused.
//   * mma (int8_matmul_qx below, form 0; what the maps cannot read: N % 16,
//     an unaligned base): int8_gemm.cuh's 128 x 128 mma.sync.m16n8k32 tile
//     with another A loader, which reads the float x tile (bf16, f16 or
//     f32), divides by s_row with IEEE division (__fdiv_rn: quantize_rows
//     divides, no reciprocal), rounds half to even (__float2int_rn), clips
//     to [-127, 127] and stores int8 [m][k]. No cp.async, TMA or wgmma.
// The epilogue is __fmul_rn(__fmul_rn(float(acc), s_row), s_col), then one
// rounding to out_dtype, as the Pallas kernels do. M, N and K edges are
// masked (the TMA maps fill zeros past M and K).
#include "wgmma_gemm.cuh"

namespace smelter {
namespace wg {
namespace {

template <typename T>
constexpr CUtensorMapDataType x_map_type() {
  return std::is_same<T, float>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : map_type<T>();
}

// -- W^T as wgmma's register operand (gemm_tma_s8's gather) --------------------

// The byte permute that undoes lane t's rotated K-row order: byte i <- byte
// (i - t) & 3.
__device__ __forceinline__ uint32_t wt_rotation(int t) {
  uint32_t rot = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) rot |= static_cast<uint32_t>((i - t) & 3) << (4 * i);
  return rot;
}

// This thread's A fragments of W^T for one 128-byte K step, from a W box of
// 128 K rows x 128 columns (128-byte swizzle): W column pair nb of the box
// (A rows g and g + 8 of the warp), K rows read in the lane-rotated order of
// gemm_tma_s8 (no two lanes of a load on one bank), bytes put back in K
// order by byte permutes.
__device__ __forceinline__ void wt_fragments(uint32_t (&a)[S8_BK / 32][4], const uint8_t* w,
                                             int nb, int t, uint32_t rot) {
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
}

// -- the panel form -----------------------------------------------------------

constexpr int QP_SLOT = 16384;  // a ring slot: one x landing box or one W box
constexpr int QP_THREADS = 128 * (CONSUMERS + 1);
constexpr int QP_EX = 256;      // consumer threads: the exchange buffers' row length
constexpr int QP_BIAS = 1 << 25;  // a sum's bias in the exchange: |sum| < 2^25 at k_chunk <= 1,152

// Rows of an x landing box: 128 elements (S8_BK bytes once quantized) a row.
template <typename T>
__host__ __device__ constexpr int qp_box_rows() {
  return QP_SLOT / (S8_BK * static_cast<int>(sizeof(T)));
}
// Bytes: alignment, the panel (kb K blocks of 128 rows x 128 bytes), the
// ring and its two mbarriers a stage, the two exchange buffers of (64 / S)
// int32 sums a consumer thread (in 64-bit pairs).
__host__ __device__ constexpr int qp_smem(int S, int kb, int stages) {
  return 1024 + kb * S8_BOX + stages * (QP_SLOT + 16) + 2 * (64 / S) * QP_EX * 4;
}

// The cluster barrier in two halves, for threads that reach it apart (the
// producer thread between its loads): arrive (release) and wait (acquire).
__device__ __forceinline__ void qp_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void qp_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}
// This CTA's shared address `addr` in rank q's shared memory (shared::cluster).
__device__ __forceinline__ uint32_t mapa(uint32_t addr, int q) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(q));
  return r;
}
// A 64-bit add into another CTA's shared memory, returning nothing.
__device__ __forceinline__ void red_add_cluster(uint32_t addr, unsigned long long v) {
  asm volatile("red.relaxed.cluster.shared::cluster.add.u64 [%0], %1;\n" ::"r"(addr), "l"(v)
               : "memory");
}

// out (M, N) = float(q(x) @ W) * s_row * s_col with q(x) quantized into a
// resident panel. Grid (S, C): C persistent clusters of the S ranks; rank r
// sums K [r k_chunk, (r + 1) k_chunk) (k_chunk a multiple of 128; past K
// the maps read zeros). The work units, (128-row panel, N tile) with tiles
// fastest, are split evenly over the clusters; a cluster quantizes a panel
// when its run of units enters it (at most once, so a panel's x is read
// and quantized once, or twice where two clusters share it). After unit
// i's K loop a rank adds the sums of the other ranks' rows into their
// buffer i & 1, keeps its own rows' in registers, and arrives on the
// cluster barrier; after unit i + 1's K loop it waits there (every rank has
// added unit i's sums, and has read and cleared its buffer (i + 1) & 1's
// unit i - 1), stores unit i's rows and clears the buffer. Every thread of
// the cluster arrives and waits once a unit and once before the first.
template <typename T, typename OutT, int S>
__global__ void __launch_bounds__(QP_THREADS, 1)
gemm_panel_qx(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_w,
              const float* __restrict__ s_row, const float* __restrict__ s_col,
              OutT* __restrict__ out, int M, int N, int K, int k_chunk, int stages) {
  static_assert(S == 4 || S == 8, "4 or 8 ranks");
  constexpr int JR = 16 / S;       // 8-row groups of a tile a rank stores
  constexpr int OWN = 4 * JR;      // sums a consumer thread holds for its rank's rows
  constexpr int LR = qp_box_rows<T>();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* panel = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int kb_n = k_chunk / S8_BK;
  uint8_t* ring = panel + kb_n * S8_BOX;
  // [2][OWN / 2][QP_EX]: pairs of sums, each biased by QP_BIAS, in one word
  auto* xbuf = reinterpret_cast<unsigned long long*>(ring + stages * QP_SLOT);
  uint64_t* full = reinterpret_cast<uint64_t*>(xbuf + OWN * QP_EX);
  uint64_t* empty = full + stages;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int k0 = rank * k_chunk;
  const int nt = div_up(N, RA_BW), boxes = kb_n * (BM / LR);
  const long long units = static_cast<long long>(div_up(M, BM)) * nt;
  const int u0 = static_cast<int>(units * blockIdx.y / gridDim.y);
  const int u1 = static_cast<int>(units * (blockIdx.y + 1) / gridDim.y);
  // unit u enters a new panel: the cluster's first unit, or the first of a panel
  auto fresh = [&](int u) { return u == u0 || u % nt == 0; };

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS * 128);  // every consumer thread, once done reading
    }
    mbar_fence_init();
  }
  for (int i = static_cast<int>(threadIdx.x); i < OWN * QP_EX; i += QP_THREADS) xbuf[i] = 0ull;
  __syncthreads();
  qp_arrive();  // every rank's buffers are clear before any rank adds into them
  qp_wait();

  if (threadIdx.x < 128) {  // the producer warpgroup: one thread issues every load
    if (threadIdx.x == 0) {
      int stage = 0, phase = 0;
      auto load = [&](const CUtensorMap* map, int c0, int c1) {
        mbar_wait(&empty[stage], phase ^ 1);
        mbar_expect_tx(&full[stage], QP_SLOT);
        tma_load_2d(ring + stage * QP_SLOT, map, &full[stage], c0, c1);
        if (++stage == stages) {
          stage = 0;
          phase ^= 1;
        }
      };
      for (int u = u0; u < u1; ++u) {
        const int m0 = u / nt * BM;
        if (fresh(u))  // the panel's float boxes, K block by K block
          for (int b = 0; b < boxes; ++b)
            load(&map_x, k0 + (b / (BM / LR)) * S8_BK, m0 + (b % (BM / LR)) * LR);
        for (int kb = 0; kb < kb_n; ++kb) load(&map_w, u % nt * RA_BW, k0 + kb * S8_BK);
        if (u > u0) qp_wait();
        qp_arrive();
      }
      if (u1 > u0) qp_wait();
    } else {
      for (int u = u0; u < u1; ++u) {
        qp_arrive();
        qp_wait();
      }
    }
    return;
  }

  const int ct = threadIdx.x - 128, wgi = ct >> 7, warp = (ct >> 5) & 3, lane = ct & 31;
  const int g = lane >> 2, t4 = lane & 3;
  int stage = 0, phase = 0;
  auto advance = [&] {
    if (++stage == stages) {
      stage = 0;
      phase ^= 1;
    }
  };

  // the panel of rows m0..: each box's 8-element groups, 16 a row,
  // consecutive threads along a row; each group's 8 bytes go to their
  // swizzled place
  auto quantize = [&](int m0) {
    for (int b = 0; b < boxes; ++b) {
      const int kb = b / (BM / LR), r0 = (b % (BM / LR)) * LR;
      mbar_wait(&full[stage], phase);
      const T* box = reinterpret_cast<const T*>(ring + stage * QP_SLOT);
#pragma unroll
      for (int i = 0; i < LR * 16 / QP_EX; ++i) {
        const int c = ct + i * QP_EX, r = r0 + (c >> 4), kbyte = (c & 15) * 8;
        const float s = m0 + r < M ? s_row[m0 + r] : 1.f;
        alignas(16) T v[8];
        const uint4* src = reinterpret_cast<const uint4*>(box + (c >> 4) * S8_BK + kbyte);
#pragma unroll
        for (int u = 0; u < static_cast<int>(sizeof(T)) / 2; ++u)
          reinterpret_cast<uint4*>(v)[u] = src[u];
        *reinterpret_cast<uint2*>(panel + kb * S8_BOX + r * 128 +
                                  (((kbyte >> 4) ^ (r & 7)) << 4) + (kbyte & 15)) =
            make_uint2(quant4(v, s), quant4(v + 4, s));
      }
      mbar_arrive(&empty[stage]);  // this thread's reads of the box are done
      advance();
    }
    fence_proxy_async();  // the panel, before wgmma reads it
    named_sync(3, 256);
  };

  const int nb = wgi * 64 + warp * 16 + 2 * g;  // this thread's W column pair in the tile
  const uint32_t rot = wt_rotation(t4);
  int acc[64], own[OWN];
  uint32_t ra0[S8_BK / 32][4], ra1[S8_BK / 32][4];
  uint32_t dst[S];  // each rank's exchange buffers, this thread's column (shared::cluster)
#pragma unroll
  for (int q = 0; q < S; ++q) dst[q] = mapa(smem_u32(xbuf + ct), q);

  auto step = [&](uint32_t (&a)[S8_BK / 32][4], const uint8_t* w, const uint8_t* x) {
    wt_fragments(a, w, nb, t4, rot);
    wgmma_fence();
    const uint64_t db = desc(x, 16, 1024);
#pragma unroll
    for (int kk = 0; kk < S8_BK / 32; ++kk) mma_s8_rs_m64n128k32(acc, a[kk], db + 2 * kk);
    wgmma_commit();
  };
  // unit u's rows of this rank (its i-th unit): its own sums plus the S - 1
  // others' (each word holds two sums, each biased by QP_BIAS once a
  // sender), then clear
  auto store = [&](int u, int i) {
    unsigned long long* mine = xbuf + (i & 1) * (OWN / 2) * QP_EX + ct;
    int sum[OWN];
#pragma unroll
    for (int p = 0; p < OWN / 2; ++p) {
      const unsigned long long v = mine[p * QP_EX];
      mine[p * QP_EX] = 0ull;
      sum[2 * p] = own[2 * p] + static_cast<int>(static_cast<unsigned>(v) - (S - 1) * QP_BIAS);
      sum[2 * p + 1] =
          own[2 * p + 1] + static_cast<int>(static_cast<unsigned>(v >> 32) - (S - 1) * QP_BIAS);
    }
    const int col = u % nt * RA_BW + nb, m0 = u / nt * BM;
    if (col < N) {  // N % 16 == 0: col + 1 < N with it
      const float sc0 = s_col[col], sc1 = s_col[col + 1];
#pragma unroll
      for (int jj = 0; jj < JR; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int row = m0 + 8 * (rank * JR + jj) + 2 * t4 + e;
          const int a0 = 4 * jj + e, a1 = a0 + 2;
          if (row < M)
            put_s8_pair(out, static_cast<size_t>(row) * N + col, sum[a0], sum[a1], s_row[row],
                        sc0, sc1);
        }
    }
  };

  for (int u = u0; u < u1; ++u) {
    const int i = u - u0;
    if (fresh(u)) {
      if (i > 0) named_sync(3, 256);  // both warpgroups are done with the last panel
      quantize(u / nt * BM);
    }
#pragma unroll
    for (int j = 0; j < 64; ++j) acc[j] = 0;
    for (int kb = 0; kb < kb_n; ++kb) {
      mbar_wait(&full[stage], phase);
      const uint8_t* w = ring + stage * QP_SLOT;
      if (kb & 1)
        step(ra1, w, panel + kb * S8_BOX);
      else
        step(ra0, w, panel + kb * S8_BOX);
      // W went into registers: its stage is free before the group retires
      mbar_arrive(&empty[stage]);
      wgmma_wait<1>();  // the step before retired: its registers are free
      advance();
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (i > 0) {
      qp_wait();
      store(u - 1, i - 1);
    }
    // acc[4j + 2h + e]: W column nb + h, x row 8j + 2t4 + e; rank j / JR
    // stores it. A pair of sums goes as one 64-bit add, each half biased to
    // [0, 2^26) (|sum| <= 127 * 128 * 1,152 < QP_BIAS), so that S - 1 of
    // them never carry out of their 32 bits: the halves stay exact.
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int h = 0; h < 4; h += 2) {
        const int q = j / JR, a = 4 * (j % JR) + h;
        if (q == rank) {
          own[a] = acc[4 * j + h];
          own[a + 1] = acc[4 * j + h + 1];
        } else {
          const unsigned long long v =
              static_cast<unsigned>(acc[4 * j + h] + QP_BIAS) |
              static_cast<unsigned long long>(static_cast<unsigned>(acc[4 * j + h + 1] + QP_BIAS))
                  << 32;
          red_add_cluster(dst[q] + ((i & 1) * (OWN / 2) + a / 2) * QP_EX * 8, v);
        }
      }
    qp_arrive();
  }
  if (u1 > u0) {
    qp_wait();
    store(u1 - 1, u1 - 1 - u0);
  }
}

// The panel form: grid (S, C) in clusters of S, C = the clusters that fit
// the card at once (cudaOccupancyMaxActiveClusters, read once a shared
// memory size), at most one a unit; x (M, K) in T and w (K, N) int8, both
// 16-byte aligned, K sizeof(T) % 16 == 0, N % 16 == 0, M, N, K >= 128 (the
// plan's checks).
template <typename T, typename OutT, int S>
static int launch_panel_qx(const void* x, const void* w, const float* s_row, const float* s_col,
                           void* out, int M, int N, int K, int k_chunk, int stages,
                           cudaStream_t stream) {
  const int smem = qp_smem(S, k_chunk / S8_BK, stages);
  if (k_chunk <= 0 || k_chunk % S8_BK || k_chunk > 1152 || stages < 2 || smem > 232448)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map_x, map_w;
  int rc = make_map(&map_x, x, x_map_type<T>(), sizeof(T), M, K, qp_box_rows<T>(), S8_BK,
                    CU_TENSOR_MAP_SWIZZLE_NONE);
  if (rc == 0)
    rc = make_map(&map_w, w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, K, N, S8_BK, RA_BW,
                  CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc != 0) return rc;
  static const cudaError_t smem_set = cudaFuncSetAttribute(
      gemm_panel_qx<T, OutT, S>, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
  (void)smem_set;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(S, 1, 1);
  cfg.blockDim = dim3(QP_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  static int fit_smem = -1, fit = 0;  // co-resident clusters at shared memory fit_smem
  if (fit_smem != smem) {
    const cudaError_t e = cudaOccupancyMaxActiveClusters(&fit, gemm_panel_qx<T, OutT, S>, &cfg);
    if (e != cudaSuccess || fit < 1) return static_cast<int>(e != cudaSuccess ? e : cudaErrorInvalidValue);
    fit_smem = smem;
  }
  cfg.gridDim.y = min(fit, cdiv(M, BM) * cdiv(N, RA_BW));
  const cudaError_t e = cudaLaunchKernelEx(&cfg, gemm_panel_qx<T, OutT, S>, map_x, map_w, s_row,
                                           s_col, static_cast<OutT*>(out), M, N, K, k_chunk,
                                           stages);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

// -- the revisit form ---------------------------------------------------------

constexpr int QR_THREADS = 128 * (CONSUMERS + 1);
constexpr int QR_HELPERS = 96;  // the producer warpgroup's warps 1-3, which quantize too
constexpr float QR_MAGIC = 12582912.0f;  // 1.5 * 2^23: the low byte of q + QR_MAGIC is rint(q)
constexpr float QR_TINY = 0x1p-96f;      // a row scale below it is scaled by QR_UP
constexpr float QR_UP = 0x1p100f;

// Bytes of one x float box (128 rows x 128 elements) in a stage.
template <typename T>
__host__ __device__ constexpr int qr_x_bytes() {
  return BM * S8_BK * static_cast<int>(sizeof(T));
}
// Bytes: alignment, the two quantized x boxes, the row table (two floats
// and a bit a row), then the ring: a stage is the x float box and NB W
// boxes, with two mbarriers.
__host__ __device__ constexpr int qr_smem(int x_bytes, int nb, int stages) {
  return 1024 + 2 * S8_BOX + BM * 8 + BM / 8 +
         stages * (BM * S8_BK * x_bytes + nb * S8_BOX + 16);
}

// Keeps the compiler from reusing or moving a fragment set's registers
// while a wgmma group may still read them.
__device__ __forceinline__ void fence_frag(uint32_t (&a)[S8_BK / 32][4]) {
#pragma unroll
  for (int i = 0; i < S8_BK / 32; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// 128 x 168 registers at launch: the producer warpgroup gives 112 of each
// thread's to the consumers.
__device__ __forceinline__ void setmaxnreg_dec56() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n" ::: "memory");
}
__device__ __forceinline__ void setmaxnreg_inc224() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n" ::: "memory");
}

// out (M, N) = float(q(x) @ W) * s_row * s_col, quantize-on-revisit on int8
// wgmma: a persistent CTA an SM walks the output tiles of 128 x rows x NB *
// 128 W columns in gemm_tma_s8's order (tile / nt, N fastest, so the tiles
// in flight share a few x panels in L2). One producer thread TMA-loads each
// K step's x float box (128 rows x 128 elements, no swizzle) and the NB W
// boxes (128 K rows x 128 columns, 128-byte swizzle) into a ring of
// `stages`. The two consumer warpgroups and the producer warpgroup's three
// other warps (5 and 8 of the box's 16-byte loads a thread) quantize the x
// box into one of two int8 boxes, K-major with the 128-byte swizzle
// (wgmma's B); then the consumers run gemm_tma_s8's product on it: W^T
// gathered from each W box as the register A operand of
// wgmma.m64n128k32.s32.s8.s8, a commit group a W box. A step's quantizing
// runs under the step before's groups (the two int8 boxes in turn), the
// second W box's gather under the first box's group; the third warp on a
// sub-partition hides the quantizer's latency. The quantizer computes
// quantize_rows' fl(v / s) without a division: with r = fl(1/s) (__frcp_rn,
// once a row),
// q0 = fl(v r), rem = fma(-q0, s, v) (exact) and q1 = fma(rem, r, q0),
// q1 = fl(v / s) (Markstein's theorem: r correctly rounded, q0 within an
// ulp, no underflow, which rows with s >= 2^-96 keep; a row of smaller s
// runs on v 2^100 and s 2^100, exact scalings of the same quotient); then
// q1 + 1.5 * 2^23 rounds it half to even, its low byte the int8 value. No
// clip: |v| <= the row's absmax = 127 s, so |q1| < 127.5. Four
// floating-point instructions a value, no division, no branch.
template <typename T, typename OutT, int NB>
__global__ void __launch_bounds__(QR_THREADS, 1)
gemm_revisit_qx(const __grid_constant__ CUtensorMap map_x,
                const __grid_constant__ CUtensorMap map_w, const float* __restrict__ s_row,
                const float* __restrict__ s_col,
                OutT* __restrict__ out, int M, int N, int K, int stages) {
  static_assert(NB == 1 || NB == 2, "one or two W boxes a tile");
  constexpr int XB = qr_x_bytes<T>(), STAGE = XB + NB * S8_BOX, LR = qp_box_rows<T>();
  constexpr int E = 16 / static_cast<int>(sizeof(T));  // x elements a 16-byte load
  constexpr int CT = CONSUMERS * 128, HT = QR_HELPERS;  // consumer and helper threads
  // 16-byte x loads a step: a consumer thread's, then a helper thread's
  constexpr int UC = 5 * 8 / E, UH = 8 * 8 / E;
  static_assert(CT * UC + HT * UH == BM * S8_BK / E, "the loads of an x box, once each");
  using Plain = std::integral_constant<bool, false>;
  using Scaled = std::integral_constant<bool, true>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* xq = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ring = xq + 2 * S8_BOX;
  // (1/s, s) a row of the tile; a row of s < 2^-96: (1/s', -s'), s' = s 2^100
  float2* table = reinterpret_cast<float2*>(ring + stages * STAGE);
  uint32_t* small = reinterpret_cast<uint32_t*>(table + BM);  // such rows, a bit each
  uint64_t* full = reinterpret_cast<uint64_t*>(small + BM / 32);
  uint64_t* empty = full + stages;
  const int nt = div_up(N, NB * RA_BW), tiles = div_up(M, BM) * nt, KT = div_up(K, S8_BK);

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CT + HT);  // every consumer and helper thread, once done reading
    }
    mbar_fence_init();
  }
  __syncthreads();

  // 16-byte load q of the x box, consecutive threads along a row; its E
  // bytes go to their swizzled place in dst. Scaled (a tile with a row of
  // s < 2^-96), a row whose s in the table is negative has its values
  // scaled by 2^100 too: the same quotients, exactly.
  auto quantize_load = [&](const uint8_t* box, uint8_t* dst, int q, auto scaled) {
    const int r = q / (S8_BK / E), c = q % (S8_BK / E) * E;
    alignas(16) T v[E];
    *reinterpret_cast<uint4*>(v) =
        *reinterpret_cast<const uint4*>(box + (r * S8_BK + c) * static_cast<int>(sizeof(T)));
    const float2 rs = table[r];
    float up = 1.f, s = rs.y;
    if constexpr (decltype(scaled)::value) {
      up = rs.y < 0.f ? QR_UP : 1.f;
      s = fabsf(rs.y);
    }
    uint32_t word[E / 4];
#pragma unroll
    for (int k = 0; k < E / 4; ++k) {
      uint32_t b[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float f = to_f32(v[4 * k + e]);
        if constexpr (decltype(scaled)::value) f = __fmul_rn(f, up);
        const float p = __fmul_rn(f, rs.x), q1 = __fmaf_rn(__fmaf_rn(-p, s, f), rs.x, p);
        b[e] = __float_as_uint(__fadd_rn(q1, QR_MAGIC));
      }
      word[k] = __byte_perm(__byte_perm(b[0], b[1], 0x0040), __byte_perm(b[2], b[3], 0x0040),
                            0x5410);
    }
    uint8_t* d = dst + r * 128 + (((c >> 4) ^ (r & 7)) << 4) + (c & 15);
    if constexpr (E == 8)
      *reinterpret_cast<uint2*>(d) = make_uint2(word[0], word[1]);
    else
      *reinterpret_cast<uint32_t*>(d) = word[0];
  };
  // `U` loads from load q0, `step` apart
  auto quantize = [&](const uint8_t* box, uint8_t* dst, int q0, int step, auto units,
                      auto scaled) {
#pragma unroll
    for (int i = 0; i < decltype(units)::value; ++i)
      quantize_load(box, dst, q0 + i * step, scaled);
  };
  // whether the tile has a row of s < 2^-96 (after the barrier that
  // follows the table): the same answer in every thread, so that each
  // warpgroup runs one copy of the K loop (a test in the loop, or a second
  // quantizer beside it, costs a sixth of the kernel's time)
  auto tile_scaled = [&] {
    const uint4 w = *reinterpret_cast<const uint4*>(small);
    return (w.x | w.y | w.z | w.w) != 0u;
  };

  if (threadIdx.x < 128) {  // the producer warpgroup
    if constexpr (NB == 2) setmaxnreg_dec56();
    int stage = 0, phase = 0;
    if (threadIdx.x == 0) {  // one thread issues every load
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = tile / nt * BM, n0 = tile % nt * NB * RA_BW;
        for (int kt = 0; kt < KT; ++kt) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], STAGE);
          uint8_t* st = ring + stage * STAGE;
#pragma unroll
          for (int b = 0; b < BM / LR; ++b)
            tma_load_2d(st + b * QP_SLOT, &map_x, &full[stage], kt * S8_BK, m0 + b * LR);
#pragma unroll
          for (int j = 0; j < NB; ++j)
            tma_load_2d(st + XB + j * S8_BOX, &map_w, &full[stage], n0 + j * RA_BW, kt * S8_BK);
          if (++stage == stages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    } else if (threadIdx.x >= 32) {  // warps 1-3 help quantize: the last HT * UH loads
      const int q0 = CT * UC + threadIdx.x - 32;
      const auto units = std::integral_constant<int, UH>();
      auto k_loop = [&](auto scaled) {
        for (int kt = 0; kt < KT; ++kt) {
          mbar_wait(&full[stage], phase);
          quantize(ring + stage * STAGE, xq + (kt & 1) * S8_BOX, q0, HT, units, scaled);
          fence_proxy_async();
          named_sync(1, CT + HT);
          mbar_arrive(&empty[stage]);
          if (++stage == stages) {
            stage = 0;
            phase ^= 1;
          }
        }
      };
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        named_sync(1, CT + HT);  // the tile's row table is written
        if (tile_scaled())
          k_loop(Scaled());
        else
          k_loop(Plain());
      }
    }
    return;
  }
  if constexpr (NB == 2) setmaxnreg_inc224();

  const int ct = threadIdx.x - 128, wgi = ct >> 7, warp = (ct >> 5) & 3, lane = ct & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int nb = wgi * 64 + warp * 16 + 2 * g;  // this thread's W column pair in a W box
  const uint32_t rot = wt_rotation(t4);
  const auto units = std::integral_constant<int, UC>();
  int acc[NB][64];
  uint32_t fa[S8_BK / 32][4], fb[S8_BK / 32][4];  // A fragments of the two W boxes
  int stage = 0, phase = 0;

  // one W box's products on the quantized box, as one commit group
  auto issue = [&](int (&d)[64], uint32_t (&a)[S8_BK / 32][4], uint64_t db) {
    fence_regs(d);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < S8_BK / 32; ++kk) mma_s8_rs_m64n128k32(d, a[kk], db + 2 * kk);
    wgmma_commit();
    fence_regs(d);
    fence_frag(a);
  };
  // A K step: quantize this thread's share of the x box into one of two
  // int8 boxes under the step before's groups, then retire them before the
  // barrier, so that past it no warpgroup's group still reads the int8 box
  // the next step overwrites (wait_group covers a warpgroup's own groups
  // only); then gather and issue each W box, the second box's gather under
  // the first box's group.
  auto k_loop = [&](auto scaled) {
    for (int kt = 0; kt < KT; ++kt) {
      mbar_wait(&full[stage], phase);
      const uint8_t* st = ring + stage * STAGE;
      uint8_t* xk = xq + (kt & 1) * S8_BOX;
      quantize(st, xk, ct, CT, units, scaled);
      wgmma_wait<0>();
      fence_frag(fa);
      if constexpr (NB == 2) fence_frag(fb);
      fence_proxy_async();  // the int8 box, before wgmma reads it
      named_sync(1, CT + HT);
      const uint64_t db = desc(xk, 16, 1024);
      wt_fragments(fa, st + XB, nb, t4, rot);
      issue(acc[0], fa, db);
      if constexpr (NB == 2) {
        wt_fragments(fb, st + XB + S8_BOX, nb, t4, rot);
        issue(acc[1], fb, db);
      }
      mbar_arrive(&empty[stage]);  // this thread's reads of the stage are done
      if (++stage == stages) {
        stage = 0;
        phase ^= 1;
      }
    }
  };

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = tile / nt * BM, n0 = tile % nt * NB * RA_BW;
    // every consumer and helper passed the last tile's final quantizing
    // (the barrier after it), so the table is free
    if (ct < BM) {
      const float s = m0 + ct < M ? s_row[m0 + ct] : 1.f;
      table[ct] = s < QR_TINY ? make_float2(__frcp_rn(s * QR_UP), -(s * QR_UP))
                              : make_float2(__frcp_rn(s), s);
      const uint32_t bits = __ballot_sync(0xffffffffu, s < QR_TINY);
      if (lane == 0) small[ct >> 5] = bits;
    }
    named_sync(1, CT + HT);
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[j][i] = 0;
    if (tile_scaled())
      k_loop(Scaled());
    else
      k_loop(Plain());
    wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      fence_regs(acc[j]);
      // acc[j][4i + 2h + e]: W column n0 + 128 j + nb + h, x row m0 + 8i + 2t4 + e
      const int col = n0 + j * RA_BW + nb;
      if (col >= N) continue;  // N % 16 == 0: col + 1 < N with it
      const float sc0 = s_col[col], sc1 = s_col[col + 1];
#pragma unroll
      for (int i = 0; i < BM / 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int row = m0 + 8 * i + 2 * t4 + e;
          if (row < M)
            put_s8_pair(out, static_cast<size_t>(row) * N + col, acc[j][4 * i + e],
                        acc[j][4 * i + 2 + e], s_row[row], sc0, sc1);
        }
    }
  }
}

// The revisit form: `grid` persistent CTAs (one an SM) over tiles of NB x
// 128 W columns; x (M, K) in T and w (K, N) int8, both 16-byte aligned, K
// sizeof(T) % 16 == 0, N % 16 == 0, M, N, K >= 128 (the plan's checks).
template <typename T, typename OutT, int NB>
static int launch_revisit_qx(const void* x, const void* w, const float* s_row,
                             const float* s_col, void* out, int M, int N, int K, int stages,
                             int grid, cudaStream_t stream) {
  const int smem = qr_smem(static_cast<int>(sizeof(T)), NB, stages);
  if (stages < 2 || smem > 232448 || grid < 1) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map_x, map_w;
  int rc = make_map(&map_x, x, x_map_type<T>(), sizeof(T), M, K, qp_box_rows<T>(), S8_BK,
                    CU_TENSOR_MAP_SWIZZLE_NONE);
  if (rc == 0)
    rc = make_map(&map_w, w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, K, N, S8_BK, RA_BW,
                  CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc != 0) return rc;
  static const cudaError_t smem_set = cudaFuncSetAttribute(
      gemm_revisit_qx<T, OutT, NB>, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
  (void)smem_set;
  gemm_revisit_qx<T, OutT, NB><<<grid, QR_THREADS, smem, stream>>>(
      map_x, map_w, s_row, s_col, static_cast<OutT*>(out), M, N, K, stages);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace wg
}  // namespace smelter

namespace {

using namespace smelter;
using i8::BK;
using i8::SK;

constexpr int THREADS = 256;

using wg::quant;
using wg::to_f32;

// VE = 16 / sizeof(T) activations (one 16-byte vector) of row `xr` from
// column gk, zero past K.
template <typename T>
__device__ __forceinline__ uint4 load_x(const T* __restrict__ xr, int gk, int K, bool vec) {
  constexpr int VE = 16 / static_cast<int>(sizeof(T));
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (vec && gk + VE <= K) {
    v = *reinterpret_cast<const uint4*>(xr + gk);
  } else {
    T* e = reinterpret_cast<T*>(&v);
#pragma unroll
    for (int j = 0; j < VE; ++j)
      if (gk + j < K) e[j] = xr[gk + j];
  }
  return v;
}

// Those VE activations quantized at scale s, as VE bytes at dst.
template <typename T>
__device__ __forceinline__ void quant_store(int8_t* dst, const uint4& v, float s) {
  constexpr int VE = 16 / static_cast<int>(sizeof(T));
  const T* e = reinterpret_cast<const T*>(&v);
  uint32_t p[VE / 4];
#pragma unroll
  for (int i = 0; i < VE / 4; ++i)
    p[i] = quant(to_f32(e[4 * i]), s) | quant(to_f32(e[4 * i + 1]), s) << 8 |
           quant(to_f32(e[4 * i + 2]), s) << 16 | quant(to_f32(e[4 * i + 3]), s) << 24;
  if constexpr (VE == 8) {
    *reinterpret_cast<uint2*>(dst) = make_uint2(p[0], p[1]);
  } else {
    *reinterpret_cast<uint32_t*>(dst) = p[0];
  }
}

// Quantize-on-revisit: one 128 x 128 output tile a block. Thread `tid` owns
// row tid / 2 of the A tile, its 32 columns from (tid % 2) * 32, so its
// row's scale is read once. Capped at 128 registers a thread, so that two
// blocks share an SM: uncapped, the compiler takes more and one block runs
// alone, with no other block's tensor-core work to hide its loads behind.
template <typename T, typename OutT>
__global__ void __launch_bounds__(THREADS, 2)
int8_matmul_qx(const T* __restrict__ x, const int8_t* __restrict__ w,
               const float* __restrict__ s_row, const float* __restrict__ s_col,
               OutT* __restrict__ out, int M, int N, int K, bool x_vec, bool w_vec) {
  constexpr int BM = 128, BN = 128;
  constexpr int VE = 16 / static_cast<int>(sizeof(T)), NV = 32 / VE;
  __shared__ __align__(16) int8_t As[BM * SK];  // [m][k]
  __shared__ __align__(16) int8_t Bs[BN * SK];  // [n][k]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 64;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int ar = tid >> 1, ac = (tid & 1) * 32, gm = m0 + ar;
  const float sr = gm < M ? s_row[gm] : 1.f;
  const T* xr = x + static_cast<size_t>(gm < M ? gm : 0) * K;

  int acc[2][8][4];
  i8::zero(acc);
  uint4 ra[NV];
  i8::WTile<BN, THREADS> wt;

  auto load = [&](int k0) {
#pragma unroll
    for (int v = 0; v < NV; ++v)
      ra[v] = gm < M ? load_x(xr, k0 + ac + v * VE, K, x_vec) : make_uint4(0u, 0u, 0u, 0u);
    wt.load(w, K, N, k0, n0, w_vec, tid);
  };

  if (K > 0) load(0);
  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int v = 0; v < NV; ++v) quant_store<T>(&As[ar * SK + ac + v * VE], ra[v], sr);
    wt.stash(Bs, tid);
    __syncthreads();
    if (k0 + BK < K) load(k0 + BK);  // in flight while the tensor cores work
    i8::mma_step(acc, &As[wm * SK], SK, Bs, wn, lane);
    __syncthreads();
  }
  i8::store_tile(out, acc, s_row, s_col, M, N, m0 + wm, n0 + wn, lane);
}

template <typename T>
bool x_vector(const void* x, int K) {
  return K % (16 / static_cast<int>(sizeof(T))) == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
}

template <typename T, typename OutT>
int launch_qx(const void* x, const int8_t* w, const float* sr, const float* sc, void* out, int M,
              int N, int K, cudaStream_t stream) {
  const dim3 grid(cdiv(N, 128), cdiv(M, 128));
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const bool w_vec = (N % 4 == 0) && (reinterpret_cast<uintptr_t>(w) % 4 == 0);
  int8_matmul_qx<T, OutT><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), w, sr, sc, static_cast<OutT*>(out), M, N, K, x_vector<T>(x, K),
      w_vec);
  return static_cast<int>(cudaGetLastError());
}

// The form's kernel (form 0 the mma.sync kernel, 1 the panel form, 2 the
// cluster form, 3 the revisit form on tiles of `cols` W columns).
template <typename T, typename OutT>
int launch(const void* x, const int8_t* w, const float* sr, const float* sc, void* out, int M,
           int N, int K, int form, int split, int k_chunk, int stages, int cols, int grid,
           cudaStream_t st) {
  switch (form) {
    case 0: return launch_qx<T, OutT>(x, w, sr, sc, out, M, N, K, st);
    case 3:
      if (cols == 128)
        return wg::launch_revisit_qx<T, OutT, 1>(x, w, sr, sc, out, M, N, K, stages, grid, st);
      if (cols == 256)
        return wg::launch_revisit_qx<T, OutT, 2>(x, w, sr, sc, out, M, N, K, stages, grid, st);
      return static_cast<int>(cudaErrorInvalidValue);
    case 1:
      if (split == 4)
        return wg::launch_panel_qx<T, OutT, 4>(x, w, sr, sc, out, M, N, K, k_chunk, stages, st);
      if (split == 8)
        return wg::launch_panel_qx<T, OutT, 8>(x, w, sr, sc, out, M, N, K, k_chunk, stages, st);
      return static_cast<int>(cudaErrorInvalidValue);
    case 2:
      if (split < 1 || split > 8 || k_chunk <= 0 || k_chunk % wg::S8_BK)
        return static_cast<int>(cudaErrorInvalidValue);
      return wg::launch_cluster_s8<OutT>(static_cast<const T*>(x), w, sr, sc, out, M, N, K,
                                         split, k_chunk, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// out_dtype f32, or x's own type.
template <typename T>
int launch_x(const void* x, const int8_t* w, const float* sr, const float* sc, void* out, int M,
             int N, int K, int x_dtype, int out_dtype, int form, int split, int k_chunk,
             int stages, int cols, int grid, cudaStream_t st) {
  if (out_dtype == kF32)
    return launch<T, float>(x, w, sr, sc, out, M, N, K, form, split, k_chunk, stages, cols, grid,
                            st);
  if (out_dtype == x_dtype)
    return launch<T, T>(x, w, sr, sc, out, M, N, K, form, split, k_chunk, stages, cols, grid,
                        st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" const char* smelter_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x (M, K) row-major in x_dtype (f32, bf16, f16); w_q (K, N) int8
// row-major; s_row (M,) f32 (max(absmax, 1e-30) / 127 of each row); s_col
// (N,) f32; out (M, N) row-major in out_dtype (f32 or x_dtype). form 0 runs
// the mma.sync kernel ("mma"); form 1 the panel form (split 4 or 8 ranks of
// k_chunk K elements, `stages` ring stages); form 2 the cluster form (a K
// split of `split` CTAs of k_chunk elements); form 3 the revisit form
// (`grid` persistent CTAs, tiles of `cols` 128 or 256 W columns, `stages`
// ring stages), as kernels/wgmma_plan.py::fused_plan and revisit_plan say.
// Returns a cudaError_t code.
extern "C" int smelter_int8_matmul_fused(const void* x, const void* w_q, const void* s_row,
                                         const void* s_col, void* out, int M, int N, int K,
                                         int x_dtype, int out_dtype, int form, int split,
                                         int k_chunk, int stages, int cols, int grid,
                                         void* stream) {
  const auto* w = static_cast<const int8_t*>(w_q);
  const auto* sr = static_cast<const float*>(s_row);
  const auto* sc = static_cast<const float*>(s_col);
  auto st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0) return 0;
  switch (x_dtype) {
    case kF32:
      return launch_x<float>(x, w, sr, sc, out, M, N, K, x_dtype, out_dtype, form, split,
                             k_chunk, stages, cols, grid, st);
    case kBF16:
      return launch_x<__nv_bfloat16>(x, w, sr, sc, out, M, N, K, x_dtype, out_dtype, form,
                                     split, k_chunk, stages, cols, grid, st);
    case kF16:
      return launch_x<__half>(x, w, sr, sc, out, M, N, K, x_dtype, out_dtype, form, split,
                              k_chunk, stages, cols, grid, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

