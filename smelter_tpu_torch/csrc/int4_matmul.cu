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
// What bounds it on an H100: at decode (M = 8 slots, N x K from 1024 x 2048
// to 32000 x 2048) the weight bytes, K*N/2 of nibbles plus K*N/g*4 of
// scales: 1.1 MB to 35 MB a call, 0.3-10.5 us at 3.35 TB/s, while the
// tensor-core work is 2*16*N*K flops (M padded to 16), a hundredth of that.
//
// Design, simple first: one block of 8 warps per 32 output columns and per
// 16 rows of x, walking all of K (no split across blocks or launches). The
// warps share out the K groups, so a block keeps all its weight loads in
// flight at once, and add their partial sums in shared memory in a fixed
// order at the end: a row's result depends on nothing but that row's x, so
// it does not change with M or with the other rows.
//
// At N 1024 and 2048 that is only 32 and 64 blocks for 132 SMs. Letting the
// blocks of a thread-block cluster split a tile's K range (adding their sums
// through distributed shared memory, to fill the SMs in one launch) was
// measured slower at every decode shape: these calls take 5-14 us against
// bounds of 0.35-1.9 us, set by the latency of a few dependent loads and
// the launch, not by the SMs in use (PERF.md).
//
// Nibbles go from global memory straight into mma.sync.m16n8k16 B fragments, with no shared-memory
// stage: a thread reads 4 bytes (4 columns) of each of 4 packed rows, pairs
// the bytes of one column with byte permutes, and turns two nibbles into a
// bf16x2 with one mask-xor and one subtraction (bf16 128 + (n ^ 8) - 136).
// The mma's k and n orders are permuted to match what a thread loads
// (logical k 2t, 2t+1, 2t+8, 2t+9 are packed rows 4t..4t+3; logical column j
// of n-tile t is physical column 4j + t), and the x fragments follow the
// same k order, so a thread's 4 x values are one 8-byte load. One byte gives
// both halves: the low nibbles feed the dot with x[:, :K/2], the high
// nibbles the dot with x[:, K/2:]. No cp.async, TMA or wgmma yet.
#include "common.cuh"

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

}  // namespace

extern "C" const char* smelter_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x (M, K) row-major in x_dtype (f32 or bf16), pk (K/2, N) int8 row-major,
// scales (K/g, N) f32 row-major, out (M, N) row-major in out_dtype (f32 or
// bf16). Needs K % (2g) == 0, g % 16 == 0, N % 32 == 0 and 16-byte aligned
// pointers (the wrapper checks). Returns a cudaError_t code.
extern "C" int smelter_int4_matmul(const void* x, const void* pk, const void* scales, void* out,
                                   int M, int N, int K, int g, int x_dtype, int out_dtype,
                                   void* stream) {
  const auto* w = static_cast<const int8_t*>(pk);
  const auto* s = static_cast<const float*>(scales);
  auto st = static_cast<cudaStream_t>(stream);
  if (g <= 0 || g % 16 || K % (2 * g) || N % BN) return static_cast<int>(cudaErrorInvalidValue);
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
