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
// the int8 tensor cores (~139 us at 1,979 TOP/s); at the ResNet-50 head
// (M 128, K 2048, N 1000) HBM (~2.8 MB, ~0.85 us at 3.35 TB/s).
//
// Design, simple first, on int8_gemm.cuh's tiles (mma.sync.m16n8k32, the
// weight tile transposed to [n][k] in shared memory, 8 warps of 32 x 64):
// - quantize-on-revisit (panel_rows 0): int8_matmul.cu's 128 x 128 output
//   tile with another A loader, which reads the float x tile (bf16, f16 or
//   f32), divides by s_row with IEEE division (__fdiv_rn: quantize_rows
//   divides, no reciprocal), rounds half to even (__float2int_rn), clips to
//   [-127, 127] and stores int8 [m][k]. Every output tile quantizes the A
//   tiles it stages, so x is read once an N tile, mostly from L2.
// - panel (panel_rows BM = 32, 64 or 128): a block quantizes the BM x K
//   panel of its rows into shared memory once, then sweeps N tiles of
//   64 x 8 * 32 / BM columns against it, so x crosses HBM once and is
//   quantized once a block. The panel and one weight tile must fit in
//   227 KB (the wrapper picks BM and refuses a longer K); where M / BM
//   leaves SMs idle the N tiles split over grid.y, each split quantizing
//   its own panel.
// The epilogue is __fmul_rn(__fmul_rn(float(acc), s_row), s_col), then one
// rounding to out_dtype, as the Pallas kernels do. M, N and K edges are
// masked; no cp.async, TMA or wgmma yet.
#include "int8_gemm.cuh"

namespace {

using namespace smelter;
using i8::BK;
using i8::SK;

constexpr int THREADS = 256;
constexpr int SMEM_MAX = 232448;  // 227 KB, a block's dynamic shared memory on sm_90

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <> __device__ __forceinline__ float to_f32<__half>(__half v) { return __half2float(v); }

// The int8 byte of one activation at its row's scale, as quantize_rows.
__device__ __forceinline__ uint32_t quant(float v, float s) {
  const int q = __float2int_rn(__fdiv_rn(v, s));
  return static_cast<uint32_t>(max(-127, min(127, q))) & 0xffu;
}

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

// Panel: BM rows a block, quantized once into shared memory [BM][SP] (SP =
// K rounded up to BK, plus 16 bytes), then N tiles of BN columns from this
// split's share. Warps: BM / 32 over M x 8 * 32 / BM over N, each 32 x 64.
template <typename T, typename OutT, int BM>
__global__ void __launch_bounds__(THREADS)
int8_matmul_panel(const T* __restrict__ x, const int8_t* __restrict__ w,
                  const float* __restrict__ s_row, const float* __restrict__ s_col,
                  OutT* __restrict__ out, int M, int N, int K, int tiles_per_split, bool x_vec,
                  bool w_vec) {
  constexpr int WM = BM / 32, WN = 8 / WM, BN = 64 * WN;
  constexpr int VE = 16 / static_cast<int>(sizeof(T));
  extern __shared__ __align__(16) int8_t smem[];
  const int kp = max(1, (K + BK - 1) / BK) * BK, sp = kp + 16;  // K = 0: one step of zeros
  int8_t* P = smem;            // [BM][sp]
  int8_t* Bs = smem + BM * sp;  // [BN][SK]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp / WN) * 32, wn = (warp % WN) * 64;
  const int m0 = blockIdx.x * BM;
  const int ksteps = kp / BK;
  const int nt0 = blockIdx.y * tiles_per_split;
  const int nt1 = min((N + BN - 1) / BN, nt0 + tiles_per_split);
  const int steps = max(0, nt1 - nt0) * ksteps;

  i8::WTile<BN, THREADS> wt;
  if (steps > 0) wt.load(w, K, N, 0, nt0 * BN, w_vec, tid);  // in flight during the panel

  // the panel, zero past M and K
  const int vrow = kp / VE;
  for (int i = tid; i < BM * vrow; i += THREADS) {
    const int r = i / vrow, gk = (i % vrow) * VE, gm = m0 + r;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    float s = 1.f;
    if (gm < M) {
      v = load_x(x + static_cast<size_t>(gm) * K, gk, K, x_vec);
      s = s_row[gm];
    }
    quant_store<T>(&P[r * sp + gk], v, s);
  }

  int acc[2][8][4];
  for (int s = 0; s < steps; ++s) {
    const int nt = nt0 + s / ksteps, ks = s % ksteps;
    if (ks == 0) i8::zero(acc);
    wt.stash(Bs, tid);
    __syncthreads();  // the first time also: the panel is complete
    if (s + 1 < steps) {
      const int ns = s + 1;
      wt.load(w, K, N, (ns % ksteps) * BK, (nt0 + ns / ksteps) * BN, w_vec, tid);
    }
    i8::mma_step(acc, &P[wm * sp + ks * BK], sp, Bs, wn, lane);
    __syncthreads();
    if (ks == ksteps - 1)
      i8::store_tile(out, acc, s_row, s_col, M, N, m0 + wm, nt * BN + wn, lane);
  }
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

template <typename T, typename OutT, int BM>
int launch_panel(const void* x, const int8_t* w, const float* sr, const float* sc, void* out,
                 int M, int N, int K, int n_split, cudaStream_t stream) {
  constexpr int BN = 64 * 8 * 32 / BM;
  const long long smem =
      static_cast<long long>(BM) * ((K > 0 ? cdiv(K, BK) : 1) * BK + 16) +
      static_cast<long long>(BN) * SK;
  const int tiles = cdiv(N, BN);
  if (smem > SMEM_MAX || n_split < 1 || n_split > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  static bool attr_set = false;  // per instantiation; setting it twice is harmless
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        int8_matmul_panel<T, OutT, BM>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  const int per = cdiv(tiles, n_split);
  const dim3 grid(cdiv(M, BM), cdiv(tiles, per));
  const bool w_vec = (N % 4 == 0) && (reinterpret_cast<uintptr_t>(w) % 4 == 0);
  int8_matmul_panel<T, OutT, BM><<<grid, THREADS, static_cast<size_t>(smem), stream>>>(
      static_cast<const T*>(x), w, sr, sc, static_cast<OutT*>(out), M, N, K, per,
      x_vector<T>(x, K), w_vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename OutT>
int launch(const void* x, const int8_t* w, const float* sr, const float* sc, void* out, int M,
           int N, int K, int panel_rows, int n_split, cudaStream_t st) {
  switch (panel_rows) {
    case 0: return launch_qx<T, OutT>(x, w, sr, sc, out, M, N, K, st);
    case 32: return launch_panel<T, OutT, 32>(x, w, sr, sc, out, M, N, K, n_split, st);
    case 64: return launch_panel<T, OutT, 64>(x, w, sr, sc, out, M, N, K, n_split, st);
    case 128: return launch_panel<T, OutT, 128>(x, w, sr, sc, out, M, N, K, n_split, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// out_dtype f32, or x's own type.
template <typename T>
int launch_x(const void* x, const int8_t* w, const float* sr, const float* sc, void* out, int M,
             int N, int K, int x_dtype, int out_dtype, int panel_rows, int n_split,
             cudaStream_t st) {
  if (out_dtype == kF32) return launch<T, float>(x, w, sr, sc, out, M, N, K, panel_rows, n_split, st);
  if (out_dtype == x_dtype) return launch<T, T>(x, w, sr, sc, out, M, N, K, panel_rows, n_split, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" const char* smelter_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x (M, K) row-major in x_dtype (f32, bf16, f16); w_q (K, N) int8
// row-major; s_row (M,) f32 (max(absmax, 1e-30) / 127 of each row); s_col
// (N,) f32; out (M, N) row-major in out_dtype (f32 or x_dtype). panel_rows
// 0 runs quantize-on-revisit, 32/64/128 the panel schedule with N tiles
// split over n_split blocks. Returns a cudaError_t code.
extern "C" int smelter_int8_matmul_fused(const void* x, const void* w_q, const void* s_row,
                                         const void* s_col, void* out, int M, int N, int K,
                                         int x_dtype, int out_dtype, int panel_rows,
                                         int n_split, void* stream) {
  const auto* w = static_cast<const int8_t*>(w_q);
  const auto* sr = static_cast<const float*>(s_row);
  const auto* sc = static_cast<const float*>(s_col);
  auto st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0) return 0;
  switch (x_dtype) {
    case kF32:
      return launch_x<float>(x, w, sr, sc, out, M, N, K, x_dtype, out_dtype, panel_rows,
                             n_split, st);
    case kBF16:
      return launch_x<__nv_bfloat16>(x, w, sr, sc, out, M, N, K, x_dtype, out_dtype,
                                     panel_rows, n_split, st);
    case kF16:
      return launch_x<__half>(x, w, sr, sc, out, M, N, K, x_dtype, out_dtype, panel_rows,
                              n_split, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
