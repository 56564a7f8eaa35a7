// One rank's step of the ring GEMMs of smelter_tpu_torch/kernels/
// collective_matmul.py: out (M, N) = [recv +] A (M, K) @ B (K, N), the sum in
// f32 (or int32 for int8), one rounding to out's type.
//
// Replaces the Pallas kernels smelter_tpu/kernels/collective_matmul.py::
// collective_matmul_ag (_ag_kernel) and ::collective_matmul_rs (_rs_kernel).
// There one kernel a device runs every ring step: it dots the shard in hand
// on the MXU while make_async_remote_copy sends it (ag) or the travelling
// f32 sum (rs) to the right-hand neighbour, and trades barrier tokens with
// both neighbours before a slot is reused. Here a launch is one rank's step
// and the ring is parallel/ring.py: the slot copies run on a comm stream,
// ordered against the step launches by CUDA events, so no launch ever
// waits on another (W ranks may share one card).
//
// - ag step: out = the (M/P rows of the output for the shard in hand) =
//   round(A @ B) in A's type. bf16/f16 run on csrc/wgmma_gemm.cuh, in the
//   form kernels/wgmma_plan.py picks from the step's shape: the persistent
//   TMA kernel (aligned shapes with tiles enough: ViT-B/16 b128's 6,304 x
//   768 step makes 300 tiles of 128 x 128, llama_1b's 1,024 x 1,408 step
//   88), or the cluster form (any shape; K split over up to 8 CTAs summed in a
//   fixed order through distributed shared memory). int8 A and B sum in
//   int32 on mma.sync m16n8k32 (csrc/int8_gemm.cuh) and the int32 sum is
//   cast to int8, which wraps (keeps the low 8 bits), as the Pallas
//   kernel's astype does.
// - rs step: out = recv + A @ B, recv the f32 travelling sum received from
//   the left-hand neighbour (nullptr at step 0), written in f32 to travel
//   on, or, at the last step, rounded once to A's type. 16-bit types run
//   csrc/gemm.cuh's main loop (mma.sync m16n8k16 on 128 x 128 tiles, a
//   4-stage cp.async ring; element loads where K or N is not a multiple of
//   8 or a pointer not 16-byte aligned). int8 sums in int32 on int8_gemm.cuh,
//   converts the sum to f32 and adds it to the travelling sum; the last
//   step clamps to [-128, 127] (NaN to 0) and truncates, as the JAX kernel's
//   astype of its f32 sum does.
// - f32 (both): csrc/gemm.cuh's register-tiled FMA loop in full f32 (no
//   TF32).
//
// What bounds it on an H100: the tensor cores. At ViT-B/16's MLP at batch
// 128 over 4 ranks (25,216 rows, 768 -> 3,072 -> 768) the pair does 238
// GFLOP (241 us at 989 TFLOP/s dense bf16) against 86 MB of operands; the
// ring's copies move another 116 MB (ag: 3 of the 4 x shards to each rank;
// rs: 3 f32 partial sums of a chunk), which on one card are copies in the
// same memory. The ag step on gemm.cuh's mma.sync loop, before the wgmma
// core, ran at 83-107 TFLOP/s: 1.1074 ms a ViT-B/16 call, 0.9363 ms a
// llama_1b one (NVIDIA H100 80GB HBM3, 700 W; PERF.md row 22).
#include <type_traits>

#include "gemm.cuh"
#include "int8_gemm.cuh"
#include "wgmma_gemm.cuh"

namespace {

using namespace smelter;

// out[o] = [recv[o] +] v, one rounding to O. recv and out may be one buffer
// (the travelling sum, updated in place), so neither is __restrict__.
template <typename O>
__device__ __forceinline__ void put(O* out, const float* recv, size_t o, float v) {
  if (recv != nullptr) v = recv[o] + v;
  store(&out[o], v);
}

template <typename T, typename O, bool VEC>
__global__ void __launch_bounds__(GEMM_THREADS, 2)
step_mma(const uint16_t* __restrict__ A, const uint16_t* __restrict__ B,
         const float* recv, O* out, int M, int N, int K) {
  extern __shared__ __align__(16) uint16_t smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 64;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float acc[2][8][4];
  gemm_mma_mainloop<T, VEC>(acc, A, B, M, N, K, N, m0, n0, smem);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm + mi * 16 + g + h * 8;
        if (row >= M) continue;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = n0 + wn + ni * 8 + t * 2 + j;
          if (col < N) put(out, recv, static_cast<size_t>(row) * N + col, acc[mi][ni][h * 2 + j]);
        }
      }
}

__global__ void __launch_bounds__(GEMM_THREADS)
step_f32(const float* __restrict__ A, const float* __restrict__ B, const float* recv,
         float* out, int M, int N, int K) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * FM, n0 = blockIdx.x * FN;
  float acc[4][4];
  gemm_f32_mainloop(acc, A, B, M, N, K, N, m0, n0);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col < N) put(out, recv, static_cast<size_t>(row) * N + col, acc[i][j]);
    }
  }
}

// int8: 128 x 128 tiles of 8 warps on m16n8k32 with int32 sums, the K steps
// staged as csrc/int8_matmul.cu stages them. The epilogue by MODE: kWrap
// writes each int32 sum's low byte (ag); kTravel writes [recv +] float(sum)
// in f32 (rs before its last step); kSaturate clamps [recv +] float(sum) to
// int8 (rs's last step).
constexpr int I8_THREADS = 256;
constexpr int I8_CHUNKS = BM * i8::BK / 16 / I8_THREADS;  // 16-byte A chunks a thread
enum I8Mode : int { kWrap = 0, kTravel = 1, kSaturate = 2 };

__device__ __forceinline__ int8_t saturate_i8(float v) {
  return v != v ? 0 : static_cast<int8_t>(__float2int_rz(fminf(fmaxf(v, -128.f), 127.f)));
}

template <int MODE>
__global__ void __launch_bounds__(I8_THREADS)
step_int8(const int8_t* __restrict__ x, const int8_t* __restrict__ w, const float* recv,
          void* out, int M, int N, int K, bool x_vec, bool w_vec) {
  using i8::SK;
  __shared__ __align__(16) int8_t As[BM * SK];  // [m][k]
  __shared__ __align__(16) int8_t Bs[BN * SK];  // [n][k]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 64;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  int acc[2][8][4];
  i8::zero(acc);
  uint4 ra[I8_CHUNKS];
  i8::WTile<BN, I8_THREADS> wt;
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < I8_CHUNKS; ++i) {
      const int c = tid + i * I8_THREADS;
      const int gm = m0 + c / (i8::BK / 16), gk = k0 + (c % (i8::BK / 16)) * 16;
      if (x_vec && gm < M && gk + 16 <= K) {
        ra[i] = *reinterpret_cast<const uint4*>(x + static_cast<size_t>(gm) * K + gk);
      } else {
        uint32_t e[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int j = 0; j < 16; ++j)
          if (gm < M && gk + j < K)
            e[j >> 2] |= i8::load_byte(x + static_cast<size_t>(gm) * K + gk + j) << (8 * (j & 3));
        ra[i] = make_uint4(e[0], e[1], e[2], e[3]);
      }
    }
    wt.load(w, K, N, k0, n0, w_vec, tid);
  };

  if (K > 0) load(0);
  for (int k0 = 0; k0 < K; k0 += i8::BK) {
#pragma unroll
    for (int i = 0; i < I8_CHUNKS; ++i) {
      const int c = tid + i * I8_THREADS;
      *reinterpret_cast<uint4*>(&As[(c / (i8::BK / 16)) * SK + (c % (i8::BK / 16)) * 16]) = ra[i];
    }
    wt.stash(Bs, tid);
    __syncthreads();
    if (k0 + i8::BK < K) load(k0 + i8::BK);  // in flight while the tensor cores work
    i8::mma_step(acc, &As[wm * SK], SK, Bs, wn, lane);
    __syncthreads();
  }
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm + mi * 16 + g + h * 8;
        if (row >= M) continue;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = n0 + wn + ni * 8 + t * 2 + j;
          if (col >= N) continue;
          const size_t o = static_cast<size_t>(row) * N + col;
          const int v = acc[mi][ni][h * 2 + j];
          if constexpr (MODE == kWrap) {  // the low byte: the cast wraps
            static_cast<uint8_t*>(out)[o] = static_cast<uint8_t>(v);
          } else {
            float f = __int2float_rn(v);
            if (recv != nullptr) f = recv[o] + f;
            if constexpr (MODE == kTravel)
              static_cast<float*>(out)[o] = f;
            else
              static_cast<int8_t*>(out)[o] = saturate_i8(f);
          }
        }
      }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T, typename O, bool VEC>
void launch_mma(const void* a, const void* b, const float* recv, void* out, int M, int N, int K,
                cudaStream_t stream) {
  static const cudaError_t smem_set = cudaFuncSetAttribute(
      step_mma<T, O, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, GEMM_SMEM);
  (void)smem_set;  // a refusal shows as the launch's error
  const dim3 grid(cdiv(N, BN), cdiv(M, BM));
  step_mma<T, O, VEC><<<grid, GEMM_THREADS, GEMM_SMEM, stream>>>(
      static_cast<const uint16_t*>(a), static_cast<const uint16_t*>(b), recv,
      static_cast<O*>(out), M, N, K);
}

template <typename T, typename O>
void launch_16(const void* a, const void* b, const float* recv, void* out, int M, int N, int K,
               cudaStream_t stream) {
  if (K % 8 == 0 && N % 8 == 0 && aligned16(a) && aligned16(b))
    launch_mma<T, O, true>(a, b, recv, out, M, N, K, stream);
  else
    launch_mma<T, O, false>(a, b, recv, out, M, N, K, stream);
}

// The ag step of a 16-bit type on the wgmma core, in the plan's form.
template <typename T>
int launch_ag16(const void* a, const void* b, void* out, int M, int N, int K, int form, int bn,
                int split, int k_chunk, int grid, cudaStream_t stream) {
  const int o = std::is_same<T, __half>::value ? kF16 : kBF16;
  if (form == wg::kFormTma && bn == 128)
    return wg::launch_tma<T, 128>(a, b, out, o, M, N, K, grid, stream);
  if (form == wg::kFormCluster && bn == wg::CL_BN && split >= 1 && split <= 8 && k_chunk > 0 &&
      k_chunk % wg::BK == 0)
    return wg::launch_cluster<T, false>(a, b, nullptr, out, o, M, N, K, split, k_chunk, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The rs step of a 16-bit type (out f32, the travelling sum, or T at the
// last step) on gemm.cuh's main loop.
template <typename T>
int launch_rs16(const void* a, const void* b, const float* recv, void* out, int M, int N, int K,
                int out_dtype, cudaStream_t stream) {
  if (out_dtype == kF32)
    launch_16<T, float>(a, b, recv, out, M, N, K, stream);
  else
    launch_16<T, T>(a, b, recv, out, M, N, K, stream);
  return static_cast<int>(cudaGetLastError());
}

template <int MODE>
int launch_int8(const void* a, const void* b, const float* recv, void* out, int M, int N, int K,
                cudaStream_t stream) {
  const auto* x = static_cast<const int8_t*>(a);
  const auto* w = static_cast<const int8_t*>(b);
  const bool x_vec = K % 16 == 0 && aligned16(x);
  const bool w_vec = N % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 4 == 0;
  const dim3 grid(cdiv(N, BN), cdiv(M, BM));
  step_int8<MODE><<<grid, I8_THREADS, 0, stream>>>(x, w, recv, out, M, N, K, x_vec, w_vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* smelter_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// a (M, K) and b (K, N) row-major in in_dtype (f32, bf16, f16 or int8);
// recv (M, N) f32 or nullptr; out (M, N) row-major in out_dtype. reduce 0
// (ag): out in in_dtype, no recv; form, bn, split, k_chunk and grid are
// kernels/wgmma_plan.py's plan for a 16-bit step. reduce 1 (rs): out f32
// (the travelling sum) or in_dtype (the last step). Returns a cudaError_t
// code.
extern "C" int smelter_collective_matmul(const void* a, const void* b, const void* recv,
                                         void* out, int M, int N, int K, int in_dtype,
                                         int out_dtype, int reduce, int form, int bn, int split,
                                         int k_chunk, int grid, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const auto* r = static_cast<const float*>(recv);
  if (M == 0 || N == 0) return 0;
  const bool travel = out_dtype == kF32 && in_dtype != kF32;
  if ((reduce == 0 && (out_dtype != in_dtype || recv != nullptr)) ||
      (reduce == 1 && out_dtype != in_dtype && !travel) || (reduce != 0 && reduce != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (in_dtype) {
    case kF32: {
      const dim3 grid_f32(cdiv(N, FN), cdiv(M, FM));
      step_f32<<<grid_f32, GEMM_THREADS, 0, st>>>(static_cast<const float*>(a),
                                                  static_cast<const float*>(b), r,
                                                  static_cast<float*>(out), M, N, K);
      return static_cast<int>(cudaGetLastError());
    }
    case kBF16:
      return reduce == 0 ? launch_ag16<__nv_bfloat16>(a, b, out, M, N, K, form, bn, split,
                                                       k_chunk, grid, st)
                         : launch_rs16<__nv_bfloat16>(a, b, r, out, M, N, K, out_dtype, st);
    case kF16:
      return reduce == 0 ? launch_ag16<__half>(a, b, out, M, N, K, form, bn, split, k_chunk,
                                               grid, st)
                         : launch_rs16<__half>(a, b, r, out, M, N, K, out_dtype, st);
    case kI8:
      if (reduce == 0) return launch_int8<kWrap>(a, b, nullptr, out, M, N, K, st);
      return travel ? launch_int8<kTravel>(a, b, r, out, M, N, K, st)
                    : launch_int8<kSaturate>(a, b, r, out, M, N, K, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
