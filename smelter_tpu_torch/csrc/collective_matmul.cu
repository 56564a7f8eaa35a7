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
//   round(A @ B) in A's type.
// - rs step: out = recv + A @ B, recv the f32 travelling sum received from
//   the left-hand neighbour (nullptr at step 0), written in f32 to travel
//   on, or, at the last step, rounded once to A's type. recv and out are
//   one buffer at the middle steps (the sum updated in place).
// - bf16/f16 (both): csrc/wgmma_gemm.cuh, in the form kernels/wgmma_plan.py
//   picks from the step's shape: the persistent TMA kernel gemm_tma
//   (aligned shapes with tiles enough: ViT-B/16 b128's steps make 300 tiles
//   of 128 x 128 over 4 ranks, llama_1b's ag step 88 and its rs step 128),
//   or the cluster form (any shape; K split over up to 8 CTAs summed in a
//   fixed order through distributed shared memory). The rs epilogue adds
//   recv to the f32 sum and rounds once (the core's header says how).
// - int8 A and B sum in int32 on mma.sync m16n8k32 (csrc/int8_gemm.cuh):
//   ag casts the int32 sum to int8, which wraps (keeps the low 8 bits), as
//   the Pallas kernel's astype does; rs converts the sum to f32 and adds it
//   to the travelling sum, and its last step clamps to [-128, 127] (NaN to
//   0) and truncates, as the JAX kernel's astype of its f32 sum does.
// - f32 (both): csrc/gemm.cuh's register-tiled FMA loop in full f32 (no
//   TF32).
//
// What bounds it on an H100: the tensor cores for ag (ViT-B/16's MLP up at
// batch 128 over 4 ranks: a step of 6,304 x 768 x 768, 7.4 GFLOP, 7.5 us
// at 989 TFLOP/s dense bf16). rs's step at ViT-B/16 (6,304 x 768 x 768) is
// bound by its epilogue's bytes: recv and out in f32 are 38.7 MB a step,
// 11.6 us at 3.35 TB/s, more than its 7.5 us of tensor-core work; llama_1b's
// (1,024 x 2,048 x 1,408) nearly so (16.8 MB, 5.0 us, against 6.0 us). So
// gemm_tma brings each tile's recv into shared memory by TMA while the
// tile's K loop runs, and the epilogue only adds and stores. On one card
// the ring's slot copies move the same f32 sums again (3 a chunk).
// Before the wgmma core the steps ran gemm.cuh's mma.sync loop at 83-107
// TFLOP/s: ag 1.1074 ms a ViT-B/16 call, rs 1.4312 (NVIDIA H100 80GB HBM3,
// 700 W; PERF.md rows 22-23).
#include <type_traits>

#include "gemm.cuh"
#include "int8_gemm.cuh"
#include "wgmma_gemm.cuh"

namespace {

using namespace smelter;

// out[o] = [recv[o] +] v. recv and out may be one buffer (the travelling
// sum, updated in place), so neither is __restrict__.
__device__ __forceinline__ void put(float* out, const float* recv, size_t o, float v) {
  out[o] = recv != nullptr ? recv[o] + v : v;
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

// A 16-bit step on the wgmma core, in the plan's form: ag (recv nullptr,
// out in T) or rs (out = [recv +] A @ B, f32 or T). The tma form's rs
// epilogue moves recv and out in 16-byte chunks: both must be aligned.
template <typename T>
int launch16(const void* a, const void* b, const float* recv, void* out, int out_dtype, int M,
             int N, int K, int form, int bn, int split, int k_chunk, int grid,
             cudaStream_t stream) {
  if (form == wg::kFormTma && bn == 128 &&
      (recv == nullptr || (aligned16(recv) && aligned16(out))))
    return wg::launch_tma<T, 128>(a, b, recv, out, out_dtype, M, N, K, grid, stream);
  if (form == wg::kFormCluster && bn == wg::CL_BN && split >= 1 && split <= 8 && k_chunk > 0 &&
      k_chunk % wg::BK == 0)
    return wg::launch_cluster<T, false>(a, b, nullptr, recv, out, out_dtype, M, N, K, split,
                                        k_chunk, stream);
  return static_cast<int>(cudaErrorInvalidValue);
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
// (ag): out in in_dtype, no recv. reduce 1 (rs): out f32 (the travelling
// sum) or in_dtype (the last step). form, bn, split, k_chunk and grid are
// kernels/wgmma_plan.py's plan for a 16-bit step. Returns a cudaError_t
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
      return launch16<__nv_bfloat16>(a, b, r, out, out_dtype, M, N, K, form, bn, split, k_chunk,
                                     grid, st);
    case kF16:
      return launch16<__half>(a, b, r, out, out_dtype, M, N, K, form, bn, split, k_chunk, grid,
                              st);
    case kI8:
      if (reduce == 0) return launch_int8<kWrap>(a, b, nullptr, out, M, N, K, st);
      return travel ? launch_int8<kTravel>(a, b, r, out, M, N, K, st)
                    : launch_int8<kSaturate>(a, b, r, out, M, N, K, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
