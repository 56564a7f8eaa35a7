// Streaming-softmax attention for Hopper: out = softmax(q k^T * scale) v over
// q (B, H, Nq, hd) and k, v (B, H, Nk, hd), non-causal, Nq and Nk free.
//
// Replaces the Pallas kernel smelter_tpu/kernels/flash_attention.py::
// _flash_attention_impl, whose grid walks the KV tiles of one query tile in
// order with a running max, sum and rescaled f32 accumulator in VMEM. Two
// forms, chosen by kernels/attention_plan.py::flash_plan and passed in as
// `form`:
//
// 1: bf16/f16 at hd 32, 64, 128 whose strides and bases a TMA map takes: the
//   streaming form of csrc/wgmma_attention.cuh (attn_stream) in one call, a
//   step that is both the ring's first and last, so no f32 state touches
//   device memory. A CTA takes 128 query rows of one (batch, head): a
//   producer thread brings Q once and K and V in 128-key tiles through 4-D
//   tensor maps of the (B, H, N, hd) views into a ring of stages, two
//   consumer warpgroups run S = Q K^T and P V on wgmma with the running max,
//   sum and f32 accumulator in registers (at hd <= 64 the next tile's scores
//   and softmax overlap this tile's P V), and out = acc / l goes out through
//   out's strides. Grid (Nq / 128, B H).
// 0: everything else keeps this file's kernels: the KV sweep is a loop
//   inside one block of 4 warps a (batch, head, 64 query rows), the Q
//   tile's fragments in registers, K and V 64 keys at a time through a
//   two-stage cp.async ring, mma.sync with f32 accumulation (hd 16); f32
//   (in full f32), other head dims and rows not 16-byte aligned take
//   csrc/attention.cuh's warp-per-row kernel with f32 p.
//
// Arithmetic, as the Pallas kernel's: scores q k^T in f32 (exact products of
// the 16-bit operands summed in f32), times scale; keys past Nk are -inf
// and their V rows zeros; per KV tile m_new = max(m, max_j s), p = exp(s -
// m_new), l = exp(m - m_new) l + sum_j p, acc = exp(m - m_new) acc + p V;
// out = acc / l in q's type. One deviation: p meets V on the tensor cores
// rounded to the operands' 16-bit type (the Pallas kernel keeps it in f32);
// the sum l is taken over the f32 p. The fast exp (ex2.approx) stands for
// exp; the wgmma form folds a positive scale into its exponent.
//
// What bounds it on an H100: at ViT-B/16 384 px (B 64, H 12, N 577, hd 64)
// a call does 4 B H N^2 hd = 65.5 GFLOP (66 us at 989 TFLOP/s dense bf16)
// against 227 MB of q, k, v and out (68 us at 3.35 TB/s): the bytes, by a
// hair; at B 2, H 12, N 4096 the tensor cores (103 GFLOP, 104 us), with the
// exponentials as long: a score takes one exp and 2 hd multiply-adds, and
// at hd 64 an SM's 16 exps a clock keep pace with its 2,048 multiply-adds.
#include "attention.cuh"
#include "wgmma_attention.cuh"

namespace {

using namespace smelter;

template <typename T, int HD>
__global__ void __launch_bounds__(ATT_THREADS)
flash_mma(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
          const uint16_t* __restrict__ v, uint16_t* __restrict__ out, Strides qs, Strides ks,
          Strides vs, Strides os, int Nq, int Nk, float scale) {
  constexpr int S = HD + 8, TILE = ATT_ROWS * S;
  extern __shared__ __align__(16) uint16_t smem[];
  uint16_t* Qs = smem;               // [row][d]
  uint16_t* Ks = smem + TILE;        // [stage][key][d]
  uint16_t* Vs = smem + 3 * TILE;    // [stage][key][d]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, t = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * ATT_ROWS, wq = warp * 16;
  const bool active = q0 + wq < Nq;
  const int chunks = (Nk + ATT_ROWS - 1) / ATT_ROWS;

  load_tile<HD>(Qs, q, qs, b, h, q0, Nq);
  load_tile<HD>(Ks, k, ks, b, h, 0, Nk);
  load_tile<HD>(Vs, v, vs, b, h, 0, Nk);
  cp_async_commit();

  uint32_t qa[HD / 16][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  for (int c = 0; c < chunks; ++c) {
    const int c0 = c * ATT_ROWS, stage = c & 1;
    if (c + 1 < chunks) {  // the next tile into the other stage, freed at the end of c - 1
      load_tile<HD>(Ks + (stage ^ 1) * TILE, k, ks, b, h, c0 + ATT_ROWS, Nk);
      load_tile<HD>(Vs + (stage ^ 1) * TILE, v, vs, b, h, c0 + ATT_ROWS, Nk);
    }
    cp_async_commit();
    cp_async_wait<1>();  // every group but the newest: tile c (and Q) landed
    __syncthreads();
    if (c == 0) q_fragments<HD>(qa, Qs, wq);
    if (active) {
      float s[8][4];
      tile_scores<T, HD>(s, qa, Ks + stage * TILE);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[j][e] = c0 + j * 8 + t * 2 + (e & 1) < Nk ? s[j][e] * scale : -INFINITY;
      // running max and sum of each of the thread's two rows (4 lanes a row)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float mn = fmaxf(m[r], mx);
        const float alpha = __expf(m[r] - mn);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          s[j][2 * r] = __expf(s[j][2 * r] - mn);
          s[j][2 * r + 1] = __expf(s[j][2 * r + 1] - mn);
          sum += s[j][2 * r] + s[j][2 * r + 1];
        }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        l[r] = l[r] * alpha + sum;
        m[r] = mn;
#pragma unroll
        for (int n = 0; n < HD / 8; ++n) {
          o[n][2 * r] *= alpha;
          o[n][2 * r + 1] *= alpha;
        }
      }
      const uint16_t* vt = Vs + stage * TILE;
#pragma unroll
      for (int k2 = 0; k2 < ATT_ROWS / 16; ++k2) {
        const float* s0 = s[2 * k2];
        const float* s1 = s[2 * k2 + 1];
        const uint32_t a[4] = {pack2<T>(s0[0], s0[1]), pack2<T>(s0[2], s0[3]),
                               pack2<T>(s1[0], s1[1]), pack2<T>(s1[2], s1[3])};
        pv_step<T, HD>(o, a, vt + k2 * 16 * S);
      }
    }
    __syncthreads();  // tile c is consumed: its stage takes tile c + 2
  }
  cp_async_wait<0>();
  if (!active) return;
  const float inv[2] = {1.f / l[0], 1.f / l[1]};
  store_rows<T, HD>(out, os, b, h, q0 + wq, Nq, o, inv);
}

template <typename T, int HD>
void launch_mma(const void* q, const void* k, const void* v, void* o, const Strides (&s)[4],
                int B, int H, int Nq, int Nk, float scale, cudaStream_t stream) {
  constexpr int smem = 5 * ATT_ROWS * (HD + 8) * 2;  // Q and two stages of K and V
  static const cudaError_t smem_set = cudaFuncSetAttribute(
      flash_mma<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  (void)smem_set;  // a refusal shows as the launch's error
  const dim3 grid(cdiv(Nq, ATT_ROWS), H, B);
  flash_mma<T, HD><<<grid, ATT_THREADS, smem, stream>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), static_cast<uint16_t*>(o), s[0], s[1], s[2], s[3], Nq,
      Nk, scale);
}

template <typename T>
void launch(const void* q, const void* k, const void* v, void* o, const Strides (&s)[4], int B,
            int H, int Nq, int Nk, int hd, float scale, bool mma, cudaStream_t stream) {
  if constexpr (!std::is_same<T, float>::value) {
    if (mma) {
      if (hd == 16) return launch_mma<T, 16>(q, k, v, o, s, B, H, Nq, Nk, scale, stream);
      if (hd == 32) return launch_mma<T, 32>(q, k, v, o, s, B, H, Nq, Nk, scale, stream);
      if (hd == 64) return launch_mma<T, 64>(q, k, v, o, s, B, H, Nq, Nk, scale, stream);
      return launch_mma<T, 128>(q, k, v, o, s, B, H, Nq, Nk, scale, stream);
    }
  }
  launch_rows<T, false>(q, k, v, o, s, B, H, Nq, Nk, hd, scale, stream);
}

// One call on the streaming form of csrc/wgmma_attention.cuh (no f32
// state: the first and the last step at once) at head dim hd.
template <typename T>
int launch_stream(const void* q, const void* k, const void* v, void* o,
                  const wa::View (&vw)[4], int B, int H, int Nq, int Nk, int hd, float scale,
                  cudaStream_t stream) {
  if (hd != 32 && hd != 64 && hd != 128) return static_cast<int>(cudaErrorInvalidValue);
  const auto step = hd == 32   ? wa::launch_stream<T, 32>
                    : hd == 64 ? wa::launch_stream<T, 64>
                               : wa::launch_stream<T, 128>;
  return step(q, k, v, nullptr, nullptr, nullptr, o, vw, B, H, Nq, Nk, scale, true, true,
              stream);
}

}  // namespace

extern "C" const char* smelter_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q (B, H, Nq, hd), k and v (B, H, Nk, hd) and out (B, H, Nq, hd), all in
// x_dtype, each addressed by its (batch, head, row) element strides with a
// contiguous head dim. hd <= 256. form: kernels/attention_plan.py::
// flash_plan's code (1: the streaming form of csrc/wgmma_attention.cuh; 0:
// this file's kernels). Returns a cudaError_t code.
extern "C" int smelter_flash_attention(const void* q, const void* k, const void* v, void* out,
                                       int B, int H, int Nq, int Nk, int hd, int qsb, int qsh,
                                       int qsn, int ksb, int ksh, int ksn, int vsb, int vsh,
                                       int vsn, int osb, int osh, int osn, float scale,
                                       int x_dtype, int form, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (hd <= 0 || hd > ROWS_HD_MAX || Nk <= 0 || form < 0 || form > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || H == 0 || Nq == 0) return 0;
  if (form == 1) {
    const wa::View vw[4] = {{qsb, qsh, qsn}, {ksb, ksh, ksn}, {vsb, vsh, vsn}, {osb, osh, osn}};
    if (x_dtype == kBF16)
      return launch_stream<__nv_bfloat16>(q, k, v, out, vw, B, H, Nq, Nk, hd, scale, st);
    if (x_dtype == kF16)
      return launch_stream<__half>(q, k, v, out, vw, B, H, Nq, Nk, hd, scale, st);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Strides s[4] = {{qsb, qsh, qsn}, {ksb, ksh, ksn}, {vsb, vsh, vsn}, {osb, osh, osn}};
  const void* const ptrs[4] = {q, k, v, out};
  const bool mma = mma_path(x_dtype, hd, ptrs, s);
  switch (x_dtype) {
    case kF32:
      launch<float>(q, k, v, out, s, B, H, Nq, Nk, hd, scale, false, st);
      break;
    case kBF16:
      launch<__nv_bfloat16>(q, k, v, out, s, B, H, Nq, Nk, hd, scale, mma, st);
      break;
    case kF16:
      launch<__half>(q, k, v, out, s, B, H, Nq, Nk, hd, scale, mma, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
