// One rank's merge step of the ring attention of smelter_tpu_torch/kernels/
// ring_attention_rdma.py: fold the K/V shard in hand into the f32
// streaming-softmax state (m, l, acc) of the rank's queries; the last step
// writes out = acc / l in q's type instead of the state.
//
// Replaces the Pallas kernel smelter_tpu/kernels/ring_attention_rdma.py::
// ring_attention_rdma (_make_kernel), which holds the whole (BH, Nl, D) shard
// and its f32 state in VMEM and runs every ring step in one kernel, sending
// K and V to the right-hand neighbour by make_async_remote_copy while it
// merges. Here a launch is one rank's step (parallel/ring.py copies the
// slots on a comm stream between launches), tiled over (BH, query rows), and
// the f32 state lives in device memory between the steps: (BH, Nl) for m
// and l, (BH, Nl, D) for acc, read at the start of a step and written at its
// end (none of it at the first step; acc / l at the last).
//
// Arithmetic, as the Pallas kernel's: q, k, v widened to f32; s = q k^T *
// scale; per block of keys m_new = max(m, max_j s), p = exp(s - m_new),
// alpha = exp(m - m_new), l = alpha l + sum_j p, acc = acc alpha + p v; out
// = acc / l rounded to q's type. The Pallas kernel merges a step's whole
// shard at once; the kernels merge 128 (f32: 32) keys at a time, the same
// algebra in another order.
//
// - bf16 / f16, head dims 32, 64 and 128: csrc/wgmma_attention.cuh's
//   streaming form (attn_stream): a CTA of two consumer warpgroups takes 128
//   query rows of a (b, h), a producer thread brings Q once and K and V in
//   128-key tiles by TMA into a ring of stages behind mbarriers, S = Q K^T
//   is a wgmma from shared memory with f32 sums (exact products summed in
//   f32), and P V a wgmma with P in registers. One deviation: p meets V
//   rounded to the operands' 16-bit type (the sum l is taken over the f32
//   p), as csrc/flash_attention.cu does. Bound: 1e-2 of the largest output.
// - f32, head dims 32, 64 and 128: full f32 on the FMA units (no TF32); a
//   warp takes 4 query rows, a lane one key of each 32-key tile for the
//   scores and 1-4 head dims for p v, with the accurate expf.
// Other head dims, types and layouts raise in the wrapper.
//
// What bounds it on an H100: the tensor cores. At llama_1b's heads (H 16, D
// 128), B 1, N 32,768 over 4 ranks, the ring does 4 B H N^2 D = 8.8 TFLOP
// (8.9 ms at 989 TFLOP/s dense bf16) against 64 MB of q, k, v and out; the
// state adds 2 x 64 MB of f32 acc a rank-step (1 TB/s-scale traffic, small
// beside the products), and the ring's copies 3 x 2 x 16 MB a rank. The
// exponentials come close behind (one per 4 hd products), which the two
// warpgroups of a CTA hide from each other; mma.sync, the earlier design,
// reached 21 % of the tensor cores' rate.
#include "layer_norm.cuh"
#include "wgmma_attention.cuh"

namespace {

using namespace smelter;

// f32: a block of 4 warps takes 16 query rows (4 a warp) against 32-key
// tiles of K and V in shared memory. For the scores a lane takes one key
// (K rows padded by one word, so the 32 lanes' rows fall in 32 banks); for p
// v a lane takes head dims lane + 32 i, each p broadcast from its lane.
constexpr int F_WARPS = 4, F_ROWS = 4, F_KEYS = 32;

template <int PER>
__global__ void __launch_bounds__(32 * F_WARPS)
ring_step_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ m_g, float* __restrict__ l_g,
              float* __restrict__ acc_g, float* __restrict__ out, int Nq, int Nk, float scale,
              bool first, bool last) {
  constexpr int HD = 32 * PER, QROWS = F_WARPS * F_ROWS;
  __shared__ float Qs[QROWS][HD];
  __shared__ float Ks[F_KEYS][HD + 1];
  __shared__ float Vs[F_KEYS][HD];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.y, r0 = blockIdx.x * QROWS;
  const float* qb = q + static_cast<size_t>(bh) * Nq * HD;
  const float* kb = k + static_cast<size_t>(bh) * Nk * HD;
  const float* vb = v + static_cast<size_t>(bh) * Nk * HD;
  for (int i = tid; i < QROWS * HD; i += 32 * F_WARPS) {
    const int r = i / HD, d = i % HD;
    Qs[r][d] = r0 + r < Nq ? qb[static_cast<size_t>(r0 + r) * HD + d] : 0.f;
  }
  float m[F_ROWS], l[F_ROWS], o[F_ROWS][PER];
#pragma unroll
  for (int rr = 0; rr < F_ROWS; ++rr) {
    const int row = r0 + warp * F_ROWS + rr;
    const size_t at = static_cast<size_t>(bh) * Nq + row;
    const bool load = !first && row < Nq;
    m[rr] = load ? m_g[at] : -INFINITY;
    l[rr] = load ? l_g[at] : 0.f;
#pragma unroll
    for (int i = 0; i < PER; ++i) o[rr][i] = load ? acc_g[at * HD + lane + 32 * i] : 0.f;
  }
  for (int k0 = 0; k0 < Nk; k0 += F_KEYS) {
    __syncthreads();  // the last tile (and, at first, Q) is consumed / stored
    for (int i = tid; i < F_KEYS * HD; i += 32 * F_WARPS) {
      const int j = i / HD, d = i % HD;
      const bool in = k0 + j < Nk;
      Ks[j][d] = in ? kb[static_cast<size_t>(k0 + j) * HD + d] : 0.f;
      Vs[j][d] = in ? vb[static_cast<size_t>(k0 + j) * HD + d] : 0.f;
    }
    __syncthreads();
    const bool valid = k0 + lane < Nk;
#pragma unroll
    for (int rr = 0; rr < F_ROWS; ++rr) {
      const float* qr = Qs[warp * F_ROWS + rr];
      float sc = 0.f;
#pragma unroll 8
      for (int d = 0; d < HD; ++d) sc = fmaf(qr[d], Ks[lane][d], sc);
      sc = valid ? sc * scale : -INFINITY;
      float mx = sc;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mn = fmaxf(m[rr], mx);
      const float alpha = expf(m[rr] - mn);
      const float p = valid ? expf(sc - mn) : 0.f;
      l[rr] = alpha * l[rr] + warp_sum(p);
      m[rr] = mn;
#pragma unroll
      for (int i = 0; i < PER; ++i) o[rr][i] *= alpha;
#pragma unroll 4
      for (int j = 0; j < F_KEYS; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
        for (int i = 0; i < PER; ++i) o[rr][i] = fmaf(pj, Vs[j][lane + 32 * i], o[rr][i]);
      }
    }
  }
#pragma unroll
  for (int rr = 0; rr < F_ROWS; ++rr) {
    const int row = r0 + warp * F_ROWS + rr;
    if (row >= Nq) continue;
    const size_t at = static_cast<size_t>(bh) * Nq + row;
    if (last) {
#pragma unroll
      for (int i = 0; i < PER; ++i) out[at * HD + lane + 32 * i] = o[rr][i] / l[rr];
      continue;
    }
    if (lane == 0) {
      m_g[at] = m[rr];
      l_g[at] = l[rr];
    }
#pragma unroll
    for (int i = 0; i < PER; ++i) acc_g[at * HD + lane + 32 * i] = o[rr][i];
  }
}

template <typename T>
int launch_16(const void* q, const void* k, const void* v, float* m, float* l, float* acc,
              void* out, int BH, int Nq, int Nk, int hd, float scale, bool first, bool last,
              cudaStream_t st) {
  const auto step = hd == 32   ? wa::launch_ring_step<T, 32>
                    : hd == 64 ? wa::launch_ring_step<T, 64>
                               : wa::launch_ring_step<T, 128>;
  return step(q, k, v, m, l, acc, out, BH, Nq, Nk, scale, first, last, st);
}

template <int PER>
void launch_f32(const void* q, const void* k, const void* v, float* m, float* l, float* acc,
                void* out, int BH, int Nq, int Nk, float scale, bool first, bool last,
                cudaStream_t stream) {
  const dim3 grid(cdiv(Nq, F_WARPS * F_ROWS), BH);
  ring_step_f32<PER><<<grid, 32 * F_WARPS, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      m, l, acc, static_cast<float*>(out), Nq, Nk, scale, first, last);
}

}  // namespace

extern "C" const char* smelter_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q (BH, Nq, hd), k and v (BH, Nk, hd), out (BH, Nq, hd), contiguous, in
// x_dtype (16-byte aligned for 16-bit types); m, l (BH, Nq) and acc (BH, Nq,
// hd) f32, the state, read unless `first`, written unless `last`; out
// written only when `last`. hd 32, 64 or 128. Returns a cudaError_t code.
extern "C" int smelter_ring_attention_step(const void* q, const void* k, const void* v,
                                           void* m, void* l, void* acc, void* out, int BH,
                                           int Nq, int Nk, int hd, float scale, int first,
                                           int last, int x_dtype, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if ((hd != 32 && hd != 64 && hd != 128) || Nk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (BH == 0 || Nq == 0) return 0;
  auto* mf = static_cast<float*>(m);
  auto* lf = static_cast<float*>(l);
  auto* af = static_cast<float*>(acc);
  switch (x_dtype) {
    case kF32:
      if (hd == 32)
        launch_f32<1>(q, k, v, mf, lf, af, out, BH, Nq, Nk, scale, first, last, st);
      else if (hd == 64)
        launch_f32<2>(q, k, v, mf, lf, af, out, BH, Nq, Nk, scale, first, last, st);
      else
        launch_f32<4>(q, k, v, mf, lf, af, out, BH, Nq, Nk, scale, first, last, st);
      return static_cast<int>(cudaGetLastError());
    case kBF16:
      return launch_16<__nv_bfloat16>(q, k, v, mf, lf, af, out, BH, Nq, Nk, hd, scale, first,
                                      last, st);
    case kF16:
      return launch_16<__half>(q, k, v, mf, lf, af, out, BH, Nq, Nk, hd, scale, first, last, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
