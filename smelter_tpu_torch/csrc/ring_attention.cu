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
// shard at once; the kernels merge 64 (or 32) keys at a time, the same
// algebra in another order.
//
// - bf16 / f16, head dims 32, 64 and 128: csrc/attention.cuh's tile loop (a
//   block of 4 warps a (bh, 64 query rows), Q in registers, K and V 64 keys
//   at a time through a two-stage cp.async ring, q k^T on mma.sync with f32
//   sums, which is exact products summed in f32). One deviation: p meets V
//   on the tensor cores rounded to the operands' 16-bit type (the sum l is
//   taken over the f32 p), as csrc/flash_attention.cu does; the fast exp
//   stands for exp. Bound: 1e-2 of the largest output.
// - f32, head dims 32, 64 and 128: full f32 on the FMA units (no TF32); a
//   warp takes 4 query rows, a lane one key of each 32-key tile for the
//   scores and 1-4 head dims for p v, with the accurate expf.
// Other head dims, types and layouts raise in the wrapper.
//
// What bounds it on an H100: the tensor cores. At llama_1b's heads (H 16, D
// 128), B 1, N 32,768 over 4 ranks, the ring does 4 B H N^2 D = 8.8 TFLOP
// (8.9 ms at 989 TFLOP/s dense bf16) against 64 MB of q, k, v and out; the
// state adds 2 x 64 MB of f32 acc a rank-step (1 TB/s-scale traffic, small
// beside the products), and the ring's copies 3 x 2 x 16 MB a rank.
#include "attention.cuh"

namespace {

using namespace smelter;

template <typename T, int HD>
__global__ void __launch_bounds__(ATT_THREADS)
ring_step_mma(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
              const uint16_t* __restrict__ v, float* __restrict__ m_g, float* __restrict__ l_g,
              float* __restrict__ acc_g, uint16_t* __restrict__ out, int Nq, int Nk,
              float scale, bool first, bool last) {
  constexpr int S = HD + 8, TILE = ATT_ROWS * S;
  extern __shared__ __align__(16) uint16_t smem[];
  uint16_t* Qs = smem;             // [row][d]
  uint16_t* Ks = smem + TILE;      // [stage][key][d]
  uint16_t* Vs = smem + 3 * TILE;  // [stage][key][d]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, q0 = blockIdx.x * ATT_ROWS, wq = warp * 16;
  const bool active = q0 + wq < Nq;
  const int chunks = (Nk + ATT_ROWS - 1) / ATT_ROWS;
  const Strides qs{Nq * HD, 0, HD}, ks{Nk * HD, 0, HD};

  load_tile<HD>(Qs, q, qs, bh, 0, q0, Nq);
  load_tile<HD>(Ks, k, ks, bh, 0, 0, Nk);
  load_tile<HD>(Vs, v, ks, bh, 0, 0, Nk);
  cp_async_commit();

  // The state of the thread's two rows (g and g + 8 of the warp's 16).
  uint32_t qa[HD / 16][4];
  float m[2], l[2], o[HD / 8][4];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wq + g + 8 * r;
    const size_t at = static_cast<size_t>(bh) * Nq + row;
    const bool load = !first && row < Nq;
    m[r] = load ? m_g[at] : -INFINITY;
    l[r] = load ? l_g[at] : 0.f;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      const float2 a = load ? *reinterpret_cast<const float2*>(&acc_g[at * HD + n * 8 + t * 2])
                            : make_float2(0.f, 0.f);
      o[n][2 * r] = a.x;
      o[n][2 * r + 1] = a.y;
    }
  }

  for (int c = 0; c < chunks; ++c) {
    const int c0 = c * ATT_ROWS, stage = c & 1;
    if (c + 1 < chunks) {  // the next tile into the other stage, freed at the end of c - 1
      load_tile<HD>(Ks + (stage ^ 1) * TILE, k, ks, bh, 0, c0 + ATT_ROWS, Nk);
      load_tile<HD>(Vs + (stage ^ 1) * TILE, v, ks, bh, 0, c0 + ATT_ROWS, Nk);
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
        l[r] = alpha * l[r] + sum;
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
  if (last) {
    const float inv[2] = {1.f / l[0], 1.f / l[1]};
    store_rows<T, HD>(out, qs, bh, 0, q0 + wq, Nq, o, inv);
    return;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wq + g + 8 * r;
    if (row >= Nq) continue;
    const size_t at = static_cast<size_t>(bh) * Nq + row;
    if (t == 0) {
      m_g[at] = m[r];
      l_g[at] = l[r];
    }
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<float2*>(&acc_g[at * HD + n * 8 + t * 2]) =
          make_float2(o[n][2 * r], o[n][2 * r + 1]);
  }
}

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

template <typename T, int HD>
void launch_mma(const void* q, const void* k, const void* v, float* m, float* l, float* acc,
                void* out, int BH, int Nq, int Nk, float scale, bool first, bool last,
                cudaStream_t stream) {
  constexpr int smem = 5 * ATT_ROWS * (HD + 8) * 2;  // Q and two stages of K and V
  static const cudaError_t smem_set = cudaFuncSetAttribute(
      ring_step_mma<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  (void)smem_set;  // a refusal shows as the launch's error
  const dim3 grid(cdiv(Nq, ATT_ROWS), BH);
  ring_step_mma<T, HD><<<grid, ATT_THREADS, smem, stream>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), m, l, acc, static_cast<uint16_t*>(out), Nq, Nk, scale,
      first, last);
}

template <typename T>
int launch_16(const void* q, const void* k, const void* v, float* m, float* l, float* acc,
              void* out, int BH, int Nq, int Nk, int hd, float scale, bool first, bool last,
              cudaStream_t st) {
  if (hd == 32)
    launch_mma<T, 32>(q, k, v, m, l, acc, out, BH, Nq, Nk, scale, first, last, st);
  else if (hd == 64)
    launch_mma<T, 64>(q, k, v, m, l, acc, out, BH, Nq, Nk, scale, first, last, st);
  else
    launch_mma<T, 128>(q, k, v, m, l, acc, out, BH, Nq, Nk, scale, first, last, st);
  return static_cast<int>(cudaGetLastError());
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
