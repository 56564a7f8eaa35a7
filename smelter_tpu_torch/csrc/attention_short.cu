// Short-sequence attention for Hopper: out = softmax(q k^T * scale) v over
// equal (B, H, N, hd) q, k and v with N <= 512, whole score rows on chip.
//
// Replaces the Pallas kernel smelter_tpu/kernels/attention_short.py::
// short_attention, which holds the whole (N, N) score matrix of a group of
// heads in VMEM so that QK^T, the softmax and PV run back to back. Two forms,
// chosen by kernels/attention_plan.py::short_plan and passed in as `form`:
//
// 1: bf16/f16 at hd 16, 32, 64, 128 whose strides and bases a TMA map takes
//   (and K and V fit shared memory: hd 128 to 384 keys): the normalised form
//   of csrc/wgmma_attention.cuh (attn_norm on kViews), the Pallas kernel's
//   order. Persistent CTAs, one an SM, take work items of 128 query rows of
//   one (batch, head); a producer thread brings Q and all the head's K and V
//   into shared memory through 4-D tensor maps of the (B, H, N, hd) views,
//   two consumer warpgroups run S = Q K^T and P V on wgmma (one pass over up
//   to 256 keys, the first 128-key tile's exps staged in shared memory; two
//   passes over resident K and V past that), and the output goes out
//   through out's strides.
// 0: everything else keeps this file's kernels. One block of 4 warps takes
//   a (batch, head, 64 query rows) and keeps those rows' scores over every
//   key in shared memory, 64 x 512 f32 (128 KB) at most: K streams through
//   a 64-key tile and mma.sync writes the f32 scores into the rows; each
//   warp then takes the exact softmax of its 16 rows in place and writes p,
//   rounded to the operands' 16-bit type, over the first half of each row's
//   own bytes; V then streams through the same tile and mma.sync
//   accumulates p V in f32. f32 (in full f32), other head dims and rows not
//   16-byte aligned take csrc/attention.cuh's warp-per-row kernel, with
//   exp, the division and the same rounding of p.
//
// Arithmetic, as the Pallas kernel's: scores in f32 times scale; key
// columns past N are -1e30 (the wgmma form's -inf); p = exp(s - max) / sum
// in f32, then rounded to v's type before PV, whose sum runs in f32; out in
// q's type. The fast exp (ex2.approx) and one reciprocal of the sum a row
// stand for exp and the division: p is rounded to 8 or 11 bits next.
//
// What bounds it on an H100: at ViT-B/16 224 px (B 128, H 12, N 197, hd 64)
// a call does 4 B H N^2 hd = 15.3 GFLOP (15 us at 989 TFLOP/s dense bf16)
// against 155 MB of q, k, v and out (46 us at 3.35 TB/s): the bytes. The
// wgmma form reads each head's K and V once per 128-row item (twice at N
// 197, the second mostly from L2) and the scores never leave the SM; its
// 128-key tiles and 128-row items pad 197 keys and rows to 256.
#include "attention.cuh"
#include "wgmma_attention.cuh"

namespace {

using namespace smelter;

constexpr int SHORT_N_MAX = 512;

// Shared memory: the score rows (64 x (NP + 4) f32) and one 64-row tile.
template <int HD>
constexpr int short_smem(int NP) {
  return ATT_ROWS * (NP + 4) * 4 + ATT_ROWS * (HD + 8) * 2;
}

template <typename T, int HD>
__global__ void __launch_bounds__(ATT_THREADS)
short_mma(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
          const uint16_t* __restrict__ v, uint16_t* __restrict__ out, Strides qs, Strides ks,
          Strides vs, Strides os, int N, int NP, float scale) {
  constexpr int S = HD + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int SP = NP + 4;  // f32 per score row; as T, p takes the row's first NP halves
  float* sc = reinterpret_cast<float*>(smem_raw);
  const uint16_t* p16 = reinterpret_cast<const uint16_t*>(sc);
  uint16_t* tile = reinterpret_cast<uint16_t*>(sc + ATT_ROWS * SP);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * ATT_ROWS, wq = warp * 16;
  const bool active = q0 + wq < N;

  load_tile<HD>(tile, q, qs, b, h, q0, N);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qa[HD / 16][4];
  q_fragments<HD>(qa, tile, wq);

  // 1. the scores of every key into the rows, and each row's max
  float m[2] = {-INFINITY, -INFINITY};
  for (int c0 = 0; c0 < NP; c0 += ATT_ROWS) {
    __syncthreads();  // the tile is free
    load_tile<HD>(tile, k, ks, b, h, c0, N);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if (!active) continue;
    float s[8][4];
    tile_scores<T, HD>(s, qa, tile);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int key = c0 + j * 8 + t * 2;
        float2 val;
        val.x = key < N ? s[j][2 * r] * scale : -1e30f;
        val.y = key + 1 < N ? s[j][2 * r + 1] * scale : -1e30f;
        *reinterpret_cast<float2*>(&sc[(wq + g + 8 * r) * SP + key]) = val;
        m[r] = fmaxf(m[r], fmaxf(val.x, val.y));
      }
  }

  // 2. each thread's own score elements (rows g and g + 8 of the warp, keys
  // 8 j + 2 t and + 1 of every 8-key tile): the row's sum of exp(s - max)
  // over its 4 lanes, then p = exp(s - max) * (1 / sum) rounded to T, over
  // the first half of the row's bytes. A warp owns its 16 rows, and the p
  // of keys c0 .. c0 + 63 lands on s of keys c0 / 2 .. c0 / 2 + 31, which
  // the warp has read by then (__syncwarp between the reads and the writes).
  if (active) {
    uint16_t* pw = reinterpret_cast<uint16_t*>(sc);
    float l[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 1));
      m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 2));
    }
    for (int c0 = 0; c0 < NP; c0 += ATT_ROWS)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float2 v =
              *reinterpret_cast<const float2*>(&sc[(wq + g + 8 * r) * SP + c0 + j * 8 + t * 2]);
          l[r] += __expf(v.x - m[r]) + __expf(v.y - m[r]);
        }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      l[r] = 1.f / l[r];
    }
    for (int c0 = 0; c0 < NP; c0 += ATT_ROWS) {
      float2 v[8][2];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          v[j][r] =
              *reinterpret_cast<const float2*>(&sc[(wq + g + 8 * r) * SP + c0 + j * 8 + t * 2]);
      __syncwarp();
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          *reinterpret_cast<uint32_t*>(&pw[(wq + g + 8 * r) * 2 * SP + c0 + j * 8 + t * 2]) =
              pack2<T>(__expf(v[j][r].x - m[r]) * l[r], __expf(v[j][r].y - m[r]) * l[r]);
      __syncwarp();
    }
  }

  // 3. o = p V, V streamed through the tile
  float o[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  for (int c0 = 0; c0 < NP; c0 += ATT_ROWS) {
    __syncthreads();
    load_tile<HD>(tile, v, vs, b, h, c0, N);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if (!active) continue;
#pragma unroll
    for (int k2 = 0; k2 < ATT_ROWS / 16; ++k2) {
      uint32_t a[4];
      ldmatrix_x4(a, &p16[(wq + (lane & 15)) * 2 * SP + c0 + k2 * 16 + (lane >> 4) * 8]);
      pv_step<T, HD>(o, a, tile + k2 * 16 * S);
    }
  }
  if (!active) return;
  const float one[2] = {1.f, 1.f};
  store_rows<T, HD>(out, os, b, h, q0 + wq, N, o, one);
}

template <typename T, int HD>
void launch_mma(const void* q, const void* k, const void* v, void* o, const Strides (&s)[4],
                int B, int H, int N, float scale, cudaStream_t stream) {
  static const cudaError_t smem_set =
      cudaFuncSetAttribute(short_mma<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           short_smem<HD>(SHORT_N_MAX));
  (void)smem_set;  // a refusal shows as the launch's error
  const int NP = cdiv(N, ATT_ROWS) * ATT_ROWS;
  const dim3 grid(cdiv(N, ATT_ROWS), H, B);
  short_mma<T, HD><<<grid, ATT_THREADS, short_smem<HD>(NP), stream>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), static_cast<uint16_t*>(o), s[0], s[1], s[2], s[3], N, NP,
      scale);
}

template <typename T>
void launch(const void* q, const void* k, const void* v, void* o, const Strides (&s)[4], int B,
            int H, int N, int hd, float scale, bool mma, cudaStream_t stream) {
  if constexpr (!std::is_same<T, float>::value) {
    if (mma) {
      if (hd == 16) return launch_mma<T, 16>(q, k, v, o, s, B, H, N, scale, stream);
      if (hd == 32) return launch_mma<T, 32>(q, k, v, o, s, B, H, N, scale, stream);
      if (hd == 64) return launch_mma<T, 64>(q, k, v, o, s, B, H, N, scale, stream);
      return launch_mma<T, 128>(q, k, v, o, s, B, H, N, scale, stream);
    }
  }
  launch_rows<T, true>(q, k, v, o, s, B, H, N, N, hd, scale, stream);
}

// The normalised form of csrc/wgmma_attention.cuh at head dim hd.
template <typename T>
int launch_norm(const void* q, const void* k, const void* v, void* o, const wa::View (&vw)[4],
                int B, int H, int N, int hd, float scale, int tiles, int buffers, int grid,
                cudaStream_t stream) {
  if (hd != 16 && hd != 32 && hd != 64 && hd != 128)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto norm = hd == 16   ? wa::launch_norm_views<T, 16>
                    : hd == 32 ? wa::launch_norm_views<T, 32>
                    : hd == 64 ? wa::launch_norm_views<T, 64>
                               : wa::launch_norm_views<T, 128>;
  return norm(q, k, v, o, vw, B, H, N, scale, tiles, buffers, grid, stream);
}

}  // namespace

extern "C" const char* smelter_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q, k, v and out (B, H, N, hd) in x_dtype, each addressed by its (batch,
// head, row) element strides with a contiguous head dim. N <= 512,
// hd <= 256. form: kernels/attention_plan.py::short_plan's code (1: the
// normalised form of csrc/wgmma_attention.cuh, with the plan's tiles,
// buffers and grid; 0: this file's kernels). Returns a cudaError_t code.
extern "C" int smelter_short_attention(const void* q, const void* k, const void* v, void* out,
                                       int B, int H, int N, int hd, int qsb, int qsh, int qsn,
                                       int ksb, int ksh, int ksn, int vsb, int vsh, int vsn,
                                       int osb, int osh, int osn, float scale, int x_dtype,
                                       int form, int tiles, int buffers, int grid,
                                       void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (hd <= 0 || hd > ROWS_HD_MAX || N > SHORT_N_MAX || form < 0 || form > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || H == 0 || N == 0) return 0;
  if (form == 1) {
    const wa::View vw[4] = {{qsb, qsh, qsn}, {ksb, ksh, ksn}, {vsb, vsh, vsn}, {osb, osh, osn}};
    if (x_dtype == kBF16)
      return launch_norm<__nv_bfloat16>(q, k, v, out, vw, B, H, N, hd, scale, tiles, buffers,
                                        grid, st);
    if (x_dtype == kF16)
      return launch_norm<__half>(q, k, v, out, vw, B, H, N, hd, scale, tiles, buffers, grid, st);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Strides s[4] = {{qsb, qsh, qsn}, {ksb, ksh, ksn}, {vsb, vsh, vsn}, {osb, osh, osn}};
  const void* const ptrs[4] = {q, k, v, out};
  const bool mma = mma_path(x_dtype, hd, ptrs, s);
  switch (x_dtype) {
    case kF32:
      launch<float>(q, k, v, out, s, B, H, N, hd, scale, false, st);
      break;
    case kBF16:
      launch<__nv_bfloat16>(q, k, v, out, s, B, H, N, hd, scale, mma, st);
      break;
    case kF16:
      launch<__half>(q, k, v, out, s, B, H, N, hd, scale, mma, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
