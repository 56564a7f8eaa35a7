// Whole ConvNeXt block for Hopper: depthwise 7x7 (+ f32 bias) -> LayerNorm
// over C -> FC1 + f32 bias -> exact GELU -> FC2 + f32 bias -> * gamma ->
// + x, on NHWC activations.
//
// Replaces the Pallas kernel smelter_tpu/kernels/convnext_block.py::
// convnext_block (body _block_kernel), which holds one whole image, its
// zero-padded copy and both MLP weights in VMEM and runs the block in one
// program per image. On Hopper that does not fit: the padded stage-1 image
// alone (62 x 62 x 96 bf16) is 738 KB and each stage-3 MLP weight 1.18 MB,
// against 227 KB of shared memory a block. So the function is computed
// here as a fixed sequence of this library's own launches on the caller's
// stream (the Python wrapper counts the call once), in the Pallas kernel's
// arithmetic:
//
//   1. dw_ln_staged: one block per (strip of TW columns, band of output
//      rows, image), a thread per (channel, 7 neighbouring output columns).
//      The band's input rows (and the 3-row halo on each side, TW + 6
//      columns, all C channels) stream through a ring of 4 rows in shared
//      memory, 16 bytes a cp.async, zeros where the window leaves the image;
//      each thread reads its 13 values of a row once and adds them, times
//      its 49 weights held in registers, to the 7 output rows the row
//      reaches (accumulators of 7 rows x 7 columns in registers), so each
//      output's 49 taps are summed dy outer, dx inner, in f32, and the bias
//      added after them. A finished row goes to an f32 row in shared memory,
//      where a group of 16 or 32 lanes a pixel takes the LayerNorm over C in
//      f32 (the mean, then the mean of squared deviations) and writes xn
//      rounded once to x's type in 16-byte stores. Channels too many for a
//      block (C > 384) take dw_ln, which reads the taps through the cache;
//   2. FC1 xn (M, C) @ w1 (C, F), b1 added to the f32 sum, GELU's exact form
//      (the Abramowitz-Stegun erf polynomial over exp the Pallas kernel
//      spells), h rounded once;
//   3. FC2 h (M, F) @ w2 (F, C), b2 added in f32, times gamma in f32, x
//      added in f32, one rounding.
//
// What bounds it on an H100: at ConvNeXt-T's batch 64, per stage, FC1 and
// FC2 do 16 M C^2 (29.6 GFLOP at stage 1, ~30 us at 989 TFLOP/s dense
// bf16) against ~77 MB of x, weights and output (~23 us at 3.35 TB/s): the
// tensor cores; the depthwise taps (49 f32 FMAs an element, 0.94 G at stage
// 1, ~28 us at 67 TFLOP/s) hold the CUDA cores about as long as x and xn
// take to cross device memory. So FC1 and FC2 run on the wgmma GEMM core
// (csrc/wgmma_gemm.cuh's gemm_tma) wherever kernels/wgmma_plan.py says
// "tma" (16-bit x, aligned; FC1 through block_plan with the GELU epilogue
// kEpiBiasGelu, FC2 through layer_scale_plan with kEpiBiasScaleRes, N from
// 64: stage 1's C 96 fills one 128-column tile, the second 64-column box
// half past N), else csrc/gemm.cuh's mma.sync GEMM; f32 on its full-f32
// FMA kernel (no TF32). The depthwise step reads x about once (its column
// halos 1.2-1.9 times from L2) and spends about 13 shared-memory loads on
// 343 FMAs. xn and the hidden h (4 C a pixel) cross device memory between
// the launches.
#include "gemm.cuh"
#include "wgmma_gemm.cuh"

#include <algorithm>

namespace {

using namespace smelter;

// Two neighbouring channels (4- or 8-byte aligned) in f32.
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load2(const __half* p) {
  return __half22float2(*reinterpret_cast<const __half2*>(p));
}

constexpr int DW_THREADS = 256;
constexpr int DW_STRIP = 4;              // output pixels a thread, along W
constexpr int DW_TILE_FLOATS = 12288;    // the f32 tile's room: 48 KB

// Columns of an output row a block takes: the whole row while its f32 tile
// fits 48 KB, else a multiple of DW_STRIP.
inline int dw_tile_width(int W, int C) {
  const int tw = (DW_TILE_FLOATS / C) / DW_STRIP * DW_STRIP;
  return W < tw ? W : (tw > DW_STRIP ? tw : DW_STRIP);
}

// The depthwise step for channels too many for dw_ln_staged's tiles: one
// block per (image, output row, tile of TW columns), each thread 4
// neighbouring output pixels of 2 channels, the taps read through the
// cache. x (B, H, W, C) NHWC; dw (7, 7, C) tap-major in T; dw_b, gamma,
// beta (C,) in p_code; xn (B, H, W, C) in T. C even.
template <typename T>
__global__ void __launch_bounds__(DW_THREADS)
dw_ln(const T* __restrict__ x, const T* __restrict__ dw, const void* __restrict__ dw_b,
      const void* __restrict__ gamma, const void* __restrict__ beta, int p_code,
      T* __restrict__ xn, int H, int W, int C, int TW, float eps) {
  extern __shared__ float tile[];  // [TW][C] f32: the conv output plus its bias
  const int b = blockIdx.z, y = blockIdx.y, x0 = blockIdx.x * TW;
  const int tw = min(TW, W - x0);
  const int C2 = C / 2, strips = (tw + DW_STRIP - 1) / DW_STRIP;
  const size_t img = static_cast<size_t>(b) * H * W * C;

  for (int item = threadIdx.x; item < strips * C2; item += DW_THREADS) {
    const int c = 2 * (item % C2), xs = x0 + (item / C2) * DW_STRIP;
    float2 acc[DW_STRIP];
#pragma unroll
    for (int o = 0; o < DW_STRIP; ++o) acc[o] = make_float2(0.f, 0.f);
    for (int dy = 0; dy < 7; ++dy) {
      const int iy = y + dy - 3;
      if (iy < 0 || iy >= H) continue;  // the zero padding adds nothing
      const T* row = x + img + static_cast<size_t>(iy) * W * C + c;
      float2 w[7], in[DW_STRIP + 6];
#pragma unroll
      for (int dx = 0; dx < 7; ++dx) w[dx] = load2(dw + (dy * 7 + dx) * C + c);
#pragma unroll
      for (int i = 0; i < DW_STRIP + 6; ++i) {
        const int ix = xs - 3 + i;
        in[i] = (ix >= 0 && ix < W) ? load2(row + static_cast<size_t>(ix) * C)
                                    : make_float2(0.f, 0.f);
      }
#pragma unroll
      for (int o = 0; o < DW_STRIP; ++o)
#pragma unroll
        for (int dx = 0; dx < 7; ++dx) {
          acc[o].x += in[o + dx].x * w[dx].x;
          acc[o].y += in[o + dx].y * w[dx].y;
        }
    }
    const float b0 = param_at(dw_b, p_code, c), b1 = param_at(dw_b, p_code, c + 1);
#pragma unroll
    for (int o = 0; o < DW_STRIP; ++o) {
      const int p = xs + o - x0;
      if (p >= tw) break;
      tile[p * C + c] = acc[o].x + b0;
      tile[p * C + c + 1] = acc[o].y + b1;
    }
  }
  __syncthreads();

  // LayerNorm over C: one warp a pixel.
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int p = warp; p < tw; p += DW_THREADS / 32) {
    const float* v = tile + p * C;
    float sum = 0.f;
    for (int c = lane; c < C; c += 32) sum += v[c];
    const float mu = warp_sum(sum) / static_cast<float>(C);
    float sq = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float d = v[c] - mu;
      sq += d * d;
    }
    const float r = rsqrtf(warp_sum(sq) / static_cast<float>(C) + eps);
    T* dst = xn + img + (static_cast<size_t>(y) * W + x0 + p) * C;
    for (int c = lane; c < C; c += 32)
      store(&dst[c], (v[c] - mu) * r * param_at(gamma, p_code, c) + param_at(beta, p_code, c));
  }
}

// -- dw_ln_staged ---------------------------------------------------------------

constexpr int DW_P = 7;               // output columns a thread, along W
constexpr int DW_MAX_THREADS = 384;   // C x S threads a block (168 registers each)
constexpr int DW_AHEAD = 3;           // input rows in flight past the one in use
constexpr int DW_RING = DW_AHEAD + 1; // input rows in shared memory
constexpr int DW_BLOCKS = 120;        // blocks to reach before a column strip is cut into bands
constexpr int DW_SMEM_MAX = 227 * 1024;

// dw_ln_staged's tiling: S strips of DW_P columns (TW = S DW_P; C S
// threads, one channel of one strip each), bands of R output rows, and the
// shared memory: DW_RING input rows of TW + 6 pixels x C in T, two f32
// output rows of TW x C, and LN gamma and beta in f32. S 0 where no tiling
// fits (dw_ln's case).
struct DwPlan {
  int S, R, threads;
  size_t smem;
};

inline DwPlan dw_plan(int B, int H, int W, int C, int es) {
  int S = 0;
  while ((S + 1) * C <= DW_MAX_THREADS && S + 1 <= cdiv(W, DW_P)) ++S;
  if (S == 0) return DwPlan{0, 0, 0, 0};
  const int TW = S * DW_P, tiles = cdiv(W, TW);
  const int bands = std::max(1, std::min(cdiv(DW_BLOCKS, std::max(1, B * tiles)), H));
  const size_t smem = static_cast<size_t>(DW_RING) * (TW + 6) * C * es +
                      (2 * static_cast<size_t>(TW) + 2) * C * 4;
  if (smem > static_cast<size_t>(DW_SMEM_MAX)) return DwPlan{0, 0, 0, 0};
  return DwPlan{S, cdiv(H, bands), cdiv(C * S, 32) * 32, smem};
}

// One 16-byte copy into shared memory, or 16 zero bytes where !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }

// Eight channels of xn rounded to T, stored as 16 (bf16, f16) or 32 bytes.
__device__ __forceinline__ void store8(float* dst, const float (&v)[8]) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
template <typename T>
__device__ __forceinline__ void store8(T* dst, const float (&v)[8]) {
  uint4 u;
  T* e = reinterpret_cast<T*>(&u);
#pragma unroll
  for (int i = 0; i < 8; ++i) store(&e[i], v[i]);
  *reinterpret_cast<uint4*>(dst) = u;
}

// The LayerNorm over C of the f32 row `ob` (TW pixels x C, the conv output
// plus its bias) into xn's row y from column x0: a group of G lanes a pixel
// (G = C / 16 rounded up to 8, 16 or 32, so a lane holds at most 2 x 8
// channels and a block takes a row of ConvNeXt-T's tiles in one pass), the
// mean, then the mean of squared deviations, in f32; gs and bs the LN gamma
// and beta in f32 (shared memory). A warp's groups take neighbouring
// pixels, so every lane of a warp runs each shuffle.
template <typename T>
__device__ __forceinline__ void ln_row(const float* ob, const float* gs, const float* bs,
                                       T* xn_row, int x0, int TW, int W, int C, float eps) {
  const int G = C <= 128 ? 8 : C <= 256 ? 16 : 32, lane = threadIdx.x % G, per_warp = 32 / G;
  const int C8 = C / 8, warp = threadIdx.x / 32, warps = blockDim.x / 32;
  for (int p0 = warp * per_warp; p0 < TW; p0 += warps * per_warp) {
    const int p = p0 + (threadIdx.x % 32) / G;
    const bool live = p < TW && x0 + p < W;  // the whole group agrees
    const float4* v = reinterpret_cast<const float4*>(ob + static_cast<size_t>(p) * C);
    float val[2][8];
    float sum = 0.f;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int c8 = lane + k * G;
      const bool in = live && c8 < C8;
      const float4 lo = in ? v[2 * c8] : make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 hi = in ? v[2 * c8 + 1] : make_float4(0.f, 0.f, 0.f, 0.f);
      const float e8[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        val[k][e] = e8[e];
        sum += e8[e];
      }
    }
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    const float mu = sum / static_cast<float>(C);
    float sq = 0.f;
#pragma unroll
    for (int k = 0; k < 2; ++k)
      if (live && lane + k * G < C8)
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float d = val[k][e] - mu;
          sq += d * d;
        }
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
    if (!live) continue;
    const float rs = rsqrtf(sq / static_cast<float>(C) + eps);
    T* dst = xn_row + static_cast<size_t>(x0 + p) * C;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int c8 = lane + k * G;
      if (c8 >= C8) continue;
      float o8[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        o8[e] = (val[k][e] - mu) * rs * gs[8 * c8 + e] + bs[8 * c8 + e];
      store8(dst + 8 * c8, o8);
    }
  }
}

// Block (column tile, band, image): C x S threads, thread (c, s) channel c
// of output columns x0 + 7 s ... + 6, all its band's rows. Input row i of
// the band (image row y0 - 3 + i) comes into a ring of DW_RING rows by
// 16-byte cp.async, DW_AHEAD rows ahead, zeros outside the image; the
// thread reads its 13 values of the row once and adds them, times the
// weights held in registers, to the 7 output rows the row reaches (dy
// 6 .. 0: accumulators of 7 rows x 7 columns, a row's slot its index mod
// 7), so each output gets its taps dy outer, dx inner, in f32. A finished
// row (its bias added) goes to one of two f32 rows in shared memory, whose
// LayerNorm the block takes after the next iteration's barrier. x (B, H, W,
// C) NHWC; dw (7, 7, C) tap-major in T; dw_b, gamma, beta (C,) in p_code;
// xn (B, H, W, C) in T. C % 8 == 0; S and R from dw_plan.
template <typename T>
__global__ void __launch_bounds__(DW_MAX_THREADS, 1)
dw_ln_staged(const T* __restrict__ x, const T* __restrict__ dw, const void* __restrict__ dw_b,
             const void* __restrict__ gamma, const void* __restrict__ beta, int p_code,
             T* __restrict__ xn, int H, int W, int C, int R, int S, float eps) {
  extern __shared__ __align__(16) uint8_t dw_smem[];
  const int TW = S * DW_P, TWH = TW + 6;
  const size_t row_bytes = static_cast<size_t>(TWH) * C * sizeof(T);
  const T* ring = reinterpret_cast<const T*>(dw_smem);                    // [RING][TWH][C]
  float* outb = reinterpret_cast<float*>(dw_smem + DW_RING * row_bytes);  // [2][TW][C]
  float* gs = outb + 2 * TW * C;                                          // [C] LN gamma
  float* bs = gs + C;                                                     // [C] LN beta
  const int b = blockIdx.z, y0 = blockIdx.y * R, x0 = blockIdx.x * TW;
  const int rows_out = min(R, H - y0), n_in = rows_out + 6;
  const bool active = threadIdx.x < C * S;
  const int c = active ? threadIdx.x % C : 0, s = active ? threadIdx.x / C : 0;
  const int cpp = C * static_cast<int>(sizeof(T)) / 16;  // 16-byte chunks a pixel
  T* xn_img = xn + static_cast<size_t>(b) * H * W * C;

  const auto load_row = [&](int i) {  // one commit group a row, empty past the last
    if (i < n_in) {
      const int iy = y0 - 3 + i;
      uint8_t* dst = dw_smem + static_cast<size_t>(i % DW_RING) * row_bytes;
      for (int q = threadIdx.x; q < TWH * cpp; q += blockDim.x) {
        const int pix = q / cpp, ch = q - pix * cpp, ix = x0 - 3 + pix;
        const bool valid = iy >= 0 && iy < H && ix >= 0 && ix < W;
        const T* src = valid ? x + ((static_cast<size_t>(b) * H + iy) * W + ix) * C : x;
        cp_async16(dst + static_cast<size_t>(q) * 16,
                   reinterpret_cast<const uint8_t*>(src) + (valid ? ch * 16 : 0), valid);
      }
    }
    cp_async_commit();
  };
  for (int i = 0; i < DW_AHEAD; ++i) load_row(i);
  for (int k = threadIdx.x; k < C; k += blockDim.x) {  // read after the loop's barriers
    gs[k] = param_at(gamma, p_code, k);
    bs[k] = param_at(beta, p_code, k);
  }

  float w[7][7];
#pragma unroll
  for (int dy = 0; dy < 7; ++dy)
#pragma unroll
    for (int dx = 0; dx < 7; ++dx) w[dy][dx] = to_float(dw[(dy * 7 + dx) * C + c]);
  const float bias = param_at(dw_b, p_code, c);
  float acc[7][DW_P];
#pragma unroll
  for (int k = 0; k < 7; ++k)
#pragma unroll
    for (int o = 0; o < DW_P; ++o) acc[k][o] = 0.f;

  for (int i0 = 0; i0 < n_in; i0 += 7) {
#pragma unroll
    for (int j = 0; j < 7; ++j) {
      const int i = i0 + j;  // the band's input row (the block agrees on every branch below)
      if (i >= n_in) break;
      cp_async_wait<DW_AHEAD - 1>();  // row i landed, this thread's copies
      __syncthreads();                // ... and everyone's; row i - 1's slot is free
      if (i >= 7)                     // the output row finished at i - 1
        ln_row(outb + ((i - 7) & 1) * TW * C, gs, bs,
               xn_img + static_cast<size_t>(y0 + i - 7) * W * C, x0, TW, W, C, eps);
      load_row(i + DW_AHEAD);
      if (!active) continue;
      const T* row = ring + (static_cast<size_t>(i % DW_RING) * TWH + s * DW_P) * C + c;
      float in[DW_P + 6];
#pragma unroll
      for (int k = 0; k < DW_P + 6; ++k) in[k] = to_float(row[k * C]);
#pragma unroll
      for (int dy = 0; dy < 7; ++dy) {
        const int t = i - dy;  // the output row this input row is tap row dy of
        if (t < 0 || t >= rows_out) continue;
        float(&a)[DW_P] = acc[(j - dy + 7) % 7];
#pragma unroll
        for (int o = 0; o < DW_P; ++o) {
          float v = dy == 0 ? 0.f : a[o];
#pragma unroll
          for (int dx = 0; dx < 7; ++dx) v = fmaf(in[o + dx], w[dy][dx], v);
          a[o] = v;
        }
      }
      if (i >= 6) {  // output row i - 6 has all its taps
        float* ob = outb + ((i - 6) & 1) * TW * C + static_cast<size_t>(s) * DW_P * C + c;
#pragma unroll
        for (int o = 0; o < DW_P; ++o) ob[o * C] = acc[(j + 1) % 7][o] + bias;
      }
    }
  }
  __syncthreads();
  ln_row(outb + ((rows_out - 1) & 1) * TW * C, gs, bs,
         xn_img + static_cast<size_t>(y0 + rows_out - 1) * W * C, x0, TW, W, C, eps);
}

// -- the sequence -------------------------------------------------------------------

// The GEMMs' forms, as the wrapper's plans give them: 1 gemm_tma on `grid`
// CTAs, 0 csrc/gemm.cuh.
struct Forms {
  int fc1, fc1_grid, fc2, fc2_grid;
};

template <typename T>
int run(const void* x, const void* dw, const void* dw_b, const void* ln_g, const void* ln_b,
        const void* w1, const void* b1, const void* w2, const void* b2, const void* gm, void* xn,
        void* h, void* out, int B, int H, int W, int C, int F, float eps, int p_code,
        const Forms& f, cudaStream_t stream) {
  const int M = B * H * W;
  const DwPlan t = dw_plan(B, H, W, C, static_cast<int>(sizeof(T)));
  if (t.S > 0) {
    static const cudaError_t smem_set = cudaFuncSetAttribute(
        dw_ln_staged<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, DW_SMEM_MAX);
    (void)smem_set;  // a refusal shows as the launch's error
    const dim3 grid(cdiv(W, t.S * DW_P), cdiv(H, t.R), B);
    dw_ln_staged<T><<<grid, t.threads, t.smem, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(dw), dw_b, ln_g, ln_b, p_code,
        static_cast<T*>(xn), H, W, C, t.R, t.S, eps);
  } else {
    const int TW = dw_tile_width(W, C);
    const dim3 grid(cdiv(W, TW), H, B);
    dw_ln<T><<<grid, DW_THREADS, TW * C * sizeof(float), stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(dw), dw_b, ln_g, ln_b, p_code,
        static_cast<T*>(xn), H, W, C, TW, eps);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  int rc = 0;
  if constexpr (std::is_same<T, float>::value) {
    if (f.fc1 || f.fc2) return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (f.fc1)
      rc = wg::launch_tma_gelu<T>(xn, w1, b1, p_code == kF32, kActGeluExact, h, M, F, C,
                                  f.fc1_grid, stream);
  }
  if (!f.fc1)
    gemm<T>(static_cast<const T*>(xn), static_cast<const T*>(w1), b1, p_code, kActGeluExact,
            nullptr, static_cast<T*>(h), M, F, C, F, stream);
  if (rc != 0 || (err = cudaGetLastError()) != cudaSuccess)
    return rc != 0 ? rc : static_cast<int>(err);
  if constexpr (!std::is_same<T, float>::value) {
    if (f.fc2)
      return wg::launch_tma_scale_res<T>(h, w2, b2, gm, p_code == kF32, x, out, M, C, F,
                                         f.fc2_grid, stream);
  }
  gemm<T>(static_cast<const T*>(h), static_cast<const T*>(w2), b2, p_code, kActNone,
          static_cast<const T*>(x), static_cast<T*>(out), M, C, F, C, stream, gm);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* smelter_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x and out (B, H, W, C) NHWC, dw (7, 7, 1, C), w1 (C, F), w2 (F, C),
// scratch xn (B H W, C) and h (B H W, F), all row-major in x_dtype and
// 16-byte aligned; dw_b, ln_g, ln_b, b2, gm (C,) and b1 (F,) in p_dtype (f32
// or x_dtype). C and F multiples of 8. fc1 / fc2: 1 runs that product on
// gemm_tma on fc1_grid / fc2_grid CTAs (16-bit x; wgmma_plan's block_plan
// and layer_scale_plan check the rest), 0 on gemm.cuh.
// Returns a cudaError_t code.
extern "C" int smelter_convnext_block(const void* x, const void* dw, const void* dw_b,
                                      const void* ln_g, const void* ln_b, const void* w1,
                                      const void* b1, const void* w2, const void* b2,
                                      const void* gm, void* xn, void* h, void* out, int B, int H,
                                      int W, int C, int F, float eps, int x_dtype, int p_dtype,
                                      int fc1, int fc1_grid, int fc2, int fc2_grid,
                                      void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const auto misaligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; };
  if (misaligned(x) || misaligned(dw) || misaligned(w1) || misaligned(w2) || misaligned(xn) ||
      misaligned(h) || misaligned(out))
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (C % 8 != 0 || F % 8 != 0 || C > DW_TILE_FLOATS / DW_STRIP ||
      (p_dtype != kF32 && p_dtype != x_dtype) || fc1 < 0 || fc1 > 1 || fc2 < 0 || fc2 > 1 ||
      (fc1 && fc1_grid <= 0) || (fc2 && fc2_grid <= 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || H == 0 || W == 0) return 0;
  const Forms f{fc1, fc1_grid, fc2, fc2_grid};
  switch (x_dtype) {
    case kF32:
      return run<float>(x, dw, dw_b, ln_g, ln_b, w1, b1, w2, b2, gm, xn, h, out, B, H, W, C, F,
                        eps, p_dtype, f, st);
    case kBF16:
      return run<__nv_bfloat16>(x, dw, dw_b, ln_g, ln_b, w1, b1, w2, b2, gm, xn, h, out, B, H,
                                W, C, F, eps, p_dtype, f, st);
    case kF16:
      return run<__half>(x, dw, dw_b, ln_g, ln_b, w1, b1, w2, b2, gm, xn, h, out, B, H, W, C,
                         F, eps, p_dtype, f, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
