// MaxUnpool of non-overlapping 2x2 / stride 2 windows for Hopper: each value
// of x (B, C, h, w) lands in its own 2x2 window of the (B, C, 2h, 2w) output
// at the parity of its flat index, ((idx / 2w) % 2, idx % 2), and the other
// three positions of the window are zero.
//
// Replaces smelter_tpu/kernels/max_unpool.py::max_unpool2x2, the Pallas
// kernel that reads x and int32 indices once at input resolution and writes
// the output through 0/1 permutation matmuls (Mosaic takes no interleaving
// reshape).
//
// What bounds it on an H100: the bytes. x and the int64 index are read once
// and the output written once: at SegNet's three unpools (batch 16, 256 px,
// base 32, bf16) ~264 MB, ~79 us at 3.35 TB/s.
//
// Design, simple first: one thread an input element; it reads its value and
// index and writes its window's two output rows as two 2-element stores
// (4 bytes each in bf16/f16, 8 in f32), so consecutive threads read and
// write consecutive addresses.
#include "common.cuh"

namespace {

using namespace smelter;

template <typename Raw, typename Pair>
__global__ void __launch_bounds__(256)
max_unpool2x2_kernel(const Raw* __restrict__ x, const long long* __restrict__ idx,
                     Raw* __restrict__ out, int n, int w) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int row = i / w, j = i - row * w;  // row = (b * C + c) * h + input row
  const long long wout = 2LL * w;
  const long long id = idx[i];
  const int dy = static_cast<int>((id / wout) & 1), dx = static_cast<int>(id & 1);
  const Raw v = x[i];
  Pair hit, zero;
  Raw* hv = reinterpret_cast<Raw*>(&hit);
  Raw* zv = reinterpret_cast<Raw*>(&zero);
  hv[0] = dx == 0 ? v : Raw(0);
  hv[1] = dx == 1 ? v : Raw(0);
  zv[0] = zv[1] = Raw(0);
  Pair* o = reinterpret_cast<Pair*>(out + static_cast<size_t>(2 * row) * wout + 2 * j);
  o[0] = dy == 0 ? hit : zero;
  o[wout / 2] = dy == 1 ? hit : zero;
}

}  // namespace

extern "C" const char* smelter_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x (n / w rows of w) in x_dtype (f32, bf16, f16), idx int64 of x's shape,
// out (2 * n / w rows of 2w) in x_dtype. Returns a cudaError_t code.
extern "C" int smelter_max_unpool2x2(const void* x, const void* idx, void* out, int n, int w,
                                     int x_dtype, void* stream) {
  if (n <= 0) return 0;
  if (w <= 0 || n % w) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  const auto* ix = static_cast<const long long*>(idx);
  const int blocks = cdiv(n, 256);
  switch (x_dtype) {
    case kF32:
      max_unpool2x2_kernel<uint32_t, uint2><<<blocks, 256, 0, st>>>(
          static_cast<const uint32_t*>(x), ix, static_cast<uint32_t*>(out), n, w);
      break;
    case kBF16:
    case kF16:
      max_unpool2x2_kernel<uint16_t, uint32_t><<<blocks, 256, 0, st>>>(
          static_cast<const uint16_t*>(x), ix, static_cast<uint16_t*>(out), n, w);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
