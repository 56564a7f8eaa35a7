// Ragged GQA decode attention for Hopper: each slot's query rows attend over
// its own contiguous KV cache, reading only the rows up to its position.
//
// Replaces smelter_tpu/kernels/ragged_decode_attention.py::
// ragged_decode_attention (its Pallas `_kernel`, batched form `_batched`):
// q (B, kvh, g*c, hd), caches (B, L, kvh*hd) in q's dtype or int8 with
// per-row scales (B, L, 1) in f32 or q's dtype, pos (B,) int64. Query row i
// (chunk offset i % c) attends rows <= pos + i % c; only rows up to the
// frontier min(pos + c - 1, L - 1) are read. A reused slot holds the
// previous occupant's rows past the frontier: they are neither scored nor
// added (the Pallas kernel zeros V there).
//
// What bounds it on an H100: the live K/V bytes, (pos + c) rows of 2 * kvd
// bytes (int8) a slot; at llama_1b's shape with 8 slots spread over 0-511
// about 4 MB a step, ~1.2 us at 3.35 TB/s. The flops (4 per cached element
// and query row) are far below the tensor-core rate.
//
// The Pallas kernel streams the cache in row blocks through VMEM with the
// block index clamped at the frontier; here decode_attention.cuh's split-KV
// kernels run over blocks of `block_rows` cache rows (ContiguousRows): one
// CUDA block per (row block, KV head, slot) writes a partial softmax state,
// a second launch merges a slot's partials in block order. The wrapper
// picks block_rows from (B, kvh, L) alone, so that the grid fills the card
// at one slot as at eight and never depends on pos.
#include "decode_attention.cuh"

using namespace smelter;

extern "C" const char* smelter_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q (B, kvh, gc, hd) and out in q_dtype (f32 or bf16); k/v (B, L, kvh*hd) in
// q_dtype or int8 (kv_dtype) with scales (B, L, 1) in f32 or q_dtype
// (scale_dtype); pos (B,) int64; scratch of B kvh nblk gc (hd + 2) floats,
// nblk = ceil(L / block_rows). All contiguous, 16-byte aligned. Needs hd in
// {32, 64, 128, 256} and c dividing gc (the wrapper checks). Two launches.
// Returns a cudaError_t code.
extern "C" int smelter_ragged_decode_attention(const void* q, const void* k, const void* v,
                                               const void* ks, const void* vs, const void* pos,
                                               void* out, void* scratch, int B, int L, int kvh,
                                               int hd, int gc, int c, int block_rows,
                                               float scale, int q_dtype, int kv_dtype,
                                               int scale_dtype, void* stream) {
  if (gc < 1 || c < 1 || gc % c || L < 1 || block_rows < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || kvh == 0) return 0;
  const decode_attention::ContiguousRows src{L, block_rows};
  const int nblk = cdiv(L, block_rows);
  auto st = static_cast<cudaStream_t>(stream);
  switch (q_dtype) {
    case kF32:
      return decode_attention::launch_split<float>(kv_dtype, scale_dtype, q, k, v, ks, vs, pos,
                                                   out, scratch, src, B, kvh, hd, gc, c, nblk,
                                                   scale, st);
    case kBF16:
      return decode_attention::launch_split<__nv_bfloat16>(kv_dtype, scale_dtype, q, k, v, ks,
                                                           vs, pos, out, scratch, src, B, kvh,
                                                           hd, gc, c, nblk, scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
