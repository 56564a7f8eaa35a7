// Paged GQA decode attention for Hopper: each slot's query rows attend over
// its KV cache, read through a page table from a pool shared by all slots.
//
// Replaces smelter_tpu/kernels/paged_decode_attention.py::
// paged_decode_attention (its Pallas `_kernel`): q (B, kvh, g*c, hd), pools
// (P, ps, kvh*hd) in q's dtype or int8 with per-row scale pools (P, ps, 1),
// page table (B, npg) int32, pos (B,) int64. Query row i (chunk offset
// i % c) attends logical rows <= pos + i % c; logical row j*ps + r of slot b
// lives at row r of pool page table[b, j]. Only pages j <= min((pos + c - 1)
// // ps, npg - 1) are read, and of the last one only its rows up to the
// frontier pos + c - 1.
//
// What bounds it on an H100: the live K/V bytes. At llama_1b's decode shape
// (B 8, kvh 8, g 2, hd 128, ps 128, int8 pools) with positions spread over
// 0-511 that is about 4 MB a step, ~1.2 us at 3.35 TB/s; the flops (4 per
// cached element and query row) are far below the tensor-core rate.
//
// The kernels are decode_attention.cuh's split-KV pair over PagedRows: a
// page is cut into `split` blocks of ps / split rows (the wrapper's
// `paged_split_plan`, from (B, kvh, npg, ps) alone), one CUDA block of 4
// warps per (row block, KV head, slot) writes a partial softmax state, and
// a second launch merges each slot's partials in block order. At llama_1b's
// shape that is 32-row blocks, 16 a slot, 1,024 CUDA blocks (one slot: 128)
// where one block per (KV head, slot) gave 64 (one slot: 8).
#include "decode_attention.cuh"

using namespace smelter;

extern "C" const char* smelter_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q (B, kvh, gc, hd) and out in q_dtype (f32 or bf16); k/v pools
// (P, ps, kvh*hd) in q_dtype or int8 (kv_dtype) with scale pools (P, ps, 1)
// in f32 or q_dtype (scale_dtype); table (B, npg) int32; pos (B,) int64;
// scratch of B kvh (npg split) gc (hd + 2) floats. All contiguous, 16-byte
// aligned. Needs hd in {32, 64, 128, 256}, c dividing gc and split dividing
// ps (the wrapper checks). Two launches. Returns a cudaError_t code.
extern "C" int smelter_paged_decode_attention(const void* q, const void* k, const void* v,
                                              const void* ks, const void* vs, const void* table,
                                              const void* pos, void* out, void* scratch, int B,
                                              int P, int ps, int kvh, int hd, int gc, int c,
                                              int npg, int split, float scale, int q_dtype,
                                              int kv_dtype, int scale_dtype, void* stream) {
  if (gc < 1 || c < 1 || gc % c || ps < 1 || npg < 1 || P < 1 || split < 1 ||
      ps % split)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || kvh == 0) return 0;
  const decode_attention::PagedRows src{static_cast<const int*>(table), P, npg, ps, split,
                                        ps / split};
  const int nblk = npg * split;
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
