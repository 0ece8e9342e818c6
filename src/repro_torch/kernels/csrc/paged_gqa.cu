// Paged GQA decode over bf16 (or fp32) KV pages.
//
// Replaces the TPU kernel paged_gqa_fwd
// (src/repro/kernels/paged_attention/paged_attention.py:107), whose grid
// (B, KV, n_pages) walks the pages in order with the page id
// scalar-prefetched into the K/V BlockSpec index maps and (m, l, acc) in
// VMEM.  Here one block per (kv head, request) reads bt and pos itself
// and walks the pages in a loop; the design and its bound are in
// paged_gqa.cuh.  q and the pools share one type.
#include "paged_gqa.cuh"

extern "C" int paged_gqa_f32(const void* q, const void* pool_k,
                             const void* pool_v, const void* bt,
                             const void* pos, void* out, int B, int H,
                             int KV, int hd, int ps, int bt_cols, int length,
                             int window, int smem, void* stream) {
  return paged_gqa::launch<float, float, false>(
      q, pool_k, pool_v, nullptr, nullptr, bt, pos, out, B, H, KV, hd, ps,
      bt_cols, length, window, smem, stream);
}

extern "C" int paged_gqa_bf16(const void* q, const void* pool_k,
                              const void* pool_v, const void* bt,
                              const void* pos, void* out, int B, int H,
                              int KV, int hd, int ps, int bt_cols,
                              int length, int window, int smem,
                              void* stream) {
  return paged_gqa::launch<__nv_bfloat16, __nv_bfloat16, false>(
      q, pool_k, pool_v, nullptr, nullptr, bt, pos, out, B, H, KV, hd, ps,
      bt_cols, length, window, smem, stream);
}
