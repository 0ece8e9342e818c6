// Paged GQA decode over bf16 (or fp32) KV pages.
//
// Replaces the TPU kernel paged_gqa_fwd
// (src/repro/kernels/paged_attention/paged_attention.py:107), whose grid
// (B, KV, n_pages) walks the pages in order with the page id
// scalar-prefetched into the K/V BlockSpec index maps and (m, l, acc) in
// VMEM.  Bound: bytes (each live page read once).  Here one launch runs a
// thread-block cluster per (kv head, query-row tile, request): its CTAs
// split the request's live pages into ranges, warps walk pages with
// 16-byte cp.async copies in flight ahead of the math, and rank 0 merges
// the ranges through distributed shared memory; the design, and what it
// does about each fault of the first version, is in paged_gqa.cuh.  q and
// the pools share one type.
#include "paged_gqa.cuh"

extern "C" int paged_gqa_f32(const void* q, const void* pool_k,
                             const void* pool_v, const void* bt,
                             const void* pos, void* out, int B, int H,
                             int KV, int hd, int ps, int bt_cols, int length,
                             int window, int n_split, void* stream) {
  return paged_gqa::launch<float, float, false>(
      q, pool_k, pool_v, nullptr, nullptr, bt, pos, out, B, H, KV, hd, ps,
      bt_cols, length, window, n_split, stream);
}

extern "C" int paged_gqa_bf16(const void* q, const void* pool_k,
                              const void* pool_v, const void* bt,
                              const void* pos, void* out, int B, int H,
                              int KV, int hd, int ps, int bt_cols,
                              int length, int window, int n_split,
                              void* stream) {
  return paged_gqa::launch<__nv_bfloat16, __nv_bfloat16, false>(
      q, pool_k, pool_v, nullptr, nullptr, bt, pos, out, B, H, KV, hd, ps,
      bt_cols, length, window, n_split, stream);
}

// The layout launch() takes on pools of itemsize-byte elements (4 fp32,
// 2 bf16) at (hd, G, pools aligned or not): paged_gqa::layout_info.
extern "C" int paged_gqa_layout(int hd, int itemsize, int G, int aligned,
                                void* out) {
  int* o = static_cast<int*>(out);
  if (itemsize == 4) return paged_gqa::layout_info<float>(hd, G, aligned, o);
  if (itemsize == 2) {
    return paged_gqa::layout_info<__nv_bfloat16>(hd, G, aligned, o);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
