// Paged GQA decode over int8 KV pages with one float32 scale per
// (page, kv head).
//
// Replaces the TPU kernel paged_gqa_fwd_q8
// (src/repro/kernels/paged_attention/paged_attention.py:179), which
// brings each page's scale in as a (1, 1) block through the block-table
// index map and dequantizes in registers before both dots.  Bound: bytes,
// half the page bytes of the bf16 kernel.  Here the page's two scales
// ride in its ring slot beside its codes (one 4-byte cp.async each), and
// each lane multiplies the codes by them in registers before the dots, so
// the dots see exactly codes * scale, as the plain version's dequantized
// pools hold.  An int8 row at hd 64 is four 16-byte chunks, four lanes a
// row, eight rows a pass of the warp; at hd 160 ten chunks over 16 lanes,
// six of them masked.  Otherwise the design (cluster page
// ranges, warps on pages, one launch) and what it does about each fault
// of the first version are those of paged_gqa.cuh.
#include "paged_gqa.cuh"

extern "C" int paged_gqa_q8_f32(const void* q, const void* pool_k,
                                const void* pool_v, const void* k_scale,
                                const void* v_scale, const void* bt,
                                const void* pos, void* out, int B, int H,
                                int KV, int hd, int ps, int bt_cols,
                                int length, int window, int n_split,
                                void* stream) {
  return paged_gqa::launch<float, int8_t, true>(
      q, pool_k, pool_v, k_scale, v_scale, bt, pos, out, B, H, KV, hd, ps,
      bt_cols, length, window, n_split, stream);
}

extern "C" int paged_gqa_q8_bf16(const void* q, const void* pool_k,
                                 const void* pool_v, const void* k_scale,
                                 const void* v_scale, const void* bt,
                                 const void* pos, void* out, int B, int H,
                                 int KV, int hd, int ps, int bt_cols,
                                 int length, int window, int n_split,
                                 void* stream) {
  return paged_gqa::launch<__nv_bfloat16, int8_t, true>(
      q, pool_k, pool_v, k_scale, v_scale, bt, pos, out, B, H, KV, hd, ps,
      bt_cols, length, window, n_split, stream);
}

// The layout launch() takes on int8 pages (paged_gqa::layout_info).
extern "C" int paged_gqa_q8_layout(int hd, int G, int aligned, void* out) {
  return paged_gqa::layout_info<int8_t>(hd, G, aligned,
                                        static_cast<int*>(out));
}
