// Paged GQA decode over int8 KV pages with one float32 scale per
// (page, kv head).
//
// Replaces the TPU kernel paged_gqa_fwd_q8
// (src/repro/kernels/paged_attention/paged_attention.py:179), which
// brings each page's scale in as a (1, 1) block through the block-table
// index map and dequantizes in registers before both dots.  Here the
// block reads the two scales of each page it visits and multiplies the
// codes by them as the page is staged in shared memory (fp32), so the
// dots see exactly codes * scale, as the plain version's dequantized
// pools hold.  Half the page bytes of the bf16 kernel; otherwise the
// design and its bound are those of paged_gqa.cuh.
#include "paged_gqa.cuh"

extern "C" int paged_gqa_q8_f32(const void* q, const void* pool_k,
                                const void* pool_v, const void* k_scale,
                                const void* v_scale, const void* bt,
                                const void* pos, void* out, int B, int H,
                                int KV, int hd, int ps, int bt_cols,
                                int length, int window, int smem,
                                void* stream) {
  return paged_gqa::launch<float, int8_t, true>(
      q, pool_k, pool_v, k_scale, v_scale, bt, pos, out, B, H, KV, hd, ps,
      bt_cols, length, window, smem, stream);
}

extern "C" int paged_gqa_q8_bf16(const void* q, const void* pool_k,
                                 const void* pool_v, const void* k_scale,
                                 const void* v_scale, const void* bt,
                                 const void* pos, void* out, int B, int H,
                                 int KV, int hd, int ps, int bt_cols,
                                 int length, int window, int smem,
                                 void* stream) {
  return paged_gqa::launch<__nv_bfloat16, int8_t, true>(
      q, pool_k, pool_v, k_scale, v_scale, bt, pos, out, B, H, KV, hd, ps,
      bt_cols, length, window, smem, stream);
}
