// Paged weight-absorbed MLA decode over int8 latent pages with one
// float32 scale per page for each pool.
//
// Replaces the TPU kernel paged_mla_fwd_q8
// (src/repro/kernels/paged_attention/paged_attention.py:332, body
// _mla_kernel_q8 :298), which brings each page's ckv and krope scales in
// as (1, 1) blocks through the block-table index map and dequantizes in
// registers before the dots.  Here the block reads the two scales of each
// page it visits and multiplies the codes by them as the page is staged in
// shared memory (fp32), so the dots see exactly codes * scale, as the
// plain version's dequantized pools hold.  Half the page bytes of the
// bf16 kernel; otherwise the design and its bound are those of
// paged_mla.cuh.  bf16 queries at the shapes ops.mla_route takes run the
// tensor-core route instead (paged_mla_q8_bf16_tc, paged_mla_tc.cuh): the
// codes land by TMA and are widened to bf16 in shared memory (exact), the
// ckv and krope scores are summed apart and scaled by their page's scales,
// and P carries the ckv scale into the latent sum.
#include "paged_mla.cuh"
#include "paged_mla_tc.cuh"

extern "C" int paged_mla_q8_f32(const void* q_abs, const void* q_rope,
                                const void* pool_ckv, const void* pool_krope,
                                const void* ckv_scale,
                                const void* krope_scale, const void* bt,
                                const void* pos, void* part_acc,
                                void* part_ml, void* out, int B, int H,
                                int r, int dr, int ps, int bt_cols,
                                int length, int n_split, int vec, int smem,
                                float scale, void* stream) {
  return paged_mla::launch<float, int8_t, true>(
      q_abs, q_rope, pool_ckv, pool_krope, ckv_scale, krope_scale, bt, pos,
      part_acc, part_ml, out, B, H, r, dr, ps, bt_cols, length, n_split, vec,
      smem, scale, stream);
}

extern "C" int paged_mla_q8_bf16(const void* q_abs, const void* q_rope,
                                 const void* pool_ckv,
                                 const void* pool_krope,
                                 const void* ckv_scale,
                                 const void* krope_scale, const void* bt,
                                 const void* pos, void* part_acc,
                                 void* part_ml, void* out, int B, int H,
                                 int r, int dr, int ps, int bt_cols,
                                 int length, int n_split, int vec, int smem,
                                 float scale, void* stream) {
  return paged_mla::launch<__nv_bfloat16, int8_t, true>(
      q_abs, q_rope, pool_ckv, pool_krope, ckv_scale, krope_scale, bt, pos,
      part_acc, part_ml, out, B, H, r, dr, ps, bt_cols, length, n_split, vec,
      smem, scale, stream);
}

// The tc route, as paged_mla_bf16_tc over int8 pools with their scales.
extern "C" int paged_mla_q8_bf16_tc(const void* q_abs, const void* q_rope,
                                    const void* pool_ckv,
                                    const void* pool_krope,
                                    const void* ckv_scale,
                                    const void* krope_scale, const void* bt,
                                    const void* pos, void* part_acc,
                                    void* part_ml, void* out, int B, int H,
                                    int r, int dr, int P, int ps,
                                    int bt_cols, int length, int n_split,
                                    float scale, void* stream) {
  return paged_mla::tc::launch<true>(
      q_abs, q_rope, pool_ckv, pool_krope, ckv_scale, krope_scale, bt, pos,
      part_acc, part_ml, out, B, H, r, dr, P, ps, bt_cols, length, n_split,
      scale, stream);
}

// As paged_mla_tc_info, for the int8 split kernel.
extern "C" int paged_mla_q8_tc_info(void* out) {
  return paged_mla::tc::info<true>(static_cast<int*>(out));
}
