// Paged weight-absorbed MLA decode over bf16 (or fp32) latent pages.
//
// Replaces the TPU kernel paged_mla_fwd
// (src/repro/kernels/paged_attention/paged_attention.py:259, body
// _mla_kernel :226), whose grid (B, n_pages) walks a request's latent
// pages in order with the page id scalar-prefetched into the ckv/krope
// BlockSpec index maps and (m, l, acc) for all H heads in VMEM.  Here one
// block per (8 query heads, request, range of its pages) reads bt and pos
// itself and walks its pages in a loop, and a second kernel combines the
// ranges; the design and its bound are in paged_mla.cuh.  bf16 queries
// over bf16 pages at the shapes ops.mla_route takes run the tensor-core
// route instead (paged_mla_bf16_tc, paged_mla_tc.cuh): 64 heads of a
// request a CTA, pages by TMA, wgmma for the scores and the latent sum.
// q_abs, q_rope and the pools share one type.
#include "paged_mla.cuh"
#include "paged_mla_tc.cuh"

extern "C" int paged_mla_f32(const void* q_abs, const void* q_rope,
                             const void* pool_ckv, const void* pool_krope,
                             const void* bt, const void* pos,
                             void* part_acc, void* part_ml, void* out, int B,
                             int H, int r, int dr, int ps, int bt_cols,
                             int length, int n_split, int vec, int smem,
                             float scale, void* stream) {
  return paged_mla::launch<float, float, false>(
      q_abs, q_rope, pool_ckv, pool_krope, nullptr, nullptr, bt, pos,
      part_acc, part_ml, out, B, H, r, dr, ps, bt_cols, length, n_split, vec,
      smem, scale, stream);
}

extern "C" int paged_mla_bf16(const void* q_abs, const void* q_rope,
                              const void* pool_ckv, const void* pool_krope,
                              const void* bt, const void* pos,
                              void* part_acc, void* part_ml, void* out,
                              int B, int H, int r, int dr, int ps,
                              int bt_cols, int length, int n_split, int vec,
                              int smem, float scale, void* stream) {
  return paged_mla::launch<__nv_bfloat16, __nv_bfloat16, false>(
      q_abs, q_rope, pool_ckv, pool_krope, nullptr, nullptr, bt, pos,
      part_acc, part_ml, out, B, H, r, dr, ps, bt_cols, length, n_split, vec,
      smem, scale, stream);
}

// The tc route (P: pages of the pools; n_split: page ranges a request);
// cudaErrorInvalidValue for a shape or alignment it does not take.
extern "C" int paged_mla_bf16_tc(const void* q_abs, const void* q_rope,
                                 const void* pool_ckv,
                                 const void* pool_krope, const void* bt,
                                 const void* pos, void* part_acc,
                                 void* part_ml, void* out, int B, int H,
                                 int r, int dr, int P, int ps, int bt_cols,
                                 int length, int n_split,
                                 float scale, void* stream) {
  return paged_mla::tc::launch<false>(
      q_abs, q_rope, pool_ckv, pool_krope, nullptr, nullptr, bt, pos,
      part_acc, part_ml, out, B, H, r, dr, P, ps, bt_cols, length, n_split,
      scale, stream);
}

// Registers, local bytes, dynamic shared bytes, resident CTAs an SM and
// threads of the tc route's split kernel (five ints into out).
extern "C" int paged_mla_tc_info(void* out) {
  return paged_mla::tc::info<false>(static_cast<int*>(out));
}
