"""Plain PyTorch paged (block-table) single-token decode attention (port
of ``repro.kernels.paged_attention.ref``: GQA and MLA latent pages).

The KV cache lives in a shared page pool ``(num_pages, page_size, ...)``;
each request owns a chain of page ids (one block-table row).  Entry j of
request b's dense view is ``pool[block_tables[b, j // ps], j % ps]``:
for global GQA and MLA latent pages j IS the absolute position; for a
sliding window j is a ring index over ``length`` entries holding the
latest position <= pos congruent to j (mod length).

Entries whose reconstructed position is masked contribute exactly zero
attention weight whatever the page holds, so stale pages of freed
requests and unallocated block-table entries never reach an output.

:func:`paged_gqa_ref` is the plain version of the GQA CUDA kernels
(``csrc/paged_gqa.cu``, ``csrc/paged_gqa_q8.cu``), :func:`paged_mla_ref`
that of the MLA ones (``csrc/paged_mla.cu``, ``csrc/paged_mla_q8.cu``).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.paged_attention import quant

NEG_INF = -1e30


def _chain_index(block_tables, length, page_size):
    """(page ids (B, length), in-page offsets (length,)) of the first
    ``length`` in-cache entries of every chain."""
    idx = torch.arange(length, device=block_tables.device)
    pages = block_tables[:, idx // page_size].long()
    return pages, idx % page_size


def gather_pages(pool, block_tables, length):
    """Dense view of the first ``length`` in-cache entries per request.
    pool: (P, page, ...); block_tables: (B, n_chain) -> (B, length, ...).
    Every block-table entry is a page id of the pool (unallocated entries
    hold 0), so no index leaves the pool."""
    pages, off = _chain_index(block_tables, length, pool.shape[1])
    return pool[pages, off[None, :]]


def gather_dequant(pool, scale, block_tables, length, dtype=torch.float32):
    """Dense dequantized view of an int8 pool's first ``length`` entries:
    codes AND their per-page scales gathered through the block table.
    pool: (P, page, *feat, d) int8; scale: (P, *feat) -> (B, length,
    *feat, d)."""
    pages, off = _chain_index(block_tables, length, pool.shape[1])
    vals = pool[pages, off[None, :]].float()
    return (vals * scale[pages][..., None]).to(dtype)


def paged_positions(pos, length, window=None):
    """Reconstructed absolute position + validity per in-cache index.
    pos: (B,) -> (k_pos, valid), both (B, length)."""
    pos = pos.long()[:, None]
    idx = torch.arange(length, device=pos.device)[None, :]
    if window is None:
        k_pos = idx.expand(pos.shape[0], length)
    else:
        k_pos = pos - torch.remainder(pos - idx, length)
    valid = (k_pos >= 0) & (k_pos <= pos)
    if window is not None:
        valid &= (pos - k_pos) < window
    return k_pos, valid


def paged_gqa_ref(q, pool_k, pool_v, block_tables, pos, *, length,
                  window=None, k_scale=None, v_scale=None):
    """q: (B, H, hd); pool_k/v: (P, page, KV, hd); pos: (B,) ->
    (B, H, hd) in q's dtype.  fp32 scores and softmax (the kernels'
    numerics); with int8 pools pass ``k_scale``/``v_scale`` (P, KV) and
    the pools are dequantized up front."""
    B, H, hd = q.shape
    KV = pool_k.shape[2]
    G = H // KV
    if k_scale is not None:
        pool_k = quant.dequantize(pool_k, k_scale)
        pool_v = quant.dequantize(pool_v, v_scale)
    kd = gather_pages(pool_k, block_tables, length).float()  # (B,L,KV,hd)
    vd = gather_pages(pool_v, block_tables, length).float()
    _k_pos, valid = paged_positions(pos, length, window)
    qg = q.reshape(B, KV, G, hd).float()
    scores = torch.einsum("bkgd,blkd->bkgl", qg, kd) / math.sqrt(hd)
    scores = torch.where(valid[:, None, None, :], scores,
                         torch.full((), NEG_INF, device=scores.device))
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgl,blkd->bkgd", w, vd)
    return out.reshape(B, H, hd).to(q.dtype)


def paged_mla_ref(q_abs, q_rope, pool_ckv, pool_krope, block_tables, pos, *,
                  length, scale, ckv_scale=None, krope_scale=None,
                  acc=torch.float32):
    """Weight-absorbed MLA decode over latent pages.  q_abs: (B, H, r)
    absorbed queries; q_rope: (B, H, dr); pool_ckv: (P, page, r);
    pool_krope: (P, page, dr) -> latent output (B, H, r) in q_abs's dtype
    (the caller up-projects through W^{UV}).  Scores, softmax and sums
    are taken in ``acc``: fp32 is what the kernels compute; fp64 gives
    the exact function of the same operands (the card's fp32 check of
    the simt route), with ``scale`` rounded to fp32 as the kernels take
    it.  With int8 latent pools pass ``ckv_scale``/``krope_scale`` (P,)
    and the pools are dequantized up front."""
    if ckv_scale is not None:
        pool_ckv = quant.dequantize(pool_ckv, ckv_scale)
        pool_krope = quant.dequantize(pool_krope, krope_scale)
    ccd = gather_pages(pool_ckv, block_tables, length).to(acc)   # (B,L,r)
    crd = gather_pages(pool_krope, block_tables, length).to(acc)  # (B,L,dr)
    _k_pos, valid = paged_positions(pos, length, None)
    scale = float(torch.tensor(scale, dtype=torch.float32))
    scores = (torch.einsum("bhr,blr->bhl", q_abs.to(acc), ccd)
              + torch.einsum("bhk,blk->bhl", q_rope.to(acc), crd)) * scale
    scores = torch.where(valid[:, None, :], scores,
                         torch.full((), NEG_INF, device=scores.device))
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhl,blr->bhr", w, ccd)
    return out.to(q_abs.dtype)
