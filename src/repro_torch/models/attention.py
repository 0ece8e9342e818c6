"""Grouped-query attention, global and sliding-window (port of the GQA
parts of ``repro.models.attention``).

Execution regimes, as in the reference:

  * ``forward``      — full-sequence causal attention (naive softmax or
                       flash attention, ``cfg.attention_impl``)
  * ``prefill``      — one chunk against a dense cache: global layers
                       scatter K/V at absolute positions, window layers do
                       the wrap-aware ring write
  * ``decode``       — one token per slot against the dense cache, with
                       PER-SLOT positions (the reference vmaps a scalar-pos
                       step over slots; here the slot batch is native)
  * ``decode_paged`` — one token per slot against a shared page pool read
                       through the block table: ``paged_impl="gather"``
                       rebuilds each slot's dense view and runs the dense
                       math (bitwise the dense layout), ``"kernel"`` reads
                       through the paged GQA decode kernels

``forward`` runs the naive softmax (``attention_impl="naive"``) or the
flash-attention op (``"flash"``: the CUDA forward and backward kernels on
the card, their plain versions on the CPU).  Parameter shapes are the
reference's: ``wq`` (d, H, hd), ``wk``/``wv`` (d, KV, hd), ``wo`` (H, hd,
d), so the bridge maps them by path.  MLA and speculative verify/commit
are not ported yet.

JAX drops out-of-bounds scatter writes and clamps out-of-bounds gathers,
and the reference leans on both (inactive slots write to page ``P``,
grid padding writes to index ``L``).  PyTorch raises on the CPU and traps
on the card, so every write here selects its rows explicitly instead.
Pool writes are IN PLACE (the pools are the engine's own buffers; the
reference returns updated copies).
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.paged_attention import quant as kvq
from repro_torch.kernels.paged_attention.ref import (gather_dequant,
                                                     gather_pages,
                                                     paged_positions)
from repro_torch.models.module import fan_in_init

NEG_INF = -1e30


def rope_freqs(head_dim: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x, positions, theta: float = 1e4):
    """x: (B, S, H, hd); positions: (B, S) or (S,) -> x rotated, in
    x.dtype (fp32 internally)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)
    angles = positions[..., None].float() * freqs        # (B, S, hd/2)
    if angles.dim() == 2:
        angles = angles[None]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _neg_inf(like):
    return torch.full((), NEG_INF, dtype=torch.float32, device=like.device)


def causal_mask(q_pos, k_pos, window: int | None = None):
    """(…, Sq, Sk) additive fp32 mask: causal, optionally banded."""
    m = q_pos[..., :, None] >= k_pos[..., None, :]
    if window is not None:
        m &= (q_pos[..., :, None] - k_pos[..., None, :]) < window
    return torch.where(m, torch.zeros((), device=m.device), _neg_inf(m))


def _sdpa(q, k, v, mask):
    """q: (B,S,H,hd), k/v: (B,L,KV,hd) with H = KV*G. mask: (B,1,S,L).
    Scores in q's dtype, promoted to fp32 for the mask and softmax, the
    weights back in q's dtype (``attention._sdpa``)."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    q = q.reshape(B, S, KV, G, hd)
    scores = torch.einsum("bskgd,blkd->bkgsl", q, k).float()
    scores = scores / math.sqrt(hd) + mask[:, :, None, :, :]
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgsl,blkd->bskgd", w, v)
    return out.reshape(B, S, H, hd)


def _paged_write_q8(pool, scale, wpage, in_page, fresh, tok):
    """Quantized page-granular decode write, IN PLACE: read each writing
    slot's live page, grow its scale monotonically to admit the new token,
    rescale the existing codes, set the token's codes, write page and
    scale back (``attention._paged_write_q8``).  In the steady state the
    scale is unchanged and round(c * 1.0) == c, so stored codes never
    move; ``fresh`` marks writes that START a page, where the previous
    tenant's scale resets to 0 (which zeroes its codes in the rescale).

    pool: (P, ps, KV, hd) int8; scale: (P, KV) f32; wpage, in_page,
    fresh: (n,) for the n WRITING slots only (no out-of-bounds rows —
    the caller selects the active slots); tok: (n, KV, hd)."""
    n = tok.shape[0]
    rows = pool[wpage]                                   # (n, ps, KV, hd)
    old_s = torch.where(fresh[:, None], torch.zeros((), device=pool.device),
                        scale[wpage])
    tok_s = torch.amax(tok.float().abs(), dim=-1) / kvq._scalar(kvq.QMAX,
                                                                tok)
    new_s = torch.maximum(torch.maximum(old_s, tok_s),
                          kvq._scalar(kvq.MIN_SCALE, tok))
    rows = kvq.rescale_codes(rows, old_s, new_s)
    code = torch.clamp(torch.round(tok.float() / new_s[..., None]),
                       -kvq.QMAX, kvq.QMAX).to(torch.int8)
    rows[torch.arange(n, device=pool.device), in_page] = code
    pool[wpage] = rows
    scale[wpage] = new_s


class GQAAttention(nn.Module):
    """Rotary GQA; ``local`` makes it a sliding-window ring of
    ``cfg.sliding_window`` positions."""

    def __init__(self, cfg: ModelConfig, *, local: bool = False,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.cfg = cfg
        self.local = local
        self.window = cfg.sliding_window if local else None
        d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        kw = dict(dtype=dtype, device=device)
        self.wq = nn.Parameter(torch.empty(d, H, hd, **kw))
        self.wk = nn.Parameter(torch.empty(d, KV, hd, **kw))
        self.wv = nn.Parameter(torch.empty(d, KV, hd, **kw))
        self.wo = nn.Parameter(torch.empty(H, hd, d, **kw))
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        c = self.cfg
        for w in (self.wq, self.wk, self.wv):
            fan_in_init(w, c.d_model, generator)
        fan_in_init(self.wo, c.n_heads * c.head_dim, generator)

    def _qkv(self, x, positions):
        dt = x.dtype
        q = torch.einsum("bsd,dhk->bshk", x, self.wq.to(dt))
        k = torch.einsum("bsd,dhk->bshk", x, self.wk.to(dt))
        v = torch.einsum("bsd,dhk->bshk", x, self.wv.to(dt))
        theta = self.cfg.rope_theta
        return apply_rope(q, positions, theta), apply_rope(k, positions,
                                                           theta), v

    def _out(self, out, x):
        return torch.einsum("bshk,hkd->bsd", out, self.wo.to(x.dtype))

    def forward(self, x, positions=None):
        """Full-sequence causal attention. x: (B, S, D).

        ``naive``: the masked softmax over ``positions``.  ``flash``: the
        flash-attention op on the (B, S, H, hd) projections passed as
        (B, H, S, hd) views (no copies; its output comes back in the same
        layout); as in the reference, rope is applied at ``positions`` but
        the causal and window mask is on the sequence index 0..S-1.  (The
        config admits no other value: the dry-run's ``stub`` is not
        ported.)"""
        B, S, _ = x.shape
        if positions is None:
            positions = torch.arange(S, device=x.device)
        q, k, v = self._qkv(x, positions)
        if self.cfg.attention_impl == "flash":
            out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), True, self.window)
            return self._out(out.transpose(1, 2), x)
        pos = positions.expand(B, S) if positions.dim() == 1 else positions
        mask = causal_mask(pos, pos, self.window)[:, None]
        return self._out(_sdpa(q, k, v, mask), x)

    # --- dense cache ---------------------------------------------------
    def ring_length(self, length):
        """Dense in-cache length this layer keeps at engine max_len
        ``length`` (the sliding-window ring retains only the window)."""
        return min(length, self.window) if self.window else length

    def init_cache(self, batch, length, dtype=torch.bfloat16):
        c = self.cfg
        shape = (batch, self.ring_length(length), c.n_kv_heads, c.head_dim)
        dev = self.wq.device
        return {"k": torch.zeros(shape, dtype=dtype, device=dev),
                "v": torch.zeros(shape, dtype=dtype, device=dev)}

    def prefill(self, x, cache, pos0, length=None):
        """Chunk prefill (``GQAAttention.prefill``).  x: (B, S, D); the
        tokens at in-chunk index >= ``length`` (a host int; None = all)
        are grid padding: masked out of attention and never written.

        Global: write K/V at absolute positions [pos0, pos0+length) and
        attend causally against the whole cache.  Window: attend each
        query against (ring snapshot ++ in-chunk K/V), then write the last
        min(L, length) valid tokens into the ring — one writer per slot.
        Returns (y, new cache); the input cache is not modified."""
        B, S, _ = x.shape
        length = S if length is None else int(length)
        dev = x.device
        positions = pos0 + torch.arange(S, device=dev)
        q, k, v = self._qkv(x, positions.expand(B, S))
        L = cache["k"].shape[1]
        i = torch.arange(S, device=dev)
        zero = torch.zeros((), device=dev)
        ck, cv = cache["k"].clone(), cache["v"].clone()
        if not self.local:
            keep = slice(0, max(0, min(length, L - pos0)))
            idx = positions[keep]
            ck[:, idx] = k[:, keep].to(ck.dtype)
            cv[:, idx] = v[:, keep].to(cv.dtype)
            k_pos = torch.arange(L, device=dev)
            mask = torch.where(k_pos[None, :] <= positions[:, None], zero,
                               _neg_inf(x))
            mask = mask[None, None].expand(B, 1, S, L)
            out = _sdpa(q, ck.to(q.dtype), cv.to(q.dtype), mask)
        else:
            W = min(self.window, L)
            j = torch.arange(L, device=dev)
            ring_pos = (pos0 - 1) - torch.remainder(pos0 - 1 - j, L)
            ring_m = ((ring_pos >= 0) & (pos0 >= 1))[None, :] \
                & (positions[:, None] - ring_pos[None, :] < W)
            valid = i < length
            in_m = ((positions[None, :] <= positions[:, None])
                    & (positions[:, None] - positions[None, :] < W)
                    & valid[None, :])
            mask = torch.where(torch.cat([ring_m, in_m], dim=1), zero,
                               _neg_inf(x))
            mask = mask[None, None].expand(B, 1, S, L + S)
            kk = torch.cat([cache["k"].to(q.dtype), k], dim=1)
            vv = torch.cat([cache["v"].to(q.dtype), v], dim=1)
            out = _sdpa(q, kk, vv, mask)
            # only the last L valid tokens survive a wrap
            keep = slice(max(0, length - L), length)
            idx = torch.remainder(positions[keep], L)
            ck[:, idx] = k[:, keep].to(ck.dtype)
            cv[:, idx] = v[:, keep].to(cv.dtype)
        return self._out(out, x), {"k": ck, "v": cv}

    def _decode_mask(self, pos, L):
        """(B, 1, 1, L) additive mask of the dense (ring) view for queries
        at per-slot positions ``pos`` (B,)."""
        _k_pos, valid = paged_positions(pos, L, self.window)
        return torch.where(valid, torch.zeros((), device=pos.device),
                           _neg_inf(pos))[:, None, None, :]

    def decode(self, x, cache, pos):
        """One-token decode against the dense cache. x: (B, 1, D); pos:
        (B,) per-slot positions.  Returns (y, new cache); the write of a
        slot whose pos is past a global cache clamps to its last entry
        (the reference's dynamic_update_slice) — such a slot is inactive
        and its result is discarded by the caller's masked merge."""
        B = x.shape[0]
        pos = pos.long()
        q, k, v = self._qkv(x, pos[:, None])
        L = cache["k"].shape[1]
        slot = torch.remainder(pos, L) if self.window else pos.clamp(0, L - 1)
        rows = torch.arange(B, device=x.device)
        ck, cv = cache["k"].clone(), cache["v"].clone()
        ck[rows, slot] = k[:, 0].to(ck.dtype)
        cv[rows, slot] = v[:, 0].to(cv.dtype)
        out = _sdpa(q, ck.to(q.dtype), cv.to(q.dtype),
                    self._decode_mask(pos, L))
        return self._out(out, x), {"k": ck, "v": cv}

    # --- paged cache ---------------------------------------------------
    def paged_cache_spec(self, num_pages, page_size, dtype=torch.bfloat16):
        """{leaf: (shape, dtype)} of this layer's page pool; int8 pools
        add a float32 (page, kv head) scale leaf per data leaf."""
        c = self.cfg
        shape = (num_pages, page_size, c.n_kv_heads, c.head_dim)
        if c.kv_dtype == "int8":
            sc = ((num_pages, c.n_kv_heads), torch.float32)
            return {"k": (shape, torch.int8), "v": (shape, torch.int8),
                    "k_scale": sc, "v_scale": sc}
        return {"k": (shape, dtype), "v": (shape, dtype)}

    def decode_paged(self, x, cache, pos, bt, active, length, rows=None):
        """One slot-batched decode step against the page pool.

        x: (B, 1, D); pos: (B,); active: (B,) bool; bt: (B, max_pages)
        page ids; cache: {"k", "v"[, "k_scale", "v_scale"]} pools;
        ``length`` = the engine's max_len; ``rows`` = the indices of the
        active slots when the caller has them (else taken from
        ``active``).  Each ACTIVE slot's K/V is written into its live page
        in place (int8: quantized into it), then attention reads the
        chains back.  Returns (y, cache)."""
        q, k, v = self._qkv(x, pos.long()[:, None])
        ps = cache["k"].shape[1]
        L = self.ring_length(length)
        if rows is None:
            rows = torch.nonzero(active).flatten()
        wpos = pos.long()[rows]
        slot = torch.remainder(wpos, L) if self.window else wpos
        wpage = bt[rows, slot // ps].long()
        in_page = slot % ps
        q8 = self.cfg.kv_dtype == "int8"
        if q8:
            # a page is brand-new only when the write lands on its first
            # entry at an unwrapped position (ring laps recycle in place)
            fresh = (in_page == 0) & (wpos == slot)
            _paged_write_q8(cache["k"], cache["k_scale"], wpage, in_page,
                            fresh, k[rows, 0])
            _paged_write_q8(cache["v"], cache["v_scale"], wpage, in_page,
                            fresh, v[rows, 0])
            cks, cvs = cache["k_scale"], cache["v_scale"]
        else:
            cache["k"][wpage, in_page] = k[rows, 0].to(cache["k"].dtype)
            cache["v"][wpage, in_page] = v[rows, 0].to(cache["v"].dtype)
            cks = cvs = None
        ck, cv = cache["k"], cache["v"]
        if self.cfg.paged_impl != "gather":
            from repro_torch.kernels.paged_attention.ops import (
                paged_gqa_attention)
            out = paged_gqa_attention(
                q[:, 0], ck, cv, bt, pos, length=L, window=self.window,
                backend=self.cfg.paged_impl, k_scale=cks,
                v_scale=cvs)[:, None]
        else:
            if q8:
                kd = gather_dequant(ck, cks, bt, L, q.dtype)
                vd = gather_dequant(cv, cvs, bt, L, q.dtype)
            else:
                kd = gather_pages(ck, bt, L).to(q.dtype)
                vd = gather_pages(cv, bt, L).to(q.dtype)
            out = _sdpa(q, kd, vd, self._decode_mask(pos, L))
        return self._out(out, x), cache
