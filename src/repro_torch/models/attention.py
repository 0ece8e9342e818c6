"""Grouped-query attention, global and sliding-window, and DeepSeek
multi-head latent attention (port of ``repro.models.attention``).

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
                       through the paged GQA (MLA: latent) decode kernels

``forward`` runs the naive softmax (``attention_impl="naive"``) or the
flash-attention op (``"flash"``: the CUDA forward and backward kernels on
the card, their plain versions on the CPU).  Parameter shapes are the
reference's: ``wq`` (d, H, hd), ``wk``/``wv`` (d, KV, hd), ``wo`` (H, hd,
d), so the bridge maps them by path; :class:`MLAAttention` keeps the
reference's MLA leaves and layouts as well.

Speculative verify (``verify_paged``) scores K tokens against the pool
WITHOUT writing it: the projections run once over all K tokens, and
query i attends through the gathered pool snapshot with the in-flight
K/V of tokens m <= i overlaid at their native in-cache indices — the
view a sequential ``decode_paged`` at ``pos+i`` would read — in the S=1
attention of the gather decode.  ``commit_paged`` then writes only the
accepted prefix.

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
from repro_torch.parallel import spmd

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


def no_mask(q, k):
    """The all-zero additive mask (B, 1, S, L) of unmasked attention of q
    (B, S, ...) over k (B, L, ...), in q's dtype: a broadcast view of one
    zero (the reference's ``jnp.zeros((B, 1, S, L), q.dtype)``)."""
    B, S, L = q.shape[0], q.shape[1], k.shape[1]
    return torch.zeros((1, 1, 1, 1), dtype=q.dtype,
                       device=q.device).expand(B, 1, S, L)


def _decode_mask(pos, L, window=None):
    """(B, 1, 1, L) additive mask of the dense (ring) view for queries at
    per-slot positions ``pos`` (B,)."""
    _k_pos, valid = paged_positions(pos, L, window)
    return torch.where(valid, torch.zeros((), device=pos.device),
                       _neg_inf(pos))[:, None, None, :]


def _refuse_q8(cfg):
    if cfg.kv_dtype == "int8":
        raise NotImplementedError(
            "speculative verify requires bf16 pools (int8 page rescale "
            "is not replayable per accepted prefix)")


def _verify_slots(p, L, window):
    """In-cache index of absolute positions ``p``: the ring slot of a
    window layer, else ``p`` clamped into the cache (only queries past a
    slot's verify width reach the clamp, and their results are
    discarded)."""
    return torch.remainder(p, L) if window else p.clamp(max=L - 1)


def _verify_overlays(view, block, positions, window, attend):
    """The per-query loop of a verify wave: for i < K, overlay token i's
    cache-dtype ``block`` entries (B, K, ...) into the gathered ``view``
    {leaf: (B, L, ...)} in place at its in-cache index, then
    ``attend(i, view, mask)`` as the gather decode at ``positions[:, i]``.
    Returns the K outputs concatenated on axis 1."""
    L = next(iter(view.values())).shape[1]
    rows = torch.arange(positions.shape[0], device=positions.device)
    outs = []
    for i in range(positions.shape[1]):
        p = positions[:, i]
        slot = _verify_slots(p, L, window)
        for key, val in block.items():
            view[key][rows, slot] = val[:, i]
        outs.append(attend(i, view, _decode_mask(p, L, window)))
    return torch.cat(outs, 1)


def _commit(cache, block, pos, bt, sel, L, window):
    """Write the selected (row, j) entries of a verify block into the
    pools in place: ``sel`` (n, 2) = the accepted (slot, token) pairs."""
    b, j = sel[:, 0], sel[:, 1]
    ps = next(iter(cache.values())).shape[1]
    p = pos.long()[b] + j
    slot = torch.remainder(p, L) if window else p
    wpage = bt[b, slot // ps].long()
    for key, val in block.items():
        cache[key][wpage, slot % ps] = val[b, j]
    return cache


def commit_select(n_commit, active, K):
    """(n, 2) indices of the (slot, token) pairs a commit writes: the
    first ``n_commit[b]`` of each active slot's K."""
    j = torch.arange(K, device=n_commit.device)
    ok = (j[None, :] < n_commit.long()[:, None]) & active[:, None]
    return torch.nonzero(ok)


def _paged_write_q8(pool, scale, wpage, in_page, fresh, tok):
    """Quantized page-granular decode write, IN PLACE: read each writing
    slot's live page, grow its scale monotonically to admit the new token,
    rescale the existing codes, set the token's codes, write page and
    scale back (``attention._paged_write_q8``).  In the steady state the
    scale is unchanged and round(c * 1.0) == c, so stored codes never
    move; ``fresh`` marks writes that START a page, where the previous
    tenant's scale resets to 0 (which zeroes its codes in the rescale).

    pool: (P, ps, *feat, d) int8 — GQA (P, ps, KV, hd), MLA latents
    (P, ps, r); scale: (P, *feat) f32; wpage, in_page, fresh: (n,) for the
    n WRITING slots only (no out-of-bounds rows — the caller selects the
    active slots); tok: (n, *feat, d)."""
    n = tok.shape[0]
    rows = pool[wpage]                                   # (n, ps, *feat, d)
    old_s = scale[wpage]                                 # (n, *feat)
    f = fresh.reshape((n,) + (1,) * (old_s.dim() - 1))
    old_s = torch.where(f, torch.zeros((), device=pool.device), old_s)
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

    def axes(self):
        return {"wq": ("embed", "heads", "head_dim"),
                "wk": ("embed", "kv_heads", "head_dim"),
                "wv": ("embed", "kv_heads", "head_dim"),
                "wo": ("heads", "head_dim", "embed")}

    def cache_axes(self):
        a = ("batch", "kv_len", "kv_heads", "head_dim")
        return {"k": a, "v": a}

    def paged_cache_axes(self):
        a = ("pages", "page", "kv_heads", "head_dim")
        if self.cfg.kv_dtype == "int8":
            sc = ("pages", "kv_heads")
            return {"k": a, "v": a, "k_scale": sc, "v_scale": sc}
        return {"k": a, "v": a}

    # --- tensor parallelism: this rank's heads ---------------------------
    # The rule tables shard the query heads when their count divides the
    # "model" axis, and the KV heads likewise; KV heads cannot shard while
    # the query heads replicate (H = KV·G).  Sharded query heads make the
    # output projection a partial sum; replicated KV heads under sharded
    # query heads (4 heads, 2 KV heads at TP 4) keep every KV head on
    # every rank, and a rank's local query head h reads KV head
    # (h + rank·H/tp) // G.
    def _tp(self):
        """The runtime when this layer's query heads are sharded."""
        s = spmd.current()
        return s if s is not None and \
            self.wq.shape[1] < self.cfg.n_heads else None

    def _kv_index(self):
        """KV head of each local query head when the query heads shard and
        the KV heads do not (else None: the plain H // KV grouping)."""
        s = self._tp()
        if s is None or self.wk.shape[1] < self.cfg.n_kv_heads:
            return None
        hl = self.wq.shape[1]
        g = self.cfg.n_heads // self.cfg.n_kv_heads
        return (s.tp_rank * hl + torch.arange(hl, device=self.wq.device)) \
            // g

    def _kernel_rows(self, idx):
        """(row of each local query head, query rows a KV head) of the
        query block the paged kernel takes when :meth:`_kv_index` applies:
        KV head j's rows are j·m .. j·m + m - 1, m = the most local heads
        one KV head serves."""
        heads = idx.tolist()
        m = max(heads.count(h) for h in heads)
        seen, rows = {}, []
        for h in heads:
            rows.append(h * m + seen.get(h, 0))
            seen[h] = seen.get(h, 0) + 1
        return torch.as_tensor(rows, device=idx.device), m

    def _kv(self, k, v):
        """K/V (B, L, KV, hd) as this rank's query heads read them."""
        idx = self._kv_index()
        if idx is None:
            return k, v
        return k[:, :, idx], v[:, :, idx]

    def _attend(self, q, k, v, mask):
        return _sdpa(q, *self._kv(k, v), mask)

    def _qkv(self, x, positions):
        dt = x.dtype
        s = self._tp()
        if s is not None:
            x = s.enter(x)
        q = torch.einsum("bsd,dhk->bshk", x, self.wq.to(dt))
        k = torch.einsum("bsd,dhk->bshk", x, self.wk.to(dt))
        v = torch.einsum("bsd,dhk->bshk", x, self.wv.to(dt))
        theta = self.cfg.rope_theta
        return apply_rope(q, positions, theta), apply_rope(k, positions,
                                                           theta), v

    def _out(self, out, x):
        s = self._tp()
        if s is not None:
            # the heads' partial products stay in fp32 (what the compute
            # dtype's GEMM accumulates in) until the sum over "model",
            # rounded once as the single-device product is
            return s.reduce(torch.einsum(
                "bshk,hkd->bsd", out.float(),
                self.wo.to(x.dtype).float())).to(x.dtype)
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
            k, v = self._kv(k, v)
            out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), True, self.window)
            return self._out(out.transpose(1, 2), x)
        pos = positions.expand(B, S) if positions.dim() == 1 else positions
        mask = causal_mask(pos, pos, self.window)[:, None]
        return self._out(self._attend(q, k, v, mask), x)

    def bidirectional(self, x):
        """Full-sequence attention with no mask, rope at 0..S-1: the
        Whisper encoder's self-attention (``whisper.EncoderLayer``), the
        naive softmax whatever ``attention_impl`` says, as in the
        reference.  x: (B, S, D)."""
        q, k, v = self._qkv(x, torch.arange(x.shape[1], device=x.device))
        return self._out(self._attend(q, k, v, no_mask(q, k)), x)

    # --- dense cache ---------------------------------------------------
    def ring_length(self, length):
        """Dense in-cache length this layer keeps at engine max_len
        ``length`` (the sliding-window ring retains only the window)."""
        return min(length, self.window) if self.window else length

    def init_cache(self, batch, length, dtype=torch.bfloat16):
        c = self.cfg
        # self.wk: this rank's KV heads inside spmd.local_view, all of
        # them outside
        shape = (batch, self.ring_length(length), self.wk.shape[1],
                 c.head_dim)
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
            out = self._attend(q, ck.to(q.dtype), cv.to(q.dtype), mask)
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
            out = self._attend(q, kk, vv, mask)
            # only the last L valid tokens survive a wrap
            keep = slice(max(0, length - L), length)
            idx = torch.remainder(positions[keep], L)
            ck[:, idx] = k[:, keep].to(ck.dtype)
            cv[:, idx] = v[:, keep].to(cv.dtype)
        return self._out(out, x), {"k": ck, "v": cv}

    def _decode_mask(self, pos, L):
        return _decode_mask(pos, L, self.window)

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
        out = self._attend(q, ck.to(q.dtype), cv.to(q.dtype),
                           self._decode_mask(pos, L))
        return self._out(out, x), {"k": ck, "v": cv}

    # --- paged cache ---------------------------------------------------
    def paged_cache_spec(self, num_pages, page_size, dtype=torch.bfloat16):
        """{leaf: (shape, dtype)} of this layer's page pool; int8 pools
        add a float32 (page, kv head) scale leaf per data leaf."""
        c = self.cfg
        kv = self.wk.shape[1]       # this rank's, in spmd.local_view
        shape = (num_pages, page_size, kv, c.head_dim)
        if c.kv_dtype == "int8":
            sc = ((num_pages, kv), torch.float32)
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
        chains back.

        Slots sharded over "data" (a bound mesh's decode step): the pools
        are whole on every data rank, so the K/V of every rank's active
        slots are gathered and written on each (the step's global views,
        ``Spmd.step``), and the attention reads this rank's slots.
        Returns (y, cache)."""
        q, k, v = self._qkv(x, pos.long()[:, None])
        ps = cache["k"].shape[1]
        L = self.ring_length(length)
        if rows is None:
            rows = torch.nonzero(active).flatten()
        s = spmd.current()
        wbt, wposs = bt, pos
        if s is not None and s.step is not None:
            k, v = s.gather_rows(k, s.step.n), s.gather_rows(v, s.step.n)
            wbt, wposs, rows = s.step.bt, s.step.pos, s.step.rows
        wpos = wposs.long()[rows]
        slot = torch.remainder(wpos, L) if self.window else wpos
        wpage = wbt[rows, slot // ps].long()
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
            idx = self._kv_index()
            qk = q[:, 0]
            if idx is not None:
                # every KV head is here but this rank's query heads do not
                # make whole groups: give the kernel m query rows a KV head
                # (zeros where no local head reads it)
                sel, m = self._kernel_rows(idx)
                qk = qk.new_zeros(qk.shape[0], ck.shape[2] * m, qk.shape[2])
                qk[:, sel] = q[:, 0]
            out = paged_gqa_attention(
                qk, ck, cv, bt, pos, length=L, window=self.window,
                backend=self.cfg.paged_impl, k_scale=cks,
                v_scale=cvs)
            if idx is not None:
                out = out[:, sel]
            out = out[:, None]
        else:
            if q8:
                kd = gather_dequant(ck, cks, bt, L, q.dtype)
                vd = gather_dequant(cv, cvs, bt, L, q.dtype)
            else:
                kd = gather_pages(ck, bt, L).to(q.dtype)
                vd = gather_pages(cv, bt, L).to(q.dtype)
            out = self._attend(q, kd, vd, self._decode_mask(pos, L))
        return self._out(out, x), cache

    # --- speculative k-token verify (read-only; commit is separate) ---
    def verify_paged(self, x, cache, pos, bt, active, length):
        """Score K speculative tokens x (B, K, D) at positions ``pos ..
        pos+K-1`` against the pool without writing it: Q/K/V and ``wo``
        over all K tokens at once, the S=1 gather-read attention of
        :meth:`decode_paged` once per query.  Returns (y (B, K, D), block
        {"k", "v"} (B, K, KV, hd) in the pool dtype for
        :meth:`commit_paged`).  K must not exceed the ring length (the
        engine checks spec_k); int8 pools are refused."""
        del active
        _refuse_q8(self.cfg)
        K = x.shape[1]
        positions = pos.long()[:, None] + torch.arange(K, device=x.device)
        q, k, v = self._qkv(x, positions)
        L = self.ring_length(length)
        view = {"k": gather_pages(cache["k"], bt, L),
                "v": gather_pages(cache["v"], bt, L)}
        block = {"k": k.to(view["k"].dtype), "v": v.to(view["v"].dtype)}

        def attend(i, view, mask):
            return self._attend(q[:, i:i + 1].contiguous(),
                                view["k"].to(q.dtype),
                                view["v"].to(q.dtype), mask)
        out = _verify_overlays(view, block, positions, self.window, attend)
        return self._out(out, x), block

    def commit_paged(self, cache, block, pos, bt, n_commit, active, length,
                     sel=None):
        """Write the first ``n_commit[b]`` tokens of ``block`` of each
        active slot into the pool at ``pos[b] ..``, in place; rejected
        tokens are never written.  ``sel`` = :func:`commit_select`'s
        indices when the caller has them."""
        if sel is None:
            sel = commit_select(n_commit, active, block["k"].shape[1])
        return _commit(cache, block, pos, bt, sel, self.ring_length(length),
                       self.window)


class MLAAttention(nn.Module):
    """DeepSeek multi-head latent attention (``attention.MLAAttention``):
    queries through a q_lora bottleneck, keys and values through one
    shared kv_lora latent plus one shared rotary key head.  Decode caches
    only the compressed latents (``ckv`` (…, r) and ``krope`` (…, dr)) and
    absorbs W^{UK} into the query, so attention runs in the latent space
    and W^{UV} up-projects its output.

    Parameter names and layouts are the reference's: ``w_dq`` (d, q_lora),
    ``w_uq`` (q_lora, H, nope + rope), ``w_dkv`` (d, r), ``w_kr`` (d, dr),
    ``w_ukv`` (r, H, nope + v), ``wo`` (H, v, d), ``q_norm`` (q_lora,),
    ``kv_norm`` (r,)."""

    def __init__(self, cfg: ModelConfig, *, dtype=torch.float32, device=None):
        super().__init__()
        if cfg.mla is None:
            raise ValueError(f"{cfg.name}: MLAAttention needs cfg.mla")
        self.cfg = cfg
        self.m = m = cfg.mla
        d, H = cfg.d_model, cfg.n_heads
        kw = dict(dtype=dtype, device=device)
        qk = m.qk_nope_head_dim + m.qk_rope_head_dim
        self.w_dq = nn.Parameter(torch.empty(d, m.q_lora_rank, **kw))
        self.w_uq = nn.Parameter(torch.empty(m.q_lora_rank, H, qk, **kw))
        self.w_dkv = nn.Parameter(torch.empty(d, m.kv_lora_rank, **kw))
        self.w_kr = nn.Parameter(torch.empty(d, m.qk_rope_head_dim, **kw))
        self.w_ukv = nn.Parameter(torch.empty(
            m.kv_lora_rank, H, m.qk_nope_head_dim + m.v_head_dim, **kw))
        self.wo = nn.Parameter(torch.empty(H, m.v_head_dim, d, **kw))
        self.q_norm = nn.Parameter(torch.empty(m.q_lora_rank, **kw))
        self.kv_norm = nn.Parameter(torch.empty(m.kv_lora_rank, **kw))
        #: the reference's 1 / sqrt(nope + rope) softmax scale
        self.scale = 1.0 / math.sqrt(qk)
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        """Fan-in init of the projections, unit norm scales (the
        reference's ``init``)."""
        c, m = self.cfg, self.m
        fan_in_init(self.w_dq, c.d_model, generator)
        fan_in_init(self.w_uq, m.q_lora_rank, generator)
        fan_in_init(self.w_dkv, c.d_model, generator)
        fan_in_init(self.w_kr, c.d_model, generator)
        fan_in_init(self.w_ukv, m.kv_lora_rank, generator)
        fan_in_init(self.wo, c.n_heads * m.v_head_dim, generator)
        with torch.no_grad():
            self.q_norm.fill_(1.0)
            self.kv_norm.fill_(1.0)

    def axes(self):
        return {"w_dq": ("embed", "q_lora"),
                "w_uq": ("q_lora", "heads", "head_dim"),
                "w_dkv": ("embed", "kv_lora"),
                "w_kr": ("embed", "head_dim"),
                "w_ukv": ("kv_lora", "heads", "head_dim"),
                "wo": ("heads", "head_dim", "embed"),
                "q_norm": ("q_lora",), "kv_norm": ("kv_lora",)}

    def cache_axes(self):
        return {"ckv": ("batch", "kv_len", "kv_lora"),
                "krope": ("batch", "kv_len", "head_dim")}

    def paged_cache_axes(self):
        a = {"ckv": ("pages", "page", "kv_lora"),
             "krope": ("pages", "page", "head_dim")}
        if self.cfg.kv_dtype == "int8":
            a.update(ckv_scale=("pages",), krope_scale=("pages",))
        return a

    @staticmethod
    def _rms(x, scale, eps=1e-6):
        """The reference's fixed-eps RMS norm of the latents: fp32
        internals, back in x's dtype (not ``cfg.norm_eps``)."""
        xf = x.float()
        v = torch.mean(torch.square(xf), -1, keepdim=True)
        return (xf * torch.rsqrt(v + eps) * scale.float()).to(x.dtype)

    def _latents(self, x, positions):
        """(q_nope (B,S,H,nope), q_rope (B,S,H,dr), ckv (B,S,r),
        k_rope (B,S,dr)) of x (B, S, D) at ``positions``."""
        c, m = self.cfg, self.m
        dt = x.dtype
        cq = self._rms(x @ self.w_dq.to(dt), self.q_norm)
        q = torch.einsum("bsr,rhk->bshk", cq, self.w_uq.to(dt))
        q_nope = q[..., :m.qk_nope_head_dim]
        q_rope = apply_rope(q[..., m.qk_nope_head_dim:], positions,
                            c.rope_theta)
        ckv = self._rms(x @ self.w_dkv.to(dt), self.kv_norm)
        k_rope = (x @ self.w_kr.to(dt))[:, :, None, :]   # 1 shared head
        k_rope = apply_rope(k_rope, positions, c.rope_theta)[:, :, 0, :]
        return q_nope, q_rope, ckv, k_rope

    def _absorb(self, q_nope, dt):
        """q_abs = q_nope @ W^{UK}ᵀ per head: (B, S, H, nope) -> (B, S,
        H, r)."""
        w_uk = self.w_ukv[:, :, :self.m.qk_nope_head_dim].to(dt)
        return torch.einsum("bshk,rhk->bshr", q_nope, w_uk)

    def _latent_attend(self, q_abs, q_rope, cc, cr, mask):
        """Weight-absorbed attention over latents cc (B, L, r) and cr
        (B, L, dr) in the compute dtype; mask: additive (B|1, 1, S, L) ->
        latent output (B, S, H, r)."""
        scores = (torch.einsum("bshr,blr->bhsl", q_abs, cc)
                  + torch.einsum("bshk,blk->bhsl", q_rope, cr))
        w = torch.softmax(scores.float() * self.scale + mask,
                          -1).to(q_abs.dtype)
        return torch.einsum("bhsl,blr->bshr", w, cc)

    def _up(self, o_latent, x):
        """Latent output (B, S, H, r) through W^{UV} and ``wo``."""
        w_uv = self.w_ukv[:, :, self.m.qk_nope_head_dim:].to(x.dtype)
        out = torch.einsum("bshr,rhk->bshk", o_latent, w_uv)
        return torch.einsum("bshk,hkd->bsd", out, self.wo.to(x.dtype))

    def forward(self, x, positions=None):
        """Full-sequence causal attention (the reference's naive
        ``__call__``: keys and values up-projected, no absorption).
        x: (B, S, D)."""
        m = self.m
        B, S, _ = x.shape
        if positions is None:
            positions = torch.arange(S, device=x.device)
        q_nope, q_rope, ckv, k_rope = self._latents(x, positions)
        kv = torch.einsum("bsr,rhk->bshk", ckv, self.w_ukv.to(x.dtype))
        k_nope, v = kv[..., :m.qk_nope_head_dim], kv[..., m.qk_nope_head_dim:]
        pos = positions.expand(B, S) if positions.dim() == 1 else positions
        mask = causal_mask(pos, pos)[:, None]
        scores = (torch.einsum("bshk,blhk->bhsl", q_nope, k_nope)
                  + torch.einsum("bshk,blk->bhsl", q_rope, k_rope))
        w = torch.softmax(scores.float() * self.scale + mask,
                          -1).to(x.dtype)
        out = torch.einsum("bhsl,blhk->bshk", w, v)
        return torch.einsum("bshk,hkd->bsd", out, self.wo.to(x.dtype))

    # --- dense latent cache ----------------------------------------------
    def cache_spec(self, batch, length, dtype=torch.bfloat16):
        """{leaf: (shape, dtype)} of the dense latent cache."""
        m = self.m
        return {"ckv": ((batch, length, m.kv_lora_rank), dtype),
                "krope": ((batch, length, m.qk_rope_head_dim), dtype)}

    def init_cache(self, batch, length, dtype=torch.bfloat16):
        dev = self.w_dq.device
        return {k: torch.zeros(shape, dtype=dt, device=dev)
                for k, (shape, dt) in self.cache_spec(batch, length,
                                                      dtype).items()}

    def can_prefill(self):
        return True

    def ring_length(self, length):
        """Latent caches index globally: the whole engine max_len."""
        return length

    def prefill(self, x, cache, pos0, length=None):
        """Chunk prefill with the compressed latent cache
        (``MLAAttention.prefill``): write the chunk's latents at absolute
        positions [pos0, pos0+length), then run the weight-absorbed
        attention of ``decode`` for all S queries at once.  Tokens at
        in-chunk index >= ``length`` (a host int; None = all) are grid
        padding — never written, and causally masked for every valid
        query.  Returns (y, new cache); the input cache is not modified."""
        B, S, _ = x.shape
        length = S if length is None else int(length)
        dev = x.device
        positions = pos0 + torch.arange(S, device=dev)
        q_nope, q_rope, ckv, k_rope = self._latents(x, positions.expand(B, S))
        L = cache["ckv"].shape[1]
        keep = slice(0, max(0, min(length, L - pos0)))
        idx = positions[keep]
        cc, cr = cache["ckv"].clone(), cache["krope"].clone()
        cc[:, idx] = ckv[:, keep].to(cc.dtype)
        cr[:, idx] = k_rope[:, keep].to(cr.dtype)
        mask = torch.where(torch.arange(L, device=dev)[None, :]
                           <= positions[:, None],
                           torch.zeros((), device=dev), _neg_inf(x))
        o_latent = self._latent_attend(self._absorb(q_nope, x.dtype), q_rope,
                                       cc.to(x.dtype), cr.to(x.dtype),
                                       mask[None, None])
        return self._up(o_latent, x), {"ckv": cc, "krope": cr}

    def decode(self, x, cache, pos):
        """One-token decode against the dense latent cache with per-slot
        positions ``pos`` (B,) (the reference vmaps a scalar-position
        step).  The write of a slot whose pos is past the cache clamps to
        its last entry (the reference's dynamic_update_slice).  Returns
        (y, new cache)."""
        B = x.shape[0]
        pos = pos.long()
        q_nope, q_rope, ckv, k_rope = self._latents(x, pos[:, None])
        L = cache["ckv"].shape[1]
        slot = pos.clamp(0, L - 1)
        rows = torch.arange(B, device=x.device)
        cc, cr = cache["ckv"].clone(), cache["krope"].clone()
        cc[rows, slot] = ckv[:, 0].to(cc.dtype)
        cr[rows, slot] = k_rope[:, 0].to(cr.dtype)
        o_latent = self._latent_attend(self._absorb(q_nope, x.dtype), q_rope,
                                       cc.to(x.dtype), cr.to(x.dtype),
                                       _decode_mask(pos, L))
        return self._up(o_latent, x), {"ckv": cc, "krope": cr}

    # --- paged latent pools ----------------------------------------------
    def paged_cache_spec(self, num_pages, page_size, dtype=torch.bfloat16):
        """{leaf: (shape, dtype)} of this layer's latent page pools; int8
        pools add one float32 scale per page for each (``ckv_scale``,
        ``krope_scale`` (P,))."""
        m = self.m
        q8 = self.cfg.kv_dtype == "int8"
        dt = torch.int8 if q8 else dtype
        spec = {"ckv": ((num_pages, page_size, m.kv_lora_rank), dt),
                "krope": ((num_pages, page_size, m.qk_rope_head_dim), dt)}
        if q8:
            sc = ((num_pages,), torch.float32)
            spec.update(ckv_scale=sc, krope_scale=sc)
        return spec

    def decode_paged(self, x, cache, pos, bt, active, length, rows=None):
        """Slot-batched weight-absorbed decode against the latent page
        pools (the contract of :meth:`GQAAttention.decode_paged`): each
        ACTIVE slot's latents are written into its live page in place
        (int8: quantized into it), then the chains are read back through
        ``paged_impl`` — the paged MLA kernels, or the gather of each
        chain into the dense decode math.  Returns (y, cache)."""
        q_nope, q_rope, ckv, k_rope = self._latents(x, pos.long()[:, None])
        ps = cache["ckv"].shape[1]
        if rows is None:
            rows = torch.nonzero(active).flatten()
        s = spmd.current()
        wbt, wposs = bt, pos
        if s is not None and s.step is not None:     # DP: pools whole
            ckv = s.gather_rows(ckv, s.step.n)
            k_rope = s.gather_rows(k_rope, s.step.n)
            wbt, wposs, rows = s.step.bt, s.step.pos, s.step.rows
        wpos = wposs.long()[rows]
        wpage = wbt[rows, wpos // ps].long()
        in_page = wpos % ps
        q8 = self.cfg.kv_dtype == "int8"
        if q8:
            fresh = in_page == 0            # latent pages index globally
            _paged_write_q8(cache["ckv"], cache["ckv_scale"], wpage,
                            in_page, fresh, ckv[rows, 0])
            _paged_write_q8(cache["krope"], cache["krope_scale"], wpage,
                            in_page, fresh, k_rope[rows, 0])
            ccs, crs = cache["ckv_scale"], cache["krope_scale"]
        else:
            cache["ckv"][wpage, in_page] = ckv[rows, 0].to(cache["ckv"].dtype)
            cache["krope"][wpage, in_page] = k_rope[rows, 0].to(
                cache["krope"].dtype)
            ccs = crs = None
        cc, cr = cache["ckv"], cache["krope"]
        q_abs = self._absorb(q_nope, x.dtype)
        if self.cfg.paged_impl != "gather":
            from repro_torch.kernels.paged_attention.ops import (
                paged_mla_attention)
            o_latent = paged_mla_attention(
                q_abs[:, 0].contiguous(), q_rope[:, 0].contiguous(), cc, cr,
                bt, pos, length=length, scale=self.scale,
                backend=self.cfg.paged_impl, ckv_scale=ccs,
                krope_scale=crs)[:, None].to(x.dtype)
        else:
            if q8:
                ccd = gather_dequant(cc, ccs, bt, length, x.dtype)
                crd = gather_dequant(cr, crs, bt, length, x.dtype)
            else:
                ccd = gather_pages(cc, bt, length).to(x.dtype)
                crd = gather_pages(cr, bt, length).to(x.dtype)
            o_latent = self._latent_attend(q_abs, q_rope, ccd, crd,
                                           _decode_mask(pos, length))
        return self._up(o_latent, x), cache

    # --- speculative k-token verify (read-only; commit is separate) ---
    def verify_paged(self, x, cache, pos, bt, active, length):
        """MLA k-token verify (the contract of
        :meth:`GQAAttention.verify_paged`, on the latents): projections,
        absorption and up-projection over all K tokens, the gather read's
        weight-absorbed attention once per query."""
        del active
        _refuse_q8(self.cfg)
        K = x.shape[1]
        positions = pos.long()[:, None] + torch.arange(K, device=x.device)
        q_nope, q_rope, ckv, k_rope = self._latents(x, positions)
        view = {"ckv": gather_pages(cache["ckv"], bt, length),
                "krope": gather_pages(cache["krope"], bt, length)}
        block = {"ckv": ckv.to(view["ckv"].dtype),
                 "krope": k_rope.to(view["krope"].dtype)}
        q_abs = self._absorb(q_nope, x.dtype)

        def attend(i, view, mask):
            return self._latent_attend(
                q_abs[:, i:i + 1].contiguous(),
                q_rope[:, i:i + 1].contiguous(), view["ckv"].to(x.dtype),
                view["krope"].to(x.dtype), mask)
        o_latent = _verify_overlays(view, block, positions, None, attend)
        return self._up(o_latent, x), block

    def commit_paged(self, cache, block, pos, bt, n_commit, active, length,
                     sel=None):
        """Commit the first ``n_commit[b]`` verified latents (see
        :meth:`GQAAttention.commit_paged`)."""
        if sel is None:
            sel = commit_select(n_commit, active, block["ckv"].shape[1])
        return _commit(cache, block, pos, bt, sel, length, None)
