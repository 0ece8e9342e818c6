"""Per-request stochastic decoding (port of ``repro.serve.sampling``).

Counter-based randomness: the uniform behind vocab entry v of the token
at absolute position ``pos`` of request ``uid`` is a pure hash of
``(seed, uid_lo, uid_hi, pos, v)``, computed on the device for the whole
slot batch at once.  A request's draws therefore depend only on its own
``(seed, uid)`` and the position being generated — never on co-batched
traffic or admission grouping.  jax's threefry has no counterpart in
PyTorch, so sampled streams differ from the reference's by design; the
filters and the greedy path are the reference's.

Filter semantics (the reference's):

  * ``temperature <= 0`` — greedy argmax (the stochastic path is bypassed).
  * ``top_k > 0``        — keep logits >= the k-th largest (ties kept).
  * ``top_p < 1``        — keep the MINIMAL nucleus (mass accumulated
    BEFORE a token still < top_p); ``top_p >= 1`` disables.

The draw is Gumbel-max: argmax(filtered logits − log(−log u)), which
samples the softmax of the filtered logits exactly.
"""
from __future__ import annotations

import numpy as np
import torch

_M32 = 0xFFFFFFFF


def _mix32(x):
    """32-bit avalanche mixer on int64 tensors holding uint32 values.
    Both multipliers are odd and below 2**31, so every product stays
    below 2**63 (no signed overflow in int64)."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x5BD1E995) & _M32
    return x ^ (x >> 16)


def request_uniforms(seed, uid, uid_hi, pos, vocab: int, salt: int = 0):
    """Uniforms in (0, 1), shape (B, vocab): entry [b, v] hashes
    (seed[b], uid[b], uid_hi[b], pos[b], v).  Inputs are (B,) int64
    tensors on the target device.  A nonzero ``salt`` selects a separate
    stream (the speculative verifier's accept and residual draws); salt 0
    is the plain sequential draw."""
    key = _mix32(seed ^ 0x243F6A88)
    key = _mix32(key ^ uid)
    key = _mix32(key ^ uid_hi)
    key = _mix32(key ^ pos)
    if salt:
        key = _mix32(key ^ int(salt))
    idx = torch.arange(vocab, dtype=torch.int64, device=key.device)
    bits = _mix32(_mix32(key[:, None] ^ idx[None, :]) ^ 0x85EBCA6B)
    # top 24 bits -> float32 exactly; +0.5 keeps u off both endpoints
    return ((bits >> 8).to(torch.float32) + 0.5) * (2.0 ** -24)


def filter_logits(logits, temperature, top_k, top_p):
    """temperature -> top-k -> top-p on fp32 logits (B, V): returns the
    SCALED logits with every filtered token at -inf (the reference's
    ``_filter_row``, batched)."""
    V = logits.shape[-1]
    scaled = logits / torch.clamp(temperature, min=1e-6)[:, None]
    kth_idx = (torch.clamp(top_k, 1, V) - 1)[:, None]
    kth = torch.sort(scaled, dim=-1, descending=True).values.gather(1,
                                                                    kth_idx)
    use_k = ((top_k > 0) & (top_k < V))[:, None]
    scaled = torch.where(use_k & (scaled < kth),
                         torch.full_like(scaled, -torch.inf), scaled)
    probs = torch.softmax(scaled, dim=-1)
    sp, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    mass_before = torch.cumsum(sp, dim=-1) - sp
    keep_sorted = (mass_before < torch.clamp(top_p, 1e-6, 1.0)[:, None]) \
        | (top_p >= 1.0)[:, None]
    keep = torch.zeros_like(keep_sorted).scatter(1, order, keep_sorted)
    return torch.where(keep, scaled, torch.full_like(scaled, -torch.inf))


def sample_tokens(logits, seed, uid, uid_hi, pos, temperature, top_k,
                  top_p):
    """One token per row of fp32 logits (B, V) over the REAL vocab; every
    knob is a (B,) tensor on the logits' device.  Greedy rows
    (temperature <= 0) take the plain argmax."""
    greedy = torch.argmax(logits, dim=-1)
    scaled = filter_logits(logits, temperature, top_k, top_p)
    u = request_uniforms(seed, uid, uid_hi, pos, logits.shape[-1])
    drawn = torch.argmax(scaled - torch.log(-torch.log(u)), dim=-1)
    return torch.where(temperature <= 0.0, greedy, drawn).to(torch.int32)


# ---------------------------------------------------------------------------
# Speculative decoding: rejection/residual sampling (see serve/spec.py)
# ---------------------------------------------------------------------------

#: Salts of the verifier's accept-uniform and residual draws: streams
#: independent of each other and of the plain draw at the same position.
ACCEPT_SALT = 0x5A11
RESID_SALT = 0x5A12


def _gumbel_draw(logits, seed, uid, uid_hi, pos, salt=0):
    """Gumbel-max draw of one token per row of (B, V) logits from the
    counter hash's ``salt`` stream at positions ``pos`` (B,)."""
    u = request_uniforms(seed, uid, uid_hi, pos, logits.shape[-1], salt)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def rejection_sample_row(p_logits, q_logits, draft_tok, seed, uid, uid_hi,
                         pos):
    """One general-q rejection/residual step: accept ``draft_tok`` with
    probability min(1, p/q), else draw from the normalized residual
    (p - q)+.  The composite marginal is exactly p for any proposal q.
    ``p_logits``/``q_logits``: (V,) tensors; the counter knobs are ints.
    Returns (token, accepted) as 0-d tensors.  The engine's verifier uses
    the one-hot-q case (the drafter proposes greedily); this general form
    is what the sampling tests pin."""
    dev = p_logits.device
    p = torch.softmax(p_logits.float(), -1)
    q = torch.softmax(q_logits.float(), -1)
    knob = [torch.tensor([int(v)], dtype=torch.int64, device=dev)
            for v in (seed, uid, uid_hi, pos)]
    u = request_uniforms(*knob, 1, ACCEPT_SALT)[0, 0]
    ratio = p[draft_tok] / torch.clamp(q[draft_tok], min=1e-30)
    accepted = u < torch.clamp(ratio, max=1.0)
    resid = torch.clamp(p - q, min=0.0)
    resid_logits = torch.where(resid > 0, torch.log(resid),
                               torch.full_like(resid, -torch.inf))
    # p == q gives an empty residual, but then ratio == 1 and the accept
    # branch always wins
    r = _gumbel_draw(resid_logits[None], *knob, RESID_SALT)[0]
    tok = torch.where(accepted, torch.as_tensor(int(draft_tok), device=dev),
                      r)
    return tok.to(torch.int32), accepted


def verify_tokens(logits, toks, k_slot, seed, uid, uid_hi, pos,
                  temperature, top_k, top_p, greedy_only=False):
    """Batched k-token verification (``sampling._verify_row`` over the
    slot axis).  ``logits``: (B, K, V) fp32 target logits over the REAL
    vocab for the fed tokens ``toks`` (B, K) = [current, d_1, .., d_{K-1}]
    at positions ``pos .. pos+K-1`` — row j decides stream position
    ``pos+1+j``; ``k_slot`` (B,) is each slot's verify width (1..K); the
    knobs are (B,) tensors.

    The drafter proposes greedily (one-hot q): a draft is accepted with
    probability p(draft) after the sequential sampler's filters, and a
    rejection draws from p with the draft removed.  Greedy rows accept a
    draft iff it equals the fp32 argmax, so a greedy spec stream is
    bitwise the sequential one.  Every draw is counter-keyed by the
    position it decides.  ``greedy_only`` (every row greedy, known on
    the host) skips the stochastic pipeline.  Returns ``(emitted (B, K)
    int32, n_emit (B,) int32)``: ``emitted[b, :n_emit[b]]`` are the
    accepted drafts plus one correction (or, on full acceptance, the
    plain sequential draw)."""
    B, K, V = logits.shape
    dev = logits.device
    lg = logits.float()
    idx = torch.arange(K, device=dev)
    toks = toks.long()
    drafts = torch.cat([toks[:, 1:], toks[:, :1]], dim=1)       # (B, K)
    valid = idx[None, :] < (k_slot.long()[:, None] - 1)
    flat = lg.reshape(B * K, V)
    greedy = torch.argmax(flat, -1).reshape(B, K)
    if greedy_only:
        a = torch.cumprod(((drafts == greedy) & valid).to(torch.int32),
                          dim=1).sum(1)
        emitted = torch.where(idx[None, :] < a[:, None], drafts, greedy)
        return emitted.to(torch.int32), (a + 1).to(torch.int32)
    positions = (pos.long()[:, None] + 1 + idx[None, :]).reshape(-1)

    def rep(t):                        # (B,) -> (B*K,) per-row knobs
        return t.repeat_interleave(K)
    filtered = filter_logits(flat, rep(temperature), rep(top_k),
                             rep(top_p))
    probs = torch.softmax(filtered, -1)
    keys = (rep(seed), rep(uid), rep(uid_hi), positions)
    u = request_uniforms(*keys, 1, ACCEPT_SALT)[:, 0].reshape(B, K)
    p_draft = probs.gather(1, drafts.reshape(-1, 1))[:, 0].reshape(B, K)
    is_greedy = (temperature <= 0.0)[:, None]
    accept = torch.where(is_greedy, drafts == greedy, u < p_draft)
    a = torch.cumprod((accept & valid).to(torch.int32), dim=1).sum(1)
    n_emit = a + 1
    resid = filtered.masked_fill(
        torch.arange(V, device=dev)[None, :] == drafts.reshape(-1, 1),
        -torch.inf)
    r = _gumbel_draw(resid, *keys, RESID_SALT).reshape(B, K)
    b = _gumbel_draw(filtered, *keys).reshape(B, K)
    full = (n_emit == k_slot.long())[:, None]
    fix = torch.where(is_greedy, greedy, torch.where(full, b, r))
    emitted = torch.where(idx[None, :] < a[:, None], drafts, fix)
    return emitted.to(torch.int32), n_emit.to(torch.int32)


#: The per-slot knob schema (host-side numpy dtypes; the reference's
#: ``KNOB_DTYPES``).
KNOB_DTYPES = {
    "seed": np.uint32,
    "uid": np.uint32,        # low 32 bits of the request uid
    "uid_hi": np.uint32,     # bits 32..63
    "temperature": np.float32,
    "top_k": np.int32,
    "top_p": np.float32,
}

#: Knob values that reproduce greedy argmax.
KNOB_GREEDY = {"seed": 0, "uid": 0, "uid_hi": 0, "temperature": 0.0,
               "top_k": 0, "top_p": 1.0}


def greedy_arrays(n):
    """Per-slot knobs that reproduce greedy argmax (host numpy arrays)."""
    return {k: np.full((n,), KNOB_GREEDY[k], KNOB_DTYPES[k])
            for k in KNOB_DTYPES}


def knobs_to_device(knobs, device):
    """Host knob arrays -> device tensors (the uint32 words as int64, so
    the hash's arithmetic has headroom)."""
    out = {}
    for k, v in knobs.items():
        v = np.asarray(v)
        if v.dtype == np.uint32:
            v = v.astype(np.int64)
        out[k] = torch.as_tensor(v, device=device)
    return out
