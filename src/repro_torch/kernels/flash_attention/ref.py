"""Plain PyTorch attention (port of ``repro.kernels.flash_attention.ref``)
and the plain versions of the two flash-attention CUDA kernels.

  * :func:`mha_ref` — the reference's naive oracle, op for op: scores in
    q's dtype, promoted to fp32 for the additive ``-1e30`` mask and the
    softmax, weights back in q's dtype;
  * :func:`flash_attention_ref` — what ``csrc/flash_fwd.cu`` computes
    (the TPU kernel ``flash_fwd``'s numerics): fp32 products of the
    inputs, the same additive mask, an fp32 softmax, out in q's dtype,
    plus the row logsumexp ``lse = m + log(max(l, 1e-30))``;
  * :func:`flash_attention_bwd_ref` — what ``csrc/flash_bwd.cu`` computes
    (``flash_bwd`` and the group sum of its custom VJP): p recomputed as
    exp(s − lse), delta = rowsum(out ⊙ do) from the saved ``out``, dq, and
    dk/dv summed over each kv head's group of query heads.

Layouts are the reference's: q (B, H, S, D), k and v (B, KV, S, D) with
H % KV == 0 (query head h reads kv head h // (H / KV)).  Any strides.
These materialise the (B, H, S, S) scores: on the CPU they are the port's
flash path, on the card only the tests and chip_smoke call them.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def _neg_inf(device):
    return torch.full((), NEG_INF, dtype=torch.float32, device=device)


def _scale(D, device):
    """1/sqrt(D) as the reference rounds it: a double, once to fp32.  A
    0-dim tensor made by a fill (no host copy, so a CUDA graph can
    capture it)."""
    return torch.full((), 1.0 / math.sqrt(D), dtype=torch.float32,
                      device=device)


def attend_mask(S, causal, window, device):
    """(S, S) bool: query i may attend key j (causal: j <= i; window:
    i − j < window)."""
    idx = torch.arange(S, device=device)
    ok = torch.ones(S, S, dtype=torch.bool, device=device)
    if causal:
        ok &= idx[:, None] >= idx[None, :]
    if window is not None:
        ok &= (idx[:, None] - idx[None, :]) < window
    return ok


def _expand(t, group):
    return t if group == 1 else t.repeat_interleave(group, dim=1)


def mha_ref(q, k, v, causal=True, window=None):
    """q, k, v: (B, H, S, D) (kv heads already expanded) -> (B, H, S, D)
    in q's dtype (``ref.mha_ref``)."""
    S = q.shape[2]
    logits = torch.einsum("bhsd,bhtd->bhst", q, k).float() * _scale(
        q.shape[-1], q.device)
    ok = attend_mask(S, causal, window, q.device)
    logits = torch.where(ok, logits, _neg_inf(q.device))
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bhst,bhtd->bhsd", w.to(q.dtype), v)


def _scores(q, k, causal, window, acc=torch.float32):
    """q·kᵀ · scale in ``acc`` with the additive mask; k expanded to H
    heads."""
    S, D = q.shape[2], q.shape[3]
    s = torch.einsum("bhsd,bhtd->bhst", q.to(acc),
                     _expand(k, q.shape[1] // k.shape[1]).to(acc))
    s = s * _scale(D, q.device)
    ok = attend_mask(S, causal, window, q.device)
    return s + torch.where(ok, torch.zeros((), device=q.device),
                           _neg_inf(q.device))


def flash_attention_ref(q, k, v, causal=True, window=None):
    """q: (B, H, S, D); k, v: (B, KV, S, D) -> (out (B, H, S, D) in q's
    dtype, lse (B, H, S) fp32)."""
    s = _scores(q, k, causal, window)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp(min=1e-30)
    vx = _expand(v, q.shape[1] // v.shape[1]).float()
    out = torch.einsum("bhst,bhtd->bhsd", p, vx) / l
    lse = (m + torch.log(l))[..., 0]
    return out.to(q.dtype), lse


def _group_sum(t, KV):
    B, H, S, D = t.shape
    return t.reshape(B, KV, H // KV, S, D).sum(2)


def flash_attention_bwd_ref(q, k, v, out, lse, do, causal=True,
                            window=None, acc=torch.float32):
    """Cotangents (dq, dk, dv) of :func:`flash_attention_ref` given its
    saved ``out`` and ``lse`` and the output cotangent ``do``; dq in q's
    dtype, dk/dv summed over the GQA group in k's/v's dtype.  The sums
    are taken in ``acc``: fp32 is what the kernels compute; fp64 makes
    them exact enough that a kernel's own rounding can be held to a bound
    (over thousands of rows two fp32 orders part by up to about 1e-7 of
    the terms' summed magnitude)."""
    KV, D = k.shape[1], q.shape[3]
    G = q.shape[1] // KV
    p = torch.exp(_scores(q, k, causal, window, acc)
                  - lse[..., None].to(acc))
    do32 = do.to(acc)
    delta = (out.to(acc) * do32).sum(-1)
    dv = torch.einsum("bhst,bhsd->bhtd", p, do32)
    dp = torch.einsum("bhsd,bhtd->bhst", do32, _expand(v, G).to(acc))
    ds = p * (dp - delta[..., None]) * _scale(D, q.device)
    dq = torch.einsum("bhst,bhtd->bhsd", ds, _expand(k, G).to(acc))
    dk = torch.einsum("bhst,bhsd->bhtd", ds, q.to(acc))
    return (dq.to(q.dtype), _group_sum(dk, KV).to(k.dtype),
            _group_sum(dv, KV).to(v.dtype))
