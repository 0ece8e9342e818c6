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


def request_uniforms(seed, uid, uid_hi, pos, vocab: int):
    """Uniforms in (0, 1), shape (B, vocab): entry [b, v] hashes
    (seed[b], uid[b], uid_hi[b], pos[b], v).  Inputs are (B,) int64
    tensors on the target device."""
    key = _mix32(seed ^ 0x243F6A88)
    key = _mix32(key ^ uid)
    key = _mix32(key ^ uid_hi)
    key = _mix32(key ^ pos)
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
