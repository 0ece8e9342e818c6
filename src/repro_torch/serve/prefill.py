"""Chunked prompt prefill (port of the grid-padded fast path of
``repro.serve.prefill``).

The prompt is padded up to a multiple of ``chunk`` and consumed as
equal-width chunks by ``DecoderLM.prefill``; the number of VALID tokens
of each chunk rides along as ``length``, so every layer masks the padding
out of its cache update.  Each minGRU layer runs ONE linear scan per
chunk.  The reference's scanned per-token fallback is not needed: every
ported layer kind has a chunk path.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def chunked_prefill(step_model, tokens, *, chunk=256, pos0=0):
    """Consume a whole prompt batch. tokens: (B, P) -> (last-valid-token
    logits (B, V_pad), cache carry with batch B) ready for decode."""
    model = step_model.model
    tokens = torch.as_tensor(tokens, dtype=torch.int64, device=model.device)
    B, P = tokens.shape
    chunk = max(1, int(chunk))
    cache = model.init_cache(B, step_model.max_len)
    if P % chunk:
        tokens = F.pad(tokens, (0, chunk - P % chunk))
    last = None
    for s in range(0, tokens.shape[1], chunk):
        valid = min(P - s, chunk)
        logits, cache = model.prefill(tokens[:, s:s + chunk], cache,
                                      pos0 + s, length=valid)
        last = logits[:, -1, :]
        step_model.n_prefill_chunks += 1
    return last, cache
