"""Chunked prompt prefill (port of the grid-padded fast path of
``repro.serve.prefill``).

The prompt is padded up to a multiple of ``chunk`` and consumed as
equal-width chunks by ``DecoderLM.prefill``; the number of VALID tokens
of each chunk rides along as ``length``, so every layer masks the padding
out of its cache update.  Each minGRU layer runs ONE linear scan per
chunk.  The reference's scanned per-token fallback is not needed: every
ported layer kind has a chunk path.

``cache0``/``start`` resume a prefix-cache attach: the cache seeded from
the shared pages holds the first ``start`` positions (or more), and only
the chunks from ``start`` on are computed — with the same chunk widths
and boundaries, so every computed chunk is the program a from-scratch
prefill of the same prompt would run.

On a mesh (a step model bound by ``bind_mesh``) the wave's rows shard
over "data" when their count divides it: each rank prefills its rows on
its local shards, and the logits and carry it returns are those rows'.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.parallel import spmd


def chunked_prefill(step_model, tokens, *, chunk=256, pos0=0, cache0=None,
                    start=0):
    """Consume a whole prompt batch. tokens: (B, P) -> (last-valid-token
    logits (B, V_pad), cache carry with batch B) ready for decode.
    ``cache0``/``start``: tail prefill from a seeded cache (``start`` on
    the chunk grid)."""
    model = step_model.model
    tokens = torch.as_tensor(tokens, dtype=torch.int64, device=model.device)
    s = getattr(step_model, "spmd", None)
    if s is None:
        return _prefill(step_model, model, tokens, chunk, pos0, cache0,
                        start)
    sharded = s.dp_sharded(tokens.shape[0])
    tokens = tokens[s.rows(tokens.shape[0])]
    with spmd.local_view(model), s.data_rows(sharded):
        return _prefill(step_model, model, tokens, chunk, pos0, cache0,
                        start)


def _prefill(step_model, model, tokens, chunk, pos0, cache0, start):
    B, P = tokens.shape
    chunk = max(1, int(chunk))
    start = int(start)
    if start % chunk:
        raise ValueError(f"tail prefill start={start} must sit on the "
                         f"chunk grid (chunk={chunk})")
    if not 0 <= start < P:
        raise ValueError(f"start={start} outside prompt of {P} tokens")
    if cache0 is not None:
        cache = cache0
    elif start:
        raise ValueError("start > 0 needs a seeded cache0")
    else:
        cache = model.init_cache(B, step_model.max_len)
    if P % chunk:
        tokens = F.pad(tokens, (0, chunk - P % chunk))
    last = None
    for s in range(start, tokens.shape[1], chunk):
        valid = min(P - s, chunk)
        logits, cache = model.prefill(tokens[:, s:s + chunk], cache,
                                      pos0 + s, length=valid)
        last = logits[:, -1, :]
        step_model.n_prefill_chunks += 1
    return last, cache
