"""Speculative decoding: the minGRU drafter (port of ``repro.serve.spec``).

An O(1)-state stack (minGRU or Mamba; no KV cache, no positions) proposes
K-1 greedy tokens per wave for every active slot, and the attention
target scores all K in one ``DecoderStepModel.verify`` call.

:class:`DraftStepModel` keeps, per engine slot, the K stacked carries the
last propose wave produced: carry ``m`` is the drafter's state AFTER
consuming the wave's ``m``-th fed token.  When the verifier accepts
``n_emit`` tokens the engine selects carry ``n_emit - 1`` as the next
wave's resume point (``sel``): acceptance bookkeeping is an index, never a
recompute.

Alignment invariant: between waves, ``store[slot, sel]`` is the drafter
state after consuming the stream through position ``pos - 1``, where
``pos``/``cur`` are the slot's position and its last emitted (uncached)
token.  A wave feeds ``cur, d_1, .., d_{K-1}``, so the state after feed
``m`` belongs to stream position ``pos + m``, and every accepted prefix is
the true stream.

``propose`` is an eager loop of K greedy ``decode_step`` calls over the
slot batch.  Admission installs the drafter's own chunked-prefill carry
tiled K-wide (``sel = 0``); preemption and fork snapshot, restore and
copy single slot rows.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ATTN, ATTN_LOCAL, MLA
from repro_torch.serve.protocol import (DecoderStepModel, _scatter_slots,
                                        masked_update)
from repro_torch.serve.telemetry import NULL_TELEMETRY


def _tree_map(fn, tree, *rest):
    """``fn`` over the tensors of a cache (a tensor, or a list/dict of
    them), the other trees aligned leaf for leaf."""
    if isinstance(tree, (list, tuple)):
        return [_tree_map(fn, *leaves) for leaves in zip(tree, *rest)]
    if isinstance(tree, dict):
        return {k: _tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)


class DraftStepModel:
    """K-token greedy draft proposer over a pure O(1)-state DecoderLM.

    ``store`` layout: the drafter's native decode cache with a K axis of
    stacked carries inserted after the slot axis — a minGRU stack's
    (n_layers, slots, K, d), a Mamba stack's per-layer (slots, K, ...).
    """

    def __init__(self, model, *, spec_k: int, prefill_chunk: int = 256):
        kinds = {s.kind for s in model.cfg.layer_specs()}
        if kinds & {ATTN, ATTN_LOCAL, MLA}:
            raise ValueError(
                f"drafter {model.cfg.name} carries attention layers "
                f"({sorted(kinds)}): a draft model must be a pure "
                "O(1)-state stack — its whole point is constant per-token "
                "state with no KV traffic")
        if int(spec_k) < 1:
            raise ValueError(f"spec_k must be >= 1, got {spec_k}")
        self.model = model
        self.k = int(spec_k)
        self.vocab = model.cfg.vocab
        # the serving prefill machinery through a dense, position-free
        # adapter: admission prompts prefill like any O(1) stack
        self.sm = DecoderStepModel(model, max_len=1,
                                   prefill_chunk=prefill_chunk)
        self._ax = self.sm._slot_axis
        self.telemetry = NULL_TELEMETRY

    @property
    def device(self):
        return self.model.device

    # -- store -------------------------------------------------------------
    def init_store(self, slots: int):
        """Zero store: (slots, K) stacked carries per decode-cache leaf."""
        ax = self._ax
        with torch.inference_mode():
            return _tree_map(
                lambda c: c.unsqueeze(ax + 1).repeat_interleave(
                    self.k, ax + 1).contiguous(),
                self.model.init_cache(int(slots), 1))

    # -- propose (the per-wave hot path) -----------------------------------
    def propose(self, store, sel, tok, active):
        """Roll K greedy drafter steps per slot from its selected carry.
        ``sel``: (slots,) — which stacked carry is the resume point;
        ``tok``: (slots,) current tokens.  Returns (toks (slots, K) int64
        on the device with ``toks[:, 0] == tok``, new store).  Inactive
        slots keep their carries; their drafts are ignored."""
        ax, dev = self._ax, self.device
        with torch.inference_mode():
            sel = torch.as_tensor(np.asarray(sel), dtype=torch.int64,
                                  device=dev)
            tok0 = torch.as_tensor(np.asarray(tok), dtype=torch.int64,
                                   device=dev)
            act = torch.as_tensor(np.asarray(active), device=dev)
            slots = torch.arange(sel.shape[0], device=dev)

            def take(s):
                return s[slots, sel] if ax == 0 else s[:, slots, sel]
            cache = _tree_map(take, store)
            t, drafts, states = tok0, [], []
            for _ in range(self.k):
                logits, cache = self.model.decode_step(t[:, None], cache, 0)
                t = torch.argmax(logits[:, -1, :self.vocab], -1)
                drafts.append(t)
                states.append(cache)
            # the K-th draft is rolled only for its carry (a fully
            # accepted wave resumes from it)
            toks = torch.stack([tok0] + drafts[:self.k - 1], 1)
            stacked = _tree_map(lambda *cs: torch.stack(cs, ax + 1),
                                *states)
            return toks, masked_update(store, stacked, act, axis=ax)

    # -- admission ---------------------------------------------------------
    def prefill(self, xs):
        """Consume an admission wave's prompts; returns the native carry
        (the TARGET draws the first token; the drafter only tracks
        state)."""
        _last, carry = self.sm.prefill(xs)
        return carry

    def install(self, store, carry, slots):
        """Scatter a wave's prefill carry into its slots, tiled across the
        K axis, in place; padding entries (>= capacity) are dropped."""
        ax = self._ax
        slots = np.asarray(slots)
        with torch.inference_mode():
            tiled = _tree_map(
                lambda c: c.unsqueeze(ax + 1).expand(
                    *c.shape[:ax + 1], self.k, *c.shape[ax + 1:]), carry)
            return _scatter_slots(store, tiled, slots, ax)

    # -- preemption / fork (rare host-paced events) -------------------------
    def snapshot_slot(self, store, slot: int):
        """Host copy of one slot's K stacked carries."""
        with torch.inference_mode():
            out = _tree_map(lambda s: s.select(self._ax, int(slot)).to(
                "cpu", copy=True),
                            store)
        self.telemetry.instant("draft_snapshot", slot=int(slot))
        return out

    def restore_slot(self, store, snap, slot: int):
        """Install a host snapshot into ``slot``, in place (any slot:
        reads go through ``sel``)."""
        with torch.inference_mode():
            _tree_map(lambda s, v: s.select(self._ax, int(slot)).copy_(
                v.to(s.device)), store, snap)
        self.telemetry.instant("draft_restore", slot=int(slot))
        return store

    def copy_slot(self, store, src: int, dst: int):
        """Fork: duplicate ``src``'s stacked carries into ``dst``."""
        with torch.inference_mode():
            _tree_map(lambda s: s.select(self._ax, int(dst)).copy_(
                s.select(self._ax, int(src))), store)
        self.telemetry.instant("draft_copy", src=int(src), dst=int(dst))
        return store


def heterogeneous_k(requested, remaining, k_max: int):
    """Per-slot verify widths of one wave: the request's own ``spec_k``
    clamped to [1, k_max] and to the slot's remaining budget (a wave never
    commits K/V past ``pos + remaining``).  numpy in, numpy out."""
    return np.minimum(np.minimum(np.maximum(requested, 1), int(k_max)),
                      np.maximum(remaining, 1)).astype(np.int32)
