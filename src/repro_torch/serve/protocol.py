"""The StepModel protocol: what the serving engine requires of a model
(port of ``repro.serve.protocol``: single device, dense and paged KV
layouts).

A StepModel reduces a model to a few operations over a slot-batched
recurrent state:

  * ``init_state(batch)``                 — blank per-slot state
  * ``prefill(xs, pos0=0)``               — consume an admission wave's
                                            prompts (LMs)
  * ``step(x, state, pos, active, sampling=None)``
                                          — one slot-batch decode step;
                                            inactive slots stay frozen
  * ``write_slots(state, batch_state, slots)``
                                          — install a wave's carry
                                            (paged layout: also its
                                            page rows and prompt length)

The port's modules own their parameters, so no ``params`` argument
travels through these calls.  Paged decoder stacks also offer the
preemption and fork operations (``snapshot_slot``, ``restore_slot``,
``copy_slot``) and the speculative ``verify``.  The mesh part of the
reference is not ported yet.

  * :class:`DecoderStepModel` — a ``DecoderLM`` of minGRU, GQA, MLA or
    Mamba layers with dense or MoE MLPs, with a dense or (attention-
    bearing stacks, hybrid Mamba/attention ones included) a paged KV
    layout (see the class).
  * :class:`MinimalistStepModel` — the paper's ``MinimalistNetwork``
    streaming frames, optionally through the fused CUDA step kernel on
    exported 2 b codes.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

from repro_torch.common import pow2ceil
from repro_torch.configs.base import ATTN, ATTN_LOCAL, MLA
from repro_torch.kernels.minimalist_block import ops as mb_ops
from repro_torch.kernels.paged_attention import quant as kvq
from repro_torch.kernels.paged_attention.ref import (gather_dequant,
                                                     gather_pages)
from repro_torch.serve.paged import PagedConfig
from repro_torch.serve.prefill import chunked_prefill
from repro_torch.serve.sampling import (greedy_arrays, knobs_to_device,
                                        sample_tokens, verify_tokens)


def _data_keys(pool):
    """A layer pool's data leaves (GQA ``k``/``v``, MLA ``ckv``/``krope``),
    without their int8 ``*_scale`` siblings."""
    return [k for k in pool if not k.endswith("_scale")]


class StepModel:
    """Contract only; see module docstring."""

    #: LM generation (emitted tokens feed back) vs frame streaming.
    autoregressive: bool = True

    def init_state(self, batch):
        raise NotImplementedError

    def step(self, x, state, pos, active, sampling=None):
        raise NotImplementedError

    def write_slots(self, state, batch_state, slots):
        raise NotImplementedError


def _axis_mask(active, leaf, axis=0):
    """Broadcast (slots,) bool over a leaf whose slot dim sits at ``axis``."""
    shape = [1] * leaf.dim()
    shape[axis] = active.shape[0]
    return active.reshape(shape)


def masked_update(state, new_state, active, axis=0):
    """Freeze inactive slots: new value where active, old where not.
    ``state`` is a tensor, or a list or dict of them (slot axis at
    ``axis``)."""
    if isinstance(state, (list, tuple)):
        return [masked_update(o, n, active, axis)
                for o, n in zip(state, new_state)]
    if isinstance(state, dict):
        return {k: masked_update(state[k], new_state[k], active, axis)
                for k in state}
    return torch.where(_axis_mask(active, new_state, axis), new_state, state)


def _scatter_slots(s, v, slots, axis):
    """In place: s[..slots..] = v along ``axis`` (tensors, or lists/dicts
    of them); entries of ``slots`` >= capacity are admission-wave padding
    and are dropped (the reference's out-of-bounds scatter semantics)."""
    if isinstance(s, (list, tuple)):
        return [_scatter_slots(a, b, slots, axis) for a, b in zip(s, v)]
    if isinstance(s, dict):
        return {k: _scatter_slots(s[k], v[k], slots, axis) for k in s}
    keep = slots < s.shape[axis]
    idx = torch.as_tensor(slots[keep], dtype=torch.int64, device=s.device)
    sel = torch.as_tensor(np.flatnonzero(keep), dtype=torch.int64,
                          device=s.device)
    s.index_copy_(axis, idx, v.index_select(axis, sel).to(s.dtype))
    return s


class DecoderStepModel(StepModel):
    """StepModel over a ``DecoderLM``; state = the per-layer decode caches
    (``DecoderLM``'s layouts).

    ``kv_layout`` selects where attention caches live:

      * "dense" (default) — every slot owns (max_len, ...) cache rows;
        positional stacks decode in one batched step with per-slot
        positions (the reference vmaps a scalar-position step instead).
      * "paged" — attention caches are shared page pools read through
        per-slot block tables (``serve.paged``); admission prefill still
        computes the dense wave cache and ``write_slots`` scatters it
        PAGE-granularly, and the engine allocates pages as positions cross
        page boundaries.  ``ModelConfig.paged_impl="kernel"`` (default)
        reads through the paged GQA or MLA decode kernels; ``"gather"``
        keeps the decode math bitwise identical to the dense layout.  With
        ``kv_dtype="int8"`` pools hold symmetric per-page codes plus
        float32 ``*_scale`` leaves: ``write_slots`` quantizes page rows on
        install and the decode write requantizes incrementally.  The
        install and attach code is generic over each layer's leaves (GQA
        ``k``/``v``, MLA ``ckv``/``krope``) and their ``*_scale``
        siblings.  In a hybrid stack (jamba) only the attention layers
        are paged: each O(1)-state (Mamba) layer keeps its per-slot carry
        leaves, which the decode step merges under ``active``, a fork
        copies, and a preemption snapshot carries beside the pages.

    Pool leaves are updated IN PLACE (the engine's own buffers).
    ``moe_dispatch`` is None for a dense stack, else the config's MoE
    dispatch ("auto" routes prefill per request and decode by gather-GEMM,
    so streams do not depend on co-batched traffic; "pooled" warns).
    """

    autoregressive = True

    def __init__(self, model, *, max_len: int = 256,
                 prefill_chunk: int = 256, kv_layout: str = "dense",
                 paged=None):
        self.model = model
        self.max_len = int(max_len)
        self.prefill_chunk = int(prefill_chunk)
        self.vocab = model.cfg.vocab
        kinds = {s.kind for s in model.cfg.layer_specs()}
        # position-free stacks: every mixer carries O(1) state
        self.positional = bool(kinds & {ATTN, ATTN_LOCAL, MLA})
        if kv_layout not in ("dense", "paged"):
            raise ValueError(f"kv_layout must be 'dense' or 'paged', "
                             f"got {kv_layout!r}")
        self.kv_layout = kv_layout
        self.paged = None
        self._pool = frozenset()
        if kv_layout == "paged":
            if not self.positional:
                raise ValueError(
                    f"{model.cfg.name}: kv_layout='paged' needs an "
                    "attention stack (or a hybrid one) — pure O(1)-state "
                    "stacks have no KV cache to page (serve them dense)")
            # stack positions whose cache is a page pool; the others (Mamba
            # layers of a hybrid stack) keep per-slot carries
            self._pool = frozenset(model.paged_layer_names())
            # the longest in-cache span any layer keeps: global layers
            # span max_len; a pure sliding-window stack is bounded by its
            # ring, so its page chains never exceed the window
            if ATTN in kinds or MLA in kinds:
                self._page_cap = self.max_len
            else:
                self._page_cap = min(model.cfg.sliding_window, self.max_len)
            self.paged = paged if paged is not None else PagedConfig()
            self.max_pages = self.pages_for(self.max_len)
            self.paged.validate_for(self.max_len, self.max_pages)
            # copy-on-write metadata: the in-chain pages a decode write at
            # position p touches — page p//ps for global layers, page
            # (p % L)//ps of each window ring of length L
            ring, has_global = set(), False
            for j in sorted(self._pool):
                L = model.layers[j].mixer.ring_length(self.max_len)
                if L < self.max_len:
                    ring.add(int(L))
                else:
                    has_global = True
            self._ring_lens = sorted(ring)
            self._has_global = has_global
            self._has_window = bool(ring)
        self.n_prefill_chunks = 0      # chunks prefilled, for kernel audits
        self._greedy = {}
        self.moe_dispatch = (model.cfg.moe.dispatch
                             if any(s.moe for s in model.cfg.layer_specs())
                             else None)
        if self.moe_dispatch == "pooled":
            warnings.warn(
                f"{model.cfg.name}: dispatch='pooled' pools every token of "
                "a call into one capacity-limited dispatch — serving "
                "outputs will vary with concurrent traffic and prefill "
                "chunking (use 'auto' or 'per_request' for batch-invariant "
                "routing)", stacklevel=2)

    @property
    def device(self):
        return self.model.device

    @property
    def _slot_axis(self):
        """Slot axis of the dense state's leaves: 1 in a pure minGRU
        stack's stacked (n_layers, slots, d) tensor, else 0."""
        return 1 if self.model.stacked_cache else 0

    # -- paged layout ----------------------------------------------------
    def pages_for(self, n: int) -> int:
        """Pages a request needs once it spans ``n`` positions."""
        ps = self.paged.page_size
        return -(-min(int(n), self._page_cap) // ps)

    def num_pages(self, slots: int) -> int:
        """Resolved pool capacity (0 in the config = dense-equivalent)."""
        return self.paged.resolve_num_pages(slots, self.max_pages)

    def write_page_indices(self, pos: int):
        """In-chain page indices a decode write at ``pos`` touches (the
        engine copies-on-write those that are shared)."""
        ps = self.paged.page_size
        out = set()
        if self._has_global:
            out.add(int(pos) // ps)
        for L in self._ring_lens:
            out.add((int(pos) % L) // ps)
        return sorted(out)

    def check_prefix_cacheable(self):
        """Prefix caching rebuilds a request's WHOLE decode state from
        pages — reject stacks where that is impossible."""
        if self.kv_layout != "paged":
            raise ValueError("prefix caching needs kv_layout='paged'")
        o1 = sorted(set(range(len(self.model.layers))) - self._pool)
        if o1:
            raise ValueError(
                f"prefix caching needs an all-attention stack: layers "
                f"{o1} carry O(1) mixer state that does not live in "
                "pages, so an attached request could not reconstruct it")
        if self._page_cap < self.max_len:
            raise ValueError(
                "prefix caching needs page chains spanning max_len; a "
                f"pure sliding-window stack caps them at the ring "
                f"({self._page_cap} positions) and overwrites prompt "
                "pages in place")
        return True

    def copy_pages(self, state, src, dst):
        """Copy-on-write device copies, in place: page ``src[i]`` ->
        ``dst[i]`` in every pool leaf (codes and scales alike)."""
        dev = self.device
        src = torch.as_tensor(np.asarray(src), dtype=torch.int64, device=dev)
        dst = torch.as_tensor(np.asarray(dst), dtype=torch.int64, device=dev)
        with torch.inference_mode():
            for j in self._pool:
                for leaf in state[j].values():
                    leaf[dst] = leaf[src]
        return state

    # -- preemption and fork ---------------------------------------------
    # What a slot owns: its page chain in every pool (the engine's block
    # table names it) and, in a hybrid stack, its row of every per-slot
    # carry leaf of the O(1)-state layers.
    def copy_slot(self, state, src: int, dst: int):
        """Fork, in place: the child shares the parent's page chain
        through the block tables; the per-slot carry rows of the
        O(1)-state layers are copied from ``src`` to ``dst``."""
        with torch.inference_mode():
            for j, sub in enumerate(state):
                if j not in self._pool:
                    for leaf in sub.values():
                        leaf[int(dst)] = leaf[int(src)]
        return state

    def snapshot_slot(self, state, slot, pages):
        """Host copy of what slot ``slot`` owns: the rows ``pages`` (its
        chain's physical ids) of every pool leaf — int8 codes AND their
        scales — and row ``slot`` of every per-slot carry leaf."""
        if self.kv_layout != "paged":
            raise ValueError("preemption snapshots need kv_layout='paged' "
                             "(page swap is what makes them cheap)")
        pg = torch.as_tensor(np.asarray(pages), dtype=torch.int64,
                             device=self.device)
        with torch.inference_mode():
            # copy=True: on a CPU state a carry row would otherwise be a
            # view that the slot's next occupant overwrites
            return [{k: (v[pg] if j in self._pool else v[int(slot)]).to(
                        "cpu", copy=True) for k, v in sub.items()}
                    for j, sub in enumerate(state)]

    def restore_slot(self, state, snap, slot, pages):
        """Inverse of :meth:`snapshot_slot`, in place, under a FRESH page
        chain ``pages`` and into slot ``slot``: reads go through the block
        table, so the resumed stream sees identical bytes at identical
        positions, and the carries are the snapshot's, not the slot's last
        occupant's."""
        if self.kv_layout != "paged":
            raise ValueError("preemption restores need kv_layout='paged'")
        pg = torch.as_tensor(np.asarray(pages), dtype=torch.int64,
                             device=self.device)
        with torch.inference_mode():
            for j, (sub, saved) in enumerate(zip(state, snap)):
                for k, v in sub.items():
                    if j in self._pool:
                        v[pg] = saved[k].to(self.device)
                    else:
                        v[int(slot)] = saved[k].to(self.device)
        return state

    def seed_cache(self, state, bt_row):
        """Prefix attach: the dense (B=1) prefill cache that ``bt_row``'s
        page chain holds, ready to resume ``prefill(cache0=...,
        start=...)``.  Int8 pools give the dequantized view.  Entries past
        the chain gather page 0 — every read of them is position-masked or
        overwritten by the tail prefill."""
        bt = torch.as_tensor(np.asarray(bt_row), dtype=torch.int32,
                             device=self.device)
        out = []
        with torch.inference_mode():
            for layer, sub in zip(self.model.layers, state):
                Lv = layer.mixer.ring_length(self.max_len)
                out.append({
                    k: gather_dequant(sub[k], sub[k + "_scale"], bt, Lv,
                                      torch.bfloat16)
                    if k + "_scale" in sub
                    else gather_pages(sub[k], bt, Lv).to(torch.bfloat16)
                    for k in _data_keys(sub)})
        return out

    # -- state ------------------------------------------------------------
    def init_state(self, batch):
        if self.kv_layout == "paged":
            return self.model.init_paged_cache(self.num_pages(batch),
                                               self.paged.page_size,
                                               batch=batch)
        return self.model.init_cache(batch, self.max_len)

    def chunk_for(self, plen: int) -> int:
        """Chunk width of a ``plen``-token prompt: ``prefill_chunk`` capped
        at the next power of two of the prompt (padding waste < 2x).  Part
        of the prefix-cache key: attaching is bitwise only between
        requests sharing one chunk grid."""
        return min(self.prefill_chunk, pow2ceil(int(plen)))

    def prefill(self, xs, pos0=0, cache0=None, start=0):
        """xs: (B, P) int prompts -> (last logits (B, V_pad), carry).
        ``cache0``/``start``: prefix-attach tail prefill from a seeded
        cache (:meth:`seed_cache`), from chunk-aligned ``start`` on."""
        with torch.inference_mode():
            return chunked_prefill(self, xs, chunk=self.chunk_for(
                np.shape(xs)[1]), pos0=pos0, cache0=cache0, start=start)

    def _sample(self, logits, samp, pos):
        """Per-row counter-keyed sampling over the REAL vocab; an
        all-greedy batch (decided on the host, where the knobs live)
        takes the plain argmax."""
        lg = logits[..., :self.vocab].float()
        if not (np.asarray(samp["temperature"]) > 0).any():
            return torch.argmax(lg, dim=-1).to(torch.int32)
        dev = knobs_to_device(samp, lg.device)
        pos = torch.as_tensor(np.asarray(pos, np.int64), device=lg.device)
        return sample_tokens(lg, dev["seed"], dev["uid"], dev["uid_hi"], pos,
                             dev["temperature"], dev["top_k"], dev["top_p"])

    def step(self, tok, state, pos, active, sampling=None, bt=None):
        """tok: (slots,) int; pos, active: (slots,) host arrays; sampling:
        dict of per-slot host knob arrays (None -> all greedy); bt:
        (slots, max_pages) int32 block tables (paged layout only).
        Returns (next token per slot (slots,) int32 on the device, merged
        state)."""
        n = int(np.shape(tok)[0])
        if sampling is None:
            if n not in self._greedy:
                self._greedy[n] = greedy_arrays(n)
            sampling = self._greedy[n]
        dev = self.device
        active = np.asarray(active)
        with torch.inference_mode():
            tok_t = torch.as_tensor(np.asarray(tok), dtype=torch.int64,
                                    device=dev)
            act = torch.as_tensor(active, device=dev)
            pos_t = torch.as_tensor(np.asarray(pos), dtype=torch.int32,
                                    device=dev)
            if self.kv_layout == "paged":
                if bt is None:
                    raise ValueError("paged kv_layout needs block tables "
                                     "(the engine passes pool.block_tables)")
                bt_t = torch.as_tensor(np.asarray(bt), dtype=torch.int32,
                                       device=dev)
                rows = torch.as_tensor(np.flatnonzero(active),
                                       dtype=torch.int64, device=dev)
                # the pools are written in place for the active slots only;
                # per-slot carries (hybrid stacks) take the masked merge
                logits, new_state = self.model.decode_step_paged(
                    tok_t[:, None], state, pos_t, bt_t, act, self.max_len,
                    rows=rows)
                merged = [new if j in self._pool
                          else masked_update(old, new, act)
                          for j, (old, new) in enumerate(zip(state,
                                                             new_state))]
            else:
                logits, new_state = self.model.decode_step(
                    tok_t[:, None], state, pos_t)
                merged = masked_update(state, new_state, act,
                                       axis=self._slot_axis)
            # the token produced from input position p lands at p + 1
            out = self._sample(logits[:, -1, :], sampling,
                               np.asarray(pos, np.int64) + 1)
        return out, merged

    def verify(self, toks, state, pos, active, k_slot, sampling=None,
               bt=None):
        """k-token speculative verify.  ``toks``: (slots, K) — per slot
        the current token (emitted, not yet in the cache) and K-1 greedy
        drafts, fed at positions ``pos .. pos+K-1``; ``k_slot``: (slots,)
        verify widths 1..K.  Scores the K tokens through the gather read,
        runs the verifier on the real-vocab fp32 logits, then commits the
        accepted prefix's K/V.  Returns (emitted (slots, K) and n_emit
        (slots,) as host arrays, state): ``emitted[b, :n_emit[b]]`` are
        the tokens of positions ``pos[b]+1 ..``; inactive slots emit 0."""
        if self.kv_layout != "paged":
            raise ValueError("speculative verify needs kv_layout='paged' "
                             "(rollback = uncommitted pages)")
        if bt is None:
            raise ValueError("paged verify needs block tables "
                             "(the engine passes pool.block_tables)")
        n = int(np.shape(toks)[0])
        if sampling is None:
            sampling = greedy_arrays(n)
        dev = self.device
        with torch.inference_mode():
            # the drafter's proposals may already sit on the device
            toks_t = toks.to(dev, torch.int64) if torch.is_tensor(toks) \
                else torch.as_tensor(np.asarray(toks), dtype=torch.int64,
                                     device=dev)
            pos_t = torch.as_tensor(np.asarray(pos), dtype=torch.int32,
                                    device=dev)
            act = torch.as_tensor(np.asarray(active), device=dev)
            bt_t = torch.as_tensor(np.asarray(bt), dtype=torch.int32,
                                   device=dev)
            logits, blocks = self.model.verify_step_paged(
                toks_t, state, pos_t, bt_t, act, self.max_len)
            knobs = knobs_to_device(sampling, dev)
            emitted, n_emit = verify_tokens(
                logits[..., :self.vocab].float(), toks_t,
                torch.as_tensor(np.asarray(k_slot), device=dev),
                knobs["seed"], knobs["uid"], knobs["uid_hi"], pos_t,
                knobs["temperature"], knobs["top_k"], knobs["top_p"],
                greedy_only=not (np.asarray(sampling["temperature"])
                                 > 0).any())
            n_emit = torch.where(act, n_emit, torch.zeros_like(n_emit))
            state = self.model.commit_step_paged(
                state, blocks, pos_t, bt_t, n_emit, act, self.max_len)
            return emitted.cpu().numpy(), n_emit.cpu().numpy(), state

    def sample(self, logits, sampling, pos):
        """Draw one token per row of ``logits`` (admission-wave shape)."""
        with torch.inference_mode():
            return self._sample(logits, sampling, pos)

    def emit(self, logits):
        """Greedy over the REAL vocab (debugging helper)."""
        return torch.argmax(logits[..., :self.vocab], dim=-1).to(torch.int32)

    def _write_pages(self, pool, batch_state, rows, pages, plen):
        """Install one attention layer's dense wave cache page-granularly,
        in place: each real wave row's first ceil(min(plen, L)/ps) pages
        of every (length L) cache leaf — K/V (B, L, KV, hd) or MLA latents
        (B, L, r) — land at its chain's page ids; int8 pools quantize each
        page row on install (absmax scale per page and feature row: per
        kv head, or one per latent page) and store codes and scales."""
        ps = self.paged.page_size
        for key in _data_keys(pool):
            v = batch_state[key]
            Lv = v.shape[1]
            n = -(-min(plen, Lv) // ps)
            take = min(n * ps, Lv)
            v2 = v[rows, :take]
            if take < n * ps:               # ring shorter than whole pages
                v2 = torch.nn.functional.pad(
                    v2, (0, 0) * (v2.dim() - 2) + (0, n * ps - take))
            v2 = v2.reshape(v2.shape[0], n, ps, *v2.shape[2:])
            pg = pages[:, :n]
            if key + "_scale" in pool:
                sc = kvq.page_abs_scale(v2, page_axis=2)
                pool[key][pg] = kvq.quantize(v2, sc, page_axis=2)
                pool[key + "_scale"][pg] = sc
            else:
                pool[key][pg] = v2.to(pool[key].dtype)

    def write_slots(self, state, batch_state, slots, pages=None,
                    plen=None):
        """Install a wave's carry (batch axis aligned with ``slots``) into
        the slot batch, IN PLACE (the state is the engine's own buffer).
        Padding entries (>= capacity) are dropped.  Paged layout:
        ``pages`` = the wave's block-table rows (padding rows all out of
        bounds) and ``plen`` = the wave's prompt length."""
        slots = np.asarray(slots)
        with torch.inference_mode():
            if self.kv_layout != "paged":
                return _scatter_slots(state, batch_state, slots,
                                      self._slot_axis)
            if pages is None or plen is None:
                raise ValueError("paged write_slots needs the wave's page "
                                 "rows and its prompt length")
            # padding rows of the wave hold out-of-bounds page ids
            pages = np.asarray(pages)
            n_pool = next(iter(state[min(self._pool)].values())).shape[0]
            real = np.flatnonzero(pages[:, 0] < n_pool)
            dev = self.device
            rows = torch.as_tensor(real, dtype=torch.int64, device=dev)
            pg = torch.as_tensor(pages[real], dtype=torch.int64, device=dev)
            for j, (sub, wave) in enumerate(zip(state, batch_state)):
                if j in self._pool:
                    self._write_pages(sub, wave, rows, pg, int(plen))
                else:                      # a hybrid stack's carries
                    _scatter_slots(sub, wave, slots, 0)
            return state


class MinimalistStepModel(StepModel):
    """Frame-streaming StepModel over ``core.mingru.MinimalistNetwork``.

    ``use_fused_kernel=True`` serves the exported hardware model through
    the fused single-step kernel (kernels.minimalist_block): the 2 b-code
    export is cached and redone whenever a block's parameters change
    (tracked by their tensor versions), so a reload never serves stale
    weights.
    """

    autoregressive = False

    def __init__(self, net, *, use_fused_kernel=False):
        self.net = net
        self.use_fused_kernel = use_fused_kernel
        self._exported = None
        self._export_key = None

    @property
    def device(self):
        return self.net.block0.wh.device

    def _export(self):
        key = tuple((p.data_ptr(), p._version)
                    for p in self.net.parameters())
        if self._exported is None or self._export_key != key:
            self._exported = [mb_ops.from_block_params(b)
                              for b in self.net.blocks]
            self._export_key = key
        return self._exported

    def init_state(self, batch):
        return self.net.initial_state(batch)

    def _raw_step(self, x, state):
        if self.use_fused_kernel:
            exported = self._export()
            out, new_states = x, []
            for i, exp in enumerate(exported):
                y, h = mb_ops.minimalist_step_kernel(out, *exp, state[i])
                new_states.append(h)
                # readout layer: the analog h is the result (no comparator)
                out = h if i == len(exported) - 1 else y
            return out, new_states
        return self.net.step(x, state)

    def step(self, x, state, pos, active, sampling=None):
        """x: (slots, d_in) frames; pos unused (position-free); sampling
        ignored — frame streaming emits analog outputs, not tokens."""
        del pos, sampling
        dev = self.device
        with torch.inference_mode():
            x = torch.as_tensor(np.asarray(x), dtype=torch.float32,
                                device=dev)
            act = torch.as_tensor(np.asarray(active), device=dev)
            out, new_state = self._raw_step(x, state)
            return out, masked_update(state, new_state, act)

    def write_slots(self, state, batch_state, slots):
        """In place, per block state; padding entries are dropped."""
        slots = np.asarray(slots)
        with torch.inference_mode():
            return [_scatter_slots(s, v, slots, 0)
                    for s, v in zip(state, batch_state)]
