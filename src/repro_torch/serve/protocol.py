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
``copy_slot``) and the speculative ``verify``.

Mesh serving: ``bind_mesh(mesh, slots)`` commits an adapter to a
("data", "model") ``DeviceMesh`` — the parameters TP-shard over "model"
through the model's logical-axis rule tables (``parallel.spmd.bind``:
DTensor parameters, the modules computing on local shards with explicit
collectives), and every slot-leading array (the slot-batch state, the
per-call host arrays, an admission wave's prompts and carries) shards
dim 0 over "data" when it divides (``parallel.sharding.dim0_dp_spec``).
Each rank computes its rows and the results come back whole, so the
engine on every rank sees the same tokens and takes the same decisions.
Page pools are pages x TP-sharded KV heads, whole on every data rank:
a decode step's new K/V rows are gathered over "data" and written on
each, and page copies run on each.  See :class:`ServeShardings`.

  * :class:`DecoderStepModel` — a ``DecoderLM`` of minGRU, GQA, MLA or
    Mamba layers with dense or MoE MLPs, with a dense or (attention-
    bearing stacks, hybrid Mamba/attention ones included) a paged KV
    layout (see the class).
  * :class:`MinimalistStepModel` — the paper's ``MinimalistNetwork``
    streaming frames, optionally through the fused CUDA step kernel on
    exported 2 b codes.
"""
from __future__ import annotations

import contextlib
import dataclasses
import warnings
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.common import pow2ceil
from repro_torch.configs.base import ATTN, ATTN_LOCAL, MLA
from repro_torch.kernels.minimalist_block import ops as mb_ops
from repro_torch.kernels.paged_attention import quant as kvq
from repro_torch.kernels.paged_attention.ref import (gather_dequant,
                                                     gather_pages)
from repro_torch.parallel import sharding as shd
from repro_torch.parallel import spmd
from repro_torch.serve.paged import PagedConfig
from repro_torch.serve.prefill import chunked_prefill
from repro_torch.serve.sampling import (greedy_arrays, knobs_to_device,
                                        sample_tokens, verify_tokens)


def _data_keys(pool):
    """A layer pool's data leaves (GQA ``k``/``v``, MLA ``ckv``/``krope``),
    without their int8 ``*_scale`` siblings."""
    return [k for k in pool if not k.endswith("_scale")]


@dataclasses.dataclass(frozen=True)
class ServeShardings:
    """Every placement the serving engine uses, for one (mesh, model,
    slot count), as PartitionSpec trees: ``params`` (the model's
    parameters, by its logical axes), ``state`` (the slot-batch state of
    ``init_state(slots)``, by the serve cache rules), ``slot`` ((slots,)
    arrays: DP over "data" when it divides) and ``replicated``."""

    mesh: Any
    params: Any
    state: Any
    slot: Any
    replicated: Any


@dataclasses.dataclass
class _StepView:
    """The whole slot batch of a DP-sharded decode step, for the layers
    that write the data-replicated page pools (``Spmd.step``)."""

    n: int          # slots
    bt: Any         # (slots, max_pages) int32 block tables
    pos: Any        # (slots,) positions
    rows: Any       # indices of every active slot


def _local_slots(slots, rows: slice):
    """Global slot ids -> this rank's row indices; other ranks' slots map
    past the end (dropped like wave padding)."""
    slots = np.asarray(slots, np.int64)
    mine = (slots >= rows.start) & (slots < rows.stop)
    return np.where(mine, slots - rows.start, np.iinfo(np.int64).max)


def _gather_tree(s, tree, n, axis=0):
    """Every leaf of a tree of this rank's rows (dim ``axis``) made whole."""
    if isinstance(tree, (list, tuple)):
        return [_gather_tree(s, t, n, axis) for t in tree]
    if isinstance(tree, dict):
        return {k: _gather_tree(s, v, n, axis) for k, v in tree.items()}
    if axis == 0:
        return s.gather_rows(tree, n)
    return s.gather_rows(tree.movedim(axis, 0).contiguous(),
                         n).movedim(0, axis)


class StepModel:
    """Contract only; see module docstring."""

    #: LM generation (emitted tokens feed back) vs frame streaming.
    autoregressive: bool = True

    #: bound by :meth:`bind_mesh`; None = single-device serving.
    mesh = None
    sharding: Optional[ServeShardings] = None
    spmd = None

    def put_slot(self, a):
        """This rank's rows of a host slot-leading array (dim 0 over
        "data" when it divides; the whole array when unbound)."""
        a = np.asarray(a)
        if self.spmd is None or a.ndim == 0:
            return a
        return a[self.spmd.rows(a.shape[0])]

    def _put_knobs(self, knobs):
        """This rank's rows of a dict of per-slot sampling knobs."""
        return {k: self.put_slot(v) for k, v in knobs.items()}

    def _slot_owner(self, slot, n):
        """(data rank, local row) holding slot ``slot`` of ``n``."""
        s = self.spmd
        if s is None or not s.dp_sharded(n):
            return (s.dp_rank if s is not None else 0), int(slot)
        k = n // s.dp
        return int(slot) // k, int(slot) % k

    def _slot_rows(self, n):
        return self.spmd.rows(n) if self.spmd is not None else slice(0, n)

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

    # -- mesh placement ----------------------------------------------------
    def state_axes(self):
        """Logical axes of :meth:`init_state`'s layout: the model's native
        cache layout (its batch axis is the slot axis), or page pools
        ("pages", "page", kv heads, ...) with the O(1) carries of a hybrid
        stack under the paged layout."""
        if self.kv_layout == "paged":
            return self.model.paged_cache_axes()
        return self.model.cache_axes()

    def _state_sharding(self, mesh, batch):
        """Serve cache specs of ``init_state(batch)``, from the whole
        state's shapes (outside ``local_view`` a bound model reads its
        parameters' global shapes)."""
        shapes = self._state(int(batch), int(batch))
        return shd.serve_cache_specs(self.state_axes(), shapes, mesh)

    def shardings(self, mesh, slots, rules=None) -> ServeShardings:
        """The placements this model's serve arrays take on ``mesh`` with
        a ``slots``-wide slot batch (computed, not bound)."""
        from repro_torch.common.pytree import module_tree

        return ServeShardings(
            mesh=mesh,
            params=shd.param_specs(self.model, module_tree(self.model),
                                   mesh, rules),
            state=self._state_sharding(mesh, slots),
            slot=shd.dim0_dp_spec((int(slots),), mesh), replicated=shd.P())

    def put_params(self, mesh, rules=None):
        """Place the model's parameters on ``mesh`` (in place: DTensor
        parameters, ``parallel.spmd.bind``); returns their tree."""
        from repro_torch.common.pytree import module_tree

        b = spmd.binding(self.model)
        if b is None:
            spmd.bind(self.model, mesh, rules)
        elif b.spmd.mesh is not mesh:
            raise ValueError("the model is bound to another mesh")
        return module_tree(self.model)

    def bind_mesh(self, mesh, slots, rules=None) -> ServeShardings:
        """Commit this StepModel to ``mesh`` for a ``slots``-wide engine:
        place the parameters, then shard every slot-leading array over
        "data" from here on (one mesh per StepModel; the model's
        parameters are placed in place, so a no-mesh run needs a model of
        its own)."""
        slots = int(slots)
        if self.mesh is mesh and self._bound_slots == slots:
            return self.sharding
        if self.mesh is not None:
            raise ValueError("this StepModel is bound to another mesh "
                             "(or slot count)")
        sharding = self.shardings(mesh, slots, rules)
        self.put_params(mesh, rules)
        self.mesh, self._bound_slots = mesh, slots
        self.spmd = spmd.binding(self.model).spmd
        self.sharding = sharding
        self._greedy = {}
        return sharding

    def place_cache(self, cache):
        """This rank's rows of a whole native-layout wave cache (dim 0
        over "data" when it divides)."""
        if self.spmd is None:
            return cache
        if isinstance(cache, (list, tuple)):
            return [self.place_cache(c) for c in cache]
        if isinstance(cache, dict):
            return {k: self.place_cache(v) for k, v in cache.items()}
        return cache[self.spmd.rows(cache.shape[0])]

    def _n_rows(self, n):
        r = self._slot_rows(int(n))
        return r.stop - r.start

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
        O(1)-state layers are copied from ``src`` to ``dst`` (across
        "data" ranks: sent by the rank holding ``src``)."""
        with torch.inference_mode():
            for j, sub in enumerate(state):
                if j not in self._pool:
                    for leaf in sub.values():
                        row = self._read_row(leaf, src)
                        self._write_row(leaf, dst, row)
        return state

    def _read_row(self, leaf, slot):
        """Row ``slot`` of a per-slot leaf, on every rank (sent over
        "data" by the rank that holds it)."""
        n = self._bound_slots if self.spmd is not None else leaf.shape[0]
        owner, i = self._slot_owner(slot, n)
        if self.spmd is None or not self.spmd.dp_sharded(n):
            return leaf[i].clone()
        row = leaf[i].clone() if owner == self.spmd.dp_rank \
            else leaf.new_empty(leaf.shape[1:])
        return self.spmd.broadcast_row(row, owner)

    def _write_row(self, leaf, slot, row):
        """Row ``slot`` of a per-slot leaf := ``row`` (on its rank)."""
        n = self._bound_slots if self.spmd is not None else leaf.shape[0]
        owner, i = self._slot_owner(slot, n)
        if self.spmd is None or owner == self.spmd.dp_rank:
            leaf[i] = row.to(leaf.device, leaf.dtype)

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
            return [{k: (v[pg] if j in self._pool
                         else self._read_row(v, slot)).to("cpu", copy=True)
                     for k, v in sub.items()}
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
                        self._write_row(v, slot, saved[k])
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
        """Zero state of a ``batch``-slot engine; on a mesh this rank's
        rows of it (the pools keep every page: they are whole on every
        "data" rank)."""
        with spmd.local_view(self.model):
            return self._state(batch, self._n_rows(batch))

    def _state(self, batch, rows):
        """Zero state of a ``batch``-slot engine with ``rows`` slot rows."""
        if self.kv_layout == "paged":
            return self.model.init_paged_cache(self.num_pages(batch),
                                               self.paged.page_size,
                                               batch=rows)
        return self.model.init_cache(rows, self.max_len)

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
        takes the plain argmax.  The logits are whole over the vocab
        (a vocab-sharded head gathers them), so draws hash global vocab
        indices."""
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
        state).  On a mesh each rank steps its slots and the tokens come
        back whole."""
        n = int(np.shape(tok)[0])
        if sampling is None:
            if n not in self._greedy:
                self._greedy[n] = greedy_arrays(n)
            sampling = self._greedy[n]
        s = self.spmd
        if s is None:
            return self._step(tok, state, pos, active, sampling, bt)
        if self.kv_layout == "paged" and s.dp_sharded(n) and bt is not None:
            dev = self.device
            s.step = _StepView(
                n, torch.as_tensor(np.asarray(bt), dtype=torch.int32,
                                   device=dev),
                torch.as_tensor(np.asarray(pos), dtype=torch.int32,
                                device=dev),
                torch.as_tensor(np.flatnonzero(np.asarray(active)),
                                dtype=torch.int64, device=dev))
        try:
            # inference mode first: the view then swaps in the shards'
            # aliases, with no autograd node a parameter
            with torch.inference_mode(), spmd.local_view(self.model), \
                    s.data_rows(s.dp_sharded(n)):
                out, state = self._step(
                    self.put_slot(tok), state, self.put_slot(pos),
                    self.put_slot(active), self._put_knobs(sampling),
                    None if bt is None else self.put_slot(bt))
        finally:
            s.step = None
        with torch.inference_mode():
            return s.gather_rows(out, n), state

    def _step(self, tok, state, pos, active, sampling, bt):
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
        # on a mesh each rank scores its slots; the accepted K/V of every
        # slot are then committed into the whole pools on each rank
        sp, r = self.spmd, self._slot_rows(n)
        dev = self.device
        with torch.inference_mode():
            with spmd.local_view(self.model), (
                    sp.data_rows(sp.dp_sharded(n)) if sp is not None
                    else contextlib.nullcontext()):
                emitted, n_emit, blocks = self._score(
                    toks[r], state, self.put_slot(pos),
                    self.put_slot(active), self.put_slot(k_slot),
                    self._put_knobs(sampling), self.put_slot(bt))
            if sp is not None:
                emitted = sp.gather_rows(emitted, n)
                n_emit = sp.gather_rows(n_emit, n)
                blocks = _gather_tree(sp, blocks, n)
            state = self.model.commit_step_paged(
                state, blocks,
                torch.as_tensor(np.asarray(pos), dtype=torch.int32,
                                device=dev),
                torch.as_tensor(np.asarray(bt), dtype=torch.int32,
                                device=dev), n_emit,
                torch.as_tensor(np.asarray(active), device=dev),
                self.max_len)
            return emitted.cpu().numpy(), n_emit.cpu().numpy(), state

    def _score(self, toks, state, pos, active, k_slot, sampling, bt):
        """The verify's read half on this rank's slots: (emitted, n_emit,
        blocks) as device tensors."""
        dev = self.device
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
        return emitted, n_emit, blocks

    def sample(self, logits, sampling, pos):
        """Draw one token per row of ``logits`` (admission-wave shape; on
        a mesh this rank's rows of the wave, the tokens returned whole)."""
        with torch.inference_mode():
            s, n = self.spmd, int(np.shape(pos)[0])
            if s is None:
                return self._sample(logits, sampling, pos)
            out = self._sample(logits, self._put_knobs(sampling),
                               self.put_slot(pos))
            return s.gather_rows(out, n)

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
        s = self.spmd
        if s is not None:
            # the wave's rows come whole (they shard like any slot-leading
            # array), then each rank keeps those of its own slots
            n = len(slots)
            with torch.inference_mode():
                if self.kv_layout != "paged":
                    batch_state = _gather_tree(s, batch_state, n,
                                               self._slot_axis)
                else:
                    batch_state = _gather_tree(s, batch_state, n)
            slots = _local_slots(slots, s.rows(self._bound_slots))
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

    # -- mesh placement ----------------------------------------------------
    # Frame streaming serves DP-only: slots (and their O(1) states) shard
    # over "data"; the paper-scale analog blocks are far too small to pay
    # TP collectives, so the parameters replicate.
    def shardings(self, mesh, slots, rules=None) -> ServeShardings:
        del rules
        from repro_torch.common.pytree import module_tree

        params = module_tree(self.net)
        rep = {k: {n: shd.P(*([None] * p.dim())) for n, p in v.items()}
               for k, v in params.items()}
        return ServeShardings(
            mesh=mesh, params=rep,
            state=shd.slot_specs(self.net.initial_state(int(slots)), mesh),
            slot=shd.dim0_dp_spec((int(slots),), mesh), replicated=shd.P())

    def bind_mesh(self, mesh, slots, rules=None) -> ServeShardings:
        """DP-only binding: rank 0's parameters on every rank (replicated),
        slot states sharded over "data"."""
        from torch.distributed.tensor import Replicate, distribute_tensor

        slots = int(slots)
        if self.mesh is mesh and self._bound_slots == slots:
            return self.sharding
        if self.mesh is not None:
            raise ValueError("this StepModel is bound to another mesh")
        self.sharding = self.shardings(mesh, slots, rules)
        rep = [Replicate()] * mesh.ndim
        with torch.no_grad():
            for p in self.net.parameters():
                p.copy_(distribute_tensor(p.detach(), mesh, rep).to_local())
        self.mesh, self._bound_slots = mesh, slots
        self.spmd = spmd.Spmd(mesh)
        if self.spmd.tp > 1:
            raise ValueError("frame streaming serves DP-only: use a mesh "
                             "with model=1")
        return self.sharding

    def init_state(self, batch):
        """Zero per-block states; on a mesh this rank's rows."""
        r = self._slot_rows(int(batch))
        return self.net.initial_state(r.stop - r.start)

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
        n = int(np.shape(x)[0])
        with torch.inference_mode():
            x = torch.as_tensor(self.put_slot(x), dtype=torch.float32,
                                device=dev)
            act = torch.as_tensor(self.put_slot(active), device=dev)
            out, new_state = self._raw_step(x, state)
            if self.spmd is not None:
                out = self.spmd.gather_rows(out, n)
            return out, masked_update(state, new_state, act)

    def write_slots(self, state, batch_state, slots):
        """In place, per block state; padding entries are dropped.  On a
        mesh the wave's rows come whole and each rank keeps its slots'."""
        slots = np.asarray(slots)
        with torch.inference_mode():
            if self.spmd is not None:
                batch_state = _gather_tree(self.spmd, batch_state,
                                           len(slots))
                slots = _local_slots(slots, self.spmd.rows(
                    self._bound_slots))
            return [_scatter_slots(s, v, slots, 0)
                    for s, v in zip(state, batch_state)]
