"""The StepModel protocol: what the serving engine requires of a model
(port of ``repro.serve.protocol``, dense single-device layout).

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

The port's modules own their parameters, so no ``params`` argument
travels through these calls.  The mesh, paged, verify, fork and
copy-on-write parts of the reference are not ported yet.

  * :class:`DecoderStepModel` — a ``DecoderLM`` of O(1)-state (minGRU)
    layers; state = the model's (n_layers, slots, d_model) cache.
  * :class:`MinimalistStepModel` — the paper's ``MinimalistNetwork``
    streaming frames, optionally through the fused CUDA step kernel on
    exported 2 b codes.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.common import pow2ceil
from repro_torch.configs.base import ATTN, ATTN_LOCAL, MLA
from repro_torch.kernels.minimalist_block import ops as mb_ops
from repro_torch.serve.prefill import chunked_prefill
from repro_torch.serve.sampling import (greedy_arrays, knobs_to_device,
                                        sample_tokens)


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
    ``state`` is a tensor or a list of tensors (slot axis at ``axis``)."""
    if isinstance(state, (list, tuple)):
        return [masked_update(o, n, active, axis)
                for o, n in zip(state, new_state)]
    return torch.where(_axis_mask(active, new_state, axis), new_state, state)


def _scatter_slots(s, v, slots, axis):
    """In place: s[..slots..] = v along ``axis``; entries of ``slots`` >=
    capacity are admission-wave padding and are dropped (the reference's
    out-of-bounds scatter semantics)."""
    keep = slots < s.shape[axis]
    idx = torch.as_tensor(slots[keep], dtype=torch.int64, device=s.device)
    sel = torch.as_tensor(np.flatnonzero(keep), dtype=torch.int64,
                          device=s.device)
    s.index_copy_(axis, idx, v.index_select(axis, sel).to(s.dtype))
    return s


class DecoderStepModel(StepModel):
    """StepModel over a ``DecoderLM`` of O(1)-state layers; state = the
    per-layer minGRU carries, (n_layers, slots, d_model) in bf16.  The
    decode step is one batched ``decode_step`` (the layers are
    position-free), and the slot axis of the state is 1."""

    autoregressive = True

    def __init__(self, model, *, max_len: int = 256,
                 prefill_chunk: int = 256):
        self.model = model
        self.max_len = int(max_len)
        self.prefill_chunk = int(prefill_chunk)
        self.vocab = model.cfg.vocab
        kinds = {s.kind for s in model.cfg.layer_specs()}
        self.positional = bool(kinds & {ATTN, ATTN_LOCAL, MLA})
        if self.positional:
            raise NotImplementedError(
                f"{model.cfg.name}: attention-bearing stacks are not ported "
                "yet (the port serves O(1)-state minGRU stacks)")
        self.n_prefill_chunks = 0      # chunks prefilled, for kernel audits
        self._greedy = {}

    @property
    def device(self):
        return self.model.device

    def init_state(self, batch):
        return self.model.init_cache(batch, self.max_len)

    def chunk_for(self, plen: int) -> int:
        """Chunk width of a ``plen``-token prompt: ``prefill_chunk`` capped
        at the next power of two of the prompt (padding waste < 2x)."""
        return min(self.prefill_chunk, pow2ceil(int(plen)))

    def prefill(self, xs, pos0=0):
        """xs: (B, P) int prompts -> (last logits (B, V_pad), carry)."""
        with torch.inference_mode():
            return chunked_prefill(self, xs, chunk=self.chunk_for(
                np.shape(xs)[1]), pos0=pos0)

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

    def step(self, tok, state, pos, active, sampling=None):
        """tok: (slots,) int; pos, active: (slots,) host arrays; sampling:
        dict of per-slot host knob arrays (None -> all greedy).  Returns
        (next token per slot (slots,) int32 on the device, merged state)."""
        n = int(np.shape(tok)[0])
        if sampling is None:
            if n not in self._greedy:
                self._greedy[n] = greedy_arrays(n)
            sampling = self._greedy[n]
        dev = self.device
        with torch.inference_mode():
            tok_t = torch.as_tensor(np.asarray(tok), dtype=torch.int64,
                                    device=dev)
            act = torch.as_tensor(np.asarray(active), device=dev)
            logits, new_state = self.model.decode_step(tok_t[:, None], state)
            merged = masked_update(state, new_state, act, axis=1)
            # the token produced from input position p lands at p + 1
            out = self._sample(logits[:, -1, :], sampling,
                               np.asarray(pos, np.int64) + 1)
        return out, merged

    def sample(self, logits, sampling, pos):
        """Draw one token per row of ``logits`` (admission-wave shape)."""
        with torch.inference_mode():
            return self._sample(logits, sampling, pos)

    def emit(self, logits):
        """Greedy over the REAL vocab (debugging helper)."""
        return torch.argmax(logits[..., :self.vocab], dim=-1).to(torch.int32)

    def write_slots(self, state, batch_state, slots):
        """Install a wave's carry (batch axis aligned with ``slots``) into
        the slot batch, IN PLACE (the state is the engine's own buffer).
        Padding entries (>= capacity) are dropped."""
        with torch.inference_mode():
            return _scatter_slots(state, batch_state, np.asarray(slots), 1)


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
