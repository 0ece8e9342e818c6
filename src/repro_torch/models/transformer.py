"""Decoder LM over minGRU, GQA, MLA and Mamba layers with dense or
mixture-of-experts MLPs (port of ``repro.models.transformer``).

The reference scans a stacked pattern unit with ``lax.scan``; here the
layers are written out as an ``nn.ModuleList`` (``layers[j]`` is stack
position j; :func:`repro_torch.bridge.load_jax_params` unstacks the
reference's layer axis onto it).  An MoE MLP takes the route of the call
(``models.moe``): "train" in ``forward``/``loss``, "prefill" in
``prefill``, "decode" in ``decode``, ``decode_paged`` and
``verify_paged``; its aux loss is dropped in the layer, as the
reference's, so ``loss`` stays the plain NLL.

Dtypes mirror the reference: fp32 parameters, bf16 compute
(``DecoderLM.compute_dtype``), fp32 RMSNorm internals, fp32 logits, and
a bf16 decode cache.  Cache layouts:

  * a minGRU stack keeps ONE tensor (n_layers, B, d_model) holding every
    layer's O(1) state — the layout of the reference's scanned-unit leaf
    ``{"unit0": {"h": (n_repeats, B, d_model)}}``;
  * an attention stack keeps a list with one ``{"k", "v"}`` entry per
    layer, (B, L, KV, hd) with L = max_len or a window layer's ring
    length; under the paged KV layout each entry is a shared page pool
    (P, page, KV, hd) (int8 pools add ``k_scale`` and ``v_scale`` (P, KV))
    with no slot axis, whose pages the serving engine hands out;
  * an MLA stack keeps one ``{"ckv": (B, L, kv_lora), "krope": (B, L,
    rope)}`` latent entry per layer; paged, the latents are page pools
    (P, page, kv_lora) and (P, page, rope) (int8 pools add ``ckv_scale``
    and ``krope_scale`` (P,), one scale per page);
  * a Mamba layer keeps one ``{"ssm": (B, d_inner, d_state),
    "conv": (B, d_conv - 1, d_inner)}`` carry; under the paged layout a
    hybrid stack (jamba: Mamba and attention) keeps these per-slot carries
    beside its attention layers' page pools.

Stacks that mix minGRU and attention layers are not ported yet.
"""
from __future__ import annotations

import contextlib

import torch
from torch import nn

from repro_torch.configs.base import (ATTN, ATTN_LOCAL, MAMBA, MINGRU, MLA,
                                      LayerSpec, ModelConfig)
from repro_torch.core.mingru import MinGRUBlock
from repro_torch.core.quant import QuantConfig
from repro_torch.models.attention import (GQAAttention, MLAAttention,
                                          commit_select)
from repro_torch.models.mamba import MambaBlock
from repro_torch.models.module import Embedding, RMSNorm
from repro_torch.models.moe import DenseMLP, MoEMLP
from repro_torch.parallel import spmd

_QUANT_MODES = {
    "float": QuantConfig.float_baseline,
    "quantized": QuantConfig.quantized,
    "hardware": QuantConfig.hardware,
}


class MinGRUMixer(nn.Module):
    """The paper's minGRU block as an LM time-mixing layer
    (``transformer.MinGRUMixer``): paper semantics inside the block, the
    standard pre-norm residual around it (in :class:`DecoderLayer`)."""

    def __init__(self, cfg: ModelConfig, *, dtype=torch.float32, device=None):
        super().__init__()
        self.cfg = cfg
        self.block = MinGRUBlock(cfg.d_model, cfg.d_model,
                                 qcfg=_QUANT_MODES[cfg.mingru_quant](),
                                 scan_backend=cfg.scan_backend, dtype=dtype,
                                 device=device)

    def reset_parameters(self, generator=None):
        self.block.reset_parameters(generator)

    def axes(self):
        return {"block": self.block.axes()}

    def cache_axes(self):
        return {"h": ("batch", "mlp")}

    def forward(self, x, positions=None):
        del positions
        out, _h = self.block(x)
        return out

    def decode(self, x, h, pos=None):
        """x: (B, 1, D); h: (B, D) -> (out (B, 1, D), new h); position-free."""
        del pos
        out, h = self.block.step(x[:, 0, :], h)
        return out[:, None, :], h

    def prefill(self, x, h, pos0=0, length=None):
        """Chunk prefill: ONE linear scan over the chunk, O(1) carry.
        ``length`` picks the carry at the last VALID token when the chunk
        tail is grid padding (the scan is causal: padding never reaches
        h[length-1])."""
        del pos0
        out, hs = self.block(x, h0=h.to(x.dtype))
        carry = hs[:, -1] if length is None else hs[:, length - 1]
        return out, carry.to(h.dtype)


def check_ported(spec: LayerSpec):
    """Raise for a layer kind the port cannot build."""
    if spec.kind not in (MINGRU, ATTN, ATTN_LOCAL, MLA, MAMBA):
        raise NotImplementedError(
            f"layer kind {spec.kind!r} is not ported yet: the port runs "
            "minGRU, GQA, MLA and Mamba layers")


class DecoderLayer(nn.Module):
    """pre-norm mixer + residual, then pre-norm MLP (dense or MoE) +
    residual (``transformer.DecoderLayer``); Mamba layers of a pure-SSM
    stack (falcon-mamba) have no MLP (d_ff = 0)."""

    def __init__(self, cfg: ModelConfig, spec: LayerSpec, *,
                 dtype=torch.float32, device=None):
        super().__init__()
        check_ported(spec)
        kw = dict(dtype=dtype, device=device)
        if spec.kind == MINGRU:
            self.mixer = MinGRUMixer(cfg, **kw)
        elif spec.kind == MAMBA:
            self.mixer = MambaBlock(cfg, **kw)
        elif spec.kind == MLA:
            self.mixer = MLAAttention(cfg, **kw)
        else:
            self.mixer = GQAAttention(cfg, local=spec.kind == ATTN_LOCAL,
                                      **kw)
        self.norm1 = RMSNorm(cfg.d_model, eps=cfg.norm_eps, **kw)
        d_ff = spec.d_ff or cfg.d_ff
        if spec.moe:
            if cfg.moe is None:
                raise ValueError(f"{cfg.name}: an moe=True layer needs "
                                 "ModelConfig.moe")
            self.mlp = MoEMLP(cfg.d_model, cfg.moe, **kw)
        else:
            self.mlp = DenseMLP(cfg.d_model, d_ff, **kw) if d_ff else None
        self.norm2 = RMSNorm(cfg.d_model, eps=cfg.norm_eps, **kw) \
            if self.mlp is not None else None

    def reset_parameters(self, generator=None):
        self.mixer.reset_parameters(generator)
        if self.mlp is not None:
            self.mlp.reset_parameters(generator)

    def axes(self):
        a = {"mixer": self.mixer.axes(), "norm1": self.norm1.axes()}
        if self.mlp is not None:
            a["mlp"] = self.mlp.axes()
            a["norm2"] = self.norm2.axes()
        return a

    def cache_axes(self):
        return self.mixer.cache_axes()

    def paged_cache_axes(self):
        if self.paged():
            return self.mixer.paged_cache_axes()
        return self.cache_axes()

    def _mlp_tail(self, x, route="train"):
        """Residual MLP tail; ``route`` picks an MoE MLP's dispatch path
        (pooled for training, per-request prefill, gather-GEMM decode
        under ``dispatch="auto"``) and its aux loss is dropped here."""
        if self.mlp is not None:
            h = self.norm2(x)
            if isinstance(self.mlp, MoEMLP):
                m, _aux = self.mlp(h, route=route)
            else:
                m = self.mlp(h)
            x = x + m
        return x

    def forward(self, x, positions=None):
        return self._mlp_tail(x + self.mixer(self.norm1(x), positions))

    def init_cache(self, batch, length, dtype=torch.bfloat16):
        return self.mixer.init_cache(batch, length, dtype)

    def decode(self, x, cache, pos=None):
        out, cache = self.mixer.decode(self.norm1(x), cache, pos)
        return self._mlp_tail(x + out, "decode"), cache

    def prefill(self, x, cache, pos0=0, length=None):
        out, cache = self.mixer.prefill(self.norm1(x), cache, pos0,
                                        length=length)
        return self._mlp_tail(x + out, "prefill"), cache

    def paged(self) -> bool:
        """True when this layer's cache lives in a shared page pool under
        the paged KV layout (attention mixers, GQA and MLA); O(1)-state
        mixers keep their per-slot state either way."""
        return isinstance(self.mixer, (GQAAttention, MLAAttention))

    def decode_paged(self, x, cache, pos, bt, active, length, rows=None):
        """Slot-batched decode: an attention layer reads and writes its
        page pool (the active slots' K/V, in place); an O(1)-state mixer
        takes its ordinary batched decode and returns every slot's new
        carry (the caller keeps the inactive slots' old ones)."""
        h = self.norm1(x)
        if self.paged():
            h, cache = self.mixer.decode_paged(h, cache, pos, bt, active,
                                               length, rows=rows)
        else:
            h, cache = self.mixer.decode(h, cache, pos)
        return self._mlp_tail(x + h, "decode"), cache

    def verify_paged(self, x, cache, pos, bt, active, length):
        """K speculative tokens x (B, K, D) through this attention layer
        without writing its pool: (y, the mixer's verify block).  An
        O(1)-state mixer's carry cannot be rolled back to an accepted
        prefix, so only attention layers verify."""
        if not self.paged():
            raise NotImplementedError(
                "speculative verify requires attention mixers; "
                f"{type(self.mixer).__name__} keeps O(1) state")
        h, block = self.mixer.verify_paged(self.norm1(x), cache, pos, bt,
                                           active, length)
        return self._mlp_tail(x + h, "decode"), block


def _rows_sharded(t) -> bool:
    """Whether ``t`` is a DTensor with its dim 0 sharded."""
    from torch.distributed.tensor import Shard
    return spmd.is_dtensor(t) and any(
        isinstance(pl, Shard) and pl.dim == 0 for pl in t.placements)


class DecoderLM(nn.Module):
    """Embedding + the layer stack + final norm + tied (or separate) head
    (``transformer.DecoderLM``: ``__call__``, ``loss``, ``prefill``,
    ``decode_step``, ``init_cache``)."""

    def __init__(self, cfg: ModelConfig, *, dtype=torch.float32, device=None,
                 generator=None):
        super().__init__()
        specs = cfg.layer_specs()
        for spec in specs:             # refuse before allocating anything
            check_ported(spec)
        kinds = {s.kind for s in specs}
        if MINGRU in kinds and len(kinds) > 1:
            raise NotImplementedError(
                f"{cfg.name}: stacks that mix minGRU and attention layers "
                "are not ported yet")
        self.cfg = cfg
        kw = dict(dtype=dtype, device=device)
        self.embed = Embedding(cfg.vocab_padded, cfg.d_model, **kw)
        self.layers = nn.ModuleList(DecoderLayer(cfg, s, **kw)
                                    for s in specs)
        self.final_norm = RMSNorm(cfg.d_model, eps=cfg.norm_eps, **kw)
        self.lm_head = None if cfg.tie_embeddings \
            else Embedding(cfg.vocab_padded, cfg.d_model, **kw)
        self.reset_parameters(generator)

    def reset_parameters(self, generator=None):
        """Seeded random init of every parameter (the reference's
        initializer families; see models.module)."""
        self.embed.reset_parameters(generator)
        if self.lm_head is not None:
            self.lm_head.reset_parameters(generator)
        for layer in self.layers:
            layer.reset_parameters(generator)

    def axes(self):
        """Logical axes keyed by the port's parameter names; the layers
        are a list, so the reference's stacked "layers" axis (which maps
        to None in every table) is dropped."""
        a = {"embed": self.embed.axes(),
             "layers": {str(j): l.axes() for j, l in enumerate(self.layers)},
             "final_norm": self.final_norm.axes()}
        if self.lm_head is not None:
            a["lm_head"] = self.lm_head.axes()
        return a

    def cache_axes(self):
        """Axes of :meth:`init_cache`'s layout: a minGRU stack's one
        (n_layers, B, d_model) tensor, else one entry a layer."""
        if self.stacked_cache:
            return ("layers", "batch", "mlp")
        return [l.cache_axes() for l in self.layers]

    def paged_cache_axes(self):
        """Axes of :meth:`init_paged_cache`'s layout: page pools
        ("pages", "page", kv heads or latents, ...) and, in a hybrid
        stack, the per-slot carries."""
        return [l.paged_cache_axes() for l in self.layers]

    @property
    def device(self):
        return self.embed.table.device

    @property
    def compute_dtype(self):
        dt = self.embed.table.dtype
        return torch.bfloat16 if dt == torch.float32 else dt

    def _head(self, x):
        head = self.embed if self.lm_head is None else self.lm_head
        return head.attend(self.final_norm(x))

    @property
    def stacked_cache(self) -> bool:
        """True for a minGRU stack: its decode cache is ONE (n_layers, B,
        d_model) tensor, else a list of per-layer attention caches."""
        return self.cfg.layer_specs()[0].kind == MINGRU

    def forward(self, tokens=None, positions=None, embeds=None):
        """tokens: (B, S) int, or embeds: (B, P, D) (the VLM's stubbed
        patch embeddings); both may be given, the embeds then prepended
        in the compute dtype (``DecoderLM.__call__``).  Returns logits
        (B, P + S, V_pad) fp32.  A model bound to a mesh
        (``parallel.spmd.bind``) runs on its local shards."""
        if spmd.binding(self) is not None and spmd.current() is None:
            with spmd.local_view(self):
                return self.forward(tokens, positions, embeds)
        parts = []
        if embeds is not None:
            parts.append(embeds.to(self.compute_dtype))
        if tokens is not None:
            parts.append(self.embed(tokens))
        x = torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]
        x = x.to(self.compute_dtype)
        for layer in self.layers:
            x = layer(x, positions)
        return self._head(x)

    def loss(self, batch):
        """batch: {"tokens": (B, S), "labels": (B, S), optional "embeds"
        (B, P, D)}; labels −1 are masked.  Mean next-token NLL over the
        unmasked labels, from fp32 logits; an embeds prefix gives no
        loss (``transformer.DecoderLM.loss``).  Returns (scalar loss,
        {"loss", "tokens"}).

        On a mesh (parameters placed by ``parallel.spmd.bind``, the batch
        by ``sharding.batch_specs`` as DTensors) each rank scores its own
        rows and the NLL sum and token count are summed over "data": the
        loss is the global batch's."""
        if spmd.binding(self) is not None and spmd.current() is None:
            with spmd.local_view(self):
                return self.loss(batch)
        s = spmd.current()
        if s is not None and s.dp > 1 and not _rows_sharded(batch["labels"]):
            raise ValueError("on a mesh with data > 1 the batch rows must "
                             "shard over 'data' (sharding.batch_specs; "
                             "the batch size must divide by it)")
        sharded = _rows_sharded(batch["labels"])
        batch = {k: spmd.local(v) for k, v in batch.items()}
        with s.data_rows(sharded) if s is not None \
                else contextlib.nullcontext():
            logits = self(batch.get("tokens"), embeds=batch.get("embeds"))
        labels = batch["labels"]
        logits = logits[:, -labels.shape[1]:, :].float()
        mask = labels >= 0
        lab = labels.clamp(min=0).long()
        logz = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, lab[..., None])[..., 0]
        nll = (logz - ll) * mask
        total, count = nll.sum(), mask.sum()
        if s is not None:
            total, count = s.sum_data(total), s.sum_data(count)
        loss = total / count.clamp(min=1)
        return loss, {"loss": loss, "tokens": count}

    def init_cache(self, batch, length=0, dtype=torch.bfloat16):
        """Zero dense decode cache for ``batch`` rows at cache length
        ``length`` (unused by minGRU stacks: their state is O(1)); see the
        module docstring for the layouts."""
        if self.stacked_cache:
            # the minGRU hidden (this rank's columns in spmd.local_view)
            d = self.layers[0].mixer.block.bh.shape[0]
            return torch.zeros(len(self.layers), batch, d,
                               dtype=dtype, device=self.device)
        return [layer.init_cache(batch, length, dtype)
                for layer in self.layers]

    def _new_cache(self, cache):
        return torch.empty_like(cache) if self.stacked_cache \
            else [None] * len(self.layers)

    def prefill(self, tokens, cache, pos0=0, length=None):
        """Consume a prompt chunk starting at absolute position ``pos0``.
        tokens: (B, S); ``length`` = number of valid leading tokens (None =
        all; the rest is grid padding).  Returns (logits at the last VALID
        token (B, 1, V_pad), new cache)."""
        x = self.embed(tokens).to(self.compute_dtype)
        new_cache = self._new_cache(cache)
        for j, layer in enumerate(self.layers):
            x, new_cache[j] = layer.prefill(x, cache[j], pos0, length=length)
        x = x[:, -1:] if length is None else x[:, length - 1:length]
        return self._head(x), new_cache

    def decode_step(self, tokens, cache, pos=0):
        """tokens: (B, 1); pos: an int or per-row positions (B,) ->
        (logits (B, 1, V_pad), new cache)."""
        x = self.embed(tokens).to(self.compute_dtype)
        if not torch.is_tensor(pos):
            pos = torch.full((tokens.shape[0],), int(pos),
                             dtype=torch.int64, device=x.device)
        new_cache = self._new_cache(cache)
        for j, layer in enumerate(self.layers):
            x, new_cache[j] = layer.decode(x, cache[j], pos)
        return self._head(x), new_cache

    # --- paged KV layout (reference ``DecoderLM`` :433-512) -------------
    def paged_layer_names(self):
        """Stack positions whose cache lives in the page pool."""
        return {j for j, layer in enumerate(self.layers) if layer.paged()}

    def paged_cache_spec(self, num_pages, page_size, dtype=torch.bfloat16,
                         batch=None):
        """Per layer, {leaf: (shape, dtype)}: an attention layer's shared
        page pool (no slot axis: the engine hands out pages); an
        O(1)-state layer of a hybrid stack keeps its per-slot carry of
        ``batch`` slots, as in the dense layout."""
        spec = []
        for layer in self.layers:
            if layer.paged():
                spec.append(layer.mixer.paged_cache_spec(num_pages,
                                                         page_size, dtype))
                continue
            if batch is None:
                raise ValueError(f"{self.cfg.name}: the per-slot leaves of "
                                 "its O(1)-state layers need batch")
            spec.append({k: (tuple(v.shape), v.dtype) for k, v in
                         layer.mixer.init_cache(batch, 0, dtype).items()})
        return spec

    def init_paged_cache(self, num_pages, page_size, dtype=torch.bfloat16,
                         batch=None):
        """Zero leaves of :meth:`paged_cache_spec`."""
        return [{k: torch.zeros(shape, dtype=dt, device=self.device)
                 for k, (shape, dt) in spec.items()}
                for spec in self.paged_cache_spec(num_pages, page_size,
                                                  dtype, batch)]

    def decode_step_paged(self, tokens, cache, pos, bt, active, length,
                          rows=None):
        """One slot-batched decode step under the paged KV layout.

        tokens: (B, 1); pos: (B,); active: (B,) bool; bt: (B, max_pages)
        block table shared by every layer (each indexes its OWN pool with
        the same page ids); ``length`` = the engine max_len; ``rows`` = the
        active slots' indices if the caller has them.  Each attention
        layer writes only the active slots' K/V, in place; an O(1)-state
        layer returns every slot's new carry, which the caller merges
        under ``active``.  Returns (logits, cache)."""
        x = self.embed(tokens).to(self.compute_dtype)
        if rows is None:
            rows = torch.nonzero(active).flatten()
        new_cache = list(cache)
        for j, layer in enumerate(self.layers):
            x, new_cache[j] = layer.decode_paged(x, cache[j], pos, bt,
                                                 active, length, rows=rows)
        return self._head(x), new_cache

    def verify_step_paged(self, tokens, cache, pos, bt, active, length):
        """Score K speculative tokens per slot against the page pools
        WITHOUT writing them (the reference's ``scan_layers=False``
        branch).  tokens: (B, K) — the current token plus K-1 drafts at
        positions ``pos .. pos+K-1``.  Returns (logits (B, K, V_pad),
        blocks): row j of the logits is the next-token distribution for
        stream position ``pos+1+j``, and ``blocks[layer]`` holds the K
        tokens' cache-dtype K/V (or latents) for
        :meth:`commit_step_paged`.

        The token-wise ops (embedding, projections, MLPs, head) run once
        over all K tokens; only each layer's attention runs per query."""
        x = self.embed(tokens).to(self.compute_dtype)
        blocks = []
        for layer, sub in zip(self.layers, cache):
            x, block = layer.verify_paged(x, sub, pos, bt, active, length)
            blocks.append(block)
        return self._head(x), blocks

    def commit_step_paged(self, cache, blocks, pos, bt, n_commit, active,
                          length):
        """Write the first ``n_commit[b]`` verified tokens of every
        layer's block into its pool, in place (one index computation for
        all layers).  Returns the cache."""
        K = next(iter(blocks[0].values())).shape[1]
        sel = commit_select(n_commit, active, K)
        for layer, sub, block in zip(self.layers, cache, blocks):
            layer.mixer.commit_paged(sub, block, pos, bt, n_commit, active,
                                     length, sel=sel)
        return cache
