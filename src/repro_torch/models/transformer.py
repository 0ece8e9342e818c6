"""Decoder LM over minGRU time mixing (port of the MINGRU layer kind of
``repro.models.transformer``).

The reference scans a stacked pattern unit with ``lax.scan``; here the
layers are written out as an ``nn.ModuleList`` (``layers[j]`` is stack
position j; :func:`repro_torch.bridge.load_jax_params` unstacks the
reference's layer axis onto it).  Attention, MLA, Mamba and MoE layers
are not ported yet and raise.

Dtypes mirror the reference: fp32 parameters, bf16 compute
(``DecoderLM.compute_dtype``), fp32 RMSNorm internals, fp32 logits, and
a bf16 decode cache.  The cache is ONE tensor (n_layers, B, d_model)
holding every minGRU layer's O(1) state — the layout of the reference's
scanned-unit leaf ``{"unit0": {"h": (n_repeats, B, d_model)}}``.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import MINGRU, LayerSpec, ModelConfig
from repro_torch.core.mingru import MinGRUBlock
from repro_torch.core.quant import QuantConfig
from repro_torch.models.module import Embedding, RMSNorm
from repro_torch.models.moe import DenseMLP

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

    def forward(self, x):
        out, _h = self.block(x)
        return out

    def decode(self, x, h):
        """x: (B, 1, D); h: (B, D) -> (out (B, 1, D), new h)."""
        out, h = self.block.step(x[:, 0, :], h)
        return out[:, None, :], h

    def prefill(self, x, h, length=None):
        """Chunk prefill: ONE linear scan over the chunk, O(1) carry.
        ``length`` picks the carry at the last VALID token when the chunk
        tail is grid padding (the scan is causal: padding never reaches
        h[length-1])."""
        out, hs = self.block(x, h0=h.to(x.dtype))
        carry = hs[:, -1] if length is None else hs[:, length - 1]
        return out, carry.to(h.dtype)


class DecoderLayer(nn.Module):
    """pre-norm mixer + residual, then pre-norm dense MLP + residual
    (``transformer.DecoderLayer``)."""

    def __init__(self, cfg: ModelConfig, spec: LayerSpec, *,
                 dtype=torch.float32, device=None):
        super().__init__()
        if spec.kind != MINGRU or spec.moe:
            raise NotImplementedError(
                f"layer kind {spec.kind!r} (moe={spec.moe}) is not ported "
                "yet: the port serves minGRU stacks with dense MLPs")
        kw = dict(dtype=dtype, device=device)
        self.mixer = MinGRUMixer(cfg, **kw)
        self.norm1 = RMSNorm(cfg.d_model, eps=cfg.norm_eps, **kw)
        d_ff = spec.d_ff or cfg.d_ff
        self.mlp = DenseMLP(cfg.d_model, d_ff, **kw) if d_ff else None
        self.norm2 = RMSNorm(cfg.d_model, eps=cfg.norm_eps, **kw) \
            if d_ff else None

    def reset_parameters(self, generator=None):
        self.mixer.reset_parameters(generator)
        if self.mlp is not None:
            self.mlp.reset_parameters(generator)

    def _mlp_tail(self, x):
        if self.mlp is not None:
            x = x + self.mlp(self.norm2(x))
        return x

    def forward(self, x):
        return self._mlp_tail(x + self.mixer(self.norm1(x)))

    def decode(self, x, h):
        out, h = self.mixer.decode(self.norm1(x), h)
        return self._mlp_tail(x + out), h

    def prefill(self, x, h, length=None):
        out, h = self.mixer.prefill(self.norm1(x), h, length=length)
        return self._mlp_tail(x + out), h


class DecoderLM(nn.Module):
    """Embedding + the layer stack + final norm + tied (or separate) head
    (``transformer.DecoderLM``: ``__call__``, ``loss``, ``prefill``,
    ``decode_step``, ``init_cache``)."""

    def __init__(self, cfg: ModelConfig, *, dtype=torch.float32, device=None,
                 generator=None):
        super().__init__()
        self.cfg = cfg
        kw = dict(dtype=dtype, device=device)
        self.embed = Embedding(cfg.vocab_padded, cfg.d_model, **kw)
        self.layers = nn.ModuleList(DecoderLayer(cfg, s, **kw)
                                    for s in cfg.layer_specs())
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

    def forward(self, tokens):
        """tokens: (B, S) int -> logits (B, S, V_pad) fp32."""
        x = self.embed(tokens).to(self.compute_dtype)
        for layer in self.layers:
            x = layer(x)
        return self._head(x)

    def loss(self, batch):
        """batch: {"tokens": (B, S), "labels": (B, S)}; labels −1 are
        masked.  Mean next-token NLL over the unmasked labels, from fp32
        logits (``transformer.DecoderLM.loss``).  Returns (scalar loss,
        {"loss", "tokens"})."""
        logits = self(batch["tokens"]).float()
        labels = batch["labels"]
        logits = logits[:, -labels.shape[1]:, :]
        mask = labels >= 0
        lab = labels.clamp(min=0).long()
        logz = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, lab[..., None])[..., 0]
        nll = (logz - ll) * mask
        loss = nll.sum() / mask.sum().clamp(min=1)
        return loss, {"loss": loss, "tokens": mask.sum()}

    def init_cache(self, batch, length=0, dtype=torch.bfloat16):
        """Zero decode cache (n_layers, batch, d_model); ``length`` is
        unused (minGRU state is O(1))."""
        del length
        return torch.zeros(len(self.layers), batch, self.cfg.d_model,
                           dtype=dtype, device=self.device)

    def prefill(self, tokens, cache, pos0=0, length=None):
        """Consume a prompt chunk. tokens: (B, S); ``length`` = number of
        valid leading tokens (None = all; the rest is grid padding).
        Returns (logits at the last VALID token (B, 1, V_pad), new cache)."""
        del pos0                      # minGRU layers are position-free
        x = self.embed(tokens).to(self.compute_dtype)
        new_cache = torch.empty_like(cache)
        for j, layer in enumerate(self.layers):
            x, new_cache[j] = layer.prefill(x, cache[j], length=length)
        x = x[:, -1:] if length is None else x[:, length - 1:length]
        return self._head(x), new_cache

    def decode_step(self, tokens, cache, pos=0):
        """tokens: (B, 1) -> (logits (B, 1, V_pad), new cache)."""
        del pos
        x = self.embed(tokens).to(self.compute_dtype)
        new_cache = torch.empty_like(cache)
        for j, layer in enumerate(self.layers):
            x, new_cache[j] = layer.decode(x, cache[j])
        return self._head(x), new_cache
