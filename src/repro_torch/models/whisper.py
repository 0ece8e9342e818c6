"""Whisper-style encoder-decoder backbone, its conv frontend stubbed (port
of ``repro.models.whisper``).

The caller passes precomputed frame embeddings (B, T_frames, d_model) in
place of Whisper's two strided conv layers.  The encoder runs
bidirectional self-attention over them; the decoder runs causal
self-attention over the tokens (``attention_impl``: the naive softmax or
the flash-attention kernels) and cross-attention to the encoder's
output.  The encoder's and the cross-attention's softmax are the naive
one, as in the reference, whose kernels cover causal attention only.

The reference stacks its layers on a leading axis (``"enc"`` and
``"dec"``, with ``"attn"``/``"mlp"``/``"n1"``/``"n2"`` and
``"self"``/``"cross"``/``"mlp"``/``"n1"``–``"n3"`` in each layer); here
they are ``nn.ModuleList``s, and :func:`repro_torch.bridge.load_jax_params`
unstacks the reference's tree onto them (the decoder's ``"self"`` reads
into ``self_attn``).

Decode cache: a list with one entry per decoder layer, ``{"self": {"k",
"v"} (B, L, KV, hd), "xk", "xv" (B, T_frames, H, hd)}``; the cross K/V
are computed once from the encoder's output by :meth:`EncDecLM.init_cache`
(the reference stacks the same leaves on a layer axis).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import GQAAttention, _sdpa, no_mask
from repro_torch.models.module import Embedding, RMSNorm, fan_in_init
from repro_torch.models.moe import DenseMLP


class CrossAttention(nn.Module):
    """Decoder-to-encoder attention over all H heads (no GQA grouping):
    ``wq``/``wk``/``wv`` (d, H, hd), ``wo`` (H, hd, d)."""

    def __init__(self, cfg: ModelConfig, *, dtype=torch.float32, device=None):
        super().__init__()
        self.cfg = cfg
        d, H, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
        kw = dict(dtype=dtype, device=device)
        self.wq = nn.Parameter(torch.empty(d, H, hd, **kw))
        self.wk = nn.Parameter(torch.empty(d, H, hd, **kw))
        self.wv = nn.Parameter(torch.empty(d, H, hd, **kw))
        self.wo = nn.Parameter(torch.empty(H, hd, d, **kw))
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        c = self.cfg
        for w in (self.wq, self.wk, self.wv):
            fan_in_init(w, c.d_model, generator)
        fan_in_init(self.wo, c.n_heads * c.head_dim, generator)

    def axes(self):
        return {"wq": ("embed", "heads", "head_dim"),
                "wk": ("embed", "heads", "head_dim"),
                "wv": ("embed", "heads", "head_dim"),
                "wo": ("heads", "head_dim", "embed")}

    def kv(self, memory):
        """memory: (B, L, D) -> (k, v), each (B, L, H, hd) in its dtype."""
        dt = memory.dtype
        k = torch.einsum("bld,dhk->blhk", memory, self.wk.to(dt))
        v = torch.einsum("bld,dhk->blhk", memory, self.wv.to(dt))
        return k, v

    def forward(self, x, memory=None, kv_cache=None):
        """x: (B, S, D) attends to ``memory`` (B, L, D), or to its cached
        (k, v) (read in x's dtype)."""
        if kv_cache is None:
            k, v = self.kv(memory)
        else:
            k, v = (t.to(x.dtype) for t in kv_cache)
        q = torch.einsum("bsd,dhk->bshk", x, self.wq.to(x.dtype))
        out = _sdpa(q, k, v, no_mask(q, k))
        return torch.einsum("bshk,hkd->bsd", out, self.wo.to(x.dtype))


class EncoderLayer(nn.Module):
    """Pre-norm bidirectional self-attention and SwiGLU MLP."""

    def __init__(self, cfg: ModelConfig, *, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.attn = GQAAttention(cfg, **kw)
        self.mlp = DenseMLP(cfg.d_model, cfg.d_ff, **kw)
        self.n1 = RMSNorm(cfg.d_model, **kw)
        self.n2 = RMSNorm(cfg.d_model, **kw)

    def reset_parameters(self, generator=None):
        for m in (self.attn, self.mlp, self.n1, self.n2):
            m.reset_parameters(generator)

    def axes(self):
        return {"attn": self.attn.axes(), "mlp": self.mlp.axes(),
                "n1": self.n1.axes(), "n2": self.n2.axes()}

    def forward(self, x):
        x = x + self.attn.bidirectional(self.n1(x))
        return x + self.mlp(self.n2(x))


class DecoderLayerED(nn.Module):
    """Pre-norm causal self-attention, cross-attention and SwiGLU MLP."""

    def __init__(self, cfg: ModelConfig, *, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.self_attn = GQAAttention(cfg, **kw)
        self.cross = CrossAttention(cfg, **kw)
        self.mlp = DenseMLP(cfg.d_model, cfg.d_ff, **kw)
        self.n1 = RMSNorm(cfg.d_model, **kw)
        self.n2 = RMSNorm(cfg.d_model, **kw)
        self.n3 = RMSNorm(cfg.d_model, **kw)

    def reset_parameters(self, generator=None):
        for m in (self.self_attn, self.cross, self.mlp, self.n1, self.n2,
                  self.n3):
            m.reset_parameters(generator)

    def axes(self):
        return {"self_attn": self.self_attn.axes(),
                "cross": self.cross.axes(), "mlp": self.mlp.axes(),
                "n1": self.n1.axes(), "n2": self.n2.axes(),
                "n3": self.n3.axes()}

    def forward(self, x, memory):
        x = x + self.self_attn(self.n1(x))
        x = x + self.cross(self.n2(x), memory)
        return x + self.mlp(self.n3(x))

    def decode(self, x, cache, pos):
        """x: (B, 1, D); pos: (B,) -> (y, new cache entry); the cross K/V
        pass through unchanged."""
        h, sc = self.self_attn.decode(self.n1(x), cache["self"], pos)
        x = x + h
        x = x + self.cross(self.n2(x), kv_cache=(cache["xk"], cache["xv"]))
        x = x + self.mlp(self.n3(x))
        return x, {"self": sc, "xk": cache["xk"], "xv": cache["xv"]}


class EncDecLM(nn.Module):
    """Encoder over frame embeddings, causal decoder over tokens with
    cross-attention, tied embedding head (``whisper.EncDecLM``:
    ``encode``, ``__call__``, ``loss``, ``init_cache``, ``decode_step``)."""

    def __init__(self, cfg: ModelConfig, *, dtype=torch.float32, device=None,
                 generator=None):
        super().__init__()
        self.cfg = cfg
        kw = dict(dtype=dtype, device=device)
        self.embed = Embedding(cfg.vocab_padded, cfg.d_model, **kw)
        self.enc = nn.ModuleList(EncoderLayer(cfg, **kw) for _ in
                                 range(cfg.n_enc_layers or cfg.n_layers))
        self.dec = nn.ModuleList(DecoderLayerED(cfg, **kw)
                                 for _ in range(cfg.n_layers))
        self.enc_norm = RMSNorm(cfg.d_model, **kw)
        self.final_norm = RMSNorm(cfg.d_model, **kw)
        self.reset_parameters(generator)

    def reset_parameters(self, generator=None):
        """Seeded random init of every parameter (the reference's
        initializer families; see models.module)."""
        self.embed.reset_parameters(generator)
        for layer in list(self.enc) + list(self.dec):
            layer.reset_parameters(generator)
        self.enc_norm.reset_parameters(generator)
        self.final_norm.reset_parameters(generator)

    def axes(self):
        """Keyed by the port's names: ``enc``/``dec`` are per-layer lists
        (the reference's stacked "layers" axis dropped)."""
        return {"embed": self.embed.axes(),
                "enc": {str(j): l.axes() for j, l in enumerate(self.enc)},
                "dec": {str(j): l.axes() for j, l in enumerate(self.dec)},
                "enc_norm": self.enc_norm.axes(),
                "final_norm": self.final_norm.axes()}

    def cache_axes(self):
        """One entry a decoder layer, as :meth:`init_cache` lays it out."""
        xa = ("batch", "frames", "heads", "head_dim")
        return [{"self": l.self_attn.cache_axes(), "xk": xa, "xv": xa}
                for l in self.dec]

    @property
    def device(self):
        return self.embed.table.device

    @property
    def compute_dtype(self):
        dt = self.embed.table.dtype
        return torch.bfloat16 if dt == torch.float32 else dt

    def encode(self, frame_embeds):
        """frame_embeds: (B, T, D) -> the encoder's output (B, T, D) in
        the compute dtype."""
        x = frame_embeds.to(self.compute_dtype)
        for layer in self.enc:
            x = layer(x)
        return self.enc_norm(x)

    def forward(self, tokens=None, embeds=None, positions=None):
        """embeds: (B, T, D) stub frame embeddings; tokens: (B, S) ->
        logits (B, S, V_pad) fp32, or the encoder's output when no tokens
        are given (the encoder-only regime)."""
        del positions
        memory = self.encode(embeds)
        if tokens is None:
            return memory
        x = self.embed(tokens).to(self.compute_dtype)
        for layer in self.dec:
            x = layer(x, memory)
        return self.embed.attend(self.final_norm(x))

    def loss(self, batch):
        """batch: {"tokens", "labels"} (B, S) and "embeds" (B, T, D);
        labels −1 are masked.  Mean next-token NLL from fp32 logits.
        Returns (scalar loss, {"loss"})."""
        logits = self(batch["tokens"], embeds=batch["embeds"]).float()
        labels = batch["labels"]
        mask = labels >= 0
        lab = labels.clamp(min=0).long()
        logz = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, lab[..., None])[..., 0]
        loss = ((logz - ll) * mask).sum() / mask.sum().clamp(min=1)
        return loss, {"loss": loss}

    # --- decode ---------------------------------------------------------
    def init_cache(self, batch, length, dtype=torch.bfloat16,
                   frame_embeds=None):
        """Decode cache for ``batch`` rows and ``length`` decoder
        positions (see the module docstring).  With ``frame_embeds``
        (B, T, D) the encoder runs once and each decoder layer's cross K/V
        are computed from its output; without, they are zeros over the
        config's ``frontend_seq`` frames."""
        c = self.cfg
        memory = None if frame_embeds is None else self.encode(frame_embeds)
        cache = []
        for layer in self.dec:
            if memory is None:
                shape = (batch, c.frontend_seq, c.n_heads, c.head_dim)
                xk = torch.zeros(shape, dtype=dtype, device=self.device)
                xv = torch.zeros_like(xk)
            else:
                xk, xv = (t.to(dtype) for t in layer.cross.kv(memory))
            cache.append({"self": layer.self_attn.init_cache(batch, length,
                                                             dtype),
                          "xk": xk, "xv": xv})
        return cache

    def decode_step(self, tokens, cache, pos=0):
        """tokens: (B, 1); pos: an int or per-row positions (B,) ->
        (logits (B, 1, V_pad), new cache)."""
        x = self.embed(tokens).to(self.compute_dtype)
        if not torch.is_tensor(pos):
            pos = torch.full((tokens.shape[0],), int(pos),
                             dtype=torch.int64, device=x.device)
        new_cache = []
        for layer, entry in zip(self.dec, cache):
            x, entry = layer.decode(x, entry, pos)
            new_cache.append(entry)
        return self.embed.attend(self.final_norm(x)), new_cache
