"""Initializers and core layers (port of ``repro.models.module``).

The reference's functional modules (``init(key) -> params``,
``__call__(params, x)``) become ``torch.nn.Module``s that own their
parameters.  ``reset_parameters(generator)`` reproduces the reference's
initializer families (2σ-truncated normals, fan-in scaled) from an
explicit ``torch.Generator``; the numbers differ from ``jax.random``'s,
so parity tests load the reference's parameters through
:func:`repro_torch.bridge.load_jax_params` instead.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.parallel import spmd


def _trunc_normal_(t, stddev, generator=None):
    # 2-sigma truncated normal, the standard transformer init
    with torch.no_grad():
        return nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0,
                                     generator=generator).mul_(stddev)


def fan_in_init(t, fan_in=None, generator=None):
    """In place: truncated normal with stddev 1/sqrt(fan_in) (default:
    the tensor's first dim, as ``repro.models.module.fan_in_init``)."""
    fan_in = fan_in if fan_in is not None else t.shape[0]
    return _trunc_normal_(t, 1.0 / math.sqrt(max(fan_in, 1)), generator)


def embed_init(t, generator=None):
    return _trunc_normal_(t, 1.0, generator)


class Embedding(nn.Module):
    """Token embedding; ``attend`` is the tied-embedding readout."""

    def __init__(self, vocab, dim, *, dtype=torch.float32, device=None):
        super().__init__()
        self.vocab, self.dim = int(vocab), int(dim)
        self.table = nn.Parameter(torch.empty(self.vocab, self.dim,
                                              dtype=dtype, device=device))
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        embed_init(self.table, generator)

    def axes(self):
        return {"table": ("vocab", "embed")}

    def forward(self, ids):
        """Rows of the table in bf16 when params are fp32 (the reference's
        ``Embedding.__call__``)."""
        dt = torch.bfloat16 if self.table.dtype == torch.float32 \
            else self.table.dtype
        s, vl = spmd.current(), self.table.shape[0]
        if s is not None and vl < self.vocab:
            # vocab-sharded table: each rank looks up the ids it holds and
            # the one non-zero row of every id is summed over "model"
            # (exact: x + 0 == x)
            loc = ids - s.tp_rank * vl
            mine = (loc >= 0) & (loc < vl)
            rows = self.table[loc.clamp(0, vl - 1)]
            rows = torch.where(mine[..., None], rows, rows.new_zeros(()))
            return s.reduce(rows).to(dt)
        return self.table[ids].to(dt)

    def attend(self, x):
        """Logits via tied embedding: (x @ table.T) / sqrt(dim), computed in
        x.dtype and promoted to fp32 by the scale, as in the reference."""
        s = spmd.current()
        if s is not None and self.table.shape[0] < self.vocab:
            # vocab-sharded head: each rank's columns, gathered whole
            logits = s.gather(s.enter(x) @ self.table.to(x.dtype).T)
        else:
            logits = x @ self.table.to(x.dtype).T
        return logits.float() / torch.full((), math.sqrt(self.dim),
                                           dtype=torch.float32,
                                           device=x.device)


class RMSNorm(nn.Module):
    def __init__(self, dim, *, eps=1e-6, dtype=torch.float32, device=None):
        super().__init__()
        self.dim, self.eps = int(dim), eps
        self.scale = nn.Parameter(torch.ones(self.dim, dtype=dtype,
                                             device=device))

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.scale.fill_(1.0)

    def axes(self):
        return {"scale": ("embed",)}

    def forward(self, x):
        """fp32 normalisation, result in x.dtype (``module.py:137-141``)."""
        x32 = x.float()
        var = (x32 * x32).mean(dim=-1, keepdim=True)
        y = x32 * torch.rsqrt(var + self.eps)
        return (y * self.scale.float()).to(x.dtype)
