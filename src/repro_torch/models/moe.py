"""Dense SwiGLU MLP (port of ``repro.models.moe.DenseMLP``; the routed
experts are not ported yet)."""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.core.quant import sigmoid
from repro_torch.models.module import fan_in_init


class DenseMLP(nn.Module):
    """SwiGLU MLP: down( silu(gate(x)) * up(x) ), computed in x.dtype."""

    def __init__(self, d_model, d_ff, *, dtype=torch.float32, device=None):
        super().__init__()
        self.d_model, self.d_ff = int(d_model), int(d_ff)
        kw = dict(dtype=dtype, device=device)
        self.w_gate = nn.Parameter(torch.empty(self.d_model, self.d_ff, **kw))
        self.w_up = nn.Parameter(torch.empty(self.d_model, self.d_ff, **kw))
        self.w_down = nn.Parameter(torch.empty(self.d_ff, self.d_model, **kw))
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        for w in (self.w_gate, self.w_up, self.w_down):
            fan_in_init(w, generator=generator)

    def forward(self, x):
        g = x @ self.w_gate.to(x.dtype)
        u = x @ self.w_up.to(x.dtype)
        # silu(g) = g·σ(g) with the reference's op-by-op σ (core.quant)
        return (g * sigmoid(g) * u) @ self.w_down.to(x.dtype)
