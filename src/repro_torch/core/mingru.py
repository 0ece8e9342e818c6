"""minGRU cell and the MINIMALIST block/network (port of
``repro.core.mingru``, paper §2):

    h̃_t = W^h · x_t + b^h                      (Eq. 2 — no activation)
    z_t  = σ_z(W^z · x_t + b^z)                 (Eq. 3)
    h_t  = z_t ⊙ h̃_t + (1 − z_t) ⊙ h_{t−1}     (Eq. 1)
    out  = σ_h(h_t)                             (Eq. 4 — Θ when binary)

Gates depend only on the input, so the recurrence is a diagonal linear
scan (:mod:`repro_torch.kernels.linear_scan`).  ``MinGRUBlock`` honours a
QuantConfig, so one module expresses the three models of paper Fig. 5.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from repro_torch.core import quant
from repro_torch.core.quant import QuantConfig
from repro_torch.kernels.linear_scan import ops as scan_ops
from repro_torch.models.module import fan_in_init


class MinGRUBlock(nn.Module):
    """One GRU block: (W^h | W^z) input projections + gated scan
    (``repro.core.mingru.MinGRUBlock``).  Parameters: wh, wz (in, dim),
    bh, bz (dim,)."""

    def __init__(self, in_dim: int, dim: int, *,
                 qcfg: QuantConfig = QuantConfig(), scan_backend="kernel",
                 dtype=torch.float32, device=None):
        super().__init__()
        self.in_dim, self.dim = int(in_dim), int(dim)
        self.qcfg = qcfg
        self.scan_backend = scan_backend
        kw = dict(dtype=dtype, device=device)
        self.wh = nn.Parameter(torch.empty(self.in_dim, self.dim, **kw))
        self.bh = nn.Parameter(torch.empty(self.dim, **kw))
        self.wz = nn.Parameter(torch.empty(self.in_dim, self.dim, **kw))
        self.bz = nn.Parameter(torch.empty(self.dim, **kw))
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        fan_in_init(self.wh, generator=generator)
        fan_in_init(self.wz, generator=generator)
        with torch.no_grad():
            self.bh.zero_()
            # bias the gate towards "keep state" at init (z ≈ 0.27 under σ)
            self.bz.fill_(-1.0)

    def projections(self, x):
        """Return (h̃, z) for input x: (B, T, in_dim), in x.dtype."""
        cfg = self.qcfg
        bh = quant.maybe_quant_bias(self.bh, cfg).to(x.dtype)
        bz = quant.maybe_quant_gate_bias(self.bz, cfg).to(x.dtype)
        if cfg.quantize_weights:
            # one quantization scale per layer, shared by the interleaved
            # h and z synapses (paper Fig. 2A; analog.export_layer)
            scale = torch.maximum(quant.weight_scale(self.wh),
                                  quant.weight_scale(self.wz)).detach()
            if x.dtype == torch.float32:
                # the array's own order (paper Eq. 6): sum the 2 b levels,
                # then scale by Δ once.  Exact for binary inputs in any
                # summation order, so this path, the fused step kernel and
                # cuBLAS agree bit for bit on the hardware network.
                lh = quant.quantize_levels_2b(self.wh, scale)
                lz = quant.quantize_levels_2b(self.wz, scale)
                pre_h = (x @ lh) * scale + bh
                pre_z = (x @ lz) * scale + bz
            else:
                # low-precision compute: the reference's x @ (levels·Δ)
                wh = quant.quantize_weights_2b(self.wh, scale)[0]
                wz = quant.quantize_weights_2b(self.wz, scale)[0]
                pre_h = x @ wh.to(x.dtype) + bh
                pre_z = x @ wz.to(x.dtype) + bz
        else:
            pre_h = x @ self.wh.to(x.dtype) + bh
            pre_z = x @ self.wz.to(x.dtype) + bz
        return pre_h, quant.gate_fn(cfg)(pre_z)

    def forward(self, x, h0=None, *, backend=None):
        """x: (B, T, in_dim) -> (out (B,T,dim), h (B,T,dim)).
        ``backend`` overrides the construction-time scan backend."""
        if h0 is None:
            h0 = torch.zeros(x.shape[0], self.dim, dtype=x.dtype,
                             device=x.device)
        htilde, z = self.projections(x)
        h = scan_ops.mingru_scan(z, htilde, h0.contiguous(),
                                 backend=backend or self.scan_backend)
        return quant.output_fn(self.qcfg)(h), h

    def step(self, x_t, h_prev):
        """Single inference step. x_t: (B, in_dim); h_prev: (B, dim)."""
        htilde, z = self.projections(x_t[:, None, :])
        htilde, z = htilde[:, 0], z[:, 0]
        h = z * htilde + (1.0 - z) * h_prev
        return quant.output_fn(self.qcfg)(h), h


def _readout_qcfg(qcfg: QuantConfig) -> QuantConfig:
    """The readout layer's config: h is read in the analog domain (no Θ);
    weights/biases/gate are still quantized when the stage says so."""
    return QuantConfig(quantize_weights=qcfg.quantize_weights,
                       quantize_biases=qcfg.quantize_biases,
                       binary_output=False,
                       hard_sigmoid_gate=qcfg.hard_sigmoid_gate,
                       quantize_gate_6b=qcfg.quantize_gate_6b,
                       surrogate_width=qcfg.surrogate_width)


class MinimalistNetwork(nn.Module):
    """Feed-forward stack of MinGRU blocks (paper Fig. 1;
    ``repro.core.mingru.MinimalistNetwork``).

    ``dims`` includes input and output sizes, e.g. the paper's sMNIST net
    is (1, 64, 64, 64, 64, 10).  The blocks are registered as
    ``block0, block1, ...`` — the reference's parameter names.
    Classification reads the final layer's hidden state at the last
    step (no Θ on the readout layer).
    """

    def __init__(self, dims: Sequence[int], *,
                 qcfg: QuantConfig = QuantConfig(), scan_backend="kernel",
                 dtype=torch.float32, device=None):
        super().__init__()
        self.dims = tuple(int(d) for d in dims)
        self.qcfg = qcfg
        n = len(self.dims) - 1
        for i, (din, dout) in enumerate(zip(self.dims[:-1], self.dims[1:])):
            cfg = qcfg if i < n - 1 else _readout_qcfg(qcfg)
            self.add_module(f"block{i}", MinGRUBlock(
                din, dout, qcfg=cfg, scan_backend=scan_backend, dtype=dtype,
                device=device))

    @property
    def blocks(self):
        return [getattr(self, f"block{i}") for i in range(len(self.dims) - 1)]

    def reset_parameters(self, generator=None):
        for b in self.blocks:
            b.reset_parameters(generator)

    def forward(self, x, collect_traces: bool = False):
        """x: (B, T, dims[0]) -> logits (B, dims[-1]).  With
        ``collect_traces`` also returns {block: {"htilde","z","h","out"}}."""
        traces = {}
        out, h = x, None
        for i, b in enumerate(self.blocks):
            if collect_traces:
                htilde, z = b.projections(out)
                traces[f"block{i}"] = {"htilde": htilde, "z": z}
            out, h = b(out)
            if collect_traces:
                traces[f"block{i}"]["h"] = h
                traces[f"block{i}"]["out"] = out
        logits = h[:, -1, :]
        if collect_traces:
            return logits, traces
        return logits

    def initial_state(self, batch, dtype=torch.float32, device=None):
        if device is None:
            device = self.block0.wh.device
        return [torch.zeros(batch, b.dim, dtype=dtype, device=device)
                for b in self.blocks]

    def step(self, x_t, states):
        """Recurrent single-step inference through the whole stack."""
        new_states = []
        out = x_t
        for b, s in zip(self.blocks, states):
            out, h = b.step(out, s)
            new_states.append(h)
        return out, new_states

    def prefill(self, x, states=None, *, backend=None):
        """Consume a chunk of frames with an O(1) carry: one linear scan per
        block.  Returns (y (B, T, dims[-1]), new_states)."""
        if states is None:
            states = self.initial_state(x.shape[0], x.dtype, x.device)
        out = x
        new_states = []
        for b, s in zip(self.blocks, states):
            out, h = b(out, h0=s.to(out.dtype), backend=backend)
            new_states.append(h[:, -1])
        return out, new_states
