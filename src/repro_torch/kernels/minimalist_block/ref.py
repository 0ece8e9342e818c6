"""Plain PyTorch oracle of the fused MINIMALIST block (port of
``repro.kernels.minimalist_block.ref``; inference, hardware mode):

    h̃_t = (x_t @ (codes_h − 1.5))·Δ + b_h
    z_t  = floor(63·clip(((x_t @ (codes_z − 1.5))·Δ + b_z)/6 + ½, 0, 1))/63
    h_t  = z_t ⊙ h̃_t + (1 − z_t) ⊙ h_{t−1}
    y_t  = Θ(h_t)

The 2 b levels are summed first and scaled by Δ once (paper Eq. 6, the
array's own order; the reference scales before summing).  With binary x
the level sums are exact in fp32, so this oracle, the CUDA kernel and
the hardware-mode ``MinGRUBlock`` agree bit for bit.
``minimalist_block_ref`` and ``minimalist_step_ref`` are the plain
versions of the CUDA kernels ``csrc/minimalist_block.cu`` and
``csrc/minimalist_step.cu``; every op here runs alone in fp32, so each
kernel, which spells the same ops without contraction, matches its plain
version bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.core import quant


def _project(x, codes, scale, bias):
    """(x @ (codes − 1.5))·Δ + b: level sums first, one scaling."""
    return (x @ (codes.float() - 1.5)) * scale + bias


def gate_codes(pre_z):
    """The SAR-ADC code floor(63·hard_sigmoid(pre_z)) ∈ [0, 63] as fp32;
    code/63 is :func:`quant.quantize_unit_6b` ∘ :func:`quant.hard_sigmoid`
    bit for bit."""
    return torch.floor(quant.hard_sigmoid(pre_z) * quant.GATE_UNITS)


def minimalist_block_ref(x, codes_h, codes_z, scale, bh, bz, h0):
    """x: (B,T,K) in {0,1}; codes: (K,N); scale: float; bh/bz: (N,);
    h0: (B,N).  Returns (y=Θ(h), h) each (B,T,N)."""
    htilde = _project(x, codes_h, scale, bh)
    z = quant.quantize_unit_6b(quant.hard_sigmoid(
        _project(x, codes_z, scale, bz)))
    hs = []
    h = h0
    for t in range(x.shape[1]):
        h = z[:, t] * htilde[:, t] + (1.0 - z[:, t]) * h
        hs.append(h)
    h_seq = torch.stack(hs, dim=1)
    return (h_seq > 0.0).to(x.dtype), h_seq


def minimalist_step_ref(x, codes_h, codes_z, scale, bh, bz, h_prev, *,
                        return_z_codes=False):
    """Single fused decode step. x: (B, K) in {0,1}; h_prev: (B, N).
    Returns (y=Θ(h), h) each (B, N), plus the int8 gate codes (B, N)
    when ``return_z_codes``."""
    htilde = _project(x, codes_h, scale, bh)
    zc = gate_codes(_project(x, codes_z, scale, bz))
    z = quant._div(zc, float(quant.GATE_UNITS))
    h = z * htilde + (1.0 - z) * h_prev
    y = (h > 0.0).to(x.dtype)
    if return_z_codes:
        return y, h, zc.to(torch.int8)
    return y, h
