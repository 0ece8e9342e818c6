"""Int8 error-feedback gradient compression (port of
``repro.optim.compress``).

    c_t = quantize_int8(g_t + e_{t-1})          (per-tensor scale)
    e_t = (g_t + e_{t-1}) − dequant(c_t)        (error feedback)

The compressed, dequantised gradient is what a data-parallel all-reduce
would carry; error feedback keeps the accumulated quantisation error
bounded, so sum_t dequant(c_t) == sum_t g_t + e_T.  Bitwise the
reference's arithmetic in fp32.
"""
from __future__ import annotations

import torch

from repro_torch.core.quant import _div


def quantize_int8(x):
    """Symmetric int8 with one scale per tensor: (codes, scale)."""
    scale = _div(x.abs().max(), 127.0) + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q, scale):
    return q.float() * scale


def init_error(named: dict) -> dict:
    """Zero error-feedback state, fp32, one entry per tensor."""
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in named.items()}


def compress_grads(grads: dict, error: dict):
    """Returns (compressed-dequantised grads, new error state), both
    dicts keyed like ``grads``."""
    out, new_err = {}, {}
    for k, g in grads.items():
        target = g.float() + error[k]
        q, scale = quantize_int8(target)
        deq = dequantize_int8(q, scale)
        out[k], new_err[k] = deq.to(g.dtype), target - deq
    return out, new_err
