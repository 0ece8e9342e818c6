"""Symmetric int8 per-page quantization for the paged KV cache (port of
``repro.kernels.paged_attention.quant``).

One float32 scale per (page, feature row): a pool leaf shaped
``(num_pages, page_size, *feat, d)`` quantizes with a scale tensor
``(num_pages, *feat)`` — for GQA pools ``(P, ps, KV, hd)`` a scale per
page per KV head.  Codes are round-to-nearest onto the SYMMETRIC grid
``[-QMAX, QMAX]`` (−128 is never emitted), so the round trip is within
half an LSB: ``|x − deq(q(x))| <= 0.5·scale``.

Every division here has a tensor divisor: on CUDA, PyTorch divides by a
Python scalar as a multiply by its reciprocal, which moves a code by one
against the reference (the scalar is a 0-dim tensor on the operand's
device instead, as ``repro_torch.core.quant._div`` does).  ``torch.round``
and ``jnp.round`` both round half to even.
"""
from __future__ import annotations

import torch

QMAX = 127
MIN_SCALE = 1e-8


def _scalar(v, like):
    """``v`` as a 0-dim float32 tensor on ``like``'s device."""
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def _expand(scale, ndim, page_axis):
    """Re-insert the two reduced axes so ``scale`` broadcasts against the
    codes: (P, *feat) -> (P, 1, *feat, 1) for ndim-dim page rows."""
    return scale.unsqueeze(page_axis).unsqueeze(ndim - 1)


def page_abs_scale(x, *, page_axis=1):
    """absmax/QMAX scale over (page_axis, last axis), floored at
    MIN_SCALE.  x: (..., page, *feat, d) -> float32 (..., *feat)."""
    s = torch.amax(x.float().abs(), dim=(page_axis, x.dim() - 1))
    return torch.maximum(s / _scalar(QMAX, s), _scalar(MIN_SCALE, s))


def quantize(x, scale, *, page_axis=1):
    """Round-to-nearest symmetric int8 codes for page rows ``x`` under
    per-row ``scale`` (shape = x.shape minus page_axis and last axis)."""
    s = _expand(scale, x.dim(), page_axis)
    codes = torch.round(x.float() / s)
    return torch.clamp(codes, -QMAX, QMAX).to(torch.int8)


def dequantize(codes, scale, *, page_axis=1, dtype=torch.float32):
    """codes * scale, broadcast per page row."""
    s = _expand(scale, codes.dim(), page_axis)
    return (codes.float() * s).to(dtype)


def rescale_codes(codes, old_scale, new_scale, *, page_axis=1):
    """Re-express existing codes under a grown scale: round(codes *
    old/new).  In the steady state old == new, the ratio is exactly 1.0
    and the codes are unchanged; a fresh page passes old_scale = 0, which
    zeroes the stale tenant's codes."""
    ratio = _expand((old_scale / new_scale).float(), codes.dim(), page_axis)
    codes = torch.round(codes.float() * ratio)
    return torch.clamp(codes, -QMAX, QMAX).to(torch.int8)
