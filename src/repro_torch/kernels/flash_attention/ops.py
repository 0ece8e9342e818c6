"""Flash attention: the CUDA kernels' wrappers, the differentiable op and
the analytic cost model (port of ``repro.kernels.flash_attention.ops``).

``flash_fwd_kernel`` runs ``csrc/flash_fwd.cu`` (which replaces the TPU
kernel ``flash_fwd``) on CUDA tensors and its plain version,
:func:`ref.flash_attention_ref`, on CPU tensors; ``flash_bwd_kernel``
runs the two kernels of ``csrc/flash_bwd.cu`` (which replace
``flash_bwd``'s dK/dV and dQ kernels and the group sum of its custom VJP)
or :func:`ref.flash_attention_bwd_ref`.  On a CUDA tensor they launch or
raise.  Each source has two routes, picked by :func:`route`: ``tc``
(bf16 at head dims 16/32/64/128 and 129-256: wgmma tiles fed by TMA, P
and dS split into three bf16 parts) and ``simt`` (fp32, and bf16 at the
other head dims below 128: the CUDA cores).  Both routes are compiled at
head dims 16, 32, 64, 128, 160 and 256 and run a head dim between them
at the next one, with the extra columns read as zeros and never written,
and the softmax scale of the true head dim; a head dim above 256 is
refused.
A launch that fails on the tc route raises; it is never retried on the
other.  ``flash_fwd_kernel.launches`` counts forward launches and
``.launches_tc`` those on the tc route; ``flash_bwd_kernel.launches_dq``
and ``.launches_dkv`` count the two backward kernels, ``.launches_dq_tc``
and ``.launches_dkv_tc`` those on the tc route.

:class:`FlashAttention` is the reference's custom VJP as an
``autograd.Function``: it saves (q, k, v, out, lse) and its backward is
``flash_bwd_kernel``.  Inputs may be strided views (the last axis
contiguous, bases and strides in whole 16 bytes, else the op copies
them): the kernels read them through their strides and write their
outputs in the same layout, so the model's (B, S, H, D) projections pass
as transposed views with no copies.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, check_devices, on_cpu
from repro_torch.kernels.flash_attention import ref

#: The largest head dim the CUDA kernels take (every one from 1 up).
MAX_HEAD_DIM = 256
#: Head dims the tensor-core route is compiled at (bf16 only); it runs
#: 129-159 at 160 and 161-255 at 256.
TC_HEAD_DIMS = (16, 32, 64, 128, 160, 256)


def route(dtype, head_dim):
    """The kernels' route for inputs of ``dtype`` and ``head_dim``:
    ``"tc"`` (wgmma fed by TMA) for bf16 at 16/32/64/128 and at every head
    dim from 129 to 256 (run at 160 or 256, the columns past it TMA's zero
    fill), else ``"simt"`` (the CUDA cores: fp32 has no exact bf16
    product, and the bf16 head dims below 128 that are not 16/32/64 run
    padded at a compiled one of the simt route)."""
    if dtype != torch.bfloat16:
        return "simt"
    wide = TC_HEAD_DIMS[3] < head_dim <= MAX_HEAD_DIM
    return "tc" if head_dim in TC_HEAD_DIMS or wide else "simt"


def _aligned(t):
    """Whether TMA can read ``t``: a 16-byte-aligned base and, on every
    axis but the last of more than one entry, a positive stride of whole
    16 bytes."""
    el = t.element_size()
    return t.data_ptr() % 16 == 0 and all(
        st > 0 and st * el % 16 == 0
        for n, st in zip(t.shape[:-1], t.stride()[:-1]) if n > 1)


def _padded(t):
    """An uninitialised tensor of ``t``'s shape, dtype and device whose
    rows start on 16 bytes: contiguous, or a view of the first
    ``t.shape[-1]`` columns of rows padded to whole 16 bytes (a head dim
    such as 130 in bf16, whose contiguous rows TMA cannot address)."""
    *lead, d = t.shape
    per = 16 // t.element_size()
    wide = torch.empty(*lead, -(-d // per) * per, dtype=t.dtype,
                       device=t.device)
    return wide[..., :d]


def _empty_rows(t):
    """An uninitialised tensor in ``t``'s layout (``torch.empty_like``),
    or, where TMA could not address that, :func:`_padded`."""
    out = torch.empty_like(t)
    return out if _aligned(out) else _padded(t)


def _rows(t):
    """``t`` with a contiguous last axis that TMA can read (a copy, into
    :func:`_padded` rows, only when it is not)."""
    if t.stride(-1) == 1 and _aligned(t):
        return t
    return _padded(t).copy_(t)


def _strides(*tensors):
    """(batch, head, row) strides of each (B, h, S, D) tensor, as the
    int64 array the C entry points read."""
    flat = [s for t in tensors for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(flat))(*flat)


def _check(what, q, k, v, window, extra=()):
    """Device, dtype, shape and layout checks of both CUDA wrappers;
    raises on anything the kernels do not take."""
    tensors = (q, k, v) + tuple(extra)
    check_devices(what, *tensors)
    if q.dtype not in (torch.float32, torch.bfloat16) or any(
            t.dtype != q.dtype for t in tensors):
        raise ValueError(f"{what}: inputs must share one dtype of fp32/bf16,"
                         " got " + ", ".join(str(t.dtype) for t in tensors))
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"{what}: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    B, H, S, D = q.shape
    KV = k.shape[1]
    if k.shape != (B, KV, S, D) or KV < 1 or H % KV:
        raise ValueError(f"{what}: q {tuple(q.shape)} does not fit k "
                         f"{tuple(k.shape)} (B, S, D and H % KV)")
    if any(t.shape != q.shape for t in extra):
        raise ValueError(f"{what}: out / do must have q's shape")
    if not 1 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"{what}: head dim {D} outside 1..{MAX_HEAD_DIM}")
    if window is not None and window < 1:
        raise ValueError(f"{what}: window {window} < 1")
    if any(t.stride(-1) != 1 for t in tensors):
        raise ValueError(f"{what}: the last axis must be contiguous")
    if B > 65535 or H > 65535:
        raise ValueError(f"{what}: batch or heads too large for one launch")
    if route(q.dtype, D) == "tc" and not all(map(_aligned, tensors)):
        raise ValueError(f"{what}: the tc route reads its operands with TMA,"
                         " which needs 16-byte-aligned bases and strides")


def _window(window):
    return -1 if window is None else int(window)


def _suffix(dtype, head_dim):
    """The C entry points' suffix for inputs of ``dtype`` at
    ``head_dim``: ``bf16_tc`` on the tc route, else the dtype's."""
    if route(dtype, head_dim) == "tc":
        return "bf16_tc"
    return "bf16" if dtype == torch.bfloat16 else "f32"


def flash_fwd_kernel(q, k, v, causal=True, window=None):
    """q: (B, H, S, D); k, v: (B, KV, S, D), one dtype (fp32 or bf16) ->
    (out (B, H, S, D) in q's dtype and layout, lse (B, H, S) fp32)."""
    if on_cpu(q, k, v):
        return ref.flash_attention_ref(q, k, v, causal, window)
    _check("flash_fwd_kernel", q, k, v, window)
    B, H, S, D = q.shape
    out = _empty_rows(q)
    lse = torch.empty(B, H, S, dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    suffix = _suffix(q.dtype, D)
    tc = suffix == "bf16_tc"
    fn = getattr(build.load("flash_fwd"), f"flash_fwd_{suffix}")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             lse.data_ptr(), _strides(q, k, v, out), B, H, k.shape[1], S, D,
             int(causal), _window(window), stream)
    build.check(err, "flash_fwd")
    flash_fwd_kernel.launches += 1
    flash_fwd_kernel.launches_tc += tc
    return out, lse


flash_fwd_kernel.launches = 0
flash_fwd_kernel.launches_tc = 0


def flash_bwd_kernel(q, k, v, out, lse, do, causal=True, window=None):
    """Cotangents (dq, dk, dv) given the forward's inputs, its ``out`` and
    ``lse`` and the output cotangent ``do`` (q's shape and dtype); dk and
    dv summed over each kv head's query group, each in its input's dtype
    and layout."""
    if on_cpu(q, k, v, out, lse, do):
        return ref.flash_attention_bwd_ref(q, k, v, out, lse, do, causal,
                                           window)
    check_devices("flash_bwd_kernel", q, k, v, out, lse, do)
    _check("flash_bwd_kernel", q, k, v, window, (out, do))
    B, H, S, D = q.shape
    if lse.shape != (B, H, S) or lse.dtype != torch.float32 or \
            not lse.is_contiguous():
        raise ValueError("flash_bwd_kernel: lse must be a contiguous "
                         f"({B}, {H}, {S}) float32 tensor")
    dq, dk, dv = _empty_rows(q), _empty_rows(k), _empty_rows(v)
    if dq.numel() == 0:
        return dq, dk, dv
    delta = torch.empty_like(lse)
    lib = build.load("flash_bwd")
    suffix = _suffix(q.dtype, D)
    tc = suffix == "bf16_tc"
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(),
            _strides(q, k, v, out, do, dq, dk, dv), B, H, k.shape[1], S, D,
            int(causal), _window(window),
            torch.cuda.current_stream(q.device).cuda_stream)
    # the dq kernel writes delta = rowsum(out * do), which the dkv reads
    err = getattr(lib, f"flash_bwd_dq_{suffix}")(*args)
    build.check(err, "flash_bwd_dq")
    flash_bwd_kernel.launches_dq += 1
    flash_bwd_kernel.launches_dq_tc += tc
    err = getattr(lib, f"flash_bwd_dkv_{suffix}")(*args)
    build.check(err, "flash_bwd_dkv")
    flash_bwd_kernel.launches_dkv += 1
    flash_bwd_kernel.launches_dkv_tc += tc
    return dq, dk, dv


flash_bwd_kernel.launches_dq = 0
flash_bwd_kernel.launches_dkv = 0
flash_bwd_kernel.launches_dq_tc = 0
flash_bwd_kernel.launches_dkv_tc = 0


class FlashAttention(torch.autograd.Function):
    """out = attention(q, k, v) with the reference's custom VJP
    (``ops.flash_attention``'s ``_fwd``/``_bwd``): saves (q, k, v, out,
    lse); the backward is :func:`flash_bwd_kernel`."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        q, k, v = _rows(q), _rows(k), _rows(v)
        out, lse = flash_fwd_kernel(q, k, v, causal, window)
        ctx.causal, ctx.window = causal, window
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        g = _rows(g.to(q.dtype))
        dq, dk, dv = flash_bwd_kernel(q, k, v, out, lse, g, ctx.causal,
                                      ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal=True, window=None):
    """q: (B, H, S, D); k, v: (B, KV, S, D) with H % KV == 0 ->
    (B, H, S, D) in q's dtype.  Differentiable in q, k and v
    (:class:`FlashAttention`)."""
    return FlashAttention.apply(q, k, v, causal, window)


def cost_model(B, H, KV, S, D, *, causal=True, window=None, train=True,
               dtype_bytes=2):
    """Analytic (flops, hbm_bytes) per flash-attention call
    (``ops.cost_model``, the reference's own accounting).

    flops: 2 matmuls fwd (QKᵀ, PV) = 4·B·H·S_eff·S·D; bwd adds 3 matmul
    pairs + recompute ≈ 2.5× fwd.  causal/window halve/shrink S_eff.
    hbm_bytes: q,k,v read + o written (+ lse), ×3 passes for bwd (re-read in
    dKdV and dQ) + gradient writes — O(S·D), never O(S²).
    """
    frac = 0.5 if causal else 1.0
    if window is not None and window < S:
        frac = min(frac, window / S)
    fwd_flops = 4 * B * H * S * S * D * frac
    flops = fwd_flops * (1 + 2.5 if train else 1)
    qkv = B * (H + 2 * KV) * S * D * dtype_bytes
    o = B * H * S * D * dtype_bytes
    lse = B * H * S * 4
    passes = 3 if train else 1
    grads = (qkv + o) if train else 0
    return flops, qkv * passes + o + lse * passes + grads
