"""The linear-scan kernels' wrappers, the differentiable scan and the
backend dispatch (port of ``repro.kernels.linear_scan.ops``).

``linear_scan_kernel`` runs the hand-written CUDA kernel
(``csrc/linear_scan.cu``, which replaces the TPU kernel
``linear_scan_pallas``) on CUDA tensors and its plain version,
:func:`ref.linear_scan_associative`, on CPU tensors.
``linear_scan_bwd_kernel`` does the same for the reverse-time adjoint
(``csrc/linear_scan_bwd.cu``, which replaces the reference's rerun of
``linear_scan_pallas`` in its custom VJP) with :func:`ref.linear_scan_bwd`
as its plain version.  Each counts its launches in ``<wrapper>.launches``.

:class:`LinearScan` is the reference's custom VJP as an
``autograd.Function``: it saves (a, h, h0), not b, and its backward is
the adjoint scan of the same backend.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import SCAN_BACKENDS as BACKENDS
from repro_torch.kernels import build, check_devices, on_cpu
from repro_torch.kernels.linear_scan import ref


def _check(what, tensors, names):
    """Device, dtype and contiguity checks shared by both CUDA wrappers:
    every tensor on one CUDA device, of one dtype (fp32 or bf16),
    contiguous."""
    check_devices(what, *tensors)
    first = tensors[0]
    if first.dtype not in (torch.float32, torch.bfloat16) or any(
            t.dtype != first.dtype for t in tensors):
        raise ValueError(f"{what}: {', '.join(names)} must share one dtype "
                         "of fp32/bf16, got "
                         + ", ".join(str(t.dtype) for t in tensors))
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what}: inputs must be contiguous")
    B, T, D = first.shape
    if max(B, T, D) >= 2**31 or B > 65535:
        raise ValueError(f"{what}: shape {tuple(first.shape)} too large for "
                         "one launch")


def linear_scan_kernel(a, b, h0):
    """h_t = a_t ⊙ h_{t-1} + b_t over axis 1. a, b: (B, T, D); h0: (B, D),
    all of one dtype (fp32 or bf16); returns h (B, T, D) in that dtype."""
    if on_cpu(a, b, h0):
        return ref.linear_scan_associative(a, b, h0)
    if a.dim() != 3 or b.shape != a.shape or h0.shape != (a.shape[0],
                                                          a.shape[2]):
        raise ValueError(f"linear_scan_kernel: shapes a {tuple(a.shape)}, "
                         f"b {tuple(b.shape)}, h0 {tuple(h0.shape)}")
    _check("linear_scan_kernel", (a, b, h0), ("a", "b", "h0"))
    B, T, D = a.shape
    out = torch.empty_like(a)
    if out.numel() == 0:
        return out
    lib = build.load("linear_scan")
    fn = lib.linear_scan_bf16 if a.dtype == torch.bfloat16 \
        else lib.linear_scan_f32
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = fn(a.data_ptr(), b.data_ptr(), h0.data_ptr(), out.data_ptr(),
             B, T, D, stream)
    build.check(err, "linear_scan")
    linear_scan_kernel.launches += 1
    return out


linear_scan_kernel.launches = 0


def linear_scan_bwd_kernel(a, h, h0, g):
    """Cotangents (da, db, dh0) of the scan, given its inputs a (B, T, D)
    and h0 (B, D), its output h and the output's cotangent g (B, T, D),
    all of one dtype (fp32 or bf16).  λ carries in fp32 and is rounded to
    that dtype before da and dh0 are formed from it (the reference's
    order: its scan stores λ in the dtype, then multiplies)."""
    if on_cpu(a, h, h0, g):
        return ref.linear_scan_bwd(a, h, h0, g)
    if a.dim() != 3 or h.shape != a.shape or g.shape != a.shape or \
            h0.shape != (a.shape[0], a.shape[2]):
        raise ValueError(f"linear_scan_bwd_kernel: shapes a "
                         f"{tuple(a.shape)}, h {tuple(h.shape)}, g "
                         f"{tuple(g.shape)}, h0 {tuple(h0.shape)}")
    _check("linear_scan_bwd_kernel", (a, h, h0, g), ("a", "h", "h0", "g"))
    B, T, D = a.shape
    da, db = torch.empty_like(a), torch.empty_like(a)
    dh0 = torch.empty_like(h0)
    if T == 0:
        return da, db, dh0.zero_()
    if da.numel() == 0:
        return da, db, dh0
    lib = build.load("linear_scan_bwd")
    fn = lib.linear_scan_bwd_bf16 if a.dtype == torch.bfloat16 \
        else lib.linear_scan_bwd_f32
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = fn(a.data_ptr(), g.data_ptr(), h.data_ptr(), h0.data_ptr(),
             da.data_ptr(), db.data_ptr(), dh0.data_ptr(), B, T, D, stream)
    build.check(err, "linear_scan_bwd")
    linear_scan_bwd_kernel.launches += 1
    return da, db, dh0


linear_scan_bwd_kernel.launches = 0


def _dispatch(a, b, h0, backend):
    if backend == "kernel":
        return linear_scan_kernel(a, b, h0)
    if backend == "assoc":
        return ref.linear_scan_associative(a, b, h0)
    if backend == "seq":
        return ref.linear_scan_sequential(a, b, h0)
    raise ValueError(f"unknown backend {backend!r} (one of {BACKENDS})")


class LinearScan(torch.autograd.Function):
    """h = scan(a, b, h0) with the reference's custom VJP
    (``ops.linear_scan``'s ``_fwd``/``_bwd``): the backward is the
    reverse-time scan of the same backend — the CUDA adjoint kernel for
    ``kernel`` on CUDA tensors, the plain flip-shift-scan otherwise."""

    @staticmethod
    def forward(ctx, a, b, h0, backend):
        h = _dispatch(a, b, h0, backend)
        ctx.backend = backend
        ctx.save_for_backward(a, h, h0)
        return h

    @staticmethod
    def backward(ctx, g):
        a, h, h0 = ctx.saved_tensors
        g = g.to(h.dtype).contiguous()
        if a.shape[1] == 0:
            return torch.zeros_like(a), torch.zeros_like(a), \
                torch.zeros_like(h0), None
        if ctx.backend == "kernel":
            da, db, dh0 = linear_scan_bwd_kernel(a, h, h0, g)
        elif ctx.backend == "seq":
            da, db, dh0 = ref.linear_scan_bwd(
                a, h, h0, g, scan=ref.linear_scan_sequential)
        else:
            da, db, dh0 = ref.linear_scan_bwd(a, h, h0, g)
        return da, db, dh0, None


def linear_scan(a, b, h0, backend="kernel"):
    """h_t = a_t ⊙ h_{t-1} + b_t over axis 1. a, b: (B,T,D); h0: (B,D).
    Differentiable in a, b and h0 (:class:`LinearScan`)."""
    return LinearScan.apply(a, b, h0, backend)


def mingru_scan(z, htilde, h0, **kw):
    """minGRU state update (paper Eq. 1): h_t = (1−z_t)⊙h_{t−1} + z_t⊙h̃_t."""
    return linear_scan(1.0 - z, z * htilde, h0, **kw)
