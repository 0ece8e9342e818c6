"""The linear-scan kernel's wrapper and the backend dispatch (port of
``repro.kernels.linear_scan.ops``).

``linear_scan_kernel`` runs the hand-written CUDA kernel
(``csrc/linear_scan.cu``, which replaces the TPU kernel
``linear_scan_pallas``) on CUDA tensors and its plain version,
:func:`ref.linear_scan_associative`, on CPU tensors.  It counts its
launches in ``linear_scan_kernel.launches``.

Forward only: the reverse-time backward of the reference's custom VJP
is not ported yet (the serving path runs under ``torch.inference_mode``).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import SCAN_BACKENDS as BACKENDS
from repro_torch.kernels import build
from repro_torch.kernels.linear_scan import ref


def linear_scan_kernel(a, b, h0):
    """h_t = a_t ⊙ h_{t-1} + b_t over axis 1. a, b: (B, T, D); h0: (B, D),
    all of one dtype (fp32 or bf16); returns h (B, T, D) in that dtype."""
    if a.device.type == "cpu":
        return ref.linear_scan_associative(a, b, h0)
    if a.device.type != "cuda":
        raise ValueError(f"linear_scan_kernel: unsupported device {a.device}")
    if a.dim() != 3 or b.shape != a.shape or h0.shape != (a.shape[0],
                                                          a.shape[2]):
        raise ValueError(f"linear_scan_kernel: shapes a {tuple(a.shape)}, "
                         f"b {tuple(b.shape)}, h0 {tuple(h0.shape)}")
    if a.dtype not in (torch.float32, torch.bfloat16) or not (
            b.dtype == h0.dtype == a.dtype):
        raise ValueError("linear_scan_kernel: a, b, h0 must share one dtype "
                         f"of fp32/bf16, got {a.dtype}, {b.dtype}, {h0.dtype}")
    if not (a.is_contiguous() and b.is_contiguous() and h0.is_contiguous()):
        raise ValueError("linear_scan_kernel: inputs must be contiguous")
    if not (b.device == h0.device == a.device):
        raise ValueError("linear_scan_kernel: inputs on different devices")
    B, T, D = a.shape
    if max(B, T, D) >= 2**31 or B > 65535:
        raise ValueError(f"linear_scan_kernel: shape {tuple(a.shape)} too "
                         "large for one launch")
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


def linear_scan(a, b, h0, backend="kernel"):
    """h_t = a_t ⊙ h_{t-1} + b_t over axis 1. a, b: (B,T,D); h0: (B,D)."""
    if backend == "kernel":
        return linear_scan_kernel(a, b, h0)
    if backend == "assoc":
        return ref.linear_scan_associative(a, b, h0)
    if backend == "seq":
        return ref.linear_scan_sequential(a, b, h0)
    raise ValueError(f"unknown backend {backend!r} (one of {BACKENDS})")


def mingru_scan(z, htilde, h0, **kw):
    """minGRU state update (paper Eq. 1): h_t = (1−z_t)⊙h_{t−1} + z_t⊙h̃_t."""
    return linear_scan(1.0 - z, z * htilde, h0, **kw)
