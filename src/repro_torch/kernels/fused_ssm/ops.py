"""The fused selective scan: the CUDA kernels' wrappers, the
differentiable op and the analytic cost model (port of
``repro.kernels.fused_ssm.ops``).

``fused_ssm_fwd_kernel`` runs ``csrc/fused_ssm_fwd.cu`` (which replaces
the TPU kernel ``fused_ssm_fwd``) on CUDA tensors and its plain version,
:func:`ref.fused_ssm_fwd_ref`, on CPU tensors; ``fused_ssm_bwd_kernel``
runs ``csrc/fused_ssm_bwd.cu`` (which replaces ``fused_ssm_bwd``) and
sums its dB, dC and dA partials, or runs :func:`ref.fused_ssm_bwd_ref`.
They run the plain version only when every input lies on the CPU;
otherwise they launch or raise (inputs on several devices, or on one
that is not CUDA, raise).  Each counts its launches in
``<wrapper>.launches``.

:class:`SelectiveScan` is the reference's custom VJP as an
``autograd.Function``: it saves (dt, x, Bm, Cm, A, h_entries) and its
backward is ``fused_ssm_bwd_kernel``.  The kernels compute in fp32 and
take fp32 inputs, as the model's SSM tail is (``models.mamba``); the op
takes other float types by computing in fp32 and casting the results
back, as the reference's kernels do inside.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.common import pow2ceil
from repro_torch.kernels import build, check_devices, on_cpu
from repro_torch.kernels.fused_ssm import ref

#: Time steps per chunk-entry state (``kChunk`` of ``csrc/fused_ssm.cuh``,
#: which the C entry points check).
CHUNK = 32
#: The largest state size the kernels take (two lanes of 16 states a
#: channel).
MAX_STATE = 32


def n_chunks(T):
    return -(-T // CHUNK)


def block_channels(n):
    """Channels a block of both kernels covers at state size n
    (``ssm::config_for``): 256 with one lane a channel (n <= 16), 128 with
    two (16 < n <= 32)."""
    return 256 if pow2ceil(n) <= 16 else 128


def d_blocks(di, n):
    """Blocks along d_inner of both kernels, and so the partial dB/dC rows
    a batch row of the backward writes: each sums block_channels(n)
    channels on chip."""
    return -(-di // block_channels(n))


def partial_bytes(B, T, di, n):
    """Bytes of the dB and dC partials (B, d_blocks, T, n) fp32 one
    backward call writes and its wrapper's sums read."""
    return 2 * 4 * B * d_blocks(di, n) * T * n


def kernel_info(which, n):
    """What the build made of the ``which`` ("fwd" or "bwd") kernel at
    state size n: registers and local (spill and stack) bytes a thread,
    dynamic shared bytes, resident blocks an SM, threads and channels a
    block (``ssm::kernel_info``).  Needs the CUDA toolkit and a device."""
    name = f"fused_ssm_{which}"
    out = (ctypes.c_int * 6)()
    build.check(getattr(build.load(name), f"{name}_info")(
        n, ctypes.addressof(out)), name)
    return dict(zip(("registers", "local_bytes", "smem_bytes",
                     "blocks_per_sm", "threads", "channels"), out))


def _check(what, dt, x, Bm, Cm, A, extra=()):
    """Device, dtype, shape and layout checks of both CUDA wrappers;
    raises on anything the kernels do not take."""
    tensors = (dt, x, Bm, Cm, A) + tuple(extra)
    check_devices(what, *tensors)
    if any(t.dtype != torch.float32 for t in tensors):
        raise ValueError(f"{what}: the kernels take float32 inputs, got "
                         + ", ".join(str(t.dtype) for t in tensors))
    if x.dim() != 3 or dt.shape != x.shape or Bm.dim() != 3 or \
            Cm.shape != Bm.shape or Bm.shape[:2] != x.shape[:2] or \
            A.dim() != 2 or A.shape != (x.shape[2], Bm.shape[2]):
        raise ValueError(f"{what}: shapes dt {tuple(dt.shape)}, x "
                         f"{tuple(x.shape)}, Bm {tuple(Bm.shape)}, Cm "
                         f"{tuple(Cm.shape)}, A {tuple(A.shape)}")
    B, T, di = x.shape
    n = A.shape[1]
    if not 1 <= n <= MAX_STATE:
        raise ValueError(f"{what}: state size {n} not in [1, {MAX_STATE}]")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what}: inputs must be contiguous")
    if B > 65535 or max(T, di) >= 2**31:
        raise ValueError(f"{what}: shape {tuple(x.shape)} too large for one "
                         "launch")


def fused_ssm_fwd_kernel(dt, x, Bm, Cm, A, h0=None, h_last=None):
    """dt, x: (B, T, di); Bm, Cm: (B, T, n); A: (di, n), all fp32 ->
    (y (B, T, di), h_entries (B, ceil(T / CHUNK), di, n)): the output and
    the state before every CHUNK-th step.  ``h0`` (B, di, n) fp32 is the
    state before step 0 (None: zeros); ``h_last`` (B, di, n) fp32, if
    given, is overwritten with the state after the last step — the carry
    in and out of a serving prefill chunk."""
    carry = [t for t in (h0, h_last) if t is not None]
    if on_cpu(dt, x, Bm, Cm, A, *carry):
        return ref.fused_ssm_fwd_ref(dt, x, Bm, Cm, A, CHUNK, h0=h0,
                                     h_last=h_last)
    _check("fused_ssm_fwd_kernel", dt, x, Bm, Cm, A, carry)
    B, T, di = x.shape
    n = A.shape[1]
    for t in carry:
        if t.shape != (B, di, n):
            raise ValueError(f"fused_ssm_fwd_kernel: carry {tuple(t.shape)} "
                             f"is not (B, di, n) = {(B, di, n)}")
    y = torch.empty_like(x)
    h_entries = torch.empty(B, n_chunks(T), di, n, dtype=torch.float32,
                            device=x.device)
    if y.numel() == 0:
        if h_last is not None:
            h_last.copy_(h0 if h0 is not None else torch.zeros_like(h_last))
        return y, h_entries.zero_()
    lib = build.load("fused_ssm_fwd")
    err = lib.fused_ssm_fwd_f32(
        dt.data_ptr(), x.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
        A.data_ptr(), None if h0 is None else h0.data_ptr(), y.data_ptr(),
        h_entries.data_ptr(), None if h_last is None else h_last.data_ptr(),
        B, T, di, n, CHUNK, torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "fused_ssm_fwd")
    fused_ssm_fwd_kernel.launches += 1
    return y, h_entries


fused_ssm_fwd_kernel.launches = 0


def fused_ssm_bwd_kernel(dt, x, Bm, Cm, A, h_entries, dy):
    """Cotangents (ddt, dx, dB, dC, dA), fp32, of the scan's inputs given
    the forward's inputs, its ``h_entries`` and the output cotangent dy
    (B, T, di).  The kernel writes dB and dC partials per (batch,
    d-block), each the sum over the block's channels, and dA partials per
    batch; they are summed here in a fixed order."""
    if on_cpu(dt, x, Bm, Cm, A, h_entries, dy):
        return ref.fused_ssm_bwd_ref(dt, x, Bm, Cm, A, h_entries, dy, CHUNK)
    _check("fused_ssm_bwd_kernel", dt, x, Bm, Cm, A, (h_entries, dy))
    B, T, di = x.shape
    n = A.shape[1]
    if dy.shape != x.shape or h_entries.shape != (B, n_chunks(T), di, n):
        raise ValueError(f"fused_ssm_bwd_kernel: dy {tuple(dy.shape)} or "
                         f"h_entries {tuple(h_entries.shape)} do not fit x "
                         f"{tuple(x.shape)} and A {tuple(A.shape)}")
    n_dblk = d_blocks(di, n)
    ddt, dx = torch.empty_like(dt), torch.empty_like(x)
    if ddt.numel() == 0:
        return (ddt, dx, torch.zeros_like(Bm), torch.zeros_like(Cm),
                torch.zeros_like(A))
    dBp = torch.empty(B, n_dblk, T, n, dtype=torch.float32, device=x.device)
    dCp = torch.empty_like(dBp)
    dAp = torch.empty(B, di, n, dtype=torch.float32, device=x.device)
    lib = build.load("fused_ssm_bwd")
    err = lib.fused_ssm_bwd_f32(
        dt.data_ptr(), x.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
        A.data_ptr(), h_entries.data_ptr(), dy.data_ptr(), ddt.data_ptr(),
        dx.data_ptr(), dBp.data_ptr(), dCp.data_ptr(), dAp.data_ptr(), B, T,
        di, n, CHUNK, n_dblk, torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "fused_ssm_bwd")
    fused_ssm_bwd_kernel.launches += 1
    return ddt, dx, dBp.sum(1), dCp.sum(1), dAp.sum(0)


fused_ssm_bwd_kernel.launches = 0


def _f32(t):
    return t.float().contiguous()


class SelectiveScan(torch.autograd.Function):
    """y = selective_scan(dt, x, Bm, Cm, A) with the reference's custom
    VJP (``ops.selective_scan``'s ``_fwd``/``_bwd``): saves (dt, x, Bm,
    Cm, A, h_entries); the backward is :func:`fused_ssm_bwd_kernel`, and
    each cotangent takes its input's dtype."""

    @staticmethod
    def forward(ctx, dt, x, Bm, Cm, A):
        ins = [_f32(t) for t in (dt, x, Bm, Cm, A)]
        y, h_entries = fused_ssm_fwd_kernel(*ins)
        ctx.dtypes = [t.dtype for t in (dt, x, Bm, Cm, A)]
        ctx.save_for_backward(*ins, h_entries)
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        *ins, h_entries = ctx.saved_tensors
        grads = fused_ssm_bwd_kernel(*ins, h_entries, _f32(dy))
        return tuple(g.to(dtype) for g, dtype in zip(grads, ctx.dtypes))


def selective_scan(dt, x, Bm, Cm, A):
    """dt, x: (B, T, di); Bm, Cm: (B, T, n); A: (di, n) -> y (B, T, di)
    in x's dtype.  Differentiable in every input (:class:`SelectiveScan`)."""
    return SelectiveScan.apply(dt, x, Bm, Cm, A)


def cost_model(B, T, di, n, *, train=True, dtype_bytes=2, tblk=256):
    """Analytic (flops, hbm_bytes) per fused selective-scan call
    (``ops.cost_model``, the reference's own accounting).

    flops: fwd ≈ 6 VPU ops per (t, d, n) element (exp, 2 mul-add for the
    recurrence, mul-add for y) ⇒ 6·B·T·di·n; bwd ≈ 2.5× (recompute + grads).
    hbm_bytes: inputs dt,x (B·T·di), B,C (B·T·n), y out, chunk-entry
    residuals (B·T/tblk·di·n fp32); bwd re-reads inputs + writes grads.
    The (B,T,di,n) a/b/h tensors NEVER touch HBM — that is the point.
    """
    el = B * T * di * n
    flops = 6 * el * (3.5 if train else 1.0)
    io = (2 * B * T * di + 2 * B * T * n) * dtype_bytes
    resid = (B * (T // tblk) * di * n) * 4
    out = B * T * di * dtype_bytes
    if train:
        return flops, 2 * io + 2 * out + 2 * resid + io  # re-read + grads
    return flops, io + out + resid
