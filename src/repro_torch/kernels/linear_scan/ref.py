"""Plain PyTorch versions of the diagonal linear recurrence (port of
``repro.kernels.linear_scan.ref``)

    h_t = a_t ⊙ h_{t-1} + b_t ,   t = 0..T-1,  h_{-1} = h0

the minGRU state update (a = 1 - z, b = z ⊙ h̃, paper Eq. 1).

  * ``linear_scan_sequential``  — the definitional loop (ground truth;
    carries in the inputs' dtype, as the reference's ``lax.scan`` does)
  * ``linear_scan_associative`` — the log-depth parallel form with fp32
    accumulation, the plain version of the CUDA kernel
  * ``linear_scan_bwd`` — the adjoint, written as the reference's custom
    VJP writes it (``repro.kernels.linear_scan.ops._bwd``): the same scan
    on time-flipped, shifted inputs; the plain version of the CUDA kernel
    ``csrc/linear_scan_bwd.cu``
"""
from __future__ import annotations

import torch


def linear_scan_sequential(a, b, h0):
    """a, b: (B, T, D); h0: (B, D) -> h: (B, T, D)."""
    h = h0
    hs = []
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    if not hs:
        return torch.empty_like(b)
    return torch.stack(hs, dim=1)


def linear_scan_associative(a, b, h0):
    """Inclusive scan of the associative operator
    (a2, b2) ∘ (a1, b1) = (a1·a2, a2·b1 + b2) in fp32, by recursive
    doubling (log2 T passes); output in ``a.dtype``."""
    dt = a.dtype
    T = a.shape[1]
    acc_a = a.float()
    acc_b = b.float().clone()
    if T == 0:
        return acc_b.to(dt)
    # fold h0 into the first step: b_0' = a_0·h0 + b_0
    acc_b[:, 0] += acc_a[:, 0] * h0.float()
    off = 1
    while off < T:
        acc_b = torch.cat([acc_b[:, :off],
                           acc_a[:, off:] * acc_b[:, :-off] + acc_b[:, off:]],
                          dim=1)
        acc_a = torch.cat([acc_a[:, :off], acc_a[:, off:] * acc_a[:, :-off]],
                          dim=1)
        off *= 2
    return acc_b.to(dt)


def linear_scan_bwd(a, h, h0, g, scan=linear_scan_associative):
    """Cotangents of h_t = a_t ⊙ h_{t-1} + b_t.  a, h, g: (B, T, D);
    h0: (B, D).  The adjoint is a reverse-time scan of the same form,

        λ_t = g_t + a_{t+1} ⊙ λ_{t+1}      (λ_{T-1} = g_{T-1})
        da_t = λ_t ⊙ h_{t-1},  db_t = λ_t,  dh0 = a_0 ⊙ λ_0,

    run by ``scan`` on flipped inputs with a shifted one step forward in
    time.  λ is the scan's output in the inputs' dtype, and da, dh0 are
    products in that dtype.  Returns (da, db, dh0)."""
    a_shift = torch.cat([torch.zeros_like(a[:, :1]),
                         torch.flip(a[:, 1:], dims=(1,))], dim=1)
    lam = torch.flip(scan(a_shift, torch.flip(g, dims=(1,)),
                          torch.zeros_like(h0)), dims=(1,))
    h_prev = torch.cat([h0[:, None, :], h[:, :-1, :]], dim=1)
    return lam * h_prev, lam, a[:, 0, :] * lam[:, 0, :]


def mingru_ref(x, wh, bh, wz, bz, h0, *, gate_fn, out_fn):
    """Full minGRU block oracle: projections + gate + scan + output act."""
    htilde = x @ wh + bh
    z = gate_fn(x @ wz + bz)
    h = linear_scan_sequential(1.0 - z, z * htilde, h0)
    return out_fn(h), h
