"""Plain PyTorch versions of the diagonal linear recurrence (port of
``repro.kernels.linear_scan.ref``)

    h_t = a_t ⊙ h_{t-1} + b_t ,   t = 0..T-1,  h_{-1} = h0

the minGRU state update (a = 1 - z, b = z ⊙ h̃, paper Eq. 1).

  * ``linear_scan_sequential``  — the definitional loop (ground truth;
    carries in the inputs' dtype, as the reference's ``lax.scan`` does)
  * ``linear_scan_associative`` — the log-depth parallel form with fp32
    accumulation, the plain version of the CUDA kernel
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


def mingru_ref(x, wh, bh, wz, bz, h0, *, gate_fn, out_fn):
    """Full minGRU block oracle: projections + gate + scan + output act."""
    htilde = x @ wh + bh
    z = gate_fn(x @ wz + bz)
    h = linear_scan_sequential(1.0 - z, z * htilde, h0)
    return out_fn(h), h
