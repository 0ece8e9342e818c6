"""Plain PyTorch versions of the fused selective scan (Mamba-1 SSM core;
port of ``repro.kernels.fused_ssm.ref``):

    a_t = exp(dt_t ⊙ A)                    (B, T, di, n)
    h_t = a_t ⊙ h_{t-1} + (dt_t ⊙ x_t) ⊗ B_t
    y_t = Σ_n h_t ⊙ C_t

:func:`selective_scan_ref` is the reference's oracle: it materializes a,
b and h, and autograd through it is the oracle of the gradients.
:func:`fused_ssm_fwd_ref` and :func:`fused_ssm_bwd_ref` are the plain
versions of the two CUDA kernels, with their outputs: a walk over time
that keeps only the (B, di, n) state, the chunk-entry states every
``chunk`` steps, and a backward that recomputes each chunk's trajectory
from its entry state, walking the chunks in reverse, and runs the
reference's λ recurrence (``_bwd_kernel``,
``src/repro/kernels/fused_ssm/fused_ssm.py:59-109``).  The CPU path and
the tests use them; ``chip_smoke.py`` holds the kernels to them.
"""
from __future__ import annotations

import torch


def selective_scan_ref(dt, x, Bm, Cm, A):
    """dt, x: (B, T, di); Bm, Cm: (B, T, n); A: (di, n) -> y (B, T, di)."""
    a = torch.exp(dt[..., None] * A)                       # (B, T, di, n)
    b = (dt * x)[..., None] * Bm[:, :, None, :]            # (B, T, di, n)
    h = torch.zeros_like(a[:, 0])
    hs = []
    for t in range(x.shape[1]):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    hs = torch.stack(hs, 1) if hs else a
    return torch.einsum("btdn,btn->btd", hs, Cm)


def fused_ssm_fwd_ref(dt, x, Bm, Cm, A, chunk, h0=None, h_last=None):
    """The forward kernel's plain version: (y (B, T, di) in x's dtype,
    h_entries (B, ceil(T / chunk), di, n) fp32), h_entries[:, c] being the
    state before step c·chunk.  Computes in fp32, from the state ``h0``
    (None: zeros); ``h_last``, if given, receives the final state."""
    B, T, di = x.shape
    n = A.shape[1]
    out_dtype = x.dtype
    dt, x, Bm, Cm = (t.float() for t in (dt, x, Bm, Cm))
    A = A.float()
    y = torch.empty(B, T, di, dtype=torch.float32, device=x.device)
    entries = torch.empty(B, -(-T // chunk), di, n, dtype=torch.float32,
                          device=x.device)
    h = torch.zeros(B, di, n, dtype=torch.float32, device=x.device) \
        if h0 is None else h0.float()
    for t in range(T):
        if t % chunk == 0:
            entries[:, t // chunk] = h
        a = torch.exp(dt[:, t, :, None] * A)
        h = a * h + (dt[:, t] * x[:, t])[..., None] * Bm[:, t, None, :]
        y[:, t] = (h * Cm[:, t, None, :]).sum(-1)
    if h_last is not None:
        h_last.copy_(h)
    return y.to(out_dtype), entries


def fused_ssm_bwd_ref(dt, x, Bm, Cm, A, h_entries, dy, chunk):
    """The backward kernel's plain version: cotangents (ddt, dx, dB, dC,
    dA) in fp32 of the scan's inputs, given the forward's chunk-entry
    states and the output cotangent dy (B, T, di).  Per chunk, last to
    first: the trajectory recomputed from the chunk's entry state, then
    the reverse walk

        dh_t  = dy_t ⊗ C_t + λ_{t+1},   λ_t = dh_t ⊙ a_t
        ddt_t = Σ_n dh_t h_{t-1} A a_t + x_t Σ_n dh_t B_t
        dx_t  = dt_t Σ_n dh_t B_t
        dB_t  = Σ_d dh_t (dt_t x_t),    dC_t = Σ_d dy_t h_t
        dA    = Σ_{b,t} dh_t h_{t-1} dt_t a_t
    """
    B, T, di = x.shape
    dt, x, Bm, Cm, dy = (t.float() for t in (dt, x, Bm, Cm, dy))
    A = A.float()
    ddt, dx = torch.empty_like(dt), torch.empty_like(x)
    dB, dC = torch.empty_like(Bm), torch.empty_like(Cm)
    dA = torch.zeros(B, *A.shape, dtype=torch.float32, device=x.device)
    lam = torch.zeros_like(dA)
    for c in reversed(range(h_entries.shape[1])):
        t0, t1 = c * chunk, min(T, (c + 1) * chunk)
        traj = [h_entries[:, c].float()]
        for t in range(t0, t1):
            a = torch.exp(dt[:, t, :, None] * A)
            traj.append(a * traj[-1]
                        + (dt[:, t] * x[:, t])[..., None] * Bm[:, t, None, :])
        for t in reversed(range(t0, t1)):
            a = torch.exp(dt[:, t, :, None] * A)
            h_prev, h_t = traj[t - t0], traj[t - t0 + 1]
            dh = dy[:, t, :, None] * Cm[:, t, None, :] + lam
            dC[:, t] = (dy[:, t, :, None] * h_t).sum(1)
            da = dh * h_prev
            s = (dh * Bm[:, t, None, :]).sum(-1)
            ddt[:, t] = (da * A * a).sum(-1) + s * x[:, t]
            dx[:, t] = dt[:, t] * s
            dB[:, t] = (dh * (dt[:, t] * x[:, t])[..., None]).sum(1)
            dA = dA + da * dt[:, t, :, None] * a
            lam = dh * a
    return ddt, dx, dB, dC, dA.sum(0)
