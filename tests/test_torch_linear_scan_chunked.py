"""The chunked order of the CUDA linear-scan kernels (csrc/linear_scan.cuh,
linear_scan.cu, linear_scan_bwd.cu), emulated in numpy fp32, against the
JAX reference's definitional scan (backend "seq") and its custom VJP.

The kernels cannot run here (no CUDA), so these tests hold their
arithmetic: a thread folds L steps into a summary (P, Q) from a zero
carry, a tile's nw chunks combine their summaries in order (forward) or
in reverse (backward: the carry is mu = a_{t1} * lambda_{t1}), each chunk
re-walks its steps from its true carry, tiles pass the carry on, and
steps past T are the identity.  FMAs are taken in float64 and rounded
once to fp32.  Tolerances are the kernel-versus-plain bounds of
tests/test_torch_cuda.py: 1e-5 in fp32, 2e-2 in bf16 (against the port's
plain version, which the kernels are held to on the card)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.linear_scan import ops as jops
from repro_torch.kernels.linear_scan import ref as tref

F32 = np.float32


def _fma(a, b, c):
    return (a.astype(np.float64) * b + c).astype(F32)


def _bf16(x):
    return torch.from_numpy(np.ascontiguousarray(x, F32)).bfloat16() \
        .float().numpy()


def _tiles(x, L, nw, fill):
    """(B, T, D) -> (B, n_tiles, nw, L, D), padded past T with ``fill``."""
    B, T, D = x.shape
    tile = L * nw
    n = -(-T // tile)
    pad = np.full((B, n * tile - T, D), fill, F32)
    return np.concatenate([x.astype(F32), pad], 1).reshape(B, n, nw, L, D)


def chunked_fwd(a, b, h0, L, nw):
    """h in linear_scan.cu's order."""
    B, T, D = a.shape
    A, Bv = _tiles(a, L, nw, 1.0), _tiles(b, L, nw, 0.0)
    out = np.empty_like(A)
    carry = h0.astype(F32)
    for it in range(A.shape[1]):
        av, bv = A[:, it], Bv[:, it]                      # (B, nw, L, D)
        P, Q = np.ones((B, nw, D), F32), np.zeros((B, nw, D), F32)
        for u in range(L):
            Q = _fma(av[:, :, u], Q, bv[:, :, u])
            P = (P * av[:, :, u]).astype(F32)
        h = np.empty((B, nw, D), F32)
        for j in range(nw):
            h[:, j] = carry
            carry = _fma(P[:, j], carry, Q[:, j])
        for u in range(L):
            h = _fma(av[:, :, u], h, bv[:, :, u])
            out[:, it, :, u] = h
    return out.reshape(B, -1, D)[:, :T]


def chunked_bwd(a, h, h0, g, L, nw, rnd=lambda x: x):
    """(da, db, dh0) in linear_scan_bwd.cu's order; ``rnd`` rounds lambda
    to the input type before da and dh0 are formed."""
    B, T, D = a.shape
    h_prev = np.concatenate([h0[:, None], h[:, :-1]], 1)
    A, G = _tiles(a, L, nw, 1.0), _tiles(g, L, nw, 0.0)
    H = _tiles(h_prev, L, nw, 0.0)
    da, db = np.empty_like(A), np.empty_like(A)
    mu = np.zeros((B, D), F32)
    dh0 = None
    for it in reversed(range(A.shape[1])):
        av, gv, hv = A[:, it], G[:, it], H[:, it]
        lam, P = gv[:, :, L - 1], av[:, :, L - 1]
        for u in reversed(range(L - 1)):
            lam = _fma(av[:, :, u + 1], lam, gv[:, :, u])
            P = (P * av[:, :, u]).astype(F32)
        Q = (av[:, :, 0] * lam).astype(F32)
        m = np.empty((B, nw, D), F32)
        for j in reversed(range(nw)):
            m[:, j] = mu
            mu = _fma(P[:, j], mu, Q[:, j])
        for u in reversed(range(L)):
            lam = (gv[:, :, u] + m).astype(F32) if u == L - 1 else \
                _fma(av[:, :, u + 1], lam, gv[:, :, u])
            lr = rnd(lam)
            db[:, it, :, u] = lr
            da[:, it, :, u] = (lr * hv[:, :, u]).astype(F32)
        if it == 0:
            dh0 = (av[:, 0, 0] * lr[:, 0]).astype(F32)
    return (da.reshape(B, -1, D)[:, :T], db.reshape(B, -1, D)[:, :T], dh0)


def _inputs(B, T, D, seed):
    rng = np.random.default_rng(seed)
    z = 1.0 / (1.0 + np.exp(-rng.standard_normal((B, T, D))))
    a = (1.0 - z).astype(F32)
    b = (z * rng.standard_normal((B, T, D))).astype(F32)
    h0 = rng.standard_normal((B, D)).astype(F32)
    g = rng.standard_normal((B, T, D)).astype(F32)
    return a, b, h0, g


# (B, T, D, L, nw): T of one step, one below / above a chunk, one above a
# whole tile, several tiles, a ragged last tile, 4-step chunks, 16-step
# chunks over several tiles, the LM's prefill chunk as the forward takes
# it (one tile of 16 x 16) and the backward (32 x 8)
CASES = [
    (2, 1, 7, 8, 4),
    (1, 7, 5, 8, 4),
    (1, 9, 5, 8, 4),
    (2, 33, 6, 8, 4),
    (1, 200, 3, 8, 4),
    (3, 77, 10, 4, 16),
    (2, 300, 4, 16, 8),
    (1, 256, 4, 16, 16),
    (1, 256, 4, 8, 32),
]


@pytest.mark.parametrize("case", CASES, ids=str)
def test_chunked_forward_matches_reference(case):
    B, T, D, L, nw = case
    a, b, h0, _ = _inputs(B, T, D, seed=T)
    want = jops.linear_scan(jnp.asarray(a), jnp.asarray(b), jnp.asarray(h0),
                            "seq")
    got = chunked_fwd(a, b, h0, L, nw)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("case", CASES, ids=str)
def test_chunked_backward_matches_reference_vjp(case):
    B, T, D, L, nw = case
    a, b, h0, g = _inputs(B, T, D, seed=T + 1)
    ja, jb, jh0 = map(jnp.asarray, (a, b, h0))
    h, vjp = jax.vjp(lambda *x: jops.linear_scan(*x, "seq"), ja, jb, jh0)
    want = vjp(jnp.asarray(g))
    got = chunked_bwd(a, np.asarray(h), h0, g, L, nw)
    for name, x, y in zip(("da", "db", "dh0"), got, want):
        np.testing.assert_allclose(x, np.asarray(y), atol=1e-5, rtol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("case", [(2, 33, 6, 8, 4), (3, 77, 10, 4, 16)],
                         ids=str)
def test_chunked_bf16_matches_plain_version(case):
    """bf16 inputs: h rounded once from the fp32 carry; lambda rounded
    before da and dh0 — within 2e-2 of the port's plain versions."""
    B, T, D, L, nw = case
    a, b, h0, g = (_bf16(x) for x in _inputs(B, T, D, seed=T + 2))
    h = _bf16(chunked_fwd(a, b, h0, L, nw))
    t = [torch.from_numpy(x).bfloat16() for x in (a, b, h0, g)]
    want_h = tref.linear_scan_associative(*t[:3])
    np.testing.assert_allclose(h, want_h.float().numpy(), atol=2e-2,
                               rtol=2e-2)
    got = [_bf16(x) for x in chunked_bwd(a, h, h0, g, L, nw, rnd=_bf16)]
    want = tref.linear_scan_bwd(t[0], torch.from_numpy(h).bfloat16(), t[2],
                                t[3])
    for name, x, y in zip(("da", "db", "dh0"), got, want):
        np.testing.assert_allclose(x, y.float().numpy(), atol=2e-2,
                                   rtol=2e-2, err_msg=name)
