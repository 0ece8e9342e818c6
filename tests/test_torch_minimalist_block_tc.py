"""The sequence kernel's tensor-core arithmetic (csrc/minimalist_block.cu),
modelled in plain PyTorch on the CPU and held to the reference.

The model follows the kernel's tiling (``ops.block_plan``'s slab and the
source's kChunk and kPanel): x split into three bf16 parts (hi, mid, lo),
the levels c - 1.5 in bf16, K zero-filled to whole 64-column panels and
N to whole slabs, each 16-column k-step of a part summed
exactly and added to an fp32 accumulator (the order of the kernel's
wgmmas: panel, part, k-step), the epilogue in the plain version's op
order, and T cut into 64-frame chunks with h carried across them.  On
binary x it must equal the plain version bit for bit; on analog x its h
must stay within 2e-5 of the reference's Pallas kernel in interpret mode
away from a gate-code tie (a chain is compared up to its first gate
value within 1e-3 of a code step), with Θ flips only where |h| < 1e-4.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jq
from repro.kernels.minimalist_block import ops as jops
from repro_torch.kernels.minimalist_block import ops as tops
from repro_torch.kernels.minimalist_block import ref as tref

torch.set_num_threads(1)

# csrc/minimalist_block.cu's kChunk (frames a chunk) and kPanel (K columns
# a panel), and an H100 SXM's SMs for the plan's slab
CHUNK, PANEL, SMS = 64, 64, 132


def _parts(x):
    """fp32 x -> three bf16 parts (as fp32) whose sum is x exactly."""
    parts, r = [], x
    for _ in range(3):
        p = r.to(torch.bfloat16).float()
        parts.append(p)
        r = r - p
    assert torch.equal(parts[0] + parts[1] + parts[2], x)
    return parts


def _tc_model(x, ch, cz, scale, bh, bz, h0):
    """The kernel's arithmetic: (y, h) each (B, T, N)."""
    B, T, K = x.shape
    N = ch.shape[1]
    slab, _ = tops.block_plan(B, N, SMS)
    chunk, chunks = CHUNK, -(-T // CHUNK)
    kpad = max(1, -(-K // PANEL)) * PANEL
    npad = -(-N // slab) * slab
    lv = torch.zeros(2, kpad, npad)
    for i, codes in enumerate((ch, cz)):
        lv[i, :K, :N] = (codes.float() - 1.5).to(torch.bfloat16).float()
    xp = torch.zeros(B, chunks * chunk, kpad)
    xp[:, :T, :K] = x
    parts = _parts(xp)
    bias = torch.zeros(2, npad)
    bias[0, :N], bias[1, :N] = bh, bz
    code = torch.arange(64, dtype=torch.float32)
    z_of = code / 63.0
    h = torch.zeros(B, npad)
    h[:, :N] = h0
    hs = []
    for c in range(chunks):
        rows = slice(c * chunk, (c + 1) * chunk)
        acc = torch.zeros(2, B, chunk, npad)
        for p0 in range(0, kpad, PANEL):
            for part in parts:
                for k0 in range(p0, p0 + PANEL, 16):
                    a = part[:, rows, k0:k0 + 16].double()
                    for i in range(2):
                        acc[i] = (acc[i].double()
                                  + a @ lv[i, k0:k0 + 16].double()).float()
        pre_h = (acc[0] + 0.0) * scale + bias[0]
        pre_z = (acc[1] + 0.0) * scale + bias[1]
        v = torch.clamp(pre_z / 6.0 + 0.5, 0.0, 1.0)
        idx = torch.floor(v * 63.0).long()
        z = z_of[idx]
        zp, omz = z * pre_h, 1.0 - z
        for t in range(min(chunk, T - c * chunk)):
            h = zp[:, t] + omz[:, t] * h
            hs.append(h[:, :N])
    h_seq = torch.stack(hs, dim=1)
    return (h_seq > 0.0).float(), h_seq


def _inputs(B, T, K, N, seed, *, binary=True):
    rng = np.random.default_rng(seed)
    x = rng.random((B, T, K)).astype(np.float32)
    if binary:
        x = (x > 0.5).astype(np.float32)
    ch = rng.integers(0, 4, (K, N)).astype(np.int8)
    cz = rng.integers(0, 4, (K, N)).astype(np.int8)
    bh = (rng.standard_normal(N) * 0.5).astype(np.float32)
    bz = (rng.standard_normal(N) * 0.5).astype(np.float32)
    h0 = rng.standard_normal((B, N)).astype(np.float32)
    return x, ch, cz, bh, bz, h0


@pytest.mark.parametrize("B,T,K,N", [
    (32, 98, 1, 48), (32, 98, 48, 10), (3, 60, 8, 130), (1, 8, 4, 8),
    (2, 1, 17, 24), (4, 130, 64, 64), (2, 70, 150, 24),
])
def test_tc_model_is_bitwise_on_binary_x(B, T, K, N):
    """Binary x: mid and lo are zero and every sum a multiple of 1/2, so
    the kernel's arithmetic gives the plain version's bits."""
    x, ch, cz, bh, bz, h0 = map(torch.from_numpy,
                                _inputs(B, T, K, N, seed=B * T + K + N))
    scale = 0.11 / max(1, K // 64)
    y, h = _tc_model(x, ch, cz, scale, bh, bz, h0)
    yp, hp = tref.minimalist_block_ref(x, ch, cz, scale, bh, bz, h0)
    assert torch.equal(h, hp) and torch.equal(y, yp)


@pytest.mark.parametrize("B,T,K,N", [(2, 70, 17, 24), (3, 64, 8, 130),
                                     (1, 40, 80, 10)])
def test_tc_model_matches_pallas_interpret_on_analog_x(B, T, K, N):
    """Analog x (a first layer fed unbinarised frames) against the
    reference's kernel, which scales the levels before its sum."""
    x, ch, cz, bh, bz, h0 = _inputs(B, T, K, N, seed=K + N, binary=False)
    scale = 0.11
    jy, jh = jops.minimalist_block(jnp.asarray(x), ch, cz, scale, bh, bz,
                                   jnp.asarray(h0), backend="pallas")
    jy, jh = np.asarray(jy), np.asarray(jh)
    y, h = _tc_model(*map(torch.from_numpy, (x, ch, cz)), scale,
                     *map(torch.from_numpy, (bh, bz, h0)))
    # the reference's own gate values; a chain is compared up to its
    # first one within 1e-3 of a code step
    wz = (cz.astype(np.float32) - 1.5) * scale
    v = np.asarray(jq.hard_sigmoid(jnp.asarray(x) @ wz + bz)) * 63
    tie = np.abs(v - np.round(v)) <= 1e-3
    clean = ~np.maximum.accumulate(tie, axis=1)
    assert clean.mean() > 0.5
    err = np.abs(h.numpy() - jh)[clean]
    assert err.max() <= 2e-5
    flips = (y.numpy() != jy) & clean
    assert not (flips & (np.abs(jh) > 1e-4)).any()


def test_block_plan_spreads_small_batches_and_fills_large_ones():
    plan = tops.block_plan
    # the paper's width at 8 streams: 8-column slabs, 64 CTAs
    assert plan(8, 64, SMS) == (8, 64)
    # 256 streams fill every SM with whole-width slabs
    assert plan(256, 64, SMS) == (64, 256)
    # the readout (N 10) never takes a slab wider than 16
    assert plan(256, 10, SMS) == (16, 256)
    # the system check's layers (32 streams, 48 columns): 192 CTAs
    assert plan(32, 48, SMS) == (8, 192)
    # wider slabs as soon as they fill the SMs
    assert plan(50, 128, SMS) == (32, 200)
    assert plan(50, 128, 250) == (16, 400)
    # a batch too small for any slab to fill the card takes the narrowest
    assert plan(2, 24, SMS) == (8, 6)


def test_div6_as_fp64_product_rounds_as_fp32_division():
    """The kernel's gate divides by 6 as an fp64 product rounded once to
    fp32 (csrc/minimalist_block.cu, div6): on 4 M sampled fp32 values it
    gives the correctly rounded fp32 quotient wherever that is normal."""
    rng = np.random.default_rng(6)
    bits = rng.integers(0, 2**32, size=2**22, dtype=np.uint64)
    x = bits.astype(np.uint32).view(np.float32)
    x = x[np.isfinite(x)]
    with np.errstate(all="ignore"):
        want = x / np.float32(6.0)
        got = (x.astype(np.float64) * (1.0 / 6.0)).astype(np.float32)
    normal = np.abs(want) >= np.float32(2.0**-126)
    assert normal.sum() > 2**21
    np.testing.assert_array_equal(got[normal].view(np.uint32),
                                  want[normal].view(np.uint32))
