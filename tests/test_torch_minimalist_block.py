"""PyTorch port vs the JAX reference: kernels/minimalist_block.

The fused step (the kernel wrapper, which takes its plain version on CPU
tensors) is held to the reference's Pallas kernel in interpret mode and
to its ``xla`` oracle: h within 2e-5 and the 6 b gate codes equal
wherever the reference's (pre_z/6 + 1/2)*63 is not within 1e-3 of an
integer.  The CUDA kernel is checked on the card by
tests/test_torch_cuda.py and chip_smoke.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jq
from repro.core.mingru import MinGRUBlock as JBlock
from repro.kernels.minimalist_block import ops as jops
from repro_torch.bridge import load_jax_params
from repro_torch.core.mingru import MinGRUBlock as TBlock
from repro_torch.core.quant import QuantConfig as TQ
from repro_torch.kernels.minimalist_block import ops as tops
from repro_torch.kernels.minimalist_block import ref as tref

torch.set_num_threads(1)


def _blocks(K, N, seed):
    jb = JBlock(K, N, qcfg=jq.QuantConfig.hardware())
    jp = jb.init(jax.random.PRNGKey(seed))
    tb = TBlock(K, N, qcfg=TQ.hardware())
    load_jax_params(tb, jax.tree_util.tree_map(np.asarray, jp))
    return jb, jp, tb


@pytest.mark.parametrize("K,N", [(4, 8), (16, 24), (64, 130)])
def test_export_matches_reference_exactly(K, N):
    _jb, jp, tb = _blocks(K, N, seed=K)
    jexp = jops.from_block_params(jp)
    texp = tops.from_block_params(tb)
    for j, t in zip(jexp[:2], texp[:2]):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        assert t.dtype == torch.int8
    assert texp[2] == jexp[2]
    for j, t in zip(jexp[3:], texp[3:]):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("B,K,N", [(1, 4, 8), (3, 16, 24), (8, 64, 64)])
def test_fused_step_matches_pallas_interpret(B, K, N):
    _jb, jp, tb = _blocks(K, N, seed=B + K)
    exp = tops.from_block_params(tb)
    rng = np.random.default_rng(B)
    x = (rng.random((B, K)) > 0.5).astype(np.float32)
    hp = rng.standard_normal((B, N)).astype(np.float32)
    jexp = jops.from_block_params(jp)
    jy, jh = jops.minimalist_step(jnp.asarray(x), *jexp, jnp.asarray(hp),
                                  backend="pallas")
    y, h, zc = tops.minimalist_step_kernel(
        torch.from_numpy(x), *exp, torch.from_numpy(hp),
        return_z_codes=True)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=2e-5)
    flips = y.numpy() != np.asarray(jy)
    assert not (flips & (np.abs(np.asarray(jh)) > 1e-4)).any()
    # z codes: the reference's own gate on the same pre-activation
    wz = (np.asarray(jexp[1], np.float32) - 1.5) * jexp[2]
    v = np.asarray(jq.hard_sigmoid(jnp.asarray(x) @ wz + jexp[4])) * 63
    tie = np.abs(v - np.round(v)) <= 1e-3
    want = np.floor(v)
    assert ((zc.numpy() == want) | tie).all()
    # and the software hardware-mode step of the block agrees
    _y, h_sw = tb.step(torch.from_numpy(x), torch.from_numpy(hp))
    np.testing.assert_allclose(h.numpy(), h_sw.detach().numpy(), atol=2e-5,
                               rtol=1e-5)


def test_block_ref_matches_reference_oracle():
    B, T, K, N = 2, 12, 8, 10
    rng = np.random.default_rng(7)
    x = (rng.random((B, T, K)) > 0.5).astype(np.float32)
    ch = rng.integers(0, 4, (K, N)).astype(np.int8)
    cz = rng.integers(0, 4, (K, N)).astype(np.int8)
    bh = (rng.standard_normal(N) * 0.5).astype(np.float32)
    bz = (rng.standard_normal(N) * 0.5).astype(np.float32)
    h0 = np.zeros((B, N), np.float32)
    jy, jh = jops.minimalist_block(jnp.asarray(x), ch, cz, 0.11, bh, bz,
                                   jnp.asarray(h0), backend="xla")
    ty, th = tref.minimalist_block_ref(
        torch.from_numpy(x), torch.from_numpy(ch), torch.from_numpy(cz),
        0.11, torch.from_numpy(bh), torch.from_numpy(bz),
        torch.from_numpy(h0))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=2e-5)
    # the step oracle, run T times, walks the same trajectory
    h = torch.from_numpy(h0)
    for t in range(T):
        _y, h = tref.minimalist_step_ref(
            torch.from_numpy(x[:, t]), torch.from_numpy(ch),
            torch.from_numpy(cz), 0.11, torch.from_numpy(bh),
            torch.from_numpy(bz), h)
        np.testing.assert_allclose(h.numpy(), th[:, t].numpy(), atol=1e-6)


def test_cost_model_and_backends():
    assert tops.cost_model(4, 784, 64, 64) == jops.cost_model(4, 784, 64, 64)
    x = torch.zeros(2, 4)
    codes = torch.zeros(4, 3, dtype=torch.int8)
    args = (x, codes, codes, 0.1, torch.zeros(3), torch.zeros(3),
            torch.zeros(2, 3))
    for backend in tops.BACKENDS:
        y, h = tops.minimalist_step(*args, backend=backend)
        assert y.shape == h.shape == (2, 3)
    with pytest.raises(ValueError, match="unknown backend"):
        tops.minimalist_step(*args, backend="pallas")


# ---------------------------------------------------------------------------
# The sequence kernel's wrapper (plain version on CPU tensors) against the
# reference's minimalist_block_pallas in interpret mode, at the shapes of
# tests/test_kernels_minimalist_block.py: h within 2e-5, Θ flips only at
# |h| < 1e-4.


@pytest.mark.parametrize("B,T,K,N", [
    (1, 8, 4, 8), (2, 33, 16, 24), (1, 128, 64, 64), (3, 60, 8, 130),
])
def test_block_kernel_wrapper_matches_pallas_interpret(B, T, K, N):
    _jb, jp, tb = _blocks(K, N, seed=B + T)
    x = (np.random.default_rng(B + T).random((B, T, K)) > 0.5).astype(
        np.float32)
    jy, jh = jops.minimalist_block(jnp.asarray(x), *jops.from_block_params(jp),
                                   backend="pallas")
    n0 = tops.minimalist_block_kernel.launches
    ty, th = tops.minimalist_block(torch.from_numpy(x),
                                   *tops.from_block_params(tb))
    assert tops.minimalist_block_kernel.launches == n0    # no kernel on CPU
    assert ty.shape == th.shape == (B, T, N)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=2e-5,
                               rtol=1e-5)
    flips = ty.numpy() != np.asarray(jy)
    assert not (flips & (np.abs(np.asarray(jh)) > 1e-4)).any()


def test_block_kernel_plain_version_matches_port_network():
    """The fused sequence path against the port's hardware MinGRUBlock on
    the same exported params (the port's own 2e-5 contract; the network's
    scan forms the update as one FMA-able expression)."""
    _jb, _jp, tb = _blocks(16, 24, seed=3)
    x = torch.from_numpy((np.random.default_rng(3).random((2, 40, 16))
                          > 0.5).astype(np.float32))
    out_sw, h_sw = tb(x)
    y, h = tops.minimalist_block(x, *tops.from_block_params(tb),
                                 backend="plain")
    np.testing.assert_allclose(h.numpy(), h_sw.detach().numpy(), atol=2e-5)
    flips = (y != out_sw).numpy() & (h_sw.abs() > 1e-4).numpy()
    assert not flips.any()
    with pytest.raises(ValueError, match="unknown backend"):
        tops.minimalist_block(x, *tops.from_block_params(tb),
                              backend="pallas")


def test_wrappers_refuse_mixed_devices():
    """The plain version runs only when every input lies on the CPU: one
    input elsewhere is refused by the wrapper, not handed to torch."""
    rng = np.random.default_rng(11)
    K, N = 6, 5
    ch = torch.from_numpy(rng.integers(0, 4, (K, N)).astype(np.int8))
    cz = torch.from_numpy(rng.integers(0, 4, (K, N)).astype(np.int8))
    bh = torch.from_numpy(rng.standard_normal(N).astype(np.float32))
    bz = torch.from_numpy(rng.standard_normal(N).astype(np.float32))
    h = torch.zeros(2, N)
    x1 = torch.from_numpy((rng.random((2, K)) > 0.5).astype(np.float32))
    xs = torch.from_numpy((rng.random((2, 3, K)) > 0.5).astype(np.float32))
    for fn, x in ((tops.minimalist_step_kernel, x1),
                  (tops.minimalist_block_kernel, xs)):
        args = [x, ch, cz, bh, bz, h]
        for i in range(len(args)):
            mixed = [a.to("meta") if j == i else a
                     for j, a in enumerate(args)]
            with pytest.raises(ValueError, match="different devices"):
                fn(mixed[0], mixed[1], mixed[2], 0.1, *mixed[3:])
        meta = [a.to("meta") for a in args]
        with pytest.raises(ValueError, match="unsupported device"):
            fn(meta[0], meta[1], meta[2], 0.1, *meta[3:])


# ---------------------------------------------------------------------------
# The step kernel's summation order (csrc/minimalist_step.cu), emulated in
# PyTorch: lane p of 8 sums the K rows k = p mod 8 in increasing k with
# one rounding an FMA, and the eight parts are combined as
# ((P0 + P4) + (P2 + P6)) + ((P1 + P5) + (P3 + P7)).


def _split_k_sum(x, codes):
    """x (B, K) fp32, codes (K, N) int8 -> x @ (codes - 1.5) in the
    kernel's order (each FMA as an exact float64 product and sum rounded
    once to fp32)."""
    lv = (codes.float() - 1.5).double()
    xd = x.double()
    parts = []
    for p in range(8):
        acc = torch.zeros(x.shape[0], codes.shape[1])
        for k in range(p, x.shape[1], 8):
            acc = (acc.double() + xd[:, k:k + 1] * lv[k]).float()
        parts.append(acc)
    P = parts
    return ((P[0] + P[4]) + (P[2] + P[6])) + ((P[1] + P[5]) + (P[3] + P[7]))


def _split_k_step(x, ch, cz, scale, bh, bz, hp):
    """The fused step of tref.minimalist_step_ref with the split-K sums:
    (y, h, z codes)."""
    pre_h = _split_k_sum(x, ch) * scale + bh
    zc = tref.gate_codes(_split_k_sum(x, cz) * scale + bz)
    z = zc / 63.0
    h = z * pre_h + (1.0 - z) * hp
    return (h > 0.0).float(), h, zc


@pytest.mark.parametrize("B,K,N", [(1, 4, 8), (3, 16, 24), (8, 64, 64),
                                   (2, 150, 40)])
def test_split_k_order_matches_pallas_interpret_on_analog_x(B, K, N):
    """Analog x (a first layer fed unbinarised frames): the kernel's order
    keeps h within 2e-5 of the reference's Pallas kernel in interpret mode
    and the z codes equal away from a code step."""
    _jb, jp, tb = _blocks(K, N, seed=B + K + 1)
    exp = tops.from_block_params(tb)
    rng = np.random.default_rng(B + K)
    x = rng.random((B, K)).astype(np.float32)
    hp = rng.standard_normal((B, N)).astype(np.float32)
    jexp = jops.from_block_params(jp)
    jy, jh = jops.minimalist_step(jnp.asarray(x), *jexp, jnp.asarray(hp),
                                  backend="pallas")
    y, h, zc = _split_k_step(torch.from_numpy(x), *exp,
                             torch.from_numpy(hp))
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=2e-5)
    flips = y.numpy() != np.asarray(jy)
    assert not (flips & (np.abs(np.asarray(jh)) > 1e-4)).any()
    wz = (np.asarray(jexp[1], np.float32) - 1.5) * jexp[2]
    v = np.asarray(jq.hard_sigmoid(jnp.asarray(x) @ wz + jexp[4])) * 63
    tie = np.abs(v - np.round(v)) <= 1e-3
    assert ((zc.numpy() == np.floor(v)) | tie).all()


@pytest.mark.parametrize("B,K,N", [(8, 64, 64), (3, 17, 130), (4, 1, 10),
                                   (2, 200, 24)])
def test_split_k_order_is_bitwise_on_binary_x(B, K, N):
    """Binary x: every part is an exact multiple of 1/2, so the kernel's
    order gives the plain version's (and the serial kernel's) bits."""
    rng = np.random.default_rng(K + N)
    x = torch.from_numpy((rng.random((B, K)) > 0.5).astype(np.float32))
    ch = torch.from_numpy(rng.integers(0, 4, (K, N)).astype(np.int8))
    cz = torch.from_numpy(rng.integers(0, 4, (K, N)).astype(np.int8))
    bh = torch.from_numpy(rng.standard_normal(N).astype(np.float32))
    bz = torch.from_numpy(rng.standard_normal(N).astype(np.float32))
    hp = torch.from_numpy(rng.standard_normal((B, N)).astype(np.float32))
    for mat in (ch, cz):
        assert torch.equal(_split_k_sum(x, mat), x @ (mat.float() - 1.5))
    y, h, zc = _split_k_step(x, ch, cz, 0.11, bh, bz, hp)
    yp, hpl, zcp = tref.minimalist_step_ref(x, ch, cz, 0.11, bh, bz, hp,
                                            return_z_codes=True)
    assert torch.equal(h, hpl) and torch.equal(y, yp)
    assert torch.equal(zc.to(torch.int8), zcp)
