"""PyTorch port vs the JAX reference: the fused selective scan
(kernels/fused_ssm).

The port's op on CPU tensors runs the plain versions of its two CUDA
kernels (``ref.fused_ssm_fwd_ref`` and ``ref.fused_ssm_bwd_ref``); the
reference runs its Pallas kernels in interpret mode (``backend="pallas"``)
and its materializing oracle ``ref.selective_scan_ref``, as its own tests
do (tests/test_kernels_fused_ssm.py).  Inputs are made with numpy from a
seed, distributed as the reference test's.  Tolerances are that test's:
the output within 2e-5, gradients of sum(sin(y)) at atol 5e-5 / rtol
5e-4."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fused_ssm import ops as jops
from repro.kernels.fused_ssm import ref as jref
from repro_torch.kernels.fused_ssm import ops, ref

torch.set_num_threads(1)

F32 = dict(atol=2e-5, rtol=2e-5)
GRAD = dict(atol=5e-5, rtol=5e-4)


def _inputs(B, T, di, n, seed=0):
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.standard_normal((B, T, di)))) * 0.2
    x = rng.standard_normal((B, T, di))
    Bm = rng.standard_normal((B, T, n)) * 0.5
    Cm = rng.standard_normal((B, T, n)) * 0.5
    A = -np.exp(rng.standard_normal((di, n)) * 0.3)
    return [v.astype(np.float32) for v in (dt, x, Bm, Cm, A)]


def _t(args, grad=False):
    return [torch.from_numpy(a).requires_grad_(grad) for a in args]


@pytest.mark.parametrize("B,T,di,n", [(1, 4, 8, 2), (2, 64, 128, 16),
                                      (1, 96, 32, 8)])
def test_forward_matches_reference(B, T, di, n):
    args = _inputs(B, T, di, n, seed=T + di)
    got = ops.selective_scan(*_t(args)).numpy()
    jargs = [jnp.asarray(a) for a in args]
    np.testing.assert_allclose(
        got, np.asarray(jref.selective_scan_ref(*jargs)), **F32)
    np.testing.assert_allclose(
        got, np.asarray(jops.selective_scan(*jargs, "pallas")), **F32)


@pytest.mark.parametrize("B,T,di,n", [(1, 32, 64, 4), (2, 64, 32, 8)])
def test_gradients_match_reference(B, T, di, n):
    args = _inputs(B, T, di, n, seed=T * di)

    def jloss(*a):
        return jnp.sum(jnp.sin(jops.selective_scan(*a, "pallas")))

    want = jax.grad(jloss, (0, 1, 2, 3, 4))(*[jnp.asarray(a) for a in args])
    targs = _t(args, grad=True)
    torch.sin(ops.selective_scan(*targs)).sum().backward()
    for name, w, t in zip(("dt", "x", "B", "C", "A"), want, targs):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   err_msg=name, **GRAD)


@pytest.mark.parametrize("B,T,di,n", [(2, 70, 33, 5), (1, 32, 16, 16),
                                      (3, 5, 7, 1)])
def test_plain_backward_matches_autograd_of_plain_forward(B, T, di, n):
    """fused_ssm_bwd_ref (chunked recompute from the entry states, the λ
    walk) against autograd through the materializing selective_scan_ref,
    with T past and off the chunk length; the plain forward's y equals
    the oracle's and its entry states are the oracle's states before every
    CHUNK-th step."""
    args = _inputs(B, T, di, n, seed=B + T + di + n)
    targs = _t(args, grad=True)
    y = ref.selective_scan_ref(*targs)
    dy = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (B, T, di)).astype(np.float32))
    want = torch.autograd.grad(y, targs, dy)
    y2, entries = ref.fused_ssm_fwd_ref(*_t(args), ops.CHUNK)
    np.testing.assert_allclose(y2.numpy(), y.detach().numpy(), **F32)
    assert entries.shape == (B, ops.n_chunks(T), di, n)
    assert not entries[:, 0].any()
    got = ref.fused_ssm_bwd_ref(*_t(args), entries, dy, ops.CHUNK)
    for name, g, w in zip(("ddt", "dx", "dB", "dC", "dA"), got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w.numpy(), err_msg=name,
                                   **GRAD)


def test_op_keeps_input_dtypes():
    """bf16 inputs: the op computes in fp32 (as the reference's kernels do
    inside) and gives y and each cotangent in its input's dtype."""
    args = _inputs(1, 40, 16, 4, seed=3)
    bf = [torch.from_numpy(a).to(torch.bfloat16).requires_grad_()
          for a in args[:4]]
    A = torch.from_numpy(args[4]).requires_grad_()
    y = ops.selective_scan(*bf, A)
    assert y.dtype == torch.bfloat16
    want = ref.selective_scan_ref(*[t.detach().float() for t in bf],
                                  A.detach())
    # one bf16 rounding of two fp32 results within 2e-5 of each other
    np.testing.assert_allclose(y.detach().float().numpy(), want.numpy(),
                               atol=2e-5, rtol=2.0 ** -8)
    y.float().sum().backward()
    assert [t.grad.dtype for t in bf + [A]] == [torch.bfloat16] * 4 + [
        torch.float32]


@pytest.mark.parametrize("train", [True, False])
def test_cost_model_equals_reference(train):
    for shape in [(16, 4096, 8192, 16), (4, 2048, 8192, 16), (2, 64, 32, 8)]:
        assert ops.cost_model(*shape, train=train, dtype_bytes=4) == \
            jops.cost_model(*shape, train=train, dtype_bytes=4)
        assert ops.cost_model(*shape, train=train) == \
            jops.cost_model(*shape, train=train)


def test_wrappers_refuse_other_devices():
    args = _t(_inputs(1, 4, 8, 2))
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError, match="unsupported device"):
        ops.fused_ssm_fwd_kernel(*meta)
    with pytest.raises(ValueError, match="unsupported device"):
        ops.fused_ssm_bwd_kernel(*meta, meta[0][:, :1, :, None], meta[0])


def test_wrappers_refuse_mixed_devices():
    """The plain version runs only when every input lies on the CPU: one
    input elsewhere is refused by the wrapper, not handed to torch."""
    args = _t(_inputs(1, 4, 8, 2))
    _, entries = ops.fused_ssm_fwd_kernel(*args)
    for i in range(len(args)):
        mixed = [a.to("meta") if j == i else a for j, a in enumerate(args)]
        with pytest.raises(ValueError, match="different devices"):
            ops.fused_ssm_fwd_kernel(*mixed)
        with pytest.raises(ValueError, match="different devices"):
            ops.fused_ssm_bwd_kernel(*mixed, entries, args[1])
    with pytest.raises(ValueError, match="different devices"):
        ops.fused_ssm_bwd_kernel(*args, entries.to("meta"), args[1])


def test_config_admits_xla_and_fused_only():
    """falcon-mamba-7b carries the reference's values, and ssm_impl takes
    the materializing "xla", the fused op and the dry-run's "stub" (the
    reference's three values), nothing else."""
    import dataclasses

    from repro.configs import get_config as jget
    from repro_torch.configs import get_config

    cfg = get_config("falcon-mamba-7b")
    want = jget("falcon-mamba-7b")
    for field in ("d_model", "n_layers", "vocab", "d_ff", "pattern",
                  "mamba", "tie_embeddings", "vocab_padded"):
        assert str(getattr(cfg, field)) == str(getattr(want, field)), field
    assert cfg.mamba.d_inner(cfg.d_model) == 8192 and cfg.mamba.d_state == 16
    assert str(get_config("falcon-mamba-7b-smoke").mamba) == \
        str(jget("falcon-mamba-7b-smoke").mamba)
    for impl in ("xla", "fused", "stub"):
        assert dataclasses.replace(cfg, ssm_impl=impl).ssm_impl == impl
    with pytest.raises(ValueError, match="ssm_impl"):
        dataclasses.replace(cfg, ssm_impl="pallas")


@pytest.mark.parametrize("B,T,di,n", [(2, 2 * ops.CHUNK, 64, 16),
                                      (1, ops.CHUNK, 32, 5)])
def test_plain_versions_match_reference_kernels_at_chunk(B, T, di, n):
    """The plain forward and backward at CHUNK against the reference's
    Pallas kernels run with time blocks of CHUNK steps (interpret mode):
    y, the entry states (the same spacing, so the same tensors), ddt, dx
    and the summed dB, dC and dA, at the reference's bounds."""
    from repro.kernels.fused_ssm.fused_ssm import fused_ssm_bwd, fused_ssm_fwd

    args = _inputs(B, T, di, n, seed=7 * T + n)
    dy = np.random.default_rng(5).standard_normal((B, T, di)).astype(
        np.float32)
    y, entries = ref.fused_ssm_fwd_ref(*_t(args), ops.CHUNK)
    jargs = [jnp.asarray(a) for a in args]
    jy, jent = fused_ssm_fwd(*jargs, tblk=ops.CHUNK, dblk=di)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **F32)
    np.testing.assert_allclose(entries.numpy(), np.asarray(jent), **F32)
    got = ref.fused_ssm_bwd_ref(*_t(args), entries, torch.from_numpy(dy),
                                ops.CHUNK)
    # one d-block (dblk = di): the dB/dC partials are the sums over d
    ddt, dx, dBp, dCp, dAp = fused_ssm_bwd(*jargs, jent, jnp.asarray(dy),
                                           tblk=ops.CHUNK, dblk=di)
    want = (np.asarray(ddt), np.asarray(dx), np.asarray(dBp),
            np.asarray(dCp), np.asarray(dAp).sum(0))
    for name, g, w in zip(("ddt", "dx", "dB", "dC", "dA"), got, want):
        np.testing.assert_allclose(g.numpy(), w, err_msg=name, **GRAD)


@pytest.mark.parametrize("B,T,di,n", [(1, 80, 64, 8), (2, 48, 40, 16),
                                      (1, ops.CHUNK + 8, 24, 4)])
def test_plain_versions_off_chunk_match_reference(B, T, di, n):
    """T not a multiple of CHUNK: the plain forward's y and the plain
    backward's cotangents of a dy against the reference's Pallas op
    (interpret mode) and its materializing oracle, at the reference's
    bounds; the last entry state is the oracle's state before the last
    chunk's first step."""
    assert T % ops.CHUNK
    args = _inputs(B, T, di, n, seed=T + 3 * n)
    dy = np.random.default_rng(6).standard_normal((B, T, di)).astype(
        np.float32)
    y, entries = ref.fused_ssm_fwd_ref(*_t(args), ops.CHUNK)
    got = ref.fused_ssm_bwd_ref(*_t(args), entries, torch.from_numpy(dy),
                                ops.CHUNK)
    jargs = [jnp.asarray(a) for a in args]
    for backend in ("pallas", "xla"):
        jy, vjp = jax.vjp(lambda *a: jops.selective_scan(*a, backend),
                          *jargs)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), **F32)
        for name, g, w in zip(("ddt", "dx", "dB", "dC", "dA"), got,
                              vjp(jnp.asarray(dy))):
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       err_msg=f"{backend} {name}", **GRAD)
    assert entries.shape == (B, ops.n_chunks(T), di, n)
    t_last = (ops.n_chunks(T) - 1) * ops.CHUNK
    np.testing.assert_allclose(entries[:, -1].numpy(),
                               _state_after(args, t_last).numpy(), **F32)


def _state_after(args, t):
    """The oracle's state after the first t steps (B, di, n)."""
    dt, x, Bm, _, A = (torch.from_numpy(a) for a in args)
    a = torch.exp(dt[:, :t, :, None] * A)
    b = (dt * x)[:, :t, :, None] * Bm[:, :t, None, :]
    h = torch.zeros(dt.shape[0], dt.shape[2], A.shape[1])
    for i in range(t):
        h = a[:, i] * h + b[:, i]
    return h


def test_backward_partials_at_path_width():
    """falcon-mamba-7b's SSM (d_inner 8192, d_state 16) at batch 4 x 2048:
    each backward block sums 256 channels on chip, so a batch row gets at
    most 32 partial dB/dC rows and a call writes at most 67 MB of them
    (the 16-channel blocks before wrote 512 rows, 1.07 GB)."""
    assert ops.block_channels(16) == 256
    assert ops.d_blocks(8192, 16) == 32
    assert ops.partial_bytes(4, 2048, 8192, 16) == 2 * 4 * 4 * 32 * 2048 * 16
    assert ops.partial_bytes(4, 2048, 8192, 16) <= 67e6


def test_wrapper_partials_fit_the_c_check():
    """The partial rows the wrapper allocates are the rows the C entry
    point checks (n_rows == ceil(di / CB), CB from ssm::config_for), for
    every state size and d_inner around a block's width: read from the C
    source's configuration rule, computed from shapes alone."""
    import re
    from pathlib import Path

    import repro_torch.kernels.fused_ssm.ops as mod
    csrc = Path(mod.__file__).resolve().parents[1] / "csrc"
    header = (csrc / "fused_ssm.cuh").read_text()
    rule = header[header.index("inline Config config_for"):]
    rule = rule[:rule.index("\n}\n")]
    m = re.search(r"return np <= (\d+) \? Config\{np, 1, (\d+)\} : "
                  r"Config\{(\d+), 2, (\d+)\};", rule)
    assert m, rule
    assert "n_rows != (di + CB - 1) / CB" in (
        csrc / "fused_ssm_bwd.cu").read_text()
    for n in range(1, ops.MAX_STATE + 1):
        cb = int(m[2]) if ops.pow2ceil(n) <= int(m[1]) else int(m[4])
        assert ops.block_channels(n) == cb, n
        for di in (1, cb - 1, cb, cb + 1, 3 * cb + 5, 8192):
            rows = ops.d_blocks(di, n)
            assert rows == -(-di // cb)
            assert (rows - 1) * cb < di <= rows * cb
