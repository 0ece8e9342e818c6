"""The port's IMC projection (paper Eq. 6) against the reference
(repro.kernels.imc_mvm) on the CPU: the same numpy inputs through the
reference's ``ops.imc_mvm`` with ``backend="xla"`` and ``"pallas"``
(interpret mode, padded tiles and the Kp/K rescale) and through the
port's ``imc_mvm``, whose wrapper takes the plain version when every
input lies on the CPU.

Tolerance: 1e-5 (atol and rtol), the reference's own bound for its
kernel (tests/test_kernels_imc_mvm.py); the Eq. 6 properties at the
reference's 1e-6 and exactly 0."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.imc_mvm import ops as jops
from repro.kernels.imc_mvm import ref as jref
from repro_torch.kernels.imc_mvm import ops, ref

torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)


def _inputs(M, K, N, seed, per_col_scale=True):
    rng = np.random.default_rng(seed)
    x = (rng.random((M, K)) > 0.5).astype(np.float32)
    codes = rng.integers(0, 4, size=(K, N)).astype(np.int8)
    scale = (rng.random(N).astype(np.float32) * 0.3 + 0.01
             if per_col_scale else np.float32(0.1))
    return x, codes, scale


def _port(x, codes, scale, **kw):
    s = torch.from_numpy(np.asarray(scale)) if np.ndim(scale) else \
        float(scale)
    return ops.imc_mvm(torch.from_numpy(x), torch.from_numpy(codes), s,
                       **kw).numpy()


@pytest.mark.parametrize("per_col", [True, False])
@pytest.mark.parametrize("M,K,N", [
    (1, 1, 1), (3, 5, 7), (8, 128, 128), (17, 70, 50),
    (128, 256, 384), (5, 300, 129),
])
def test_matches_reference_xla_and_pallas(M, K, N, per_col):
    x, codes, scale = _inputs(M, K, N, M * 1000 + N, per_col)
    got = _port(x, codes, scale)
    assert got.shape == (M, N) and got.dtype == np.float32
    np.testing.assert_array_equal(got, _port(x, codes, scale,
                                             backend="plain"))
    for backend in ("xla", "pallas"):
        want = jops.imc_mvm(jnp.asarray(x), jnp.asarray(codes),
                            jnp.asarray(scale), backend=backend)
        np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.mark.parametrize("bm,bn,bk", [(8, 128, 128), (128, 256, 128)])
def test_matches_reference_pallas_blockings(bm, bn, bk):
    """The reference's two tilings of its padded kernel; the port's kernel
    masks its ragged edges instead of padding."""
    x, codes, scale = _inputs(33, 200, 140, 9)
    want = jops.imc_mvm(jnp.asarray(x), jnp.asarray(codes),
                        jnp.asarray(scale), backend="pallas", bm=bm, bn=bn,
                        bk=bk)
    np.testing.assert_allclose(_port(x, codes, scale), np.asarray(want),
                               **TOL)


def test_batched_leading_dims():
    x, codes, scale = _inputs(12, 30, 20, 3)
    got = _port(x.reshape(3, 4, 30), codes, scale)
    assert got.shape == (3, 4, 20)
    want = jops.imc_mvm(jnp.asarray(x.reshape(3, 4, 30)),
                        jnp.asarray(codes), jnp.asarray(scale),
                        backend="pallas")
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    np.testing.assert_allclose(got.reshape(12, 20), _port(x, codes, scale),
                               **TOL)


@pytest.mark.parametrize("M,K,N,seed", [(1, 1, 1, 0), (7, 64, 32, 1),
                                        (16, 33, 5, 2), (3, 17, 31, 3)])
def test_charge_sharing_is_mean_and_zero_input_is_v0(M, K, N, seed):
    """Eq. 6: all-ones activations give exactly the column mean of the
    selected levels times Δ; zero activations give exactly V0 (0 in
    weight units)."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(K, N)).astype(np.int8)
    out = _port(np.ones((M, K), np.float32), codes, 0.2)
    want = ((codes.astype(np.float32) - 1.5) * 0.2).mean(0)
    np.testing.assert_allclose(out[0], want, atol=1e-6)
    np.testing.assert_allclose(out, np.broadcast_to(want, out.shape),
                               atol=1e-6)
    out0 = _port(np.zeros((M, K), np.float32), codes, 0.2)
    assert float(np.abs(out0).max()) == 0.0


def test_plain_version_is_the_reference_oracle():
    x, codes, scale = _inputs(9, 40, 11, 4)
    got = ref.imc_mvm_ref(torch.from_numpy(x), torch.from_numpy(codes),
                          torch.from_numpy(scale)).numpy()
    want = np.asarray(jref.imc_mvm_ref(jnp.asarray(x), jnp.asarray(codes),
                                       jnp.asarray(scale)))
    np.testing.assert_allclose(got, want, **TOL)
    assert ref.LEVEL_OFFSET == jref.LEVEL_OFFSET
    np.testing.assert_array_equal(
        ref.dequantize_codes(torch.from_numpy(codes), 0.25).numpy(),
        np.asarray(jref.dequantize_codes(jnp.asarray(codes), 0.25)))


def test_wrapper_takes_the_plain_version_on_cpu_without_counting():
    x, codes, scale = (torch.from_numpy(a) for a in _inputs(5, 9, 7, 5))
    n0 = ops.imc_mvm_kernel.launches
    assert torch.equal(ops.imc_mvm_kernel(x, codes, scale),
                       ref.imc_mvm_ref(x, codes, scale))
    assert ops.imc_mvm_kernel.launches == n0
    with pytest.raises(ValueError, match="backend"):
        ops.imc_mvm(x, codes, scale, backend="xla")


def test_wrapper_refuses_mixed_devices():
    """The plain version runs only when every input lies on the CPU: one
    input elsewhere is refused by the wrapper, not handed to torch."""
    args = [torch.from_numpy(a) for a in _inputs(5, 9, 7, 6)]
    for i in range(len(args)):
        mixed = [a.to("meta") if j == i else a for j, a in enumerate(args)]
        with pytest.raises(ValueError, match="different devices"):
            ops.imc_mvm_kernel(*mixed)
    with pytest.raises(ValueError, match="unsupported device"):
        ops.imc_mvm_kernel(*[a.to("meta") for a in args])


# -- the CUDA source's two routes: the rule, and the tc route's numerics --

@pytest.mark.parametrize("M,K,N,ptrs,want", [
    (4096, 1024, 1024, (0, 0, 0), "tc"),
    (130, 64, 48, (0, 0, 0), "tc"),
    (128, 256, 384, (0, 0, 0), "tc"),
    (1, 4, 16, (0, 0, 0), "tc"),
    (1, 1, 1, (0, 0, 0), "simt"),
    (3, 5, 7, (0, 0, 0), "simt"),
    (17, 70, 50, (0, 0, 0), "simt"),
    (5, 300, 129, (0, 0, 0), "simt"),
    (64, 1000, 10, (0, 0, 0), "simt"),
    (64, 32, 48, (4, 0, 0), "simt"),      # x 4 bytes into its storage
    (64, 32, 48, (0, 8, 0), "simt"),
    (64, 32, 48, (0, 0, 1040), "tc"),
    (0, 32, 48, (0, 0, 0), "simt"),
    (8, 0, 48, (0, 0, 0), "simt"),
    (8, 32, 40, (0, 0, 0), "simt"),       # N % 16 == 8: codes rows unaligned
])
def test_route_rule(M, K, N, ptrs, want):
    """tc where TMA can address every operand (K % 4, N % 16, 16-byte
    data pointers), else simt: the cases of the card tests among them."""
    assert ops.route(M, K, N, *(4096 + p for p in ptrs)) == want


def _tc_emulated(x, codes, scale):
    """The tc route's arithmetic in PyTorch: x and the levels in bf16,
    their products summed in fp32 (exact for binary x, in any order),
    then +0 and the simt route's epilogue acc * scale / K."""
    K = x.shape[1]
    levels = (codes.float() - ref.LEVEL_OFFSET).bfloat16().float()
    acc = x.bfloat16().float() @ levels
    return (acc + 0.0) * scale / K


def _exact_sum(x, codes, scale):
    """Eq. 6 with the level sum taken exactly (float64), then the same
    fp32 epilogue."""
    K = x.shape[1]
    acc = (x.double() @ (codes.double() - ref.LEVEL_OFFSET)).float()
    return acc * scale / K


@pytest.mark.parametrize("per_col", [True, False])
@pytest.mark.parametrize("M,K,N", [
    (1, 1, 1), (3, 5, 7), (8, 128, 128), (17, 70, 50),
    (128, 256, 384), (5, 300, 129),
])
def test_tc_numerics_are_the_exact_sum_on_binary_x(M, K, N, per_col):
    """bf16 x bf16 products of binary x and the 2 b levels, summed in
    fp32, are the exact level sum bit for bit; so the tc route equals the
    simt route, and lies within the reference's 1e-5 of its xla and
    Pallas (interpret) paths."""
    x, codes, scale = _inputs(M, K, N, M * 1000 + N, per_col)
    s = torch.from_numpy(np.broadcast_to(scale, (N,)).copy())
    xt, ct = torch.from_numpy(x), torch.from_numpy(codes)
    got = _tc_emulated(xt, ct, s)
    want = _exact_sum(xt, ct, s)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    for backend in ("xla", "pallas"):
        jwant = jops.imc_mvm(jnp.asarray(x), jnp.asarray(codes),
                             jnp.asarray(scale), backend=backend)
        np.testing.assert_allclose(got.numpy(), np.asarray(jwant), **TOL)


def test_tc_numerics_round_non_binary_x_to_bf16():
    """x outside {0, 1} is outside the op's domain; the tc route reads it
    as bf16: its result depends on bf16(x) only, lies within 1e-5 of the
    plain version on bf16(x), and moves away from the fp32 plain version."""
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.random((32, 96)).astype(np.float32))
    codes = torch.from_numpy(rng.integers(0, 4, (96, 48)).astype(np.int8))
    scale = torch.from_numpy(rng.random(48).astype(np.float32) + 0.5)
    xb = x.bfloat16().float()
    got = _tc_emulated(x, codes, scale)
    assert torch.equal(got, _tc_emulated(xb, codes, scale))
    want = ref.imc_mvm_ref(xb, codes, scale)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    assert float((got - ref.imc_mvm_ref(x, codes, scale)).abs().max()) > 1e-4
