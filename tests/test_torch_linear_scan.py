"""PyTorch port vs the JAX reference: kernels/linear_scan.

The port's references and its kernel wrapper (which takes the plain
version on CPU tensors) are held to the reference's ``ref`` functions and
to its Pallas kernel in interpret mode: 1e-5 in fp32, 2e-2 in bf16 (one
bf16 ulp at |h| ~ 2, where the two fp32 accumulation orders may round
differently).  The CUDA kernel itself is checked on the card by
tests/test_torch_cuda.py and chip_smoke.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.linear_scan import ops as jops
from repro.kernels.linear_scan import ref as jref
from repro_torch.kernels.linear_scan import ops as tops
from repro_torch.kernels.linear_scan import ref as tref

torch.set_num_threads(1)

TOL = {np.float32: 1e-5, "bf16": 2e-2}


def _inputs(B, T, D, seed=0):
    rng = np.random.default_rng(seed)
    z = 1.0 / (1.0 + np.exp(-rng.standard_normal((B, T, D))))
    a = (1.0 - z).astype(np.float32)
    b = (z * rng.standard_normal((B, T, D))).astype(np.float32)
    h0 = rng.standard_normal((B, D)).astype(np.float32)
    return a, b, h0


def _to(x, dt):
    t = torch.from_numpy(x)
    return t.bfloat16() if dt == "bf16" else t


def _jto(x, dt):
    return jnp.asarray(x, jnp.bfloat16 if dt == "bf16" else jnp.float32)


@pytest.mark.parametrize("dt", [np.float32, "bf16"])
@pytest.mark.parametrize("which", ["sequential", "associative"])
def test_references_match_jax(which, dt):
    a, b, h0 = _inputs(2, 37, 24)
    want = getattr(jref, f"linear_scan_{which}")(_jto(a, dt), _jto(b, dt),
                                                 _jto(h0, dt))
    got = getattr(tref, f"linear_scan_{which}")(_to(a, dt), _to(b, dt),
                                                _to(h0, dt))
    assert got.dtype == (torch.bfloat16 if dt == "bf16" else torch.float32)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL[dt], rtol=TOL[dt])


@pytest.mark.parametrize("dt", [np.float32, "bf16"])
def test_kernel_wrapper_on_cpu_matches_pallas_interpret(dt):
    """The wrapper's CPU path vs the TPU kernel run in interpret mode, at a
    ragged shape (the reference pads; the port masks)."""
    a, b, h0 = _inputs(2, 19, 130, seed=1)
    want = jops.linear_scan(_jto(a, dt), _jto(b, dt), _jto(h0, dt),
                            backend="pallas", tblk=8, dblk=128)
    got = tops.linear_scan_kernel(_to(a, dt), _to(b, dt), _to(h0, dt))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL[dt], rtol=TOL[dt])


@pytest.mark.parametrize("backend", tops.BACKENDS)
def test_dispatch_and_mingru_scan(backend):
    rng = np.random.default_rng(2)
    z = rng.random((3, 16, 8)).astype(np.float32)
    ht = rng.standard_normal((3, 16, 8)).astype(np.float32)
    h0 = rng.standard_normal((3, 8)).astype(np.float32)
    want = jops.mingru_scan(jnp.asarray(z), jnp.asarray(ht), jnp.asarray(h0),
                            backend="seq")
    got = tops.mingru_scan(torch.from_numpy(z), torch.from_numpy(ht),
                           torch.from_numpy(h0), backend=backend)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_unknown_backend_and_empty_sequence():
    a = torch.zeros(2, 0, 4)
    assert tops.linear_scan(a, a, torch.zeros(2, 4), "seq").shape == (2, 0, 4)
    assert tops.linear_scan(a, a, torch.zeros(2, 4), "assoc").shape == \
        (2, 0, 4)
    with pytest.raises(ValueError, match="unknown backend"):
        tops.linear_scan(a, a, torch.zeros(2, 4), backend="pallas")


# ---------------------------------------------------------------------------
# The backward: LinearScan's VJP against jax.vjp of the reference's
# custom-VJP scan (its own _bwd), same inputs and cotangent.  Tolerances
# as above: 1e-5 in fp32, 2e-2 in bf16 (one bf16 ulp of λ at |λ| ~ 2).


def _grads_port(a, b, h0, g, dt, backend="kernel"):
    ta, tb, th0 = (_to(x, dt).requires_grad_() for x in (a, b, h0))
    h = tops.linear_scan(ta, tb, th0, backend=backend)
    assert h.grad_fn is not None
    h.backward(_to(g, dt))
    return h, ta.grad, tb.grad, th0.grad


@pytest.mark.parametrize("dt", [np.float32, "bf16"])
@pytest.mark.parametrize("jbackend", ["xla", "pallas"])
def test_scan_grads_match_jax_vjp(jbackend, dt):
    import jax
    a, b, h0 = _inputs(2, 21, 130, seed=3)
    g = np.random.default_rng(4).standard_normal(a.shape).astype(np.float32)
    h_j, vjp = jax.vjp(
        lambda a_, b_, h_: jops.linear_scan(a_, b_, h_, backend=jbackend,
                                            tblk=8, dblk=128),
        _jto(a, dt), _jto(b, dt), _jto(h0, dt))
    want = vjp(_jto(g, dt))
    h, *got = _grads_port(a, b, h0, g, dt)
    np.testing.assert_allclose(h.detach().float().numpy(),
                               np.asarray(h_j, np.float32),
                               atol=TOL[dt], rtol=TOL[dt])
    for name, x, y in zip(("da", "db", "dh0"), got, want):
        assert x.dtype == h.dtype, name
        np.testing.assert_allclose(x.float().numpy(),
                                   np.asarray(y, np.float32), atol=TOL[dt],
                                   rtol=TOL[dt], err_msg=name)


def _fp64_args(seed=5):
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.uniform(0.2, 0.9, (2, 6, 3)))
    b = torch.from_numpy(rng.standard_normal((2, 6, 3)))
    h0 = torch.from_numpy(rng.standard_normal((2, 3)))
    return tuple(x.requires_grad_() for x in (a, b, h0))


def test_scan_gradcheck_fp64():
    """The plain backward is the exact adjoint: fp64 finite differences of
    the sequential scan, which carries in the inputs' dtype."""
    assert torch.autograd.gradcheck(
        lambda *xs: tops.linear_scan(*xs, backend="seq"), _fp64_args())


@pytest.mark.parametrize("backend", ["kernel", "assoc"])
def test_scan_grads_fp64_match_sequential(backend):
    """The associative forms carry in fp32 (as the reference's do), so
    their gradients hold to the exact adjoint at fp32 precision."""
    grads = []
    for be in (backend, "seq"):
        args = _fp64_args()
        h = tops.linear_scan(*args, backend=be)
        (h * h).sum().backward()
        grads.append([x.grad for x in args])
    for x, y in zip(*grads):
        np.testing.assert_allclose(x.numpy(), y.numpy(), atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("dt", [np.float32, "bf16"])
def test_bwd_kernel_wrapper_on_cpu_is_the_plain_backward(dt):
    """On CPU tensors the adjoint wrapper takes ref.linear_scan_bwd; the
    sequential and associative adjoints agree."""
    a, b, h0 = _inputs(3, 17, 9, seed=6)
    g = np.random.default_rng(7).standard_normal(a.shape).astype(np.float32)
    ta, th0, tg = _to(a, dt), _to(h0, dt), _to(g, dt)
    h = tref.linear_scan_associative(ta, _to(b, dt), th0)
    n0 = tops.linear_scan_bwd_kernel.launches
    got = tops.linear_scan_bwd_kernel(ta, h, th0, tg)
    assert tops.linear_scan_bwd_kernel.launches == n0   # no kernel on CPU
    want = tref.linear_scan_bwd(ta, h, th0, tg,
                                scan=tref.linear_scan_sequential)
    for x, y in zip(got, want):
        np.testing.assert_allclose(x.float().numpy(), y.float().numpy(),
                                   atol=TOL[dt], rtol=TOL[dt])



def _refuse_mixed(fn, args):
    """Each input on the meta device in turn: refused by the wrapper as
    mixed devices; all of them there: refused as an unsupported device."""
    for i in range(len(args)):
        mixed = [a.to("meta") if j == i else a for j, a in enumerate(args)]
        with pytest.raises(ValueError, match="different devices"):
            fn(*mixed)
    with pytest.raises(ValueError, match="unsupported device"):
        fn(*[a.to("meta") for a in args])


def test_wrappers_refuse_mixed_devices():
    """The plain version runs only when every input lies on the CPU: one
    input elsewhere is refused by the wrapper, not handed to torch."""
    a, b, h0 = (torch.from_numpy(x) for x in _inputs(1, 4, 8))
    _refuse_mixed(tops.linear_scan_kernel, [a, b, h0])
    h = tops.linear_scan_kernel(a, b, h0)
    _refuse_mixed(tops.linear_scan_bwd_kernel, [a, h, h0, b])
