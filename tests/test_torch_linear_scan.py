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
