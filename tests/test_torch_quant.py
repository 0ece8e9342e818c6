"""PyTorch port vs the JAX reference: the quantizers of core.quant.

Forward values are pinned BITWISE (the reference's STE is written so its
forward is exactly the quantized value, and the port keeps that form),
including the two deliberately different signed 6 b grids of
tests/test_quant_grids.py.  Both packages run eagerly on the CPU."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jq
from repro_torch.core import quant as tq

torch.set_num_threads(1)


def _x(n=4096, seed=0, scale=3.0):
    return (np.random.default_rng(seed).standard_normal(n) * scale
            ).astype(np.float32)


UNARY = ["hard_sigmoid", "hard_sigmoid_q6", "quantize_bias_6b",
         "quantize_gate_bias_adc", "sigmoid"]


@pytest.mark.parametrize("name", UNARY)
def test_unary_quantizer_bitwise(name):
    x = _x()
    jfn = jax.nn.sigmoid if name == "sigmoid" else getattr(jq, name)
    want = np.asarray(jfn(jnp.asarray(x)))
    got = getattr(tq, name)(torch.from_numpy(x)).numpy()
    if name == "sigmoid":
        # fp32 logistic: same expansion, exp() may differ by one ulp
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-7)
    else:
        np.testing.assert_array_equal(got, want)


def test_quantize_unit_6b_bitwise_on_the_unit_interval():
    z = np.random.default_rng(1).random(4096).astype(np.float32)
    z[:64] = np.arange(64, dtype=np.float32) / 63     # the grid points
    np.testing.assert_array_equal(
        tq.quantize_unit_6b(torch.from_numpy(z)).numpy(),
        np.asarray(jq.quantize_unit_6b(jnp.asarray(z))))


@pytest.mark.parametrize("scale", [None, 0.05])
def test_weights_2b_values_and_codes_bitwise(scale):
    w = _x(64 * 48, seed=2, scale=0.2).reshape(64, 48)
    jw, jc = jq.quantize_weights_2b(jnp.asarray(w), scale)
    tw, tc = tq.quantize_weights_2b(torch.from_numpy(w), scale)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(
        tq.weight_scale(torch.from_numpy(w)).numpy(),
        np.asarray(jq.weight_scale(jnp.asarray(w))))
    # the level form (sum levels, then scale) scales back to the same
    # weights, with the same identity gradient
    s = tq.weight_scale(torch.from_numpy(w)) if scale is None \
        else torch.tensor(scale)
    wt = torch.from_numpy(w).requires_grad_()
    lv = tq.quantize_levels_2b(wt, s)
    np.testing.assert_array_equal((lv * s).detach().numpy(), np.asarray(jw))
    assert set(np.unique(lv.detach().numpy())) <= {-1.5, -0.5, 0.5, 1.5}
    (lv * s).sum().backward()
    np.testing.assert_allclose(wt.grad.numpy(), 1.0, rtol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_heaviside_forward_exact_and_boxcar_gradient(dtype):
    x = torch.tensor([-4.0, -3.0, -0.5, 0.0, 0.5, 2.9, 3.0, 5.0], dtype=dtype,
                     requires_grad=True)
    y = tq.heaviside_ste(x, surrogate_width=3.0)
    assert y.dtype == dtype
    np.testing.assert_array_equal(y.detach().float().numpy(),
                                  [0, 0, 0, 0, 1, 1, 1, 1])
    y.sum().backward()
    np.testing.assert_allclose(x.grad.float().numpy(),
                               [0, 0, 1 / 6, 1 / 6, 1 / 6, 1 / 6, 0, 0],
                               rtol=1e-2)


def test_ste_gradient_is_identity_and_forward_exact():
    w = torch.from_numpy(_x(256, seed=3, scale=0.3)).requires_grad_()
    wq, _ = tq.quantize_weights_2b(w)
    b = tq.quantize_bias_6b(w)
    (wq.sum() + 2 * b.sum()).backward()
    np.testing.assert_array_equal(w.grad.numpy(), np.full(256, 3.0))
    np.testing.assert_array_equal(
        b.detach().numpy(), np.asarray(jq.quantize_bias_6b(
            jnp.asarray(w.detach().numpy()))))


def test_bias_6b_grid_is_symmetric_63_codes():
    """The pins of test_quant_grids.py, on the port."""
    lsb = 1.0 / 31.0
    b = torch.tensor(np.arange(-31, 32) * lsb, dtype=torch.float32)
    codes = np.round(tq.quantize_bias_6b(b, scale=lsb).numpy() / lsb)
    np.testing.assert_array_equal(codes.astype(int), np.arange(-31, 32))
    deep = torch.tensor([-40.0 * lsb, -31.49 * lsb])
    np.testing.assert_allclose(tq.quantize_bias_6b(deep, scale=lsb).numpy(),
                               [-31 * lsb, -31 * lsb], rtol=1e-6)
    np.testing.assert_array_equal(
        tq.quantize_bias_6b(-b, scale=lsb).numpy(),
        -tq.quantize_bias_6b(b, scale=lsb).numpy())
    np.testing.assert_array_equal(
        tq.quantize_bias_6b(torch.tensor([1.0, -1.0])).numpy(), [1.0, -1.0])


def test_gate_bias_adc_grid_is_twos_complement():
    lsb = tq.ADC_GATE_BIAS_LSB
    assert lsb == jq.ADC_GATE_BIAS_LSB == 6.0 / 63.0
    edges = torch.tensor([-40.0 * lsb, -32.0 * lsb, 32.0 * lsb, 40.0 * lsb])
    np.testing.assert_allclose(tq.quantize_gate_bias_adc(edges).numpy(),
                               [-32 * lsb, -32 * lsb, 31 * lsb, 31 * lsb],
                               rtol=1e-6)
    sweep = torch.linspace(-5, 5, 1001)
    codes = np.round(tq.quantize_gate_bias_adc(sweep).numpy() / lsb)
    assert codes.min() == -32 and codes.max() == 31


def test_quant_config_ladder_matches_reference():
    assert len(tq.QAT_PHASES) == len(jq.QAT_PHASES)
    for tp, jp in zip(tq.QAT_PHASES, jq.QAT_PHASES):
        assert dataclasses.asdict(tp) == dataclasses.asdict(jp)
