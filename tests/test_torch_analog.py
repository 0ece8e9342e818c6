"""PyTorch port vs the JAX reference: core/analog.py, the
switched-capacitor circuit model.

Same parameters (reference-initialised, bridged) and the same numpy
inputs and mismatch arrays through both.  Voltages and model-unit traces
within 1e-6 (fp32 charge sharing summed in another order); ADC codes,
exported codes and DAC presets equal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import analog as ja
from repro.core import quant as jquant
from repro.core.mingru import MinimalistNetwork as JNet
from repro_torch.bridge import load_jax_params
from repro_torch.core import analog as ta
from repro_torch.core import quant
from repro_torch.core.mingru import MinimalistNetwork

torch.set_num_threads(1)

DIMS = (4, 8, 8, 5)
TOL = dict(atol=1e-6, rtol=1e-6)


def _nets(seed=0):
    jnet = JNet(DIMS, qcfg=jquant.QuantConfig.hardware())
    jp = jnet.init(jax.random.PRNGKey(seed))
    tnet = MinimalistNetwork(DIMS, qcfg=quant.QuantConfig.hardware(),
                             device="cpu")
    load_jax_params(tnet, jax.tree_util.tree_map(np.asarray, jp))
    return jnet, jp, tnet


def _x(B=3, T=8, K=DIMS[0], seed=1):
    return (np.random.default_rng(seed).random((B, T, K)) > 0.5).astype(
        np.float32)


def _images(seed=0, acfg=ja.AnalogConfig()):
    jnet, jp, tnet = _nets(seed)
    jimgs = [ja.export_layer(jp[b.name], acfg) for b in jnet.blocks]
    timgs = [ta.export_layer(b, ta.AnalogConfig(**vars(acfg)))
             for b in tnet.blocks]
    return jnet, jp, tnet, jimgs, timgs


def test_export_layer_matches_reference():
    *_, jimgs, timgs = _images(seed=2)
    for j, t in zip(jimgs, timgs):
        np.testing.assert_array_equal(t.codes_h.numpy(), j.codes_h)
        np.testing.assert_array_equal(t.codes_z.numpy(), j.codes_z)
        np.testing.assert_array_equal(t.adc_offset_code.numpy(),
                                      j.adc_offset_code)
        np.testing.assert_allclose(t.bias_h_v.numpy(), j.bias_h_v, **TOL)
        assert (t.alpha, t.scale, t.k_rows) == (j.alpha, j.scale, j.k_rows)


@pytest.mark.parametrize("mismatch", [False, True])
def test_charge_sharing_matches_reference(mismatch):
    rng = np.random.default_rng(3)
    acfg = ja.AnalogConfig(mismatch_sigma=0.01)
    codes = rng.integers(0, 4, (32, 16))
    x = (rng.random((4, 32)) > 0.5).astype(np.float32)
    bias = (rng.standard_normal(16) * 0.01).astype(np.float32)
    caps = (1.0 + 0.01 * rng.standard_normal((33, 16))).astype(np.float32) \
        if mismatch else None
    want = ja.charge_sharing_mvm(
        jnp.asarray(x), codes, jnp.asarray(bias), acfg,
        caps=None if caps is None else jnp.asarray(caps))
    got = ta.charge_sharing_mvm(
        torch.from_numpy(x), torch.from_numpy(codes), torch.from_numpy(bias),
        ta.AnalogConfig(mismatch_sigma=0.01),
        caps=None if caps is None else torch.from_numpy(caps))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_sar_adc_matches_reference_and_closed_form():
    acfg, tcfg = ja.AnalogConfig(), ta.AnalogConfig()
    v = np.linspace(0.1, 0.7, 4001).astype(np.float32)
    offsets = np.arange(-20, 21, 4, dtype=np.int32).repeat(
        -(-4001 // 11))[:4001]
    for off in (0, -3, 17, offsets):
        want = ja.sar_adc(jnp.asarray(v), acfg, lsb_volts=0.0031,
                          offset_code=off)
        got = ta.sar_adc(torch.from_numpy(v), tcfg, lsb_volts=0.0031,
                         offset_code=torch.as_tensor(off))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        closed = ta.adc_transfer_closed_form(
            torch.from_numpy(v), tcfg, lsb_volts=0.0031,
            offset_code=torch.as_tensor(off))
        assert (closed == got).float().mean() > 0.999  # float ties only


@pytest.mark.parametrize("mismatch", [False, True])
def test_state_update_swap_matches_reference(mismatch):
    rng = np.random.default_rng(4)
    v_h = (0.4 + 0.05 * rng.standard_normal((3, 6))).astype(np.float32)
    v_ht = (0.4 + 0.05 * rng.standard_normal((3, 6))).astype(np.float32)
    z = rng.integers(0, 64, (3, 6)).astype(np.int32)
    segs = (1 + 0.02 * rng.standard_normal((63, 6))).astype(np.float32) \
        if mismatch else None
    want = ja.state_update_swap(
        jnp.asarray(v_h), jnp.asarray(v_ht), jnp.asarray(z),
        ja.AnalogConfig(), seg_caps=None if segs is None else
        jnp.asarray(segs))
    got = ta.state_update_swap(
        torch.from_numpy(v_h), torch.from_numpy(v_ht), torch.from_numpy(z),
        ta.AnalogConfig(), seg_caps=None if segs is None else
        torch.from_numpy(segs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _compare_forward(jimgs, timgs, x, acfg, jmm=None, tmm=None,
                     forced=None):
    jread, jtr = ja.analog_forward(jimgs, jnp.asarray(x), acfg,
                                   mismatch=jmm, forced_inputs=forced)
    tread, ttr = ta.analog_forward(
        timgs, torch.from_numpy(x), ta.AnalogConfig(**vars(acfg)),
        mismatch=tmm, forced_inputs=None if forced is None else
        [torch.from_numpy(np.array(f)) for f in forced])
    for li, (j, t) in enumerate(zip(jtr, ttr)):
        np.testing.assert_array_equal(t["z"].numpy(), np.asarray(j["z"]),
                                      err_msg=f"z codes, layer {li}")
        for k in ("htilde", "h"):
            np.testing.assert_allclose(
                t[k].numpy() * timgs[li].alpha,
                np.asarray(j[k]) * jimgs[li].alpha, **TOL,
                err_msg=f"{k} volts, layer {li}")
    np.testing.assert_allclose(tread.numpy() * timgs[-1].alpha,
                               np.asarray(jread) * jimgs[-1].alpha, **TOL)
    return tread, ttr


def test_analog_forward_open_loop_matches_reference():
    jnet, jp, tnet, jimgs, timgs = _images(seed=5)
    x = _x()
    _, sw = jnet(jp, jnp.asarray(x), collect_traces=True)
    forced = [np.asarray(sw[b.name]["out"]) for b in jnet.blocks[:-1]]
    _compare_forward(jimgs, timgs, x, ja.AnalogConfig(), forced=forced)


def test_analog_forward_with_mismatch_matches_reference():
    acfg = ja.AnalogConfig(mismatch_sigma=0.01)
    jnet, jp, tnet, jimgs, timgs = _images(seed=6, acfg=acfg)
    rng = np.random.default_rng(7)
    mm = [{k: np.abs(1 + 0.01 * rng.standard_normal(s)).astype(np.float32)
           for k, s in (("caps_h", (i.k_rows + 1, i.codes_h.shape[1])),
                        ("caps_z", (i.k_rows + 1, i.codes_h.shape[1])),
                        ("segs", (63, i.codes_h.shape[1])))}
          for i in jimgs]
    x = _x(seed=8)
    _, sw = jnet(jp, jnp.asarray(x), collect_traces=True)
    # open loop: a comparator flip on a state within rounding of V0 would
    # otherwise send the two closed loops down different paths
    forced = [np.asarray(sw[b.name]["out"]) for b in jnet.blocks[:-1]]
    _compare_forward(
        jimgs, timgs, x, acfg, forced=forced,
        jmm=[{k: jnp.asarray(v) for k, v in m.items()} for m in mm],
        tmm=[{k: torch.from_numpy(v) for k, v in m.items()} for m in mm])


def test_port_circuit_reproduces_port_network_open_loop():
    """The port's own Fig.-4 check (tests/test_analog.py's open loop): the
    port's circuit against the port's hardware network."""
    _, _, tnet, _, timgs = _images(seed=9)
    x = torch.from_numpy(_x(T=12, seed=10))
    logits, sw = tnet(x, collect_traces=True)
    forced = [sw[f"block{i}"]["out"] for i in range(len(timgs) - 1)]
    readout, an = ta.analog_forward(timgs, x, ta.AnalogConfig(),
                                    forced_inputs=forced)
    for li in range(len(timgs)):
        s = sw[f"block{li}"]
        assert torch.equal(an[li]["z"], s["z"].detach())
        for k in ("htilde", "h"):
            np.testing.assert_allclose(an[li][k].numpy(),
                                       s[k].detach().numpy(), atol=2e-4)
    np.testing.assert_allclose(readout.numpy(), logits.detach().numpy(),
                               atol=2e-4)


def test_mismatch_and_noise_draws_from_a_generator():
    _, _, _, _, timgs = _images(seed=11)
    acfg = ta.AnalogConfig(mismatch_sigma=0.005, comparator_noise_v=0.001)
    mm = [ta.make_mismatch(torch.Generator().manual_seed(5), timgs, acfg)
          for _ in range(2)]
    for a, b in zip(*mm):
        assert a.keys() == {"caps_h", "caps_z", "segs"}
        assert all(torch.equal(a[k], b[k]) for k in a)
    x = torch.from_numpy(_x(seed=12))
    r1, _ = ta.analog_forward(timgs, x, acfg, mismatch=mm[0],
                              generator=torch.Generator().manual_seed(6))
    r2, _ = ta.analog_forward(timgs, x, acfg, mismatch=mm[0],
                              generator=torch.Generator().manual_seed(6))
    assert torch.isfinite(r1).all() and torch.equal(r1, r2)


def test_energy_model_is_the_reference():
    for kw in (dict(rows=64, cols=64, n_cores=4),
               dict(rows=128, cols=64, n_cores=4, z_mean=0.3)):
        assert ta.energy_per_step(**kw) == ja.energy_per_step(**kw)
    assert ta.energy_per_step(64, 64, 4)["total_pJ"] <= 169.0
