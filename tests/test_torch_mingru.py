"""PyTorch port vs the JAX reference: core.mingru under all three
QuantConfig modes of paper Fig. 5, at 1e-5 (fp32), on parameters loaded
through repro_torch.bridge.load_jax_params."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.mingru import MinGRUBlock as JBlock
from repro.core.mingru import MinimalistNetwork as JNet
from repro.core.quant import QuantConfig as JQ
from repro_torch.bridge import load_jax_params
from repro_torch.core.mingru import MinGRUBlock as TBlock
from repro_torch.core.mingru import MinimalistNetwork as TNet
from repro_torch.core.quant import QuantConfig as TQ

torch.set_num_threads(1)

MODES = ["float_baseline", "quantized", "hardware"]


def _np_tree(p):
    return jax.tree_util.tree_map(np.asarray, p)


def _close(got, want, atol=1e-5):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=1e-5)


def _block(mode, K=6, N=10, seed=0):
    jb = JBlock(K, N, qcfg=getattr(JQ, mode)())
    jp = jb.init(jax.random.PRNGKey(seed))
    tb = TBlock(K, N, qcfg=getattr(TQ, mode)())
    load_jax_params(tb, _np_tree(jp))
    return jb, jp, tb


@pytest.mark.parametrize("mode", MODES)
def test_block_sequence_and_step_match_reference(mode):
    jb, jp, tb = _block(mode)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 11, 6)).astype(np.float32)
    h0 = rng.standard_normal((2, 10)).astype(np.float32)
    jo, jh = jb(jp, jnp.asarray(x), jnp.asarray(h0))
    with torch.no_grad():
        to, th = tb(torch.from_numpy(x), torch.from_numpy(h0))
    _close(th, jh)
    if tb.qcfg.binary_output:
        # binary outputs may flip only at |h| ~ 0 threshold ties
        flips = to.numpy() != np.asarray(jo)
        assert not (flips & (np.abs(np.asarray(jh)) > 1e-4)).any()
    else:
        _close(to, jo)
    jo1, jh1 = jb.step(jp, jnp.asarray(x[:, 0]), jnp.asarray(h0))
    with torch.no_grad():
        to1, th1 = tb.step(torch.from_numpy(x[:, 0]), torch.from_numpy(h0))
    _close(th1, jh1)
    _close(to1, jo1)


@pytest.mark.parametrize("mode", MODES)
def test_network_forward_traces_step_prefill(mode):
    dims = (3, 8, 8, 4)
    jn = JNet(dims, qcfg=getattr(JQ, mode)())
    jp = jn.init(jax.random.PRNGKey(1))
    tn = TNet(dims, qcfg=getattr(TQ, mode)())
    load_jax_params(tn, _np_tree(jp))
    x = np.random.default_rng(1).standard_normal((2, 9, 3)).astype(
        np.float32)
    jl, jtr = jn(jp, jnp.asarray(x), collect_traces=True)
    with torch.no_grad():
        tl, ttr = tn(torch.from_numpy(x), collect_traces=True)
        _close(tl, jl)
        assert set(ttr) == set(jtr)
        for name in jtr:
            for key in ("htilde", "z", "h"):
                _close(ttr[name][key], jtr[name][key])
        # step-by-step == one prefill == forward's last readout
        st = tn.initial_state(2)
        jst = jn.initial_state(2)
        for t in range(x.shape[1]):
            to, st = tn.step(torch.from_numpy(x[:, t]), st)
            jo, jst = jn.step(jp, jnp.asarray(x[:, t]), jst)
            _close(to, jo)
        ty, tst = tn.prefill(torch.from_numpy(x))
    jy, jpst = jn.prefill(jp, jnp.asarray(x))
    _close(ty, jy)
    for a, b in zip(tst, jpst):
        _close(a, b)
    np.testing.assert_allclose(ty[:, -1].numpy(), tl.numpy(), atol=1e-5)


def test_bridge_rejects_missing_and_misshapen_params():
    tb = TBlock(4, 5)
    jp = _np_tree(JBlock(4, 5).init(jax.random.PRNGKey(0)))
    with pytest.raises(KeyError):
        load_jax_params(tb, {k: v for k, v in jp.items() if k != "bz"})
    with pytest.raises(ValueError, match="shape"):
        load_jax_params(tb, {**jp, "wh": np.zeros((5, 4), np.float32)})
