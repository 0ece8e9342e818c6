"""PyTorch port vs the JAX reference: the QAT ladder (train/qat.py) and
its data (data/smnist.py).

One loss-and-gradient evaluation per QAT phase, on the reference's
parameters and the same batch.  Phases 0–2: loss within 1e-5 and every
gradient tensor within 1e-4 of its largest entry (plus an fp32 floor of
1e-7: some readout-gate gradients are ~1e-6 in all, where the two
summation orders differ by ~5e-9).  Phase 3 (hardware gate): loss within
1e-4 and gradient cosine > 0.999, since the port's fp32 order
(x@levels)·Δ and the reference's x@(levels·Δ) may move one 6 b gate
code."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.mingru import MinimalistNetwork as JNet
from repro.core.quant import QAT_PHASES as JPHASES
from repro.data import smnist as jsmnist
from repro.train.qat import accuracy as jaccuracy
from repro_torch.bridge import load_jax_params
from repro_torch.core.mingru import MinimalistNetwork
from repro_torch.core.quant import QAT_PHASES, QuantConfig
from repro_torch.data import smnist
from repro_torch.train.qat import QATConfig, accuracy, qat_loss, train_qat

torch.set_num_threads(1)

DIMS = (1, 16, 16, 10)


def _batch():
    (x, y), _ = smnist.load_smnist(seed=0, n_train=32, n_test=8)
    return x[:16, ::16], y[:16]


def _pair(phase, seed):
    jnet = JNet(DIMS, qcfg=JPHASES[phase])
    jp = jnet.init(jax.random.PRNGKey(seed))
    tnet = MinimalistNetwork(DIMS, qcfg=QAT_PHASES[phase], device="cpu")
    load_jax_params(tnet, jax.tree_util.tree_map(np.asarray, jp))
    return jnet, jp, tnet


@pytest.mark.parametrize("phase", [0, 1, 2, 3])
def test_qat_phase_loss_and_grads_match_reference(phase):
    assert dataclasses.asdict(QAT_PHASES[phase]) == \
        dataclasses.asdict(JPHASES[phase])
    x, y = _batch()
    jnet, jp, tnet = _pair(phase, seed=phase)

    def jloss(p):      # the reference's train_qat loss_fn
        logp = jax.nn.log_softmax(jnet(p, jnp.asarray(x)).astype(
            jnp.float32))
        return -jnp.take_along_axis(logp, jnp.asarray(y)[:, None],
                                    -1).mean()
    jl, jg = jax.jit(jax.value_and_grad(jloss))(jp)
    loss = qat_loss(tnet, torch.from_numpy(x), torch.from_numpy(y))
    loss.backward()
    assert abs(loss.item() - float(jl)) <= (1e-5 if phase < 3 else 1e-4)
    for name, p in tnet.named_parameters():
        blk, leaf = name.split(".")
        got = p.grad.double().numpy().ravel()
        want = np.asarray(jg[blk][leaf], np.float64).ravel()
        if phase < 3:
            err = np.abs(got - want).max()
            assert err <= 1e-4 * np.abs(want).max() + 1e-7, (name, err)
        else:
            cos = got @ want / (np.linalg.norm(got) * np.linalg.norm(want))
            assert cos > 0.999, (name, cos)


def test_smnist_is_the_reference_data():
    got = smnist.load_smnist(seed=3, n_train=20, n_test=10, binarize=True)
    want = jsmnist.load_smnist(seed=3, n_train=20, n_test=10, binarize=True)
    for a, b in zip(got, want):
        for u, v in zip(a, b):
            np.testing.assert_array_equal(u, v)
    assert got[0][0].shape == (20, smnist.SEQ_LEN, 1)


def test_accuracy_matches_reference():
    (x, y), _ = smnist.load_smnist(seed=1, n_train=40, n_test=8)
    x = (x[:, ::32] > 0.5).astype(np.float32)
    jnet, jp, tnet = _pair(3, seed=5)
    jitted = jax.jit(jnet.__call__)
    assert accuracy(tnet, x, y, batch=40) == jaccuracy(
        lambda p, xb: jitted(p, xb), jp, x, y, batch=40)


def test_train_qat_runs_the_ladder_on_cpu():
    """Four phases end to end at a tiny size: one result per phase with the
    phase's QuantConfig, a hardware-mode network back, loss falling in
    phase 0, and the same seed giving the same run."""
    (xtr, ytr), (xte, yte) = smnist.load_smnist(seed=0, n_train=64,
                                                n_test=32)
    tr, te = (xtr[:, ::49], ytr), (xte[:, ::49], yte)
    cfg = QATConfig(dims=(1, 12, 10), phase_epochs=(3, 1, 1, 1), batch=16,
                    lr=5e-3)
    net, results = train_qat(tr, te, cfg, verbose=False, device="cpu")
    assert [r["phase"] for r in results] == [0, 1, 2, 3]
    assert results[-1]["quant"] == dataclasses.asdict(QuantConfig.hardware())
    assert net.qcfg == QuantConfig.hardware()
    assert all(0.0 <= r["test_acc"] <= 1.0 for r in results)
    net2, results2 = train_qat(tr, te, cfg, verbose=False, device="cpu")
    assert results2 == results
    for p, q in zip(net.parameters(), net2.parameters()):
        assert torch.equal(p, q)
