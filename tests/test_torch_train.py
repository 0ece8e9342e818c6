"""PyTorch port: the LM training path (train/loop.py, checkpoint/,
data/pipeline.py, launch/train.py).  The loop and checkpoint tests mirror
tests/test_train_loop.py and tests/test_checkpoint.py on the port; the
data stream is held bitwise to the reference's.  The loss and gradients
are held to the reference in tests/test_torch_lm_grads.py."""
import os

import numpy as np
import pytest
import torch

from repro.data import SyntheticLMDataset as JDataset
from repro_torch.checkpoint import Checkpointer
from repro_torch.checkpoint.checkpointer import _flatten
from repro_torch.configs import get_config
from repro_torch.data import ShardedLoader, SyntheticLMDataset
from repro_torch.launch import train as train_cli
from repro_torch.models import build_model
from repro_torch.optim import AdamW, param_groups
from repro_torch.train import (FailureInjector, StragglerMonitor,
                               TrainConfig, Trainer, build_train_step)

torch.set_num_threads(1)

ARCH = "minimalist-lm-360m-smoke"


def _batch(vocab, seq=16, B=4, step=0):
    return SyntheticLMDataset(vocab=vocab, seq_len=seq).sample(B, step)


def _tensors(b):
    return {k: torch.from_numpy(v).long() for k, v in b.items()}


def test_loss_ignores_masked_labels():
    tm = build_model(get_config(ARCH), device="cpu")
    b = _tensors(_batch(512))
    full, _ = tm.loss(b)
    masked = dict(b, labels=b["labels"].clone())
    masked["labels"][:, 8:] = -1
    part, met = tm.loss(masked)
    sub, _ = tm.loss({"tokens": b["tokens"][:, :8],
                      "labels": b["labels"][:, :8]})
    assert int(met["tokens"]) == 4 * 8
    torch.testing.assert_close(part, sub)       # causal: prefix alone
    assert torch.isfinite(full)


def test_data_pipeline_is_the_reference_stream():
    ds, jds = SyntheticLMDataset(vocab=100, seq_len=16), JDataset(
        vocab=100, seq_len=16)
    for step in (0, 3):
        got, want = ds.sample(4, step, host_salt=1), jds.sample(4, step, 1)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    a = ShardedLoader(ds, global_batch=8, host_id=0, num_hosts=2)
    b = ShardedLoader(ds, global_batch=8, host_id=1, num_hosts=2)
    a1 = a.batch_at(3)
    np.testing.assert_array_equal(a1["tokens"], a.batch_at(3)["tokens"])
    assert a.host_batch == 4
    assert not np.array_equal(a1["tokens"], b.batch_at(3)["tokens"])
    np.testing.assert_array_equal(a1["tokens"][:, 1:], a1["labels"][:, :-1])


# ---------------------------------------------------------------------------
# the loop (tests/test_train_loop.py on the port)


def _trainer(tmp_path, steps=24, fail_at=(), **kw):
    cfg = get_config(ARCH)
    model = build_model(cfg, device="cpu")
    loader = ShardedLoader(SyntheticLMDataset(vocab=cfg.vocab, seq_len=32),
                           global_batch=4)
    kw.setdefault("ckpt_every", 8)
    tcfg = TrainConfig(steps=steps, ckpt_dir=str(tmp_path), log_every=1000,
                       **kw)
    return Trainer(model, AdamW(param_groups(model), lr=1e-3), tcfg,
                   loader=loader, failure_injector=FailureInjector(fail_at))


def test_loss_decreases(tmp_path):
    tr = _trainer(tmp_path, steps=25)
    tr.run()
    losses = [h["loss"] for h in tr.history]
    assert np.mean(losses[-5:]) < np.mean(losses[:5])
    assert tr.restores == 0 and tr.ckpt.latest_step() == 25


def test_crash_restores_and_continues(tmp_path):
    tr = _trainer(tmp_path, steps=12, fail_at=(10,))
    _, step = tr.run()
    assert step == 12 and tr.restores == 1
    steps_seen = [h["step"] for h in tr.history]
    # restored from step 8: steps 8 and 9 ran twice
    assert steps_seen.count(8) == 2 and steps_seen.count(9) == 2
    assert tr.ckpt.latest_step() == 12


def test_resume_from_checkpoint_is_deterministic(tmp_path):
    """Running 0..12 in one go == running 0..8, restarting, 8..12."""
    tr1 = _trainer(tmp_path / "a", steps=12)
    m1, _ = tr1.run()
    _trainer(tmp_path / "b", steps=8).run()
    tr2 = _trainer(tmp_path / "b", steps=12)
    m2, _ = tr2.run()
    assert [h["step"] for h in tr2.history] == [8, 9, 10, 11]
    for p, q in zip(m1.parameters(), m2.parameters()):
        np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(),
                                   atol=1e-5, rtol=1e-5)
    assert tr1.opt.step_count == tr2.opt.step_count == 12


def test_too_many_failures_raises(tmp_path):
    tr = _trainer(tmp_path, steps=10, fail_at=(3, 4, 5, 6, 7),
                  max_failures=2)
    with pytest.raises(RuntimeError, match="injected"):
        tr.run()


def test_grad_compress_training_works(tmp_path):
    tr = _trainer(tmp_path, steps=20, grad_compress=True)
    tr.run()
    losses = [h["loss"] for h in tr.history]
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5])
    state = tr.ckpt.restore()
    assert set(state["aux"]["ef_error"]) == set(tr.named)


def test_microbatch_accumulation_matches_full_batch():
    """accum(k=2) over the same tokens ≈ one big batch; Adam's sqrt(v)
    normalisation may move a near-zero-gradient parameter by up to ~2·lr
    (tests/test_train_loop.py's envelope)."""
    cfg = get_config(ARCH)
    batch = _tensors(_batch(cfg.vocab))
    out = []
    for mb in (None, 2):
        model = build_model(cfg, device="cpu",
                            generator=torch.Generator().manual_seed(0))
        opt = AdamW(param_groups(model), lr=1e-2, max_grad_norm=None)
        _, met = build_train_step(model, opt, microbatch=mb)({}, batch)
        out.append((model, met))
    (m1, met1), (m2, met2) = out
    np.testing.assert_allclose(float(met1["loss"]), float(met2["loss"]),
                               atol=2e-2)
    for a, b in zip(m1.parameters(), m2.parameters()):
        d = (a - b).abs().detach().numpy()
        assert (d < 5e-3).mean() > 0.995, d.max()
        assert d.max() < 2.5e-2


def test_straggler_monitor_flags_outliers():
    mon = StragglerMonitor(threshold=3.0)
    for i in range(10):
        mon.record(i, 0.1)
    assert mon.record(10, 1.0)
    assert not mon.record(11, 0.12)
    assert len(mon.flagged) == 1


def test_launch_train_smoke_cli(tmp_path, capsys):
    tr = train_cli.main(["--smoke", "--device", "cpu", "--steps", "3",
                         "--seq", "16", "--batch", "2", "--ckpt-dir",
                         str(tmp_path)])
    assert [h["step"] for h in tr.history] == [0, 1, 2]
    assert tr.ckpt.latest_step() == 3
    assert "done at step 3" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the checkpointer (tests/test_checkpoint.py on the port)


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn(4, 8, generator=g),
                       "b": torch.zeros(8)},
            "opt": {"m": {"w": torch.ones(4, 8) * 0.5}, "step": 7}}


def test_checkpoint_roundtrip_and_layout(tmp_path):
    ck = Checkpointer(str(tmp_path), keep_n=2)
    t = _tree()
    ck.save(10, t, blocking=True)
    d = tmp_path / "step_00000010"
    assert (d / "MANIFEST.json").exists()
    assert (d / "params%2Fw.npy").exists()
    got = ck.restore()
    fa, fb = _flatten(t), _flatten(got)
    assert set(fa) == set(fb)
    for k in fa:
        np.testing.assert_array_equal(np.asarray(fa[k]), fb[k])
    on_dev = ck.restore(10, device="cpu")
    assert torch.equal(on_dev["params"]["w"], t["params"]["w"])


def test_checkpoint_latest_and_retention(tmp_path):
    ck = Checkpointer(str(tmp_path), keep_n=2)
    for s in (1, 2, 3, 4):
        ck.save(s, _tree(s), blocking=True)
    assert ck.latest_step() == 4
    assert ck.steps() == [3, 4]


def test_checkpoint_async_save_sees_a_host_copy(tmp_path):
    ck = Checkpointer(str(tmp_path))
    t = _tree()
    want = t["params"]["w"].clone()
    ck.save(5, t, blocking=False)
    t["params"]["w"].add_(1.0)        # the next step updates in place
    ck.wait()
    assert ck.latest_step() == 5
    np.testing.assert_array_equal(ck.restore()["params"]["w"], want.numpy())


def test_checkpoint_partial_write_is_invisible(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, _tree(), blocking=True)
    os.makedirs(str(tmp_path / "step_00000009.tmp"))
    with open(str(tmp_path / "step_00000009.tmp" / "x.npy"), "w") as f:
        f.write("garbage")
    assert ck.latest_step() == 1


def test_checkpoint_restore_none_when_empty(tmp_path):
    ck = Checkpointer(str(tmp_path))
    assert ck.restore() is None
    assert ck.latest_step() is None
