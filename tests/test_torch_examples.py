"""The port's five examples (``repro_torch.examples``) on the CPU at their
smallest sizes, with the checks their references in ``examples/`` make:
the quickstart's circuit replay agrees with the trained network on more
than 90 % of the streams (and, here, the fused sequence kernel's plain
version too); the QAT ladder yields four phases of accuracies; the LM
trains through ``launch.train``; the serving example drains every
request of its three state regimes; the mixed-signal demo's ideal
circuit matches the network's gate codes."""
import numpy as np
import torch

from repro_torch.examples import (mixed_signal_demo, quickstart, serve_batch,
                                  train_lm, train_smnist)

torch.set_num_threads(1)


def test_quickstart_circuit_reproduces_the_trained_model():
    out = quickstart.main(["--device", "cpu", "--n-train", "128",
                           "--epochs", "1,1"])
    assert out["agree"] > 0.9 and out["agree_kernel"] > 0.9
    assert 0.0 <= out["accuracy"] <= 1.0


def test_train_smnist_runs_the_four_phase_ladder():
    results = train_smnist.main(["--device", "cpu", "--n-train", "128",
                                 "--phase-epochs", "1,1,1,1"])
    assert [r["phase"] for r in results] == [0, 1, 2, 3]
    assert all(0.0 <= r["test_acc"] <= 1.0 for r in results)
    assert results[-1]["quant"]["quantize_gate_6b"]


def test_train_lm_trains_through_the_training_cli(tmp_path):
    trainer = train_lm.main(["--device", "cpu", "--smoke", "--steps", "2",
                             "--batch", "2", "--seq", "16",
                             "--ckpt-dir", str(tmp_path)])
    losses = [h["loss"] for h in trainer.history]
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert trainer.model.cfg.name == "minimalist-lm-100m-smoke"


def test_serve_batch_drains_every_regime():
    out = serve_batch.main(["--device", "cpu"])
    assert list(out) == list(serve_batch.ARCHS)
    for arch, r in out.items():
        assert tuple(r["baseline"].shape) == (4, 24), arch
        assert len(r["done"]) == 8, arch
        vocab = r["engine"].sm.model.cfg.vocab
        for req in r["done"]:
            toks = req.tokens
            assert req.finished and len(toks) > 0, arch
            assert ((toks >= 0) & (toks < vocab)).all(), arch
        assert r["engine"].n_emitted >= sum(len(q.tokens)
                                            for q in r["done"])


def test_mixed_signal_demo_ideal_circuit_matches_gate_codes():
    out = mixed_signal_demo.main(["--device", "cpu", "--steps", "32"])
    assert out["z_match"] > 0.9
    assert 0.0 <= out["z_match_mismatch"] <= 1.0
