"""Paper Fig. 5 reproduction: the 4-phase QAT ladder on sequential data
(port of ``examples/train_smnist.py``).

Trains the three models of Fig. 5 (fp32 / quantized / hardware-compatible)
by gradual quantization-aware training (``train.qat``) and prints the
accuracy ladder next to the paper's numbers.

    PYTHONPATH=src python -m repro_torch.examples.train_smnist        (fast)
    PYTHONPATH=src python -m repro_torch.examples.train_smnist --full (long)

With a real mnist.npz at data/mnist.npz (or $MNIST_NPZ) this runs on real
sequential MNIST; otherwise on the procedurally generated surrogate task
(the measured quantity is the relative degradation down the ladder, as in
Fig. 5).
"""
from __future__ import annotations

import argparse

from repro_torch.data.smnist import load_smnist
from repro_torch.train.qat import QATConfig, train_qat

PAPER = {"float (phase 0)": 0.981, "quantized (phase 2)": 0.977,
         "hardware (phase 3)": 0.969}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--n-train", type=int, default=None,
                    help="training samples (default 1024, --full 8192)")
    ap.add_argument("--phase-epochs", default=None,
                    help="epochs of the four phases, e.g. 1,1,1,1")
    args = ap.parse_args(argv)

    n_train = args.n_train or (8192 if args.full else 1024)
    stride = 1 if args.full else 8
    (xtr, ytr), (xte, yte) = load_smnist(seed=args.seed, n_train=n_train,
                                         n_test=1024)
    train = (xtr[:, ::stride], ytr)
    test = (xte[:, ::stride], yte)
    dims = (1, 64, 64, 64, 64, 10) if args.full else (1, 48, 48, 10)
    epochs = (tuple(int(e) for e in args.phase_epochs.split(","))
              if args.phase_epochs else
              (30, 15, 15, 15) if args.full else (12, 8, 8, 8))
    cfg = QATConfig(dims=dims, phase_epochs=epochs, batch=64, lr=5e-3,
                    seed=args.seed)
    print(f"dims={dims} n_train={n_train} seq_stride={stride}")
    _net, results = train_qat(train, test, cfg, verbose=True,
                              device=args.device)

    print("\n=== Fig. 5 ladder (this run vs paper) ===")
    ladder = [("float (phase 0)", results[0]["test_acc"]),
              ("quantized (phase 2)", results[2]["test_acc"]),
              ("hardware (phase 3)", results[3]["test_acc"])]
    base = ladder[0][1]
    for name, acc in ladder:
        print(f"{name:24s} acc={acc:.4f}  drop={base-acc:+.4f}   "
              f"paper={PAPER[name]:.3f} (drop "
              f"{PAPER['float (phase 0)']-PAPER[name]:+.3f})")
    return results


if __name__ == "__main__":
    main()
