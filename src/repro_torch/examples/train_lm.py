"""End-to-end driver: train the ~100M-parameter MINIMALIST-LM (port of
``examples/train_lm.py``).

The paper's minGRU technique as the time-mixing layer of a 12-layer,
d_model=1024 language model (~101 M params with the tied embedding),
trained on the structured synthetic token stream with the production
training loop (``launch.train``: AdamW + cosine, grad clipping,
checkpointing, crash recovery, straggler monitoring); on the card the
minGRU scans run through the forward and adjoint ``linear_scan``
kernels.

    PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 300
    PYTHONPATH=src python -m repro_torch.examples.train_lm --smoke \\
        --device cpu --steps 2

``--hardware`` trains under the full paper constraints (2 b weights /
binary activations / 6 b gate); ``--smoke`` takes the reduced config.
"""
from __future__ import annotations

import argparse

from repro_torch.configs import get_config
from repro_torch.launch.train import main as train_main
from repro_torch.train.loop import DEFAULT_CKPT_DIR


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--hardware", action="store_true",
                    help="full paper constraints (QAT mode)")
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced config (for a quick check)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--ckpt-dir", default=DEFAULT_CKPT_DIR + "_lm100m")
    args = ap.parse_args(argv)

    arch = "minimalist-lm-100m" + ("-hw" if args.hardware else "")
    cfg = get_config(arch + ("-smoke" if args.smoke else ""))
    print(f"arch={cfg.name}: {cfg.n_layers}L d={cfg.d_model} "
          f"params≈{cfg.param_count()/1e6:.0f}M "
          f"(minGRU time mixing, quant={cfg.mingru_quant})")
    train_argv = ["--arch", arch, "--steps", str(args.steps),
                  "--batch", str(args.batch), "--seq", str(args.seq),
                  "--ckpt-dir", args.ckpt_dir, "--device", args.device]
    return train_main(train_argv + (["--smoke"] if args.smoke else []))


if __name__ == "__main__":
    main()
