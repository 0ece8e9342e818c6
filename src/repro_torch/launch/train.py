"""End-to-end training entry point (port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch minimalist-lm-360m --steps 300 --batch 8 --seq 256
    PYTHONPATH=src python -m repro_torch.launch.train --smoke \\
        --device cpu --steps 5
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
        --attention-impl flash --batch 4 --seq 2048
    PYTHONPATH=src python -m repro_torch.launch.train --arch falcon-mamba-7b \\
        --smoke --device cpu --ssm-impl fused --steps 3
    PYTHONPATH=src python -m repro_torch.launch.train --arch falcon-mamba-7b \\
        --layers 8 --ssm-impl fused --batch 4 --seq 2048 --steps 20

Runs on one CUDA device unless ``--device`` names another.  Uses the
synthetic structured-token pipeline, AdamW + cosine with the reference's
decay mask, checkpoint/restart, straggler monitoring and optional int8
gradient compression.  The minGRU scans go through the forward and
adjoint CUDA kernels on the card; with ``--attention-impl flash`` an
attention LM's layers go through the flash-attention forward and
backward kernels; with ``--ssm-impl fused`` a Mamba LM's layers go
through the fused selective-scan forward and backward kernels.
"""
from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ATTENTION_IMPLS, SSM_IMPLS
from repro_torch.data import ShardedLoader, SyntheticLMDataset
from repro_torch.models import build_model
from repro_torch.optim import AdamW, cosine_schedule, param_groups
from repro_torch.train import TrainConfig, Trainer
from repro_torch.train.loop import DEFAULT_CKPT_DIR


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="minimalist-lm-360m")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config variant")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatch", type=int, default=None)
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--ckpt-dir", default=DEFAULT_CKPT_DIR)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds the parameter initialisation")
    ap.add_argument("--attention-impl", default=None,
                    choices=ATTENTION_IMPLS,
                    help="attention LMs: the naive softmax or the flash-"
                    "attention kernels (default: the config's own)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the stack to this many layers (default: the "
                    "config's own; falcon-mamba-7b's 64 need ~116 GB of "
                    "fp32 AdamW state, 8 fit one 80 GB card)")
    ap.add_argument("--ssm-impl", default=None, choices=SSM_IMPLS,
                    help="Mamba LMs: the materializing scan or the fused "
                    "selective-scan kernels (default: the config's own)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch + ("-smoke" if args.smoke else ""))
    if args.attention_impl:
        cfg = dataclasses.replace(cfg, attention_impl=args.attention_impl)
    if args.ssm_impl:
        cfg = dataclasses.replace(cfg, ssm_impl=args.ssm_impl)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    model = build_model(cfg, device=args.device,
                        generator=torch.Generator(
                            device=args.device).manual_seed(args.seed))
    ds = SyntheticLMDataset(vocab=cfg.vocab, seq_len=args.seq)
    loader = ShardedLoader(ds, global_batch=args.batch)
    opt = AdamW(param_groups(model),
                lr=cosine_schedule(args.lr, warmup=args.steps // 20,
                                   total=args.steps))
    tcfg = TrainConfig(steps=args.steps, ckpt_every=args.ckpt_every,
                       ckpt_dir=args.ckpt_dir, microbatch=args.microbatch,
                       grad_compress=args.grad_compress, log_every=10)
    trainer = Trainer(model, opt, tcfg, loader=loader, seed=args.seed)
    _, step = trainer.run()
    losses = [h["loss"] for h in trainer.history]
    if losses:
        k = max(1, len(losses) // 10)
        print(f"done at step {step}; loss first-{k}-mean "
              f"{sum(losses[:k])/k:.4f} -> last-{k}-mean "
              f"{sum(losses[-k:])/k:.4f}")
    return trainer


if __name__ == "__main__":
    main()
