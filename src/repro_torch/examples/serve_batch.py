"""Batched serving example: continuous batching vs the static-batch loop
(port of ``examples/serve_batch.py``).

Serves three state-management regimes through the same step-model
protocol (smoke sizes, as the reference):
  * smollm-360m      — GQA KV cache (grows with context; per-slot pos)
  * falcon-mamba-7b  — O(1) SSM state (the long-context serving case)
  * minimalist-lm    — the paper's minGRU: O(1) state inference, the
                       edge-serving story of the paper (on the card its
                       prefill scans through the ``linear_scan`` kernel)

    PYTHONPATH=src python -m repro_torch.examples.serve_batch
    PYTHONPATH=src python -m repro_torch.examples.serve_batch --device cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.common import resolve_device
from repro_torch.configs import SamplingParams, ServeConfig, get_config
from repro_torch.launch.serve import build_engine, generate
from repro_torch.models import build_model

ARCHS = ("smollm-360m", "falcon-mamba-7b", "minimalist-lm-360m")


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    out = {}
    for arch in ARCHS:
        cfg = get_config(arch + "-smoke")
        model = build_model(cfg, device=dev,
                            generator=torch.Generator(device=dev)
                            .manual_seed(0))
        B, P, G = 4, 16, 24
        rng = np.random.default_rng(1)
        prompts = rng.integers(0, cfg.vocab, size=(B, P))

        # static-batch baseline: every row locked for P + G steps
        t0 = time.time()
        base = generate(model, prompts, max_len=P + G + 1, gen_tokens=G)
        _sync(dev)
        dt_base = time.time() - t0

        # continuous batching: mixed lengths, slots recycle as requests
        # end; every other request samples (temperature/top-k/top-p) with
        # its own seed, each sampled stream reproducible regardless of
        # co-batching
        eng = build_engine(model, ServeConfig(slots=B, max_len=2 * (P + G),
                                              prefill_chunk=P))
        t0 = time.time()
        for i in range(2 * B):           # twice the requests, same slots
            plen = int(rng.integers(P // 2, P + 1))
            sampling = SamplingParams(temperature=0.8, top_k=50,
                                      top_p=0.95, seed=i) if i % 2 else None
            eng.submit(rng.integers(0, cfg.vocab, size=plen),
                       max_new_tokens=int(rng.integers(G // 2, G + 1)),
                       sampling=sampling)
        done = eng.run()
        _sync(dev)
        dt_eng = time.time() - t0
        print(f"{arch:24s} baseline {B*(P+G)/dt_base:7.1f} tok/s | "
              f"engine {eng.n_emitted} tok from {len(done)} reqs in "
              f"{dt_eng:.1f}s, util {eng.utilization:.2f}, "
              f"sample={done[0].tokens[:8].tolist()}")
        out[arch] = {"baseline": base, "done": done, "engine": eng}
    return out


if __name__ == "__main__":
    main()
