"""Multi-stage quantization-aware training (port of ``repro.train.qat``,
paper §4.1).

Phases (``core.quant.QAT_PHASES``):
  0. fp32 baseline (original minGRU activations)
  1. + 2 b weights, 6 b biases
  2. + binary output activations (Θ with boxcar STE)
  3. + hard-sigmoid gate quantized to 6 b  (fully hardware-compatible)

Each phase rebuilds the network with the next QuantConfig and continues
from the previous phase's parameters (the quantizers are STE wrappers
around the same latent fp32 weights, so the state dict carries over 1:1).
The minGRU scans run through ``kernels.linear_scan`` — on the card, the
forward and adjoint CUDA kernels.

Batch order comes from a numpy generator seeded with (seed, phase,
epoch): the reference's ``jax.random.permutation`` has no counterpart, so
the port trains on the same data in another order.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.common import resolve_device
from repro_torch.core.mingru import MinimalistNetwork
from repro_torch.core.quant import QAT_PHASES
from repro_torch.optim import AdamW, cosine_schedule


@dataclasses.dataclass
class QATConfig:
    dims: Sequence[int]
    phase_epochs: Sequence[int] = (12, 8, 8, 8)
    batch: int = 128
    lr: float = 2e-3
    seed: int = 0


def _batches(n, batch, rng):
    """Index batches of one epoch: a permutation cut into full batches."""
    idx = rng.permutation(n)
    for i in range(0, n - batch + 1, batch):
        yield idx[i:i + batch]


def qat_loss(net, xb, yb):
    """Mean NLL of the labels under the readout's fp32 log-softmax."""
    logp = torch.log_softmax(net(xb).float(), dim=-1)
    return -torch.gather(logp, -1, yb[:, None].long()).mean()


def accuracy(net, x, y, batch=256):
    """Top-1 accuracy of ``net`` on numpy data (x: (N, T, K), y: (N,))."""
    dev = next(net.parameters()).device
    correct = 0
    with torch.no_grad():
        for i in range(0, x.shape[0], batch):
            logits = net(torch.from_numpy(np.ascontiguousarray(
                x[i:i + batch])).to(dev))
            correct += int((logits.argmax(-1).cpu().numpy()
                            == y[i:i + batch]).sum())
    return correct / x.shape[0]


def train_qat(train_set, test_set, cfg: QATConfig, phases=QAT_PHASES,
              verbose=True, device=None):
    """Runs the gradual QAT ladder on ``device`` (cuda unless named).
    Returns (the network of the last phase, per-phase results)."""
    dev = resolve_device(device)
    (xtr, ytr), (xte, yte) = train_set, test_set
    x_all = torch.from_numpy(np.ascontiguousarray(xtr)).to(dev)
    y_all = torch.from_numpy(np.ascontiguousarray(ytr)).to(dev)
    state, net = None, None
    results = []
    for phase_i, (qcfg, epochs) in enumerate(zip(phases, cfg.phase_epochs)):
        net = MinimalistNetwork(cfg.dims, qcfg=qcfg, device=dev)
        if state is None:
            net.reset_parameters(
                torch.Generator(device=dev).manual_seed(cfg.seed))
        else:
            net.load_state_dict(state)
        total_steps = max(1, epochs * (xtr.shape[0] // cfg.batch))
        opt = AdamW(net.parameters(),
                    lr=cosine_schedule(cfg.lr * (0.5 ** phase_i),
                                       warmup=total_steps // 20,
                                       total=total_steps),
                    weight_decay=0.0)
        for ep in range(epochs):
            rng = np.random.default_rng([cfg.seed, phase_i, ep])
            for sel in _batches(xtr.shape[0], cfg.batch, rng):
                sel = torch.from_numpy(sel).to(dev)
                opt.zero_grad(set_to_none=True)
                qat_loss(net, x_all[sel], y_all[sel]).backward()
                opt.step()
        acc = accuracy(net, xte, yte)
        results.append({"phase": phase_i, "quant": dataclasses.asdict(qcfg),
                        "test_acc": acc})
        if verbose:
            print(f"QAT phase {phase_i}: test acc {acc:.4f}", flush=True)
        state = net.state_dict()
    return net, results
