"""Fault-tolerant training loop (port of ``repro.train.loop``).

  * restore-from-latest on start; periodic async checkpoints
  * step-crash recovery: a step that raises ``RuntimeError`` restores the
    last committed checkpoint and continues (data order is step-keyed, so
    the stream resumes exactly — no skipped or doubled batches).  Each
    restore is counted in ``Trainer.restores``: a run that must show its
    kernels never failed reads it.
  * preemption: SIGTERM triggers checkpoint + clean exit at a step boundary
  * straggler monitoring
  * microbatch gradient accumulation (averaged over the k microbatches)
  * optional int8 error-feedback gradient compression
  * grad clipping and the cosine schedule (``optim.AdamW``)

The reference threads immutable (params, opt_state) through a jitted
step; here the model and the optimizer own their tensors and the step
updates them in place.
"""
from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Optional

import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.optim import AdamW
from repro_torch.optim.compress import compress_grads, init_error
from repro_torch.train.fault_tolerance import (FailureInjector,
                                               PreemptionHandler,
                                               StragglerMonitor)

#: Default checkpoint root: ``build/ckpt`` at the root of the checkout
#: (listed in ``.gitignore``).
DEFAULT_CKPT_DIR = str(Path(__file__).resolve().parents[3] / "build" / "ckpt")


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: str = DEFAULT_CKPT_DIR
    keep_n: int = 3
    log_every: int = 10
    microbatch: Optional[int] = None     # grad accumulation chunk
    grad_compress: bool = False
    max_failures: int = 3


def build_train_step(model, opt: AdamW, *, microbatch=None,
                     grad_compress=False):
    """Returns ``train_step(aux_state, batch) -> (aux_state, metrics)``:
    forward, backward and one optimizer step on ``model``'s parameters in
    place.  ``batch`` is a dict of tensors on the model's device;
    ``aux_state["ef_error"]`` is the error-feedback state when
    ``grad_compress``."""
    named = dict(model.named_parameters())

    def grads_of(batch):
        opt.zero_grad(set_to_none=True)
        if microbatch is None:
            loss, metrics = model.loss(batch)
            loss.backward()
            return loss.detach(), metrics
        # gradient accumulation over k = B / microbatch row chunks
        k = next(iter(batch.values())).shape[0] // microbatch
        losses, mets = [], []
        for i in range(k):
            mb = {key: v[i * microbatch:(i + 1) * microbatch]
                  for key, v in batch.items()}
            loss, metrics = model.loss(mb)
            loss.backward()
            losses.append(loss.detach())
            mets.append(metrics)
        for p in named.values():
            if p.grad is not None:
                p.grad.div_(torch.full((), k, dtype=p.grad.dtype,
                                       device=p.grad.device))
        metrics = {key: torch.stack([m[key].float() for m in mets]).mean()
                   for key in mets[0]}
        return torch.stack(losses).mean(), metrics

    def train_step(aux, batch):
        loss, metrics = grads_of(batch)
        if grad_compress:
            grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                     for k, p in named.items()}
            grads, new_err = compress_grads(grads, aux["ef_error"])
            for k, g in grads.items():
                named[k].grad = g
            aux = dict(aux, ef_error=new_err)
        opt_metrics = opt.step()
        return aux, dict(metrics, loss=loss, **opt_metrics)

    return train_step


class Trainer:
    """Runs ``cfg.steps`` steps of ``model.loss`` with ``opt``, batches
    from ``loader.batch_at(step)`` (numpy dicts), checkpoints under
    ``cfg.ckpt_dir``.  Parameters are initialised by
    ``model.reset_parameters`` from a generator seeded with ``seed`` when
    no checkpoint exists."""

    def __init__(self, model, opt: AdamW, cfg: TrainConfig, *, loader,
                 failure_injector=None, seed: int = 0):
        self.model, self.opt, self.cfg, self.loader = model, opt, cfg, loader
        self.seed = seed
        self.device = next(model.parameters()).device
        self.named = dict(model.named_parameters())
        self.ckpt = Checkpointer(cfg.ckpt_dir, keep_n=cfg.keep_n)
        self.monitor = StragglerMonitor()
        self.injector = failure_injector or FailureInjector()
        self.step_fn = build_train_step(model, opt, microbatch=cfg.microbatch,
                                        grad_compress=cfg.grad_compress)
        self.history = []
        self.restores = 0

    def _aux(self, ef_error=None):
        if self.cfg.grad_compress and not ef_error:
            return {"ef_error": init_error(self.named)}
        return {"ef_error": ef_error or {}}

    def _init_state(self):
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        self.model.reset_parameters(gen)
        self.opt.reset_state()
        return self._aux()

    def _restore_or_init(self):
        step = self.ckpt.latest_step()
        if step is None:
            return self._init_state(), 0
        state = self.ckpt.restore(step, device=self.device)
        with torch.no_grad():
            for name, p in self.named.items():
                p.copy_(state["params"][name])
        self.opt.load_state_tree(state["opt"], self.named)
        # empty subtrees (aux without compression) have no leaves and are
        # dropped by serialisation — rebuild them
        return self._aux((state.get("aux") or {}).get("ef_error")), int(step)

    def _save(self, step, aux, blocking=False):
        self.ckpt.save(step, {"params": self.named,
                              "opt": self.opt.state_tree(self.named),
                              "aux": aux}, blocking=blocking)

    def _batch(self, step):
        """The loader's numpy batch on the model's device: integer arrays
        (tokens, labels) as int64, float ones (the stubbed ``embeds`` of
        a VLM or Whisper) in their own dtype."""
        out = {}
        for k, v in self.loader.batch_at(step).items():
            t = torch.from_numpy(v)
            out[k] = t.to(self.device, None if t.is_floating_point()
                          else torch.int64)
        return out

    def run(self):
        """Train to ``cfg.steps``; returns (model, final step)."""
        aux, step = self._restore_or_init()
        failures = 0
        with PreemptionHandler() as preempt:
            while step < self.cfg.steps:
                try:
                    self.injector.maybe_fail(step)
                    t0 = time.time()
                    aux, metrics = self.step_fn(aux, self._batch(step))
                    loss = float(metrics["loss"])
                    dt = time.time() - t0
                    self.monitor.record(step, dt)
                    self.history.append({
                        "step": step, "loss": loss, "dt": dt,
                        "grad_norm": float(metrics["grad_norm"])})
                    if step % self.cfg.log_every == 0:
                        print(f"step {step:6d} loss {loss:.4f} "
                              f"({dt*1e3:.0f} ms)", flush=True)
                    step += 1
                    if step % self.cfg.ckpt_every == 0:
                        self._save(step, aux)
                    if preempt.requested:
                        print("preemption requested — checkpointing")
                        self._save(step, aux, blocking=True)
                        return self.model, step
                except RuntimeError as e:
                    failures += 1
                    if failures > self.cfg.max_failures:
                        raise
                    print(f"step {step} failed ({e}); restoring last "
                          f"checkpoint", flush=True)
                    self.ckpt.wait()
                    self.restores += 1
                    aux, step = self._restore_or_init()
        self.ckpt.wait()
        self._save(step, aux, blocking=True)
        return self.model, step
