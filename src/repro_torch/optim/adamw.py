"""AdamW with global-norm clipping and a cosine schedule (port of
``repro.optim.adamw``).

The update is the reference's, op for op, in fp32: grads clipped to a
global norm, then with the step count s incremented first,

    m ← b1·m + (1−b1)·g,   v ← b2·v + (1−b2)·g²
    δ = (m / (1−b1^s)) / (sqrt(v / (1−b2^s)) + eps)  [+ wd·p if decayed]
    p ← p − lr(s)·δ

(eps outside the sqrt, the schedule read at s).  The reference decays
the leaves of ITS parameter tree with ndim ≥ 2; :func:`param_groups`
rebuilds that mask for the port's modules (see its docstring).
"""
from __future__ import annotations

import math
from typing import Callable

import torch


def _f32(v, device=None):
    return torch.tensor(v, dtype=torch.float32, device=device)


def cosine_schedule(base_lr: float, warmup: int, total: int,
                    final_frac: float = 0.1) -> Callable:
    """lr(step): linear warm-up to ``base_lr`` over ``warmup`` steps, then
    a cosine down to ``final_frac·base_lr`` at ``total``; evaluated in
    fp32 as the reference evaluates it.  Returns a Python float."""
    def lr(step):
        s = _f32(float(step))
        if step < warmup:
            return float(_f32(base_lr) * s / _f32(max(warmup, 1)))
        t = torch.clamp((s - _f32(warmup)) / _f32(max(total - warmup, 1)),
                        0.0, 1.0)
        cos = _f32(final_frac) + _f32((1 - final_frac) * 0.5) * (
            1 + torch.cos(_f32(math.pi) * t))
        return float(_f32(base_lr) * cos)
    return lr


def clip_by_global_norm(grads, max_norm: float):
    """grads: list of tensors.  Returns (grads scaled by
    min(1, max_norm / max(‖g‖, 1e-9)) in fp32 and cast back, the global
    norm ‖g‖ as a 0-dim fp32 tensor)."""
    gn = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads))
    scale = torch.clamp(_f32(max_norm, gn.device)
                        / torch.clamp(gn, min=1e-9), max=1.0)
    return [(g.float() * scale).to(g.dtype) for g in grads], gn


def param_groups(model):
    """The reference's decay mask as two parameter groups of ``model``:
    ``[{"params": decayed, "decay": True}, {"params": rest, "decay":
    False}]``.

    The reference decays every leaf of its parameter tree with ndim ≥ 2.
    Its ``DecoderLM`` stacks the pattern unit's layers on a leading axis
    when it scans them (``scan_layers``, the default, whenever the unit
    repeats), so every per-layer leaf there — norm scales and the minGRU
    biases included — has ndim ≥ 2 and is decayed, while the 1-D
    ``final_norm`` scale is not.  The port keeps its layers unstacked, so
    the mask is computed from the reference's layout
    (:func:`repro_torch.bridge.reference_ndim`), not from the port's
    shapes."""
    from repro_torch.bridge import reference_ndim

    ndim = reference_ndim(model)
    groups = ([], [])
    for name, p in model.named_parameters():
        groups[0 if ndim[name] >= 2 else 1].append(p)
    return [{"params": groups[0], "decay": True},
            {"params": groups[1], "decay": False}]


class AdamW(torch.optim.Optimizer):
    """``repro.optim.AdamW`` as a ``torch.optim.Optimizer``.

    ``lr`` is a float or a schedule ``lr(step) -> float``.  A parameter
    group's ``decay`` flag says whether weight decay applies to it; left
    at None it falls back to the reference's rule on the port's own
    shapes (``p.ndim >= 2``) — use :func:`param_groups` for a model whose
    reference stacks its layers.  :meth:`step` returns ``{"grad_norm",
    "lr"}`` (grad_norm 0 when clipping is off, as in the reference).  A
    parameter without a gradient takes a zero gradient, as every leaf
    has one in the reference."""

    def __init__(self, params, lr: Callable | float = 3e-4, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, max_grad_norm=1.0):
        self.lr = lr
        self.max_grad_norm = max_grad_norm
        self.step_count = 0
        super().__init__(params, dict(b1=b1, b2=b2, eps=eps,
                                      weight_decay=weight_decay,
                                      decay=None))

    def lr_at(self, step: int) -> float:
        return float(self.lr(step)) if callable(self.lr) else float(
            _f32(self.lr))

    def _moments(self, p):
        st = self.state[p]
        if "m" not in st:
            st["m"] = torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
            st["v"] = torch.zeros_like(st["m"])
        return st["m"], st["v"]

    @torch.no_grad()
    def step(self, closure=None):
        params = [p for g in self.param_groups for p in g["params"]]
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        dev = params[0].device if params else None
        gn = torch.zeros((), device=dev)
        if self.max_grad_norm is not None:
            grads, gn = clip_by_global_norm(grads, self.max_grad_norm)
        grad_of = dict(zip(map(id, params), grads))
        self.step_count += 1
        s = self.step_count
        lr = self.lr_at(s)
        for group in self.param_groups:
            b1, b2, eps = group["b1"], group["b2"], group["eps"]
            wd = group["weight_decay"]
            bc1 = 1 - _f32(b1, dev) ** _f32(float(s), dev)
            bc2 = 1 - _f32(b2, dev) ** _f32(float(s), dev)
            for p in group["params"]:
                g32 = grad_of[id(p)].float()
                m, v = self._moments(p)
                m.copy_(b1 * m + (1 - b1) * g32)
                v.copy_(b2 * v + (1 - b2) * torch.square(g32))
                delta = (m / bc1) / (torch.sqrt(v / bc2) + eps)
                decay = group["decay"]
                if decay is None:
                    decay = p.ndim >= 2
                if wd and decay:
                    delta = delta + wd * p.float()
                p.copy_((p.float() - lr * delta).to(p.dtype))
        return {"grad_norm": gn, "lr": lr}

    # -- checkpoint layout: the reference's {"m", "v", "step"} tree --------
    def state_tree(self, named_params: dict) -> dict:
        """{"m": {name: m}, "v": {name: v}, "step": int} for the named
        parameters (zeros for a parameter not stepped yet)."""
        m, v = {}, {}
        for name, p in named_params.items():
            m[name], v[name] = self._moments(p)
        return {"m": m, "v": v, "step": self.step_count}

    def load_state_tree(self, tree: dict, named_params: dict):
        """Inverse of :meth:`state_tree`: copy m, v and the step count in
        (leaves may be numpy arrays or tensors)."""
        for name, p in named_params.items():
            m, v = self._moments(p)
            m.copy_(torch.as_tensor(tree["m"][name]))
            v.copy_(torch.as_tensor(tree["v"][name]))
        self.step_count = int(tree["step"])

    def reset_state(self):
        """Back to the state of a fresh optimizer (zero moments, step 0)."""
        self.state.clear()
        self.step_count = 0
