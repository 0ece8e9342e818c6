"""Atomic, async checkpointing (port of
``repro.checkpoint.checkpointer``), with the reference's on-disk layout:

    <root>/step_00000123.tmp/...   — written first
    <root>/step_00000123/          — atomic rename on completion
        MANIFEST.json              — leaf paths, shapes, dtypes
        <escaped.leaf.path>.npy    — one file per leaf

  * atomic commit (rename) — a crash mid-write never corrupts the latest
    checkpoint; restore scans for the newest *committed* step
  * async save (background thread) — training continues while the
    previous step serialises; ``wait()`` joins before the next save or
    at exit.  The thread only sees host copies, made on the caller's
    thread: device tensors may be updated in place by the next step.
  * retention (keep_n) with garbage collection

A tree is nested dicts / lists of tensors, numpy arrays or numbers.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading

import numpy as np
import torch


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree.keys()):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten(flat: dict):
    root: dict = {}
    for path, v in flat.items():
        parts = path.split("/")
        cur = root
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = v
    return root


def _esc(path: str) -> str:
    return path.replace("/", "%2F")


def _to_host(v):
    if torch.is_tensor(v):
        return v.detach().to("cpu", copy=True).numpy()
    return np.array(v)


class Checkpointer:
    def __init__(self, root: str, keep_n: int = 3):
        self.root = str(root)
        self.keep_n = keep_n
        self._thread: threading.Thread | None = None
        os.makedirs(self.root, exist_ok=True)

    # ---------------- save ----------------
    def save(self, step: int, tree, *, blocking: bool = False):
        self.wait()
        # host copies on the caller's thread (the next step updates the
        # device tensors in place)
        host = {k: _to_host(v) for k, v in _flatten(tree).items()}

        def _write():
            tmp = os.path.join(self.root, f"step_{step:08d}.tmp")
            final = os.path.join(self.root, f"step_{step:08d}")
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            manifest = {}
            for k, v in host.items():
                np.save(os.path.join(tmp, _esc(k) + ".npy"), v)
                manifest[k] = {"shape": list(v.shape), "dtype": str(v.dtype)}
            with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
                json.dump({"step": step, "leaves": manifest}, f)
            shutil.rmtree(final, ignore_errors=True)
            os.rename(tmp, final)
            self._gc()

        if blocking:
            _write()
        else:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    # ---------------- restore ----------------
    def steps(self):
        out = []
        for d in os.listdir(self.root):
            m = re.fullmatch(r"step_(\d+)", d)
            if m and os.path.exists(os.path.join(self.root, d,
                                                 "MANIFEST.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self):
        s = self.steps()
        return s[-1] if s else None

    def restore(self, step: int | None = None, device=None):
        """The tree saved at ``step`` (default: the latest), as numpy
        arrays, or as tensors on ``device`` when one is given; None when
        there is no checkpoint."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        d = os.path.join(self.root, f"step_{step:08d}")
        with open(os.path.join(d, "MANIFEST.json")) as f:
            manifest = json.load(f)
        flat = {k: np.load(os.path.join(d, _esc(k) + ".npy"))
                for k in manifest["leaves"]}
        if device is not None:
            flat = {k: torch.from_numpy(v).to(device)
                    for k, v in flat.items()}
        return _unflatten(flat)

    def _gc(self):
        steps = self.steps()
        for s in steps[:-self.keep_n] if self.keep_n else []:
            shutil.rmtree(os.path.join(self.root, f"step_{s:08d}"),
                          ignore_errors=True)
