"""Fault-tolerance utilities: preemption handling, straggler detection,
simulated failure injection for tests (a copy of
``repro.train.fault_tolerance``: pure Python).

At 1000+-node scale the failure model is: (a) planned preemptions (SIGTERM
with a grace period), (b) hard node loss (step crashes / collective
timeout), (c) stragglers (one host slows the synchronous step).  The
corresponding mechanisms here:

  * PreemptionHandler — catches SIGTERM/SIGINT, requests a final checkpoint
    and clean exit at the next step boundary (a device step cannot be
    safely interrupted mid-collective).
  * StragglerMonitor — rolling-median step timing; flags steps slower than
    ``threshold ×`` the median.  On a real fleet the per-host heartbeats
    feed the same interface; the mitigation hook (``on_straggler``) is where
    a production deployment triggers hot-spare swap / re-mesh
    (``repro_torch.train.elastic``: ``elastic_restart`` plans the smaller
    mesh and reshards the parameters and optimizer state onto it).
  * FailureInjector — deterministic fault injection for integration tests
    (raise at step k), proving the restore-and-continue path end to end.
"""
from __future__ import annotations

import signal
from collections import deque
from typing import Callable, Optional


class PreemptionHandler:
    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self.requested = False
        self._orig = {}
        self._signals = signals

    def __enter__(self):
        for s in self._signals:
            self._orig[s] = signal.signal(s, self._handler)
        return self

    def _handler(self, signum, frame):
        self.requested = True

    def __exit__(self, *exc):
        for s, h in self._orig.items():
            signal.signal(s, h)
        return False


class StragglerMonitor:
    def __init__(self, window: int = 32, threshold: float = 3.0,
                 on_straggler: Optional[Callable] = None):
        self.times = deque(maxlen=window)
        self.threshold = threshold
        self.on_straggler = on_straggler
        self.flagged = []

    def record(self, step: int, dt: float) -> bool:
        is_straggler = False
        if len(self.times) >= 8:
            med = sorted(self.times)[len(self.times) // 2]
            if dt > self.threshold * med:
                is_straggler = True
                self.flagged.append((step, dt, med))
                if self.on_straggler:
                    self.on_straggler(step, dt, med)
        self.times.append(dt)
        return is_straggler

    @property
    def median(self):
        if not self.times:
            return None
        return sorted(self.times)[len(self.times) // 2]


class FailureInjector:
    """Raise RuntimeError at the given steps (once each) — test harness."""

    def __init__(self, fail_at=()):
        self.fail_at = set(fail_at)

    def maybe_fail(self, step: int):
        if step in self.fail_at:
            self.fail_at.discard(step)
            raise RuntimeError(f"injected node failure at step {step}")
