"""Request/slot lifecycle state for the serving engine (port of
``repro.serve.state``, pure host Python).

:class:`SlotTable` owns the waiting queue, the free-slot bitmask and the
per-slot position / budget / active / sampling-knob arrays behind small
explicit mutators (:meth:`alloc_slot` / :meth:`free_slot` /
:meth:`retire`).  The page pool and preemption snapshots of the
reference are not ported yet.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, List, Optional

import numpy as np

from repro_torch.configs.base import SamplingParams
from repro_torch.serve.sampling import KNOB_DTYPES, KNOB_GREEDY
from repro_torch.serve.telemetry import NULL_TELEMETRY


def _knob_values(req):
    """A request's per-slot knob values (schema: sampling.KNOB_DTYPES);
    the uid enters as two 32-bit words so the FULL uid reaches the
    hash."""
    sp = req.sampling
    return {"seed": sp.seed, "uid": req.uid & 0xFFFFFFFF,
            "uid_hi": (req.uid >> 32) & 0xFFFFFFFF,
            "temperature": sp.temperature, "top_k": sp.top_k,
            "top_p": sp.top_p}


# eq=False: a request is its identity (the queue/slot bookkeeping matches
# by object), which also keeps Request hashable
@dataclasses.dataclass(eq=False)
class Request:
    uid: int
    prompt: np.ndarray                 # (P,) int32 tokens | (P, d_in) frames
    max_new_tokens: int = 0            # 0 for pure streaming requests
    eos_id: Optional[int] = None
    sampling: SamplingParams = dataclasses.field(
        default_factory=SamplingParams)
    submit_t: Optional[float] = dataclasses.field(default=None, repr=False)
    # lifecycle timestamps (time.monotonic), set once each: submission,
    # first emitted token, retirement — what ttft_ms / e2e_ms read
    created_t: Optional[float] = dataclasses.field(default=None, repr=False)
    first_token_t: Optional[float] = dataclasses.field(default=None,
                                                       repr=False)
    finish_t: Optional[float] = dataclasses.field(default=None, repr=False)
    outputs: List[Any] = dataclasses.field(default_factory=list)
    finished: bool = False
    cancelled: bool = False

    @property
    def tokens(self) -> np.ndarray:
        """Generated token ids (LM) / per-frame outputs (streaming)."""
        return np.asarray(self.outputs)


class SlotTable:
    """Host-side slot + request state for a fixed-capacity engine."""

    def __init__(self, slots: int, telemetry=None):
        self.slots = int(slots)
        if self.slots < 1:
            raise ValueError("slots must be >= 1")
        self.telemetry = telemetry if telemetry is not None \
            else NULL_TELEMETRY
        self.free_mask = (1 << self.slots) - 1     # bit i set = slot i free
        self.waiting: deque[Request] = deque()
        self.slot_req: List[Optional[Request]] = [None] * self.slots
        self.pos = np.zeros(self.slots, np.int32)
        self.remaining = np.zeros(self.slots, np.int64)
        self.active = np.zeros(self.slots, bool)
        self.knobs = {k: np.full(self.slots, KNOB_GREEDY[k], KNOB_DTYPES[k])
                      for k in KNOB_DTYPES}
        self.cur: Optional[np.ndarray] = None      # next input per slot
        self.finished: List[Request] = []

    @property
    def n_active(self) -> int:
        return int(self.active.sum())

    @property
    def n_free(self) -> int:
        return bin(self.free_mask).count("1")

    @property
    def queue_depth(self) -> int:
        return len(self.waiting)

    def alloc_slot(self) -> int:
        bit = int(self.free_mask & -self.free_mask)
        self.free_mask = int(self.free_mask) ^ bit
        return bit.bit_length() - 1

    def free_slot(self, slot: int):
        self.free_mask = int(self.free_mask) | (1 << int(slot))
        self.slot_req[slot] = None
        self.active[slot] = False
        for k, v in KNOB_GREEDY.items():
            self.knobs[k][slot] = v
        if self.telemetry.enabled:
            self.telemetry.gauge("active_slots", self.n_active)
            self.telemetry.gauge("free_slots", self.n_free)

    def retire(self, slot: int) -> Request:
        req = self.slot_req[slot]
        req.finished = True
        req.finish_t = time.monotonic()
        self.finished.append(req)
        self.free_slot(slot)
        return req

    def set_sampling(self, slot: int, req: Request):
        for k, v in _knob_values(req).items():
            self.knobs[k][slot] = v

    def pop_waiting(self, req: Request):
        """Remove ``req`` from the queue (identity match)."""
        if self.waiting and self.waiting[0] is req:
            self.waiting.popleft()
            return
        self.waiting = deque(r for r in self.waiting if r is not req)

    def discard_waiting(self, req: Request) -> bool:
        """Cancel path: drop a still-queued request (identity match)."""
        if not any(r is req for r in self.waiting):
            return False
        self.waiting = deque(r for r in self.waiting if r is not req)
        return True
