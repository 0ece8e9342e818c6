"""Request/slot lifecycle state for the serving engine (port of
``repro.serve.state``, pure host Python).

:class:`SlotTable` owns the waiting queue, the free-slot bitmask and the
per-slot position / budget / active / sampling-knob arrays behind small
explicit mutators (:meth:`alloc_slot` / :meth:`free_slot` /
:meth:`retire`).  Under the paged KV layout it also holds the page pool
and releases a slot's pages and reservation when the slot is freed.
Scheduling policies (:mod:`repro_torch.serve.scheduler`) see exactly this
object: the ``state`` of ``admit_order(queue, state)`` and
``select_victim(state)``.  A preempted request holds its page bytes and
carry on the host (``Request.snapshot``) until it resumes.
"""
from __future__ import annotations

import dataclasses
import math
import time
from collections import deque
from typing import Any, Callable, List, Optional

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
    # scheduling knobs: higher priority admits first under "priority";
    # deadline is the admission key under "edf" (earliest first)
    priority: int = 0
    deadline: Optional[float] = None
    # speculative decoding: per-request verify width (None = the engine's)
    spec_k: Optional[int] = None
    # set by submit() and reset on preemption: what queue waits measure
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
    # preemption: the victim's page bytes and carry live here (host
    # memory) between eviction and re-admission
    snapshot: Optional[Any] = dataclasses.field(default=None, repr=False)
    n_preemptions: int = 0

    @property
    def tokens(self) -> np.ndarray:
        """Generated token ids (LM) / per-frame outputs (streaming)."""
        return np.asarray(self.outputs)

    def validate_scheduling(self):
        """Bounds of the scheduler-facing knobs, checked at submit()."""
        if isinstance(self.priority, bool) or not isinstance(
                self.priority, (int, np.integer)):
            raise ValueError(
                f"priority must be an int, got {self.priority!r}")
        if not -2**31 <= int(self.priority) < 2**31:
            raise ValueError(
                f"priority must fit int32, got {self.priority}")
        if self.deadline is not None:
            d = self.deadline
            if isinstance(d, bool) or not isinstance(
                    d, (int, float, np.integer, np.floating)):
                raise ValueError(f"deadline must be a number or None, "
                                 f"got {d!r}")
            if not (math.isfinite(d) and d > 0):
                raise ValueError(
                    f"deadline must be positive and finite, got {d}")
        return self


class SlotTable:
    """Host-side slot + request state for a fixed-capacity engine.

    ``pool`` (optional) is the paged-KV
    :class:`~repro_torch.serve.paged.PagePool`; freeing a slot releases
    its pages and reservation.  ``pages_for_req`` maps a request to its
    worst-case page reservation (injected by the engine, so policies stay
    model-agnostic).
    """

    def __init__(self, slots: int, pool=None,
                 pages_for_req: Optional[Callable[[Request], int]] = None,
                 telemetry=None):
        self.slots = int(slots)
        if self.slots < 1:
            raise ValueError("slots must be >= 1")
        self.pool = pool
        self._pages_for_req = pages_for_req
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

    def pages_needed(self, req: Request) -> int:
        """Worst-case page reservation ``req`` needs to admit (0 when
        the engine is unpaged)."""
        if self.pool is None or self._pages_for_req is None:
            return 0
        return self._pages_for_req(req)

    def running(self):
        """(slot, request) pairs currently active, ascending slot."""
        return [(s, r) for s, r in enumerate(self.slot_req)
                if r is not None and self.active[s]]

    def alloc_slot(self) -> int:
        bit = int(self.free_mask & -self.free_mask)
        self.free_mask = int(self.free_mask) ^ bit
        return bit.bit_length() - 1

    def free_slot(self, slot: int):
        self.free_mask = int(self.free_mask) | (1 << int(slot))
        self.slot_req[slot] = None
        self.active[slot] = False
        if self.pool is not None:
            # pages (and the unused reservation tail) go straight back
            # into circulation; the pool content is NOT cleared — any
            # future read of a recycled page is position-masked
            self.pool.release(slot)
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
        """Cancel path: drop a still-queued request (identity match).
        Never touches the pool: a queued request holds no slot, pages or
        reservation."""
        if not any(r is req for r in self.waiting):
            return False
        self.waiting = deque(r for r in self.waiting if r is not req)
        return True
