"""Admission and preemption policies (port of ``repro.serve.scheduler``).

A :class:`SchedulingPolicy` decides two things:

  * ``admit_order(queue, state)`` — the order in which waiting requests
    are tried.  The engine admits from the front and stops at the first
    candidate it cannot place (head-of-line within the policy's order).
  * ``select_victim(state)`` — optionally a RUNNING slot to preempt when
    the policy's head is blocked (no free slot, or the page pool cannot
    cover its reservation).  The engine snapshots the victim's page chain
    to host memory, releases its pages and re-queues it; the resumed
    stream is bitwise the undisturbed one.  ``None`` disables preemption.

Policies see only the host-side :class:`~repro_torch.serve.state.SlotTable`.
Every ordering breaks ties on the request uid, so a policy's decisions
are a pure function of the submitted workload.
"""
from __future__ import annotations

from typing import List, Optional

from repro_torch.serve.state import Request, SlotTable
from repro_torch.serve.telemetry import NULL_TELEMETRY

#: Legal values of the engine's ``policy=`` knob / ``--policy`` flag.
POLICIES = ("fifo", "priority", "sjf", "edf")


class SchedulingPolicy:
    """Contract only; see module docstring."""

    name: str = "base"
    telemetry = NULL_TELEMETRY

    def begin_round(self, state: SlotTable):
        """Hook: called once per admission round, before admit_order."""

    def admit_order(self, queue, state: SlotTable) -> List[Request]:
        raise NotImplementedError

    def select_victim(self, state: SlotTable) -> Optional[int]:
        """Slot to preempt so the blocked head can admit, or None."""
        return None

    def _head_blocked(self, state: SlotTable) -> Optional[Request]:
        """The policy's head iff it cannot admit now."""
        if not state.waiting:
            return None
        head = self.admit_order(state.waiting, state)[0]
        if state.free_mask and (state.pool is None or state.pool.can_admit(
                state.pages_needed(head))):
            return None
        return head

    def _pick_victim(self, state, eligible, key):
        """The eligible running slot with the smallest ``key``, named only
        if evicting every eligible slot would free enough pages for the
        blocked head (the engine evicts one victim per retry; an eviction
        that cannot unblock the head would discard decode work for
        nothing).  Paged engines only: the page swap makes eviction
        cheap."""
        if state.pool is None:
            return None
        head = self._head_blocked(state)
        if head is None:
            return None
        victim, freeable = None, 0
        for slot, r in state.running():
            if not eligible(r, head):
                continue
            freeable += state.pool.reserved_for(slot)
            k = key(r)
            if victim is None or k < victim[0]:
                victim = (k, slot)
        if victim is None:
            return None
        if state.pages_needed(head) > state.pool.available + freeable:
            return None
        if self.telemetry.enabled:
            self.telemetry.instant(
                "victim_selected", policy=self.name, slot=int(victim[1]),
                victim_uid=state.slot_req[victim[1]].uid, head_uid=head.uid)
        return victim[1]

    def __repr__(self):
        return f"{type(self).__name__}()"


class FIFOPolicy(SchedulingPolicy):
    """Strict arrival order with defer-at-head.  Never preempts."""

    name = "fifo"

    def admit_order(self, queue, state):
        return list(queue)


class PriorityPolicy(SchedulingPolicy):
    """Higher ``priority`` first, uid tie-break.  A blocked head may evict
    the lowest-priority running request (the youngest, largest uid, within
    its class), on a STRICT priority gap only: equal-priority traffic
    never thrashes."""

    name = "priority"

    def __init__(self, preempt: bool = True):
        self.preempt = bool(preempt)

    def admit_order(self, queue, state):
        return sorted(queue, key=lambda r: (-r.priority, r.uid))

    def select_victim(self, state):
        if not self.preempt:
            return None
        return self._pick_victim(
            state, lambda r, head: r.priority < head.priority,
            lambda r: (r.priority, -r.uid))


class SJFPolicy(SchedulingPolicy):
    """Shortest prefill first with aging: the key is ``prefill_cost -
    aging * rounds_waited`` (uid tie-break), so a P-token prompt outranks
    any newcomer after at most ceil((P - 1) / aging) rounds.  A preempted
    request has no prefill left (its pages resume from host bytes), so it
    re-admits ahead of fresh prompts.  Never preempts on its own."""

    name = "sjf"

    def __init__(self, aging: float = 1.0):
        if not aging > 0:
            raise ValueError(f"aging must be > 0, got {aging}")
        self.aging = float(aging)
        self._age = {}                    # uid -> rounds spent waiting

    def begin_round(self, state):
        live = {r.uid for r in state.waiting}
        for uid in live:
            self._age[uid] = self._age.get(uid, -1) + 1
        for uid in set(self._age) - live:
            del self._age[uid]

    def _cost(self, req):
        plen = 0 if req.snapshot is not None else len(req.prompt)
        return plen - self.aging * self._age.get(req.uid, 0)

    def admit_order(self, queue, state):
        return sorted(queue, key=lambda r: (self._cost(r), r.uid))


class EDFPolicy(SchedulingPolicy):
    """Earliest deadline first (no deadline sorts last), uid tie-break.  A
    blocked head may evict the running request with the LATEST deadline
    (youngest within it), on a strict deadline gap only; a no-deadline
    head never preempts."""

    name = "edf"
    _INF = float("inf")

    def __init__(self, preempt: bool = True):
        self.preempt = bool(preempt)

    @classmethod
    def _key(cls, req):
        return cls._INF if req.deadline is None else float(req.deadline)

    def admit_order(self, queue, state):
        return sorted(queue, key=lambda r: (self._key(r), r.uid))

    def select_victim(self, state):
        if not self.preempt:
            return None
        return self._pick_victim(
            state, lambda r, head: self._key(r) > self._key(head),
            lambda r: (-self._key(r), -r.uid))


def make_policy(policy) -> SchedulingPolicy:
    """Resolve the engine's ``policy=`` knob: a name from
    :data:`POLICIES` or a SchedulingPolicy instance."""
    if isinstance(policy, SchedulingPolicy):
        return policy
    table = {"fifo": FIFOPolicy, "priority": PriorityPolicy,
             "sjf": SJFPolicy, "edf": EDFPolicy}
    if policy in table:
        return table[policy]()
    raise ValueError(f"policy must be one of {POLICIES} or a "
                     f"SchedulingPolicy instance, got {policy!r}")
