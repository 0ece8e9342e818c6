"""Admission policies (port of ``repro.serve.scheduler``; FIFO only).

A :class:`SchedulingPolicy` orders admission (``admit_order``).  The
priority, SJF and EDF policies of the reference, and the preemption they
drive through the paged KV layout, are not ported yet; asking for them
raises.
"""
from __future__ import annotations

from typing import List

from repro_torch.serve.state import Request, SlotTable
from repro_torch.serve.telemetry import NULL_TELEMETRY

#: The reference's policy names (``repro.serve.scheduler.POLICIES``).
POLICIES = ("fifo", "priority", "sjf", "edf")

#: The ones this port implements.
PORTED_POLICIES = ("fifo",)


class SchedulingPolicy:
    """Contract only; see module docstring."""

    name: str = "base"
    telemetry = NULL_TELEMETRY

    def begin_round(self, state: SlotTable):
        """Hook: called once per admission round, before admit_order."""

    def admit_order(self, queue, state: SlotTable) -> List[Request]:
        raise NotImplementedError

    def __repr__(self):
        return f"{type(self).__name__}()"


class FIFOPolicy(SchedulingPolicy):
    """Strict arrival order."""

    name = "fifo"

    def admit_order(self, queue, state):
        return list(queue)


def make_policy(policy) -> SchedulingPolicy:
    """Resolve the engine's ``policy=`` knob."""
    if isinstance(policy, SchedulingPolicy):
        return policy
    if policy == "fifo":
        return FIFOPolicy()
    if policy in POLICIES:
        raise NotImplementedError(
            f"policy {policy!r} is not ported yet (one of "
            f"{PORTED_POLICIES}): it preempts through the paged KV layout")
    raise ValueError(f"policy must be one of {POLICIES} or a "
                     f"SchedulingPolicy instance, got {policy!r}")
