"""Fixed-capacity continuous-batching engine (port of
``repro.serve.engine``, dense layout, FIFO policy).

Layers, as in the reference: STATE (:mod:`repro_torch.serve.state`),
SCHEDULER (:mod:`repro_torch.serve.scheduler`) and this EXECUTOR, which
drives a :class:`~repro_torch.serve.protocol.StepModel`.  Scheduling is
host-side list manipulation; the decode step always runs over the full
slot batch, with inactive slots masked.

Request lifecycle::

    submit() -> WAITING -> [admit: chunked prefill -> state write] ->
    RUNNING (slot-batch decode) -> retire -> FINISHED

  * autoregressive (DecoderLM): the prompt is prefilled in chunks at
    admission (same-length prompts share one padded wave); emitted tokens
    feed back until ``max_new_tokens`` or ``eos_id``.
  * streaming (MinimalistNetwork): frames are fed one per step and every
    per-frame output is recorded; the request retires when its stream is
    exhausted.

Paging, prefix caching, preemption, forking and speculative decoding are
not ported yet.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch.common import pow2ceil
from repro_torch.configs.base import SamplingParams
from repro_torch.kernels.linear_scan.ops import linear_scan_kernel
from repro_torch.kernels.minimalist_block.ops import minimalist_step_kernel
from repro_torch.serve.sampling import KNOB_DTYPES
from repro_torch.serve.scheduler import make_policy
from repro_torch.serve.state import Request, SlotTable, _knob_values
from repro_torch.serve.telemetry import (NULL_TELEMETRY, PercentileWindow,
                                         RateWindow, StatsSink)

#: The kernel wrappers whose launch counts ``metrics()`` reports.
KERNEL_WRAPPERS = {"linear_scan": linear_scan_kernel,
                   "minimalist_step": minimalist_step_kernel}


@dataclasses.dataclass(frozen=True)
class EngineStats:
    """One host-side snapshot of engine occupancy (``ServeEngine.stats()``)."""

    policy: str
    n_steps: int
    slots: int
    active_slots: int
    queue_depth: int
    utilization: float         # decode tokens per slot-step paid
    tokens_per_s: float = 0.0
    queue_wait_p50_ms: float = 0.0
    queue_wait_p99_ms: float = 0.0

    def line(self) -> str:
        return (f"[{self.policy} step {self.n_steps}] "
                f"slots {self.active_slots}/{self.slots} "
                f"queue {self.queue_depth} "
                f"util {self.utilization:.2f} "
                f"tok/s {self.tokens_per_s:.0f} "
                f"qwait {self.queue_wait_p50_ms:.1f}/"
                f"{self.queue_wait_p99_ms:.1f}ms")


class ServeEngine:
    """Continuous-batching engine over any StepModel (the model owns its
    parameters).  ``policy`` is "fifo" or a SchedulingPolicy instance."""

    def __init__(self, step_model, *, slots: int = 8, policy="fifo",
                 telemetry=None):
        self.sm = step_model
        self.slots = int(slots)
        if self.slots < 1:
            raise ValueError("slots must be >= 1")
        self.telemetry = telemetry if telemetry is not None \
            else NULL_TELEMETRY
        self.policy = make_policy(policy)
        self.policy.telemetry = self.telemetry
        self.state = step_model.init_state(self.slots)
        self.st = SlotTable(self.slots, telemetry=self.telemetry)
        self._uid = 0
        self.n_steps = 0
        self.n_emitted = 0          # all tokens, incl. admission prefill
        self._n_decoded = 0         # tokens emitted by slot-batch steps
        self._rate = RateWindow(maxlen=256)
        self._queue_wait = PercentileWindow(maxlen=512)
        self._verbose_sink: Optional[StatsSink] = None

    # views onto the SlotTable (tests and callers address state here)
    @property
    def free_mask(self) -> int:
        return self.st.free_mask

    @property
    def waiting(self):
        return self.st.waiting

    @property
    def active(self):
        return self.st.active

    @property
    def finished(self):
        return self.st.finished

    # ------------------------------------------------------------------
    # submission / admission
    # ------------------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int = 0,
               eos_id: Optional[int] = None,
               sampling: Optional[SamplingParams] = None) -> Request:
        prompt = np.asarray(prompt)
        if prompt.ndim < 1 or prompt.size < 1:
            raise ValueError("empty prompt")
        if sampling is None:
            sampling = SamplingParams()    # fresh instance per request
        else:
            sampling.validate()
            if not self.sm.autoregressive:
                raise ValueError(
                    "sampling only applies to autoregressive requests")
        if self.sm.autoregressive:
            if prompt.ndim != 1:
                raise ValueError(
                    f"LM requests need a 1-D token prompt, got shape "
                    f"{prompt.shape}")
            if max_new_tokens < 1:
                raise ValueError(
                    f"LM requests need max_new_tokens >= 1, got "
                    f"{max_new_tokens}")
            prompt = prompt.astype(np.int32)
        req = Request(self._uid, prompt, max_new_tokens, eos_id, sampling)
        self._uid += 1
        req.submit_t = time.monotonic()
        req.created_t = req.submit_t
        self.st.waiting.append(req)
        tel = self.telemetry
        if tel.enabled:
            tel.inc("requests_submitted")
            tel.gauge("queue_depth", self.st.queue_depth)
            tel.request_instant(req, "submit", prompt=len(prompt),
                                max_new_tokens=int(max_new_tokens))
            tel.request_begin(req, "queued")
        return req

    def _wave_sampling(self, group, pad_len):
        """Per-request knob arrays for an admission wave (padding rows
        replicate the last request; their draws are discarded)."""
        reqs = [r for r, _s in group]
        reqs += [reqs[-1]] * (pad_len - len(group))
        vals = [_knob_values(r) for r in reqs]
        return {k: np.asarray([v[k] for v in vals], KNOB_DTYPES[k])
                for k in KNOB_DTYPES}

    def _pad_slots(self, slots):
        """Pad an admission wave's slot list to a power of two with
        out-of-bounds indices (dropped by write_slots): at most log2(slots)
        wave shapes per prompt-length bucket."""
        padded = np.full(pow2ceil(len(slots)), self.slots, np.int32)
        padded[:len(slots)] = slots
        return padded

    def admit(self):
        """Move waiting requests into free slots until no further progress
        is possible (a slot freed mid-wave refills in the same call)."""
        self.policy.begin_round(self.st)
        while self._admit_once():
            pass

    def _admit_once(self) -> bool:
        """One admission wave: same-length prompts prefill as one batched
        chunked call and land in one slot write.  Returns True iff at least
        one request was admitted."""
        st = self.st
        admitted = []
        while st.waiting and st.free_mask:
            req = self.policy.admit_order(st.waiting, st)[0]
            st.pop_waiting(req)
            wait_ms = (time.monotonic() - req.submit_t) * 1000.0
            self._queue_wait.push(wait_ms)
            if self.telemetry.enabled:
                self.telemetry.observe("queue_wait_ms", wait_ms)
            slot = st.alloc_slot()
            st.slot_req[slot] = req
            st.active[slot] = True
            if self.telemetry.enabled:
                self.telemetry.request_begin(req, "running", slot=slot)
            admitted.append((req, slot))
            if st.cur is None:
                shape = (self.slots,) + tuple(req.prompt.shape[1:])
                st.cur = np.zeros(shape, req.prompt.dtype)
        if not admitted:
            return False
        if not self.sm.autoregressive:
            # streaming: blank state reset for the whole wave in one write
            pad = self._pad_slots([s for _r, s in admitted])
            blank = self.sm.init_state(len(pad))
            self.state = self.sm.write_slots(self.state, blank, pad)
            for req, slot in admitted:
                st.pos[slot] = 0
                st.remaining[slot] = len(req.prompt)
                st.cur[slot] = req.prompt[0]
            return True
        groups: dict = {}
        for req, slot in admitted:
            groups.setdefault(len(req.prompt), []).append((req, slot))
        tel = self.telemetry
        for plen, group in groups.items():
            cw = self.sm.chunk_for(plen)
            t0 = time.monotonic() if tel.enabled else 0.0
            with tel.span("prefill", plen=plen, wave=len(group),
                          chunk_w=cw, chunks=-(-plen // cw)):
                prompts = [r.prompt for r, _s in group]
                prompts += [prompts[-1]] * (
                    len(self._pad_slots([s for _r, s in group]))
                    - len(group))
                last, carry = self.sm.prefill(np.stack(prompts))
                self._install_wave(plen, group, last, carry)
            if tel.enabled:
                tel.observe("prefill_ms", (time.monotonic() - t0) * 1000.0)
        return True

    def _install_wave(self, plen, group, last, carry):
        """Scatter a prefilled wave into its slots and draw/book-keep the
        first sampled token (at position plen)."""
        st = self.st
        pad = self._pad_slots([s for _r, s in group])
        self.state = self.sm.write_slots(self.state, carry, pad)
        tok0 = self.sm.sample(last, self._wave_sampling(group, len(pad)),
                              np.full(len(pad), plen, np.int64))
        tok0 = tok0.cpu().numpy()
        for i, (req, slot) in enumerate(group):
            t = int(tok0[i])
            req.outputs.append(t)
            self.n_emitted += 1
            self._first_token(req)
            st.pos[slot] = plen
            st.remaining[slot] = req.max_new_tokens - 1
            st.cur[slot] = t
            st.set_sampling(slot, req)
            if st.remaining[slot] <= 0 or t == req.eos_id:
                self._retire(slot)

    # ------------------------------------------------------------------
    # decode
    # ------------------------------------------------------------------
    def _first_token(self, req: Request):
        """Book the request's first emitted token (TTFT anchor)."""
        if req.first_token_t is not None:
            return
        req.first_token_t = time.monotonic()
        if self.telemetry.enabled and req.created_t is not None:
            self.telemetry.observe(
                "ttft_ms", (req.first_token_t - req.created_t) * 1000.0)

    def _retire(self, slot: int) -> Request:
        """The ONE finish path, so telemetry sees every completion."""
        req = self.st.retire(slot)
        tel = self.telemetry
        if tel.enabled:
            tel.inc("requests_finished")
            tel.request_end(req, tokens=len(req.outputs))
            tel.request_instant(req, "finish", tokens=len(req.outputs))
            if req.created_t is not None and req.finish_t is not None:
                tel.observe("e2e_ms",
                            (req.finish_t - req.created_t) * 1000.0)
        return req

    def cancel(self, req: Request):
        """Abort a request: a waiting one leaves the queue, a running one
        frees its slot before the next step.  Tokens already emitted stay
        on the request, which is marked finished+cancelled and never joins
        ``finished``."""
        if req.finished:
            return
        if not self.st.discard_waiting(req):
            for slot, r in enumerate(self.st.slot_req):
                if r is req:
                    self.st.free_slot(slot)
                    break
            else:
                raise ValueError("request is not known to this engine")
        req.finished = True
        req.cancelled = True
        if self.telemetry.enabled:
            self.telemetry.inc("requests_cancelled")
            self.telemetry.request_end(req, cancelled=True)
            self.telemetry.request_instant(req, "cancel")

    def step(self):
        """Admit what fits, then run ONE slot-batched decode step."""
        tel = self.telemetry
        with tel.span("admit", queue_depth=self.st.queue_depth):
            self.admit()
        st = self.st
        if not st.active.any():
            return
        t0 = time.monotonic()
        d0 = self._n_decoded
        with tel.span("decode_wave", active_slots=st.n_active,
                      queue_depth=st.queue_depth) as sp:
            self._plain_step()
            sp.set(tokens=self._n_decoded - d0)
        now = time.monotonic()
        self._rate.push(now, self._n_decoded - d0)
        if tel.enabled:
            wave_ms = (now - t0) * 1000.0
            tel.observe("step_ms", wave_ms)
            tel.observe("itl_ms", wave_ms)
            tel.inc("decode_waves")
            tel.inc("tokens_decoded", self._n_decoded - d0)
            tel.gauge("active_slots", st.n_active)
            tel.gauge("queue_depth", st.queue_depth)
            tel.counter("slots", active=st.n_active, queue=st.queue_depth)

    def _plain_step(self):
        """One slot-batched decode step: one device call, one host sync."""
        st = self.st
        sampling = dict(st.knobs) if self.sm.autoregressive else None
        out, self.state = self.sm.step(st.cur, self.state, st.pos,
                                       st.active, sampling)
        emitted = out.cpu().numpy()
        self.n_steps += 1
        for slot in np.flatnonzero(st.active):
            req = st.slot_req[slot]
            req.outputs.append(emitted[slot].copy())
            self.n_emitted += 1
            self._n_decoded += 1
            self._first_token(req)
            st.pos[slot] += 1
            st.remaining[slot] -= 1
            if self.sm.autoregressive:
                st.cur[slot] = emitted[slot]
                done = (st.remaining[slot] <= 0
                        or emitted[slot] == req.eos_id)
            else:
                done = st.remaining[slot] <= 0
                if not done:
                    st.cur[slot] = req.prompt[st.pos[slot]]
            if done:
                self._retire(slot)

    def run(self, max_steps: Optional[int] = None, *,
            verbose: bool = False) -> List[Request]:
        """Drive until every submitted request finishes; returns them in
        completion order.  ``verbose=True`` prints a :meth:`stats` line
        after every step."""
        st = self.st
        steps = 0
        sink = self.telemetry.stats_sink
        if sink is None and verbose:
            if self._verbose_sink is None:
                self._verbose_sink = StatsSink()
            sink = self._verbose_sink
        while st.waiting or st.active.any():
            self.step()
            if sink is not None:
                sink.emit(self.stats())
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        return st.finished

    # ------------------------------------------------------------------
    # observability
    # ------------------------------------------------------------------
    def stats(self) -> EngineStats:
        paid = self.n_steps * self.slots
        p50, p99 = self._queue_wait.percentiles((50, 99))
        return EngineStats(
            policy=self.policy.name,
            n_steps=self.n_steps,
            slots=self.slots,
            active_slots=self.st.n_active,
            queue_depth=self.st.queue_depth,
            utilization=self._n_decoded / paid if paid else 0.0,
            tokens_per_s=self._rate.per_s(),
            queue_wait_p50_ms=p50,
            queue_wait_p99_ms=p99)

    def metrics(self) -> Dict[str, Any]:
        """Machine-readable engine metrics.  ``kernels`` holds each kernel
        wrapper's process-wide launch count (the reference's ``jit``
        section counted compiles; eager PyTorch has none)."""
        s = self.stats()
        m: Dict[str, Any] = {
            "counters": {
                "steps": self.n_steps,
                "tokens_emitted": self.n_emitted,
                "tokens_decoded": self._n_decoded,
                "requests_finished": len(self.st.finished),
                "prefill_chunks": getattr(self.sm, "n_prefill_chunks", 0),
            },
            "gauges": {
                "slots": float(self.slots),
                "active_slots": float(s.active_slots),
                "queue_depth": float(s.queue_depth),
                "utilization": s.utilization,
            },
            "rates": {
                "tokens_per_s": s.tokens_per_s,
                "queue_wait_p50_ms": s.queue_wait_p50_ms,
                "queue_wait_p99_ms": s.queue_wait_p99_ms,
            },
            "kernels": {f"{name}_launches": fn.launches
                        for name, fn in KERNEL_WRAPPERS.items()},
        }
        if self.telemetry.enabled:
            m["telemetry"] = self.telemetry.registry.as_dict()
        return m

    @property
    def utilization(self) -> float:
        return self.stats().utilization
