"""Fixed-capacity continuous-batching engine (port of
``repro.serve.engine``: dense and paged KV layouts, prefix caching, the
four scheduling policies with preemption, fork and speculative decoding).

Layers, as in the reference: STATE (:mod:`repro_torch.serve.state`),
SCHEDULER (:mod:`repro_torch.serve.scheduler`) and this EXECUTOR, which
drives a :class:`~repro_torch.serve.protocol.StepModel`.  Scheduling is
host-side list manipulation; the decode step always runs over the full
slot batch, with inactive slots masked.

Request lifecycle::

    submit() -> WAITING -> [admit: chunked prefill -> state write] ->
    RUNNING (slot-batch decode) -> retire -> FINISHED
       -> preempt -> WAITING (snapshot held) -> resume -> RUNNING

  * autoregressive (DecoderLM): the prompt is prefilled in chunks at
    admission (same-length prompts share one padded wave); emitted tokens
    feed back until ``max_new_tokens`` or ``eos_id``.
  * streaming (MinimalistNetwork): frames are fed one per step and every
    per-frame output is recorded; the request retires when its stream is
    exhausted.

Paged KV layout: the engine owns a :class:`~repro_torch.serve.paged.PagePool`.
Admission reserves a request's worst-case page chain (prompt + budget)
and DEFERS while the pool cannot cover it; pages are allocated as a
chain grows (at admission and on decode append), shared pages are copied
on write, and a slot's pages and reservation return to the pool when it
retires or is cancelled.  With ``prefix_cache=True`` admission runs
singleton waves: a request whose page-aligned prompt prefix is cached
attaches to those pages and prefills only its tail.

Preemption (paged layout only): when the policy's head is blocked it may
name a running victim; the engine copies exactly the victim's page chain
and per-slot carry to host memory, releases its pages and re-queues it.
Re-admission re-reserves what the slot held, re-seeds FRESH pages with
the saved bytes and resumes mid-stream with no prefill.  Reads go through
the block table and sampling is counter-based on (seed, uid, pos), so the
resumed stream is bitwise the undisturbed one.

``fork`` splits a running request into streams sharing its page chain
copy-on-write.  With a ``drafter`` (:mod:`repro_torch.serve.spec`) every
decode step is a propose/verify wave of up to ``spec_k`` tokens a slot;
greedy streams stay bitwise the target-only ones on the gather read.
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
from repro_torch.kernels.paged_attention.ops import (paged_gqa_kernel,
                                                     paged_gqa_q8_kernel,
                                                     paged_mla_kernel,
                                                     paged_mla_q8_kernel)
from repro_torch.serve.paged import PagePool, PrefixCache
from repro_torch.serve.sampling import KNOB_DTYPES
from repro_torch.serve.scheduler import make_policy
from repro_torch.serve.spec import heterogeneous_k
from repro_torch.serve.state import Request, SlotTable, _knob_values
from repro_torch.serve.telemetry import (NULL_TELEMETRY, PercentileWindow,
                                         RateWindow, StatsSink)

#: The kernel wrappers whose launch counts ``metrics()`` reports.
KERNEL_WRAPPERS = {"linear_scan": linear_scan_kernel,
                   "minimalist_step": minimalist_step_kernel,
                   "paged_gqa": paged_gqa_kernel,
                   "paged_gqa_q8": paged_gqa_q8_kernel,
                   "paged_mla": paged_mla_kernel,
                   "paged_mla_q8": paged_mla_q8_kernel}


@dataclasses.dataclass(frozen=True)
class EngineStats:
    """One host-side snapshot of engine occupancy (``ServeEngine.stats()``)."""

    policy: str
    n_steps: int
    slots: int
    active_slots: int
    queue_depth: int
    utilization: float         # decode tokens per slot-step paid
    pages_in_use: int = 0      # paged KV layout only (else 0)
    pages_free: int = 0
    pages_reserved: int = 0
    n_preemptions: int = 0
    # requests finished after their deadline on the engine's step clock
    deadline_misses: int = 0
    tokens_per_s: float = 0.0
    queue_wait_p50_ms: float = 0.0
    queue_wait_p99_ms: float = 0.0
    accept_rate: float = 0.0   # accepted / proposed drafts (0: no drafter)

    def line(self) -> str:
        return (f"[{self.policy} step {self.n_steps}] "
                f"slots {self.active_slots}/{self.slots} "
                f"queue {self.queue_depth} "
                f"pages {self.pages_in_use} used / {self.pages_free} "
                f"free / {self.pages_reserved} reserved "
                f"preempt {self.n_preemptions} "
                f"util {self.utilization:.2f} "
                f"tok/s {self.tokens_per_s:.0f} "
                f"qwait {self.queue_wait_p50_ms:.1f}/"
                f"{self.queue_wait_p99_ms:.1f}ms "
                f"accept {self.accept_rate:.2f}")


class ServeEngine:
    """Continuous-batching engine over any StepModel (the model owns its
    parameters).  ``policy`` is a name of
    :data:`~repro_torch.serve.scheduler.POLICIES` or a SchedulingPolicy
    instance; ``prefix_cache=True`` (paged layout only) pins finished
    prompts' pages for later requests to attach to; ``drafter`` (a
    :class:`~repro_torch.serve.spec.DraftStepModel` built for ``spec_k``)
    turns every decode step into a speculative wave.

    ``mesh=`` serves under a ("data", "model") ``DeviceMesh``: the step
    model is bound to it (``bind_mesh``) — parameters TP-shard over
    "model" by the model's logical-axis rules, slots DP-shard over
    "data" — and every rank runs this same engine on the same requests,
    so host decisions (admission, pages, preemption, the prefix cache)
    agree.  On a 1x1 mesh the streams are bitwise the no-mesh engine's."""

    def __init__(self, step_model, *, slots: int = 8, policy="fifo",
                 prefix_cache: bool = False, drafter=None, spec_k: int = 1,
                 telemetry=None, mesh=None):
        self.sm = step_model
        self.slots = int(slots)
        if self.slots < 1:
            raise ValueError("slots must be >= 1")
        if mesh is not None:
            step_model.bind_mesh(mesh, self.slots)
        self.mesh = getattr(step_model, "mesh", None)
        self.telemetry = telemetry if telemetry is not None \
            else NULL_TELEMETRY
        self.policy = make_policy(policy)
        self.policy.telemetry = self.telemetry
        self.spec_k = int(spec_k)
        self.drafter = drafter
        if drafter is None:
            if self.spec_k != 1:
                raise ValueError(
                    f"spec_k={spec_k} needs a drafter (spec_k == 1 is "
                    "plain decode)")
        else:
            self._check_spec_compat(step_model, drafter, prefix_cache)
        # paged KV layout: the engine owns the page allocator — block
        # tables, free list and per-slot chains live here on the host;
        # only the page POOLS are device state (inside self.state)
        self.pool = None
        if getattr(step_model, "kv_layout", "dense") == "paged":
            self.pool = PagePool(step_model.num_pages(self.slots),
                                 self.slots, step_model.max_pages)
            self.pool.telemetry = self.telemetry
        self.prefix_cache = None
        if prefix_cache:
            if self.pool is None:
                raise ValueError(
                    "prefix_cache=True needs kv_layout='paged'")
            step_model.check_prefix_cacheable()
            # window-bearing stacks overwrite ring slots during prefill,
            # so only end-of-prompt page state is cacheable
            self.prefix_cache = PrefixCache(
                self.pool, step_model.paged.page_size,
                full_prompt_only=step_model._has_window)
            self.prefix_cache.telemetry = self.telemetry
        self.state = step_model.init_state(self.slots)
        self.st = SlotTable(self.slots, pool=self.pool,
                            pages_for_req=self._pages_for_req,
                            telemetry=self.telemetry)
        self._uid = 0
        # speculative decoding: the drafter's stacked-carry store, each
        # slot's resume index into its K axis, and each slot's width
        if self.drafter is not None:
            self.draft_store = self.drafter.init_store(self.slots)
            self.drafter.telemetry = self.telemetry
            self._draft_sel = np.zeros(self.slots, np.int32)
            self._req_k = np.ones(self.slots, np.int32)
        self.n_steps = 0
        self.n_emitted = 0          # all tokens, incl. admission prefill
        self._n_decoded = 0         # tokens emitted by slot-batch steps
        self.n_prefix_hits = 0      # admissions that attached to cache
        self.n_prefix_tokens = 0    # prompt positions skipped by attaches
        self.n_cow_copies = 0       # device page copies (decode COW)
        self.n_forks = 0
        self.n_preemptions = 0      # victims evicted by the policy
        self.n_snapshot_bytes = 0   # host bytes of every preemption copy
        self.n_drafts_proposed = 0  # drafter tokens offered to verify
        self.n_drafts_accepted = 0  # ... that the target accepted
        self.n_deadline_misses = 0  # finished past deadline (step clock)
        self._rate = RateWindow(maxlen=256)
        self._queue_wait = PercentileWindow(maxlen=512)
        self._verbose_sink: Optional[StatsSink] = None

    def _check_spec_compat(self, step_model, drafter, prefix_cache):
        """Everything speculative decoding requires of the target, checked
        at construction (the reference's errors)."""
        if self.spec_k < 1:
            raise ValueError(f"spec_k must be >= 1, got {self.spec_k}")
        if getattr(drafter, "k", None) != self.spec_k:
            raise ValueError(
                f"drafter was built for spec_k={getattr(drafter, 'k', None)}"
                f" but the engine asks {self.spec_k} — the stacked-carry "
                "store and the verify program share one K")
        if not getattr(step_model, "autoregressive", False):
            raise ValueError("speculative decoding applies to "
                             "autoregressive LM targets only")
        if getattr(step_model, "kv_layout", "dense") != "paged":
            raise ValueError(
                "speculative decoding needs kv_layout='paged': rejection "
                "rollback = not committing pages (the dense layout writes "
                "in-place during decode)")
        if prefix_cache:
            raise ValueError("speculative decoding and prefix_cache are "
                             "mutually exclusive (singleton admission "
                             "waves; lift when needed)")
        if step_model.model.cfg.kv_dtype != "bf16":
            raise ValueError(
                f"speculative verify does not support kv_dtype="
                f"{step_model.model.cfg.kv_dtype!r}: the k-token snapshot "
                "overlay reads raw pool rows (quantized pools would need "
                "an in-graph dequant overlay)")
        o1 = sorted(set(range(len(step_model.model.layers)))
                    - step_model.model.paged_layer_names())
        if o1:
            raise ValueError(
                f"speculative targets must be attention-only stacks: "
                f"layers {o1} carry O(1) mixer state whose carry cannot "
                "be rolled back to an accepted prefix")
        if drafter.vocab != step_model.vocab:
            raise ValueError(
                f"drafter vocab ({drafter.vocab}) != target vocab "
                f"({step_model.vocab}): draft token ids must BE target "
                "token ids")
        rings = getattr(step_model, "_ring_lens", [])
        if rings and self.spec_k > min(rings):
            raise ValueError(
                f"spec_k={self.spec_k} exceeds the shortest sliding-"
                f"window ring ({min(rings)}): two speculative tokens "
                "would alias one ring slot in the verify overlay")

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

    def _pages_for_req(self, req: Request) -> int:
        """Worst-case reservation: prompt + full budget for a fresh
        request; for a preempted one, exactly the reservation its slot
        held at eviction (a fork child's budget counts from the fork point
        while its chain covers every earlier position, so prompt + budget
        would under-reserve it)."""
        if self.pool is None:
            return 0
        if req.snapshot is not None:
            return req.snapshot["reserve"]
        return self.sm.pages_for(len(req.prompt) + req.max_new_tokens)

    # ------------------------------------------------------------------
    # submission / admission
    # ------------------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int = 0,
               eos_id: Optional[int] = None,
               sampling: Optional[SamplingParams] = None, *,
               priority: int = 0, deadline: Optional[float] = None,
               spec_k: Optional[int] = None) -> Request:
        prompt = np.asarray(prompt)
        # a per-request verify width may only shrink the engine's K
        if spec_k is not None:
            if isinstance(spec_k, bool) or not isinstance(
                    spec_k, (int, np.integer)):
                raise ValueError(f"spec_k must be an int, got {spec_k!r}")
            if spec_k < 1:
                raise ValueError(f"spec_k must be >= 1, got {spec_k}")
            if spec_k > self.spec_k:
                raise ValueError(
                    f"spec_k={spec_k} exceeds the engine's verify width "
                    f"({self.spec_k}) — per-request widths may only "
                    "shrink the compiled K, never grow it")
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
            # attention writes K/V at absolute positions: past max_len the
            # stream would decode garbage — reject up front.  Under the
            # paged layout this bound also makes page OOM impossible: the
            # pool holds one max-length request, so admission only defers
            if getattr(self.sm, "positional", False):
                need = len(prompt) + max_new_tokens
                if need > self.sm.max_len:
                    raise ValueError(
                        f"prompt ({len(prompt)}) + max_new_tokens "
                        f"({max_new_tokens}) = {need} cache positions, "
                        f"but the engine was built with "
                        f"max_len={self.sm.max_len}")
        req = Request(self._uid, prompt, max_new_tokens, eos_id, sampling,
                      priority=priority, deadline=deadline, spec_k=spec_k)
        req.validate_scheduling()          # raises BEFORE the uid burns
        self._uid += 1
        req.submit_t = time.monotonic()
        req.created_t = req.submit_t
        self.st.waiting.append(req)
        tel = self.telemetry
        if tel.enabled:
            tel.inc("requests_submitted")
            tel.gauge("queue_depth", self.st.queue_depth)
            tel.request_instant(req, "submit", prompt=len(prompt),
                                max_new_tokens=int(max_new_tokens),
                                priority=req.priority)
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
        is possible (a slot freed mid-wave refills in the same call).
        When admission stalls, the policy may name a running victim to
        preempt; its eviction frees a slot and pages and admission
        retries.  Each pass admits a request or shrinks the running set,
        and ``select_victim`` returning None ends the round."""
        self.policy.begin_round(self.st)
        while True:
            if self._admit_once():
                continue
            victim = self.policy.select_victim(self.st)
            if victim is None:
                break
            self._preempt(victim)

    def _admit_once(self) -> bool:
        """One admission wave: same-length prompts prefill as one batched
        chunked call and land in one slot write.  Returns True iff at least
        one request was admitted (or a preempted one resumed).

        Paged KV: admission RESERVES the request's worst-case page chain
        (the full worst case even when a prefix attach will share pages),
        so decode-time appends and copies-on-write never fail; it defers
        at the queue's head while the pool cannot cover it.  Prefix
        caching runs SINGLETON waves, so each admission inserts its
        prompt's pages before the next request's lookup."""
        st = self.st
        admitted = []
        resumed = False
        while st.waiting and st.free_mask:
            req = self.policy.admit_order(st.waiting, st)[0]
            if self.pool is not None and not self.pool.can_admit(
                    self._pages_for_req(req)):
                break                      # defer until pages free up
            st.pop_waiting(req)
            wait_ms = (time.monotonic() - req.submit_t) * 1000.0
            self._queue_wait.push(wait_ms)
            if self.telemetry.enabled:
                self.telemetry.observe("queue_wait_ms", wait_ms)
            slot = st.alloc_slot()
            if self.pool is not None:
                self.pool.reserve(slot, self._pages_for_req(req))
            st.slot_req[slot] = req
            if req.snapshot is not None:
                self._resume(req, slot)    # no prefill: pages re-seed
                resumed = True
                continue
            st.active[slot] = True
            if self.telemetry.enabled:
                self.telemetry.request_begin(req, "running", slot=slot)
            admitted.append((req, slot))
            if st.cur is None:
                shape = (self.slots,) + tuple(req.prompt.shape[1:])
                st.cur = np.zeros(shape, req.prompt.dtype)
            if self.prefix_cache is not None:
                break                      # singleton waves (see above)
        if not admitted:
            return resumed
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
                          chunk_w=cw, chunks=-(-plen // cw)) as sp:
                pages = None
                if self.prefix_cache is not None:
                    req0, slot0 = group[0]  # singleton wave (see above)
                    pages, attach = self.prefix_cache.match(req0.prompt, cw)
                if pages is not None:
                    last, carry = self._attach_prefill(req0, slot0, pages,
                                                       attach)
                    sp.set(attached=attach)
                else:
                    if self.pool is not None:
                        for _r, s in group:
                            self.pool.grow(s, self.sm.pages_for(plen))
                    prompts = [r.prompt for r, _s in group]
                    prompts += [prompts[-1]] * (
                        len(self._pad_slots([s for _r, s in group]))
                        - len(group))
                    last, carry = self.sm.prefill(np.stack(prompts))
                self._install_wave(plen, group, last, carry)
            if tel.enabled:
                tel.observe("prefill_ms", (time.monotonic() - t0) * 1000.0)
        return True

    def _attach_prefill(self, req, slot, pages, attach):
        """Prefix-cache hit: share the resident pages into ``slot``,
        rebuild the dense cache they hold, and prefill only the tail
        chunks — the attached stream is bitwise the stream a full prefill
        would have produced (same chunk grid, same bytes)."""
        sm, plen = self.sm, len(req.prompt)
        self.pool.share(slot, pages)
        # gather BEFORE any detach below rewires the block-table row
        seed = sm.seed_cache(self.state,
                             self.pool.block_tables[slot:slot + 1])
        self.pool.grow(slot, sm.pages_for(plen))
        if sm._has_window:
            # ring pages diverge from the entry's frozen bytes the moment
            # the tail writes — detach them, with no device copy: the wave
            # write rewrites every chain page of every layer
            for i in range(len(pages)):
                self.pool.cow(slot, i, materialize=False)
            start = attach
        else:
            # global: the overlap recompute writes identical bytes, so
            # shared pages stay shared; recompute at least the last token
            # (its logits feed the first sampled token)
            cw = sm.chunk_for(plen)
            start = (min(attach, plen - 1) // cw) * cw
        last, carry = sm.prefill(req.prompt[None, :], cache0=seed,
                                 start=start)
        self.n_prefix_hits += 1
        self.n_prefix_tokens += start
        return last, carry

    def _install_wave(self, plen, group, last, carry):
        """Scatter a prefilled wave into its slots (page-granularly under
        the paged layout), pin its prompts in the prefix cache, and
        draw/book-keep the first sampled token (at position plen)."""
        st = self.st
        slots = [s for _r, s in group]
        pad = self._pad_slots(slots)
        if self.pool is None:
            self.state = self.sm.write_slots(self.state, carry, pad)
        else:
            # padding rows get all-out-of-bounds page ids (never written)
            pages = np.full((len(pad), self.pool.max_pages),
                            self.pool.num_pages, np.int32)
            pages[:len(group)] = self.pool.block_tables[slots]
            self.state = self.sm.write_slots(self.state, carry, pad,
                                             pages=pages, plen=plen)
            if self.prefix_cache is not None:
                # pin BEFORE an instant retire below releases the chain
                for r, s in group:
                    self.prefix_cache.insert(
                        r.prompt, self.pool.block_tables[s],
                        self.sm.chunk_for(plen))
        if self.drafter is not None:
            # the drafter tracks the same stream: its own prefill over the
            # wave's prompts, tiled K-wide (resume index 0); it consumes
            # tok0 as ``cur`` in the first propose wave
            prompts = [r.prompt for r, _s in group]
            prompts += [prompts[-1]] * (len(pad) - len(group))
            self.draft_store = self.drafter.install(
                self.draft_store, self.drafter.prefill(np.stack(prompts)),
                pad)
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
            if self.drafter is not None:
                self._draft_sel[slot] = 0
                self._req_k[slot] = (req.spec_k if req.spec_k is not None
                                     else self.spec_k)
            if st.remaining[slot] <= 0 or t == req.eos_id:
                self._retire(slot)

    # ------------------------------------------------------------------
    # preemption (policy-driven victim swap-out / swap-in)
    # ------------------------------------------------------------------
    def _preempt(self, slot: int):
        """Evict running ``slot``: copy exactly its page chain and per-slot
        carry to host memory, release its pages and reservation, and put
        the request back on the queue holding the snapshot."""
        st = self.st
        req = st.slot_req[slot]
        if req is None or not st.active[slot]:
            raise ValueError(f"slot {slot} is not running (cannot "
                             "preempt)")
        if self.pool is None:
            raise ValueError("preemption needs kv_layout='paged' (page "
                             "swap is what makes eviction cheap)")
        n = int(self.pool.chain_len[slot])
        pages = self.pool.block_tables[slot, :n].copy()
        tel = self.telemetry
        with tel.span("preempt", uid=req.uid, slot=int(slot), pages=n):
            state = self.sm.snapshot_slot(self.state, slot, pages)
            self.n_snapshot_bytes += sum(
                t.numel() * t.element_size() for sub in state
                for t in sub.values())
            req.snapshot = {
                "n_pages": n,
                # re-admission reserves exactly this (_pages_for_req)
                "reserve": self.pool.reserved_for(slot),
                "state": state,
                "pos": int(st.pos[slot]),
                "remaining": int(st.remaining[slot]),
                "cur": np.copy(st.cur[slot]),
            }
            if self.drafter is not None:
                req.snapshot["draft"] = self.drafter.snapshot_slot(
                    self.draft_store, slot)
                req.snapshot["draft_sel"] = int(self._draft_sel[slot])
            req.submit_t = time.monotonic()  # queue wait restarts here
            req.n_preemptions += 1
            self.n_preemptions += 1
            st.free_slot(slot)             # pages + reservation go back
        if tel.enabled:
            tel.inc("preemptions")
            tel.request_begin(req, "preempted", slot=int(slot), pages=n)
        # a policy that keeps arrival order retries the victim first
        st.waiting.appendleft(req)

    def _resume(self, req: Request, slot: int):
        """Re-admit a preempted request (the caller holds the slot and its
        reservation): grow a FRESH chain, re-seed its pages from the
        snapshot, restore the per-slot carry and counters.  No prefill,
        no first-token draw."""
        st = self.st
        snap = req.snapshot
        tel = self.telemetry
        with tel.span("resume", uid=req.uid, slot=int(slot),
                      pages=snap["n_pages"]):
            self.pool.grow(slot, snap["n_pages"])
            pages = self.pool.block_tables[slot, :snap["n_pages"]]
            self.state = self.sm.restore_slot(self.state, snap["state"],
                                              slot, pages)
            st.pos[slot] = snap["pos"]
            st.remaining[slot] = snap["remaining"]
            st.cur[slot] = snap["cur"]
            st.set_sampling(slot, req)
            st.active[slot] = True
            if self.drafter is not None:
                self.draft_store = self.drafter.restore_slot(
                    self.draft_store, snap["draft"], slot)
                self._draft_sel[slot] = snap["draft_sel"]
                self._req_k[slot] = (req.spec_k if req.spec_k is not None
                                     else self.spec_k)
        if tel.enabled:
            tel.inc("resumes")
            tel.request_begin(req, "running", slot=int(slot), resumed=True)
        req.snapshot = None                # drop the host bytes

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
        # deadlines live on the engine's step clock
        miss = req.deadline is not None and self.n_steps > req.deadline
        if miss:
            self.n_deadline_misses += 1
        tel = self.telemetry
        if tel.enabled:
            tel.inc("requests_finished")
            if miss:
                tel.inc("deadline_misses")
            tel.request_end(req, tokens=len(req.outputs),
                            preemptions=req.n_preemptions)
            tel.request_instant(req, "finish", tokens=len(req.outputs),
                                deadline_miss=miss)
            if req.created_t is not None and req.finish_t is not None:
                tel.observe("e2e_ms",
                            (req.finish_t - req.created_t) * 1000.0)
        return req

    def cancel(self, req: Request):
        """Abort a request: a waiting one leaves the queue (it holds no
        pages), a running one frees its slot — and, under the paged
        layout, its pages and reservation — before the next step.  Tokens
        already emitted stay on the request, which is marked
        finished+cancelled and never joins ``finished``.  A preempted
        request waiting in the queue drops its host snapshot."""
        if req.finished:
            return
        if not self.st.discard_waiting(req):
            for slot, r in enumerate(self.st.slot_req):
                if r is req:
                    self.st.free_slot(slot)
                    break
            else:
                raise ValueError("request is not known to this engine")
        req.snapshot = None
        req.finished = True
        req.cancelled = True
        if self.telemetry.enabled:
            self.telemetry.inc("requests_cancelled")
            self.telemetry.request_end(req, cancelled=True)
            self.telemetry.request_instant(req, "cancel")

    def step(self):
        """Admit what fits, then run ONE slot-batched decode step (a
        propose/verify wave when a drafter is configured)."""
        tel = self.telemetry
        with tel.span("admit", queue_depth=self.st.queue_depth):
            self.admit()
        st = self.st
        if not st.active.any():
            return
        t0 = time.monotonic()
        d0, a0 = self._n_decoded, self.n_drafts_accepted
        spec = self.drafter is not None
        with tel.span("spec_wave" if spec else "decode_wave",
                      active_slots=st.n_active,
                      queue_depth=st.queue_depth,
                      pages_in_use=(self.pool.pages_in_use
                                    if self.pool else 0)) as sp:
            if spec:
                self._spec_step()
                sp.set(accepted_drafts=self.n_drafts_accepted - a0)
            else:
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
            if self.pool is not None:
                tel.gauge("pool_utilization",
                          self.pool.pages_in_use / self.pool.num_pages)
                tel.counter("pool", in_use=self.pool.pages_in_use,
                            free=len(self.pool._free),
                            reserved=self.pool.reserved_total)

    def _plain_step(self):
        """One slot-batched decode step: one device call, one host sync.

        Paged layout: allocate-on-append — this step writes K/V at
        pos[slot], so every active chain must cover it (the pages come out
        of the admission reservation, so growth cannot fail); a write
        landing in a SHARED page (a prefix-cache pin also holds it) first
        detaches to a private copy, all copies of the step in one call."""
        st = self.st
        kw = {}
        if self.pool is not None:
            cow_src, cow_dst = [], []
            for slot in np.flatnonzero(st.active):
                self.pool.grow(slot,
                               self.sm.pages_for(int(st.pos[slot]) + 1))
                for ci in self.sm.write_page_indices(int(st.pos[slot])):
                    pair = self.pool.cow(slot, ci)
                    if pair is not None:
                        cow_src.append(pair[0])
                        cow_dst.append(pair[1])
            if cow_src:
                self.state = self.sm.copy_pages(self.state, cow_src,
                                                cow_dst)
                self.n_cow_copies += len(cow_src)
            kw["bt"] = self.pool.block_tables
        sampling = dict(st.knobs) if self.sm.autoregressive else None
        out, self.state = self.sm.step(st.cur, self.state, st.pos,
                                       st.active, sampling, **kw)
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

    def _spec_step(self):
        """One propose/verify wave: the drafter rolls ``spec_k`` greedy
        steps per slot, the target scores them in one ``verify`` call that
        also commits exactly the accepted prefix's K/V, and each slot
        advances by its accepted tokens plus one correction."""
        st = self.st
        # per-slot widths, clamped by the remaining budget so commits never
        # pass pos + remaining (the reservation and max_len stop there)
        k_slot = heterogeneous_k(self._req_k, st.remaining, self.spec_k)
        # a wave writes K/V at pos .. pos+k_slot-1: grow and COW the whole
        # span first (the same reservation-backed guarantee as one step)
        cow_src, cow_dst = [], []
        for slot in np.flatnonzero(st.active):
            p0, kk = int(st.pos[slot]), int(k_slot[slot])
            self.pool.grow(slot, self.sm.pages_for(p0 + kk))
            touched = set()
            for p in range(p0, p0 + kk):
                touched.update(self.sm.write_page_indices(p))
            for ci in sorted(touched):
                pair = self.pool.cow(slot, ci)
                if pair is not None:
                    cow_src.append(pair[0])
                    cow_dst.append(pair[1])
        if cow_src:
            self.state = self.sm.copy_pages(self.state, cow_src, cow_dst)
            self.n_cow_copies += len(cow_src)
        tel = self.telemetry
        with tel.span("propose", k=int(k_slot.max())):
            toks, self.draft_store = self.drafter.propose(
                self.draft_store, self._draft_sel, st.cur, st.active)
        with tel.span("verify"):
            emitted, n_emit, self.state = self.sm.verify(
                toks, self.state, st.pos, st.active, k_slot,
                dict(st.knobs), bt=self.pool.block_tables)
        self.n_steps += 1
        for slot in np.flatnonzero(st.active):
            req = st.slot_req[slot]
            n = int(n_emit[slot])
            self.n_drafts_proposed += int(k_slot[slot]) - 1
            self.n_drafts_accepted += n - 1
            done = False
            n_take = n
            for j in range(n):
                t = int(emitted[slot, j])
                req.outputs.append(emitted[slot, j].copy())
                self.n_emitted += 1
                self._n_decoded += 1
                self._first_token(req)
                if t == req.eos_id:
                    # tokens past an eos are discarded (their K/V commits
                    # die with the freed pages)
                    n_take = j + 1
                    done = True
                    break
            st.pos[slot] += n_take
            st.remaining[slot] -= n_take
            if st.remaining[slot] <= 0:
                done = True
            if done:
                self._retire(slot)
            else:
                st.cur[slot] = emitted[slot, n_take - 1]
                # the drafter state after consuming the stream through
                # pos-1 is the wave's (n_take-1)-th feed
                self._draft_sel[slot] = n_take - 1

    def fork(self, req: Request, n: int = 1, *,
             max_new_tokens: Optional[int] = None,
             sampling: Optional[SamplingParams] = None) -> List[Request]:
        """Split a RUNNING request into ``n`` more streams that share its
        page chain copy-on-write (best-of-n pays the parent's prefill
        once).  Each child copies the parent's block-table row, per-slot
        state, outputs so far, position and input token, and gets a FRESH
        uid: sampled children draw independent streams, greedy children
        reproduce the parent bitwise.  ``max_new_tokens=None`` inherits
        the parent's remaining budget.  Children need a free slot and a
        full worst-case reservation now: fork raises rather than
        queueing."""
        st = self.st
        if self.pool is None:
            raise ValueError("fork() needs kv_layout='paged' (page "
                             "sharing is what makes a fork O(1))")
        if not self.sm.autoregressive:
            raise ValueError("fork() applies to LM requests only")
        parent = next((s for s, r in enumerate(st.slot_req) if r is req),
                      None)
        if parent is None:
            raise ValueError(
                "fork parent must be RUNNING (admitted, not finished) — "
                "fork after admit()/step() has placed it in a slot")
        if sampling is not None:
            sampling.validate()
        children: List[Request] = []
        for _ in range(int(n)):
            pos = int(st.pos[parent])
            budget = (int(st.remaining[parent])
                      if max_new_tokens is None else int(max_new_tokens))
            if budget < 1:
                raise ValueError(f"fork needs a generation budget >= 1, "
                                 f"got {budget}")
            if pos + budget > self.sm.max_len:
                raise ValueError(
                    f"fork at position {pos} + {budget} new tokens "
                    f"exceeds max_len={self.sm.max_len}")
            if not st.free_mask:
                raise RuntimeError("no free slot to fork into")
            need = self.sm.pages_for(pos + budget)
            if not self.pool.can_admit(need):
                raise RuntimeError(
                    f"cannot fork: child needs a reservation of {need} "
                    f"pages but only {self.pool.available} are "
                    "unreserved (shared pages don't count — "
                    "reservations stay worst-case under sharing)")
            slot = st.alloc_slot()
            self.pool.reserve(slot, need)
            nchain = int(self.pool.chain_len[parent])
            self.pool.share(slot, self.pool.block_tables[parent, :nchain])
            samp = dataclasses.replace(sampling if sampling is not None
                                       else req.sampling)
            child = Request(self._uid, req.prompt, budget, req.eos_id, samp,
                            priority=req.priority, deadline=req.deadline,
                            spec_k=req.spec_k)
            self._uid += 1
            child.outputs = list(req.outputs)
            st.slot_req[slot] = child
            st.active[slot] = True
            st.pos[slot] = st.pos[parent]
            st.remaining[slot] = budget
            st.cur[slot] = st.cur[parent]
            st.set_sampling(slot, child)
            self.state = self.sm.copy_slot(self.state, parent, slot)
            if self.drafter is not None:
                self.draft_store = self.drafter.copy_slot(
                    self.draft_store, parent, slot)
                self._draft_sel[slot] = self._draft_sel[parent]
                self._req_k[slot] = self._req_k[parent]
            self.n_forks += 1
            if self.telemetry.enabled:
                self.telemetry.inc("forks")
                self.telemetry.instant("fork", parent_uid=req.uid,
                                       child_uid=child.uid, slot=int(slot))
                self.telemetry.request_begin(child, "running",
                                             slot=int(slot), forked=True)
            children.append(child)
        return children

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
            n_finished = len(st.finished)
            self.step()
            if sink is not None:
                sink.emit(self.stats())
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
            if (st.waiting and not st.active.any()
                    and len(st.finished) == n_finished):
                # nothing runs to free capacity: the head can never admit
                head = self.policy.admit_order(st.waiting, st)[0]
                pool = ("no page pool" if self.pool is None else
                        f"pool: {self.pool.available} of "
                        f"{self.pool.num_pages} pages unreserved, "
                        f"{self.pool.pages_in_use} in use")
                raise RuntimeError(
                    f"engine stalled: request uid={head.uid} (prompt="
                    f"{len(head.prompt)} tokens, max_new_tokens="
                    f"{head.max_new_tokens}, needs "
                    f"{self._pages_for_req(head)} pages) cannot admit and "
                    f"no slot is active to free capacity — {pool}")
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
            pages_in_use=(self.pool.pages_in_use if self.pool else 0),
            pages_free=(len(self.pool._free) if self.pool else 0),
            pages_reserved=(self.pool.reserved_total if self.pool
                            else 0),
            n_preemptions=self.n_preemptions,
            utilization=self._n_decoded / paid if paid else 0.0,
            deadline_misses=self.n_deadline_misses,
            tokens_per_s=self._rate.per_s(),
            queue_wait_p50_ms=p50,
            queue_wait_p99_ms=p99,
            accept_rate=(self.n_drafts_accepted / self.n_drafts_proposed
                         if self.n_drafts_proposed else 0.0))

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
                "preemptions": self.n_preemptions,
                "snapshot_bytes": self.n_snapshot_bytes,
                "forks": self.n_forks,
                "cow_copies": self.n_cow_copies,
                "prefix_hits": self.n_prefix_hits,
                "prefix_tokens_skipped": self.n_prefix_tokens,
                "drafts_proposed": self.n_drafts_proposed,
                "drafts_accepted": self.n_drafts_accepted,
                "deadline_misses": self.n_deadline_misses,
            },
            "gauges": {
                "slots": float(self.slots),
                "active_slots": float(s.active_slots),
                "queue_depth": float(s.queue_depth),
                "pages_in_use": float(s.pages_in_use),
                "pages_free": float(s.pages_free),
                "pages_reserved": float(s.pages_reserved),
                "pool_utilization": (
                    s.pages_in_use / self.pool.num_pages
                    if self.pool else 0.0),
                "utilization": s.utilization,
            },
            "rates": {
                "tokens_per_s": s.tokens_per_s,
                "queue_wait_p50_ms": s.queue_wait_p50_ms,
                "queue_wait_p99_ms": s.queue_wait_p99_ms,
                "accept_rate": s.accept_rate,
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
