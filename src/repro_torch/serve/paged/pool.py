"""Block-table page allocator (host side) with per-page refcounts (a copy
of ``repro.serve.paged.pool``: plain Python, copied rather than imported
so the port never loads JAX).

Pages are rows of the device-resident pools; this module only moves
int32 page ids around.  Invariants the serving engine relies on:

  * a page id belongs to the free list or has ``refcount >= 1``; a page
    with ``refcount == 1`` has exactly ONE writer (its owning chain), so
    concurrent slots can scatter into the shared pool without write
    aliasing — a chain about to WRITE into a page with ``refcount > 1``
    must first :meth:`cow` it (copy-on-write);
  * reservations are conservative UNDER SHARING: ``reserve`` charges
    every chain its full worst-case page count even when it currently
    shares pages with a parent chain or the prefix cache, so ``grow``
    (allocate-on-decode-append) and ``cow`` can never fail mid-stream —
    shared pages are a bonus, never load-bearing capacity.  Formally:
    every live chain's length is ``<= _reserved[slot]``, each physical
    page is counted at most once per chain holding it, so
    ``pages_in_use <= reserved_total + held_external`` and after the
    reclaim hook drains external holds ``len(_free) >= num_pages -
    reserved_total >= 0`` whenever a reserve-covered pop happens;
  * ``release`` decrements refcounts and returns only pages that hit
    zero (plus the unused reservation tail) — forks/prefix holds keep
    shared pages alive;
  * external holders (the prefix cache) pin pages via
    :meth:`incref`/:meth:`decref`; when the free list runs dry the pool
    calls its ``reclaim`` hook so the holder can drop unpinned pages
    before a reserve-covered allocation would fail.

Quantized pools (``kv_dtype="int8"``) change nothing here: a page id
names the page's int8 code row AND its float32 scale row in every pool
leaf, so refcounts, COW, and release move them as one unit — the device
side (``DecoderStepModel.copy_pages`` / ``write_slots``) copies
and installs ``<key>_scale`` leaves page-for-page with their codes.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serve.telemetry import NULL_TELEMETRY


class PagedConfig:
    """Paged-KV knobs.  ``num_pages == 0`` means auto-size the pool to
    dense-equivalent capacity (slots × pages-per-max-length-request) —
    useful for bitwise paged-vs-dense testing; production deployments
    set it below that to actually save memory."""

    def __init__(self, page_size: int = 16, num_pages: int = 0):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        if num_pages < 0:
            raise ValueError(f"num_pages must be >= 0 (0 = auto-size), "
                             f"got {num_pages}")
        self.page_size = int(page_size)
        self.num_pages = int(num_pages)

    def validate_for(self, max_len: int, pages_per_request: int):
        """A pool that cannot hold ONE max-length request can never
        serve anything — fail at construction, not mid-traffic."""
        if self.num_pages and self.num_pages < pages_per_request:
            raise ValueError(
                f"num_pages={self.num_pages} cannot hold one max-length "
                f"request: max_len={max_len} at page_size={self.page_size} "
                f"needs {pages_per_request} pages (raise num_pages to >= "
                f"{pages_per_request}, or 0 to auto-size)")
        return self

    def resolve_num_pages(self, slots: int, pages_per_request: int) -> int:
        return self.num_pages or int(slots) * int(pages_per_request)

    def __repr__(self):
        return (f"PagedConfig(page_size={self.page_size}, "
                f"num_pages={self.num_pages})")


class PagePool:
    """Refcounted free-list page allocator over ``num_pages`` pages for
    ``slots`` concurrent requests, each owning up to ``max_pages`` chain
    entries (one block-table row)."""

    def __init__(self, num_pages: int, slots: int, max_pages: int):
        if num_pages < 1:
            raise ValueError(f"num_pages must be >= 1, got {num_pages}")
        self.num_pages = int(num_pages)
        self.slots = int(slots)
        self.max_pages = int(max_pages)
        # LIFO free list: pop() hands out the lowest ids first
        self._free = list(range(self.num_pages - 1, -1, -1))
        # unallocated entries stay 0: reads through them are always
        # position-masked (they clamp harmlessly in gathers/kernels)
        self.block_tables = np.zeros((self.slots, self.max_pages),
                                     np.int32)
        self.chain_len = np.zeros(self.slots, np.int32)
        self._reserved = np.zeros(self.slots, np.int64)
        self.reserved_total = 0
        # one count per physical page: chains holding it + external holds
        self.refcount = np.zeros(self.num_pages, np.int32)
        #: called with the number of pages needed when the free list runs
        #: dry (the prefix cache evicts unpinned entries); may be None.
        self.reclaim: Optional[Callable[[int], None]] = None
        # telemetry
        self.n_cow = 0
        #: observability handle (no-op default; the engine passes its
        #: own) — occupancy gauges + reclaim/COW counters, host-side only
        self.telemetry = NULL_TELEMETRY

    def _tel_pages(self):
        """Refresh the pool occupancy gauges (cheap; enabled path only)."""
        tel = self.telemetry
        tel.gauge("pages_in_use", self.pages_in_use)
        tel.gauge("pages_free", len(self._free))
        tel.gauge("pages_reserved", self.reserved_total)

    # -- accounting -----------------------------------------------------
    @property
    def pages_in_use(self) -> int:
        """Pages physically off the free list (refcount >= 1)."""
        return self.num_pages - len(self._free)

    @property
    def available(self) -> int:
        """Pages not yet promised to any admitted request.  Conservative
        under sharing: a forked/attached chain still charges its FULL
        worst case here, so shared pages never prop up admission."""
        return self.num_pages - self.reserved_total

    # -- admission ------------------------------------------------------
    def can_admit(self, n_pages: int) -> bool:
        return n_pages <= self.available

    def reserve(self, slot: int, n_pages: int):
        """Promise ``n_pages`` to ``slot`` (its worst-case chain)."""
        if not self.can_admit(n_pages):
            raise RuntimeError(
                f"reserve({n_pages}) exceeds available pages "
                f"({self.available}) — admit() must check can_admit first")
        if self._reserved[slot]:
            raise RuntimeError(f"slot {slot} already holds a reservation")
        self._reserved[slot] = n_pages
        self.reserved_total += n_pages
        if self.telemetry.enabled:
            self._tel_pages()

    def reserved_for(self, slot: int) -> int:
        """Pages currently promised to ``slot`` (0 when it holds no
        reservation) — what eviction would hand back, and what a
        preemption snapshot must record to re-admit safely."""
        return int(self._reserved[slot])

    # -- allocation core -------------------------------------------------
    def _pop(self) -> int:
        """Take one page off the free list (refcount 0 -> 1), asking the
        reclaim hook to drop external holds first if it is empty.  Every
        caller is reserve-covered, so after a full reclaim a free page
        provably exists — running dry here is an accounting bug."""
        if not self._free and self.reclaim is not None:
            if self.telemetry.enabled:
                self.telemetry.inc("pool_reclaims")
                self.telemetry.instant("pool_reclaim",
                                       in_use=self.pages_in_use)
            self.reclaim(1)
        if not self._free:
            raise RuntimeError(
                "page pool exhausted under a covered reservation — "
                "refcount/reservation accounting bug "
                f"(in_use={self.pages_in_use}, "
                f"reserved_total={self.reserved_total})")
        p = self._free.pop()
        self.refcount[p] = 1
        return p

    # -- allocate-on-append ---------------------------------------------
    def grow(self, slot: int, n_chain: int):
        """Extend ``slot``'s chain to ``n_chain`` pages, drawing on its
        reservation.  Called at admission (prompt pages) and before each
        decode step that crosses a page boundary."""
        if n_chain > self._reserved[slot]:
            raise RuntimeError(
                f"slot {slot}: chain of {n_chain} pages exceeds its "
                f"reservation of {int(self._reserved[slot])} — scheduler "
                "bug (reservations are sized to the worst case)")
        while self.chain_len[slot] < n_chain:
            self.block_tables[slot, self.chain_len[slot]] = self._pop()
            self.chain_len[slot] += 1
        if self.telemetry.enabled:
            self._tel_pages()

    # -- sharing ---------------------------------------------------------
    def share(self, slot: int, pages: Sequence[int]):
        """Seed ``slot``'s (empty) chain with existing live pages —
        fork / prefix-cache attach.  Each page's refcount goes up by
        one; the slot must already hold a reservation covering its full
        worst case (sharing saves memory only OPPORTUNISTICALLY)."""
        if self.chain_len[slot]:
            raise RuntimeError(f"slot {slot} already owns a chain")
        pages = [int(p) for p in pages]
        if len(pages) > self._reserved[slot]:
            raise RuntimeError(
                f"slot {slot}: sharing {len(pages)} pages exceeds its "
                f"reservation of {int(self._reserved[slot])}")
        for p in pages:
            if self.refcount[p] < 1:
                raise RuntimeError(f"page {p} is not live (cannot share)")
            self.refcount[p] += 1
        self.block_tables[slot, :len(pages)] = pages
        self.chain_len[slot] = len(pages)

    def cow(self, slot: int, i: int,
            materialize: bool = True) -> Optional[Tuple[int, int]]:
        """Copy-on-write: if chain entry ``i`` of ``slot`` points at a
        SHARED page (refcount > 1), replace it with a private page and
        return ``(src, dst)`` so the caller can copy device bytes.
        Returns None when the page is already private.

        ``materialize=False`` detaches WITHOUT requesting a device copy
        (the caller is about to fully overwrite the page, e.g. an
        attached ring page refilled by the tail prefill)."""
        if i >= self.chain_len[slot]:
            raise RuntimeError(
                f"slot {slot}: cow({i}) beyond chain length "
                f"{int(self.chain_len[slot])}")
        src = int(self.block_tables[slot, i])
        if self.refcount[src] <= 1:
            return None
        self.refcount[src] -= 1
        dst = self._pop()
        self.block_tables[slot, i] = dst
        self.n_cow += 1
        if self.telemetry.enabled:
            self.telemetry.inc("cow_detaches")
        return (src, dst) if materialize else None

    # -- external holds (prefix cache) -----------------------------------
    def incref(self, pages: Sequence[int]):
        """Pin live pages for an external holder (refcount +1 each)."""
        for p in pages:
            p = int(p)
            if self.refcount[p] < 1:
                raise RuntimeError(f"page {p} is not live (cannot pin)")
            self.refcount[p] += 1

    def decref(self, pages: Sequence[int]) -> List[int]:
        """Drop an external hold; pages hitting refcount zero return to
        the free list.  Returns the freed page ids.

        Validates the WHOLE batch (with multiplicity — the same id may
        legally appear once per distinct hold) BEFORE mutating: a
        refcount underflow raises ValueError and leaves the pool
        untouched, instead of half-applying the batch and pushing a
        still-live page onto the free list where the next ``_pop``
        would hand it to a second writer."""
        pages = [int(p) for p in pages]
        need: dict = {}
        for p in pages:
            need[p] = need.get(p, 0) + 1
        for p, n in need.items():
            if not 0 <= p < self.num_pages:
                raise ValueError(f"page {p} is not a page id "
                                 f"(pool holds {self.num_pages})")
            if self.refcount[p] < n:
                raise ValueError(
                    f"page {p} refcount underflow (double-free): "
                    f"dropping {n} hold(s) but only "
                    f"{int(self.refcount[p])} exist")
        freed = []
        for p in pages:
            self.refcount[p] -= 1
            if self.refcount[p] == 0:
                self._free.append(p)
                freed.append(p)
        return freed

    # -- free ------------------------------------------------------------
    def release(self, slot: int):
        """Finish/cancel: decrement the chain's refcounts (pages return
        to the free list only at zero — a fork or prefix hold keeps them
        alive) and drop the remaining reservation.

        Raises ValueError on a double release: a slot holding neither a
        chain nor a reservation has nothing to give back, so a second
        release means two owners think they freed it — the old
        silent-no-op behavior let that bug ride until the free list
        aliased."""
        n = int(self.chain_len[slot])
        if n == 0 and not self._reserved[slot]:
            raise ValueError(
                f"slot {slot} double-release: it holds no chain and no "
                "reservation")
        self.decref(self.block_tables[slot, :n])
        self.reserved_total -= int(self._reserved[slot])
        self._reserved[slot] = 0
        self.chain_len[slot] = 0
        self.block_tables[slot, :] = 0
        if self.telemetry.enabled:
            self._tel_pages()
