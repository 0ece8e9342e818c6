"""Hash-keyed prefix cache over the refcounted page pool (a copy of
``repro.serve.paged.prefix``: plain Python, copied rather than imported
so the port never loads JAX).

A finished admission wave's prompt pages stay useful: a later request
whose page-aligned prompt prefix matches a resident entry ATTACHES to
the existing pages (``PagePool.share``) and chunk-prefills only the
tail — pay the shared system prompt's prefill once, vLLM/SGLang style.

Keys are CHAINED blake2b digests over page-sized token blocks:
``h_i = H(h_{i-1} || tokens[i*ps:(i+1)*ps])`` — so the digest of the
first ``i`` pages keys exactly that token prefix, and matching walks the
new prompt's own digests longest-first.

Soundness contract (enforced jointly with the engine / StepModel):

  * entries pin their pages via ``PagePool.incref`` — a pinned page can
    be freed only by eviction, and the parent request's own decode
    writes copy-on-write away from it, so pinned content is FROZEN at
    its post-prefill bytes;
  * global/MLA stacks (``full_prompt_only=False``) insert one entry per
    page-aligned prompt prefix — later writes land in later pages, so
    every page prefix is clean;
  * window-bearing stacks (``full_prompt_only=True``) insert a single
    entry per prompt, only when the prompt is page-aligned: ring slots
    are overwritten DURING prefill, so only the end-of-prompt ring state
    exists in the pages.  A match additionally requires the attach point
    to sit on the requester's chunk grid with at least one tail token —
    the ring-snapshot mask infers entry positions from ``pos0``, so the
    tail prefill must start exactly at the attach point;
  * an entry matches only a requester with the SAME prefill chunk width
    (``chunk_w``): chunk shapes are part of the bitwise contract;
  * the cache never blocks admission: ``available`` accounting ignores
    pins, and the pool's ``reclaim`` hook (wired here) evicts LRU
    entries when the free list runs dry, so a reserve-covered
    allocation always finds a page.
"""
from __future__ import annotations

import hashlib
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.serve.telemetry import NULL_TELEMETRY


class PrefixCache:
    """LRU prefix cache; all host-side (token hashing + page pinning)."""

    def __init__(self, pool, page_size: int, *,
                 full_prompt_only: bool = False):
        self.pool = pool
        self.ps = int(page_size)
        self.full_prompt_only = bool(full_prompt_only)
        # digest -> {"pages": tuple, "plen": int, "chunk_w": int, "tick"}
        self._entries: dict = {}
        self._tick = 0
        self.hits = 0
        self.misses = 0
        self.n_evicted = 0
        pool.reclaim = self.reclaim
        #: observability handle (no-op default; the engine passes its own)
        self.telemetry = NULL_TELEMETRY

    def __len__(self):
        return len(self._entries)

    @property
    def pinned_pages(self) -> int:
        """Distinct pages currently pinned by resident entries."""
        return len({p for e in self._entries.values() for p in e["pages"]})

    # -- hashing ---------------------------------------------------------
    def _digests(self, tokens, n_pages: int) -> List[bytes]:
        a = np.ascontiguousarray(
            np.asarray(tokens[:n_pages * self.ps], np.int32))
        out, h = [], b""
        for i in range(n_pages):
            blk = a[i * self.ps:(i + 1) * self.ps]
            h = hashlib.blake2b(h + blk.tobytes(), digest_size=16).digest()
            out.append(h)
        return out

    # -- lookup ----------------------------------------------------------
    def match(self, prompt, chunk_w: int) -> Tuple[Optional[List[int]],
                                                   int]:
        """Longest resident page-aligned prefix of ``prompt`` admissible
        for a requester prefilling at ``chunk_w``.  Returns
        ``(pages, attach)`` — the pages to share (NOT yet increfed; the
        caller shares them into a slot) and the attach length in
        positions — or ``(None, 0)`` on a miss."""
        plen = len(prompt)
        m = plen // self.ps
        digs = self._digests(prompt, m) if m else []
        for i in range(m, 0, -1):
            e = self._entries.get(digs[i - 1])
            if e is None or e["chunk_w"] != int(chunk_w):
                continue
            attach = i * self.ps
            if self.full_prompt_only and (attach % int(chunk_w)
                                          or attach >= plen):
                # window ring: the tail must START at the attach point on
                # the requester's chunk grid, with >= 1 token to prefill
                continue
            self._tick += 1
            e["tick"] = self._tick
            self.hits += 1
            if self.telemetry.enabled:
                self.telemetry.inc("prefix_hits")
            return list(e["pages"]), attach
        self.misses += 1
        if self.telemetry.enabled:
            self.telemetry.inc("prefix_misses")
        return None, 0

    # -- insertion -------------------------------------------------------
    def insert(self, prompt, block_row, chunk_w: int):
        """Pin ``prompt``'s freshly written pages (``block_row`` = the
        slot's block-table row).  Global/MLA mode inserts every
        page-aligned prefix; window mode inserts the full prompt only
        (and only when page-aligned).  Re-inserting a resident prefix
        just refreshes its LRU tick."""
        plen = len(prompt)
        m = plen // self.ps
        if m == 0:
            return
        if self.full_prompt_only and plen % self.ps:
            return
        digs = self._digests(prompt, m)
        first = m if self.full_prompt_only else 1
        for i in range(first, m + 1):
            key = digs[i - 1]
            self._tick += 1
            e = self._entries.get(key)
            if e is not None:
                e["tick"] = self._tick
                continue
            pages = tuple(int(p) for p in block_row[:i])
            self.pool.incref(pages)
            self._entries[key] = {"pages": pages, "plen": i * self.ps,
                                  "chunk_w": int(chunk_w),
                                  "tick": self._tick}

    # -- eviction ----------------------------------------------------------
    def _evict(self, key) -> List[int]:
        e = self._entries.pop(key)
        self.n_evicted += 1
        if self.telemetry.enabled:
            self.telemetry.inc("prefix_evictions")
        return self.pool.decref(e["pages"])

    def reclaim(self, n: int = 1):
        """Pool hook: free at least ``n`` pages by evicting LRU entries
        (stops when the cache is empty — the pool's reservation
        invariant guarantees that suffices for covered allocations)."""
        freed = 0
        while self._entries and freed < n:
            key = min(self._entries, key=lambda k: self._entries[k]["tick"])
            freed += len(self._evict(key))

    def clear(self):
        """Drop every entry (and its pins)."""
        while self._entries:
            self._evict(next(iter(self._entries)))
