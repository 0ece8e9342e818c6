"""Paged KV cache: block-table page pool for the serving engine (port of
``repro.serve.paged``).

The dense serving layout preallocates ``(slots, max_len, ...)`` cache
rows — memory scales with the worst case, not with live tokens.  Under
the paged layout every attention layer keeps a shared page pool
``(num_pages, page_size, ...)`` on device, and this package's HOST-side
allocator hands page ids to requests:

  * :class:`PagedConfig` — page size / pool capacity knobs (validated)
  * :class:`PagePool`    — refcounted free-list allocator: per-request
    page chains, one block-table row per slot, reservation-based
    admission (a request is admitted only when its worst-case chain is
    covered, so decode can NEVER run out of pages mid-stream),
    allocate-on-decode-append, copy-on-write page sharing (forks /
    prefix attaches), and free-on-finish/cancel at refcount zero.
  * :class:`PrefixCache` — hash-keyed LRU cache pinning finished
    prompts' pages so matching requests attach and prefill only the
    tail (``ServeEngine(prefix_cache=True)``).

Admission policy: requests that can never fit are rejected at submit;
admission DEFERS while the pool is temporarily full.
"""
from repro_torch.serve.paged.pool import PagedConfig, PagePool
from repro_torch.serve.paged.prefix import PrefixCache

__all__ = ["PagedConfig", "PagePool", "PrefixCache"]
