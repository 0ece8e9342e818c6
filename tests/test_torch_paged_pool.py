"""The port's host-side page allocator and prefix cache (copies of
repro.serve.paged) against the reference's, and the engine's page
lifecycle: admission that defers while the pool is full, pages and
reservations returned on finish and cancel, recycled pages that never
leak into a stream, and the prefix cache's eviction under pressure."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.serve.paged import PagePool as JPagePool
from repro.serve.paged import PrefixCache as JPrefixCache
from repro_torch.configs import SamplingParams, get_config
from repro_torch.models import build_model
from repro_torch.serve import (DecoderStepModel, PagedConfig, PagePool,
                               PrefixCache, ServeEngine)

torch.set_num_threads(1)


def test_page_pool_allocator_unit():
    pool = PagePool(6, slots=2, max_pages=3)
    assert pool.available == 6 and pool.pages_in_use == 0
    pool.reserve(0, 3)
    pool.grow(0, 2)
    assert pool.pages_in_use == 2 and pool.available == 3
    with pytest.raises(RuntimeError, match="already holds"):
        pool.reserve(0, 1)
    with pytest.raises(RuntimeError, match="exceeds its reservation"):
        pool.grow(0, 4)
    pool.reserve(1, 3)
    with pytest.raises(RuntimeError, match="exceeds available"):
        pool.reserve(1, 1)
    assert not pool.can_admit(1)
    pool.grow(1, 3)
    used = list(pool.block_tables[0, :2]) + list(pool.block_tables[1, :3])
    assert len(set(used)) == 5                  # chains are disjoint
    pool.release(0)
    assert pool.available == 3 and pool.pages_in_use == 3
    pool.release(1)
    assert pool.available == 6 and pool.pages_in_use == 0
    with pytest.raises(ValueError, match="double-release"):
        pool.release(1)


def test_prefix_cache_match_rules():
    """Longest prefix wins, a chunk-grid mismatch is a miss, and window
    mode (full prompt only) rejects full matches and off-grid attaches."""
    pool = PagePool(num_pages=16, slots=2, max_pages=8)
    pc = PrefixCache(pool, page_size=4)
    toks = np.arange(16)
    pool.reserve(0, 4)
    pool.grow(0, 4)
    pc.insert(toks, pool.block_tables[0, :4], chunk_w=8)
    pages, attach = pc.match(np.concatenate([toks, [99]]), 8)
    assert attach == 16 and len(pages) == 4
    pages, attach = pc.match(np.concatenate([toks[:8], [99]]), 8)
    assert attach == 8 and len(pages) == 2
    assert pc.match(np.concatenate([toks, [99]]), 4) == (None, 0)

    pool2 = PagePool(num_pages=16, slots=2, max_pages=8)
    pcw = PrefixCache(pool2, page_size=4, full_prompt_only=True)
    pool2.reserve(0, 4)
    pool2.grow(0, 4)
    pcw.insert(toks, pool2.block_tables[0, :4], chunk_w=8)
    assert len(pcw) == 1
    assert pcw.match(toks, 8) == (None, 0)
    pages, attach = pcw.match(np.concatenate([toks, [99]]), 8)
    assert attach == 16 and len(pages) == 4
    assert pcw.match(np.concatenate([toks, [99]]), 32) == (None, 0)


def _pool_state(pool):
    return (pool.block_tables.tolist(), pool.chain_len.tolist(),
            pool.refcount.tolist(), list(pool._free),
            pool._reserved.tolist(), pool.reserved_total, pool.n_cow)


@pytest.mark.parametrize("seed", range(4))
def test_pool_and_prefix_cache_lockstep_with_reference(seed):
    """Seeded random interleavings of reserve / grow / cow / insert /
    match / release / reclaim drive the port's pool and prefix cache and
    the reference's side by side: every result and every piece of state
    is equal after every operation, and both drain to empty."""
    rng = np.random.default_rng(seed)
    P, S, M, ps = 20, 4, 6, 4
    pools = (PagePool(P, S, M), JPagePool(P, S, M))
    caches = (PrefixCache(pools[0], ps), JPrefixCache(pools[1], ps))
    prompts = [rng.integers(0, 5, size=n) for n in (8, 12, 16, 9, 13)]
    for _ in range(300):
        op, r = int(rng.integers(0, 6)), int(rng.integers(0, 1 << 20))
        slot = r % S
        outs = []
        for pool, pc in zip(pools, caches):
            try:
                if op == 0:
                    outs.append(pool.reserve(slot, 1 + r % M))
                elif op == 1:
                    outs.append(pool.grow(slot, r % (M + 1)))
                elif op == 2 and pool.chain_len[slot]:
                    outs.append(pool.cow(slot, r % int(pool.chain_len[slot])))
                elif op == 3 and pool.chain_len[slot]:
                    p = prompts[r % len(prompts)]
                    n = int(pool.chain_len[slot]) * ps
                    outs.append(pc.insert(p[:n], pool.block_tables[slot],
                                          chunk_w=8))
                elif op == 4:
                    got = pc.match(prompts[r % len(prompts)], 8)
                    outs.append((None if got[0] is None
                                 else list(got[0]), got[1]))
                elif op == 5:
                    outs.append(pool.release(slot))
                else:
                    outs.append("skip")
            except (RuntimeError, ValueError) as e:
                outs.append(type(e).__name__)
        assert outs[0] == outs[1]
        assert _pool_state(pools[0]) == _pool_state(pools[1])
    for pool, pc in zip(pools, caches):
        for s in range(S):
            if pool.chain_len[s] or pool._reserved[s]:
                pool.release(s)
        pc.clear()
        assert pool.pages_in_use == 0 and pool.reserved_total == 0


# -- the engine's page lifecycle --------------------------------------------

@pytest.fixture(scope="module")
def gqa():
    cfg = dataclasses.replace(get_config("smollm-360m-smoke"),
                              paged_impl="gather")
    model = build_model(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    return cfg, model


def _engine(model, *, max_len=32, page_size=4, num_pages=0, slots=2,
            prefix_cache=False, layout="paged"):
    kw = {}
    if layout == "paged":
        kw = dict(kv_layout="paged", paged=PagedConfig(page_size=page_size,
                                                       num_pages=num_pages))
    sm = DecoderStepModel(model, max_len=max_len, prefill_chunk=8, **kw)
    return ServeEngine(sm, slots=slots, prefix_cache=prefix_cache)


def test_finish_and_cancel_return_pages(gqa):
    """eos-free retirement, cancel of a running request and of a queued
    one: the pool drains — every page free, no reservation, block tables
    zeroed."""
    cfg, model = gqa
    eng = _engine(model)
    rng = np.random.default_rng(5)
    a = eng.submit(rng.integers(0, cfg.vocab, size=9), max_new_tokens=20)
    b = eng.submit(rng.integers(0, cfg.vocab, size=4), max_new_tokens=6)
    c = eng.submit(rng.integers(0, cfg.vocab, size=6), max_new_tokens=8)
    eng.step()
    assert eng.pool.pages_in_use > 0
    eng.cancel(a)
    assert a.cancelled and a.finished and a not in eng.finished
    assert c in eng.waiting
    eng.cancel(c)
    assert c.cancelled and not c.outputs
    eng.run()
    assert b.finished and not b.cancelled
    assert eng.pool.pages_in_use == 0 and eng.pool.reserved_total == 0
    assert len(eng.pool._free) == eng.pool.num_pages
    np.testing.assert_array_equal(eng.pool.block_tables, 0)
    np.testing.assert_array_equal(eng.pool.chain_len, 0)
    m = eng.metrics()
    assert m["gauges"]["pages_in_use"] == 0.0
    assert m["gauges"]["pages_reserved"] == 0.0


def test_admission_defers_until_pages_free(gqa):
    """Pages for one live request only: admission is strictly serial (the
    queue defers, never raises, never bypasses FIFO order)."""
    cfg, model = gqa
    eng = _engine(model, max_len=16, num_pages=4, slots=4)
    rng = np.random.default_rng(7)
    reqs = [eng.submit(rng.integers(0, cfg.vocab, size=6),
                       max_new_tokens=8) for _ in range(3)]
    eng.admit()
    assert eng.active.sum() == 1 and len(eng.waiting) == 2
    done = eng.run()
    assert done == reqs
    assert eng.pool.pages_in_use == 0 and eng.pool.reserved_total == 0


def test_recycled_pages_never_leak_into_a_stream(gqa):
    """After churn through a small pool, a sampled target request's
    stream equals the dense engine's for the same submission order."""
    cfg, model = gqa
    rng = np.random.default_rng(6)
    churn = [(rng.integers(0, cfg.vocab, size=p), g)
             for p, g in [(11, 5), (7, 8), (15, 3), (5, 9), (9, 4)]]
    target = rng.integers(0, cfg.vocab, size=8)
    sp = SamplingParams(temperature=0.8, seed=42)
    streams = []
    for layout in ("paged", "dense"):
        eng = _engine(model, num_pages=16, layout=layout)
        for p, g in churn:
            eng.submit(p, max_new_tokens=g)
        eng.run()
        tr = eng.submit(target, max_new_tokens=7, sampling=sp)
        eng.run()
        streams.append(list(tr.tokens))
    assert streams[0] == streams[1]


def test_submit_bounds_and_stall_guard(gqa):
    cfg, model = gqa
    eng = _engine(model, max_len=16)
    with pytest.raises(ValueError, match="max_len"):
        eng.submit(np.arange(10), max_new_tokens=7)
    eng.submit(np.arange(3), max_new_tokens=2)
    # a request that needs more pages than the pool has left can never
    # admit once nothing runs: run() raises instead of spinning
    eng.pool.reserve(1, eng.pool.available)
    with pytest.raises(RuntimeError, match="stalled"):
        eng.run()


def test_prefix_cache_needs_paged_layout_and_evicts_under_pressure(gqa):
    cfg, model = gqa
    with pytest.raises(ValueError, match="paged"):
        _engine(model, layout="dense", prefix_cache=True)
    rng = np.random.default_rng(5)
    eng = _engine(model, num_pages=10, prefix_cache=True)
    reqs = [eng.submit(rng.integers(0, cfg.vocab, size=8), max_new_tokens=3)
            for _ in range(6)]
    eng.run()
    assert all(r.finished for r in reqs)
    assert eng.prefix_cache.n_evicted > 0
    eng.prefix_cache.clear()
    assert eng.pool.pages_in_use == 0 and eng.pool.reserved_total == 0
