"""The paged GQA kernels' split design on the CPU: the page-range rule that
``csrc/paged_gqa.cuh`` applies (mirrored by ``ops.gqa_page_range``), the
wrapper's layout arguments, and an fp32 emulation of the kernels'
arithmetic (page ranges, warps on pages, a per-page online softmax in
base 2, the max-rescaled merges) held against the reference's Pallas
kernels in interpret mode.

Tolerance: the reference's own bound for its kernels, ``PALLAS_TOL`` =
2e-6 (tests/test_kernels_paged_attention.py:26): the emulation sums in
another order than one global-max softmax, and scales its scores by
log2(e) / sqrt(hd) for exp2."""
import math
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention.paged_attention import (paged_gqa_fwd,
                                                           paged_gqa_fwd_q8)
from repro_torch.kernels.paged_attention import ops, quant, ref

torch.set_num_threads(1)

PALLAS_TOL = 2e-6
NEG_INF = -1e30


def _live(p, pos, length, ps):
    return p * ps <= pos and p * ps < length


@pytest.mark.parametrize("ps", [4, 8, 16])
@pytest.mark.parametrize("length,window", [(256, None), (2048, None),
                                           (7, 7), (128, 128), (100, 128),
                                           (1024, 1024)])
def test_page_ranges_partition_the_live_pages(ps, length, window):
    """Over every position (and wrapped ring positions), each live page
    lies in exactly one CTA's range, a range that is not empty begins with
    a live page, and only the last live page can hold a masked entry (the
    kernel masks no other page)."""
    n_split = ops.gqa_splits(length, ps)
    assert 1 <= n_split <= ops.GQA_MAX_SPLIT
    n_pages = -(-length // ps)
    assert n_split == min(ops.GQA_MAX_SPLIT, -(-n_pages // ops.GQA_WARPS))
    top = length if window is None else 3 * length
    for pos in range(top):
        owner = [0] * n_pages
        for rank in range(n_split):
            begin, end = ops.gqa_page_range(pos, length, ps, n_split, rank)
            if begin < end:
                assert _live(begin, pos, length, ps)
            for p in range(begin, end):
                owner[p] += 1
        live = [_live(p, pos, length, ps) for p in range(n_pages)]
        assert owner == [int(x) for x in live]
        _kp, valid = ref.paged_positions(torch.tensor([pos]), length,
                                         window)
        last = max(p for p in range(n_pages) if live[p])
        for p in range(last):
            assert bool(valid[0, p * ps:(p + 1) * ps].all())
        assert bool(valid[0, last * ps:(last + 1) * ps].any())
    assert ops.gqa_page_range(-1, length, ps, n_split, 0) == (0, 0)


def test_layout_does_not_depend_on_the_batch(monkeypatch):
    """The wrapper hands the kernel the same arguments (shape and n_split,
    the one layout argument it passes) for a request alone and inside a
    batch: only B changes."""
    calls = []

    def fake(*args):
        calls.append(args)
        return 0
    monkeypatch.setattr(ops.torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    lib = types.SimpleNamespace(paged_gqa_bf16=fake)
    pool = torch.zeros(64, 16, 5, 64, dtype=torch.bfloat16)
    for B in (1, 4):
        q = torch.zeros(B, 15, 64, dtype=torch.bfloat16)
        bt = torch.zeros(B, 16, dtype=torch.int32)
        pos = torch.zeros(B, dtype=torch.int32)
        ops.gqa_launch(lib, "paged_gqa", q, pool, pool, bt, pos, length=256,
                       window=None)
    a, b = calls
    assert a[6] == 1 and b[6] == 4           # B
    assert a[7:-1] == b[7:-1]                # every shape int and n_split
    assert a[-2] == ops.gqa_splits(256, 16) == 4


def _emulate(q, pk, pv, bt, pos, *, length, window, k_scale=None,
             v_scale=None):
    """The kernels' arithmetic in fp32: each (request, kv head) cut into
    ``gqa_splits`` page ranges, pages dealt to ``GQA_WARPS`` warps, an
    online softmax of log2(e)-scaled scores with exp2 over the steps of
    rows a warp takes at once (a lane's 4 rows, 2 for int8 chunks, times
    the rows a pass of the warp covers: 32 over the lanes a row of
    ``ops.gqa_layout``), masks only on the pages the kernel masks,
    then the warps and the ranges merged by rescaling to their common
    max."""
    B, H, hd = q.shape
    _P, ps, KV, _ = pk.shape
    G = H // KV
    n_split = ops.gqa_splits(length, ps)
    lay = ops.gqa_layout(hd, pk.element_size(), G)
    step = (32 // lay["lanes"]) * (2 if lay["chunk_elems"] >= 16 else 4)
    c2 = torch.tensor(1.4426950408889634 / math.sqrt(hd),
                      dtype=torch.float32)
    mask_all = window is not None and length > window
    _kp, valid = ref.paged_positions(pos, length, window)
    # entries past `length` in the last page are masked too
    mask = torch.full((B, -(-length // ps) * ps), NEG_INF)
    mask[:, :length] = torch.where(valid, 0.0, NEG_INF)

    def merge(parts):
        m = torch.stack([p[0] for p in parts]).amax(0)
        f = [torch.exp2(p[0] - m) for p in parts]
        return (m, sum(fi * p[1] for fi, p in zip(f, parts)),
                sum(fi[:, None] * p[2] for fi, p in zip(f, parts)))

    out = torch.empty(B, H, hd)
    for b in range(B):
        p_b = int(pos[b])
        n_live = 0 if p_b < 0 else min(p_b, length - 1) // ps + 1
        for kv in range(KV):
            qg = q[b, kv * G:(kv + 1) * G].float()
            ranges = []
            for rank in range(n_split):
                begin, end = ops.gqa_page_range(p_b, length, ps, n_split,
                                                rank)
                if begin >= end:
                    continue
                warps = []
                for w in range(ops.GQA_WARPS):
                    m = torch.full((G,), NEG_INF)
                    l, acc = torch.zeros(G), torch.zeros(G, hd)
                    for pg in range(begin + w, end, ops.GQA_WARPS):
                        page = int(bt[b, pg])
                        k = pk[page, :, kv].float()
                        v = pv[page, :, kv].float()
                        if k_scale is not None:
                            k = k * k_scale[page, kv]
                            v = v * v_scale[page, kv]
                        s = (qg @ k.T) * c2
                        if mask_all or pg == n_live - 1:
                            s = s + mask[b, pg * ps:(pg + 1) * ps]
                        for r0 in range(0, ps, step):
                            sr = s[:, r0:r0 + step]
                            m_new = torch.maximum(m, sr.amax(-1))
                            alpha = torch.exp2(m - m_new)
                            w8 = torch.exp2(sr - m_new[:, None])
                            l = l * alpha + w8.sum(-1)
                            acc = acc * alpha[:, None] + w8 @ v[r0:r0 + step]
                            m = m_new
                    warps.append((m, l, acc))
                ranges.append(merge(warps))
            if ranges:
                _m, l, acc = merge(ranges)
            else:
                l, acc = torch.zeros(G), torch.zeros(G, hd)
            out[b, kv * G:(kv + 1) * G] = acc / l.clamp(min=1e-30)[:, None]
    return out


def _inputs(rng, *, B, H, KV, hd, ps, length, pos, num_pages):
    n = -(-length // ps)
    bt = rng.permutation(num_pages)[:B * n].reshape(B, n).astype(np.int32)
    pk = rng.standard_normal((num_pages, ps, KV, hd)).astype(np.float32)
    pv = rng.standard_normal((num_pages, ps, KV, hd)).astype(np.float32)
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    return q, pk, pv, bt, np.asarray(pos, np.int32)


CASES = [
    # (B, H, KV, hd, ps, length, window, pos): a small shape, global and
    # a ring, then a 256-position chain (ranges of two pages, and pos 0 /
    # 17 where most ranks are empty) and a wrapped 128-entry ring
    (3, 4, 2, 16, 4, 24, None, [23, 5, 0]),
    (3, 4, 2, 16, 8, 24, None, [16, 7, 23]),
    (3, 4, 2, 16, 4, 7, 7, [20, 3, 6]),
    (3, 6, 2, 64, 16, 256, None, [255, 17, 0]),
    (2, 6, 2, 64, 16, 128, 128, [255, 64]),
    # gemma3-4b's heads of 256 on a 64-entry ring, and G 8 x hd 128 (the
    # kernel cuts its query rows into tiles; each row's arithmetic is the
    # same)
    (2, 4, 2, 256, 16, 64, 64, [200, 40]),
    (2, 16, 2, 128, 16, 64, None, [63, 20]),
    # stablelm-12b's heads of 160 (20 bf16 chunks over 32 lanes, 10 int8
    # ones over 16, 40 fp32 ones over 32 lanes, 2 a lane) and
    # mistral-large-123b's group 12
    (2, 8, 2, 160, 16, 64, None, [63, 20]),
    (2, 12, 1, 128, 16, 48, None, [47, 5]),
    # other rows that are whole but not power-of-two counts of chunks: hd
    # 80 (bf16 10 over 16 lanes, int8 5 over 8), 96 (12 over 16, 6 over 8,
    # fp32 24 over 16) and 192 (24 over 32, 12 over 16, 48 over 32)
    (2, 8, 2, 80, 16, 64, None, [63, 30]),
    (2, 6, 2, 96, 8, 40, 40, [90, 17]),
    (2, 4, 1, 192, 16, 48, None, [47, 0]),
]


@pytest.mark.parametrize("hd,itemsize,want", [
    (64, 2, "vector"), (128, 2, "vector"), (256, 2, "vector"),
    (160, 2, "vector"), (160, 1, "vector"), (160, 4, "vector"),
    (128, 1, "vector"), (256, 1, "vector"), (128, 4, "vector"),
    (80, 2, "vector"), (512, 2, "vector"), (24, 2, "vector"),
    (16, 2, "vector")])
def test_gqa_route_mirrors_the_launch_rule(hd, itemsize, want):
    """``ops.gqa_route``: 16-byte chunks wherever a row is a whole count
    of them and the pools are 16-byte aligned (``csrc/paged_gqa.cuh``
    ``choose_layout``); stablelm-12b's head dim 160 is 20 bf16 chunks, 10 int8
    ones and 40 fp32 ones.  Misaligned pools, or a head dim that is not a
    whole count of chunks, take the scalar route."""
    assert ops.gqa_route(hd, itemsize) == want
    assert ops.gqa_route(hd, itemsize, aligned=False) == "scalar"
    assert ops.gqa_route(hd + 1, itemsize) == "scalar"


@pytest.mark.parametrize("hd,itemsize,group,want", [
    # the power-of-two rows keep one chunk a lane, a lane a chunk
    (64, 2, 3, (8, 1, 3)), (128, 2, 8, (16, 1, 4)), (256, 2, 2, (32, 1, 2)),
    (64, 1, 3, (4, 1, 3)), (128, 4, 12, (32, 1, 4)),
    # stablelm-12b (G 4): 20 bf16 chunks over 32 lanes, one a lane, one
    # tile; 10 int8 chunks over 16 lanes; 40 fp32 chunks over 32, 2 a lane
    (160, 2, 4, (32, 1, 4)),
    (160, 1, 4, (16, 1, 2)),
    (160, 4, 4, (32, 2, 4)),
    # mistral-large-123b's group 12: three tiles of 4 (int8: four of 3)
    (128, 2, 12, (16, 1, 4)), (128, 1, 12, (8, 1, 3)),
    (80, 2, 2, (16, 1, 2)), (96, 1, 1, (8, 1, 1)), (192, 4, 4, (32, 2, 4)),
    (256, 4, 4, (32, 2, 4)), (24, 2, 4, (4, 1, 4)), (24, 4, 1, (4, 2, 1))])
def test_gqa_layout_lanes_chunks_and_tile(hd, itemsize, group, want):
    """``ops.gqa_layout``: lanes a row, chunks a lane and query rows a
    tile as ``choose_layout`` chooses them.  A lane holds at most
    ``GQA_LANE_VALUES`` fp32 values of a row (one int8 chunk), the lanes'
    chunks cover the row, and the tiles hold every query row of the kv
    head."""
    lay = ops.gqa_layout(hd, itemsize, group)
    assert (lay["lanes"], lay["chunks"], lay["tile"]) == want
    nc = hd * itemsize // 16
    assert lay["chunks"] * lay["chunk_elems"] <= max(ops.GQA_LANE_VALUES,
                                                     16 // itemsize)
    assert (lay["chunks"] - 1) * lay["lanes"] < nc <= \
        lay["chunks"] * lay["lanes"] <= 32 * lay["chunks"]
    n_tiles = -(-group // lay["tile"])
    assert n_tiles * lay["tile"] >= group > (n_tiles - 1) * lay["tile"]
    scalar = ops.gqa_layout(hd, itemsize, group, aligned=False)
    assert (scalar["route"], scalar["lanes"], scalar["tile"]) == \
        ("scalar", 32, 1)


@pytest.mark.parametrize("q8", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("case", CASES, ids=str)
def test_emulated_split_matches_reference_pallas(case, q8):
    B, H, KV, hd, ps, length, window, pos = case
    rng = np.random.default_rng(hd + ps + length)
    q, pk, pv, bt, pos = _inputs(rng, B=B, H=H, KV=KV, hd=hd, ps=ps,
                                 length=length, pos=pos,
                                 num_pages=2 * B * -(-length // ps))
    tq, tk, tv, tbt, tpos = (torch.from_numpy(a) for a in
                             (q, pk, pv, bt, pos))
    if q8:
        ks, vs = quant.page_abs_scale(tk), quant.page_abs_scale(tv)
        tk, tv = quant.quantize(tk, ks), quant.quantize(tv, vs)
        got = _emulate(tq, tk, tv, tbt, tpos, length=length, window=window,
                       k_scale=ks, v_scale=vs)
        want = paged_gqa_fwd_q8(
            jnp.asarray(q), jnp.asarray(tk.numpy()), jnp.asarray(tv.numpy()),
            jnp.asarray(ks.numpy()), jnp.asarray(vs.numpy()),
            jnp.asarray(bt), jnp.asarray(pos), length=length, window=window,
            interpret=True)
    else:
        got = _emulate(tq, tk, tv, tbt, tpos, length=length, window=window)
        want = paged_gqa_fwd(jnp.asarray(q), jnp.asarray(pk),
                             jnp.asarray(pv), jnp.asarray(bt),
                             jnp.asarray(pos), length=length, window=window,
                             interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=PALLAS_TOL, rtol=0)
