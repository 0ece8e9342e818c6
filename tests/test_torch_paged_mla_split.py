"""The paged MLA kernels' tensor-core ("tc") route on the CPU: its route
rule (``ops.mla_route``), its page-range rules (``ops.mla_tc_splits``, the
number of ranges from the static shape, and :func:`_page_range`, this
file's model of the cut the kernel makes from each request's pos), the
arguments the wrapper
hands its C entry point, and an emulation of its arithmetic
(``csrc/paged_mla_tc.cuh``) held against the reference's Pallas kernels in
interpret mode and against the port's plain version.

The emulation, in plain torch: each request's live 32-row stages of whole
pages cut into balanced ranges (a slot past a range holds the stage's
first page again, masked); scores as fp32 sums of exact products of bf16
values (int8: the ckv and rope parts summed apart, each column scaled by
its page's scales); an online softmax with exp as
exp2 of a product with log2(e); P (int8: times the column's page
ckv_scale) split into three bf16 parts, each stage's product summed apart
and added to the running sum in fp32; the ranges merged at their common
max.  Tolerance: one bf16 ulp of the output plus 2e-6, the card tests'
bound for bf16 outputs (the kernel rounds its fp32 result to bf16 once);
with two parts (hi + lo) a near-zero output breaks it."""
import math
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention.paged_attention import (paged_mla_fwd,
                                                           paged_mla_fwd_q8)
from repro_torch.kernels.paged_attention import ops, quant, ref

torch.set_num_threads(1)

NEG_INF = -1e30
LOG2E = 1.4426950408889634


def _bf16_close(got, want):
    """|got - want| within one bf16 ulp of the larger magnitude plus 2e-6,
    everywhere."""
    got, want = got.float(), want.float()
    mag = torch.maximum(got.abs(), want.abs()).clamp(min=2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return bool(((got - want).abs() <= ulp + 2e-6).all())


def _page_range(pos, length, ps, n_split, split):
    """[begin, end) of the live pages (``p * ps <= pos`` and ``p * ps <
    length``) that range ``split`` of a request reads on the tc route: the
    cut ``csrc/paged_mla_tc.cuh`` makes on the card.  The live
    MLA_TC_ROWS-row stages are cut into n_split contiguous, balanced
    ranges; one that is not empty begins with a live page."""
    pps = ops.MLA_TC_ROWS // ps
    n_live = 0 if pos < 0 else min(-(-length // ps), pos // ps + 1)
    n_lst = -(-n_live // pps)
    return (split * n_lst // n_split * pps,
            min(n_live, (split + 1) * n_lst // n_split * pps))


def _split(x, parts):
    """x (fp32) as ``parts`` bf16 parts, x_0 = bf16(x), x_i = bf16(x - x_0
    - ... - x_{i-1}) (flash_tc.cuh split2)."""
    out = []
    for _ in range(parts):
        h = x.bfloat16().float()
        out.append(h)
        x = x - h
    return out


def _emulate(qa, qr, pc, pr, bt, pos, *, length, scale, ckv_scale=None,
             krope_scale=None, sm_count=8, parts=3):
    """The tc route's arithmetic in fp32 (module docstring) -> fp32 latent
    output (B, H, r); the kernel's output is this rounded to bf16."""
    B, H, r = qa.shape
    _P, ps, _ = pc.shape
    rows = ops.MLA_TC_ROWS
    pps = rows // ps
    n_pages = -(-length // ps)
    n_split = ops.mla_tc_splits(B, H, n_pages, ps, sm_count)
    q8 = ckv_scale is not None
    sc32 = torch.tensor(scale, dtype=torch.float32)
    out = torch.empty(B, H, r)
    for b in range(B):
        p_b = int(pos[b])
        qa_b, qr_b = qa[b].float(), qr[b].float()
        parts_b = []
        for split in range(n_split):
            p_begin, p_end = _page_range(p_b, length, ps, n_split, split)
            if p_begin >= p_end:
                continue                 # (m, l) = (-1e30, 0): skipped
            m = torch.full((H,), NEG_INF)
            l = torch.zeros(H)
            run = torch.zeros(H, r)
            for pg0 in range(p_begin, p_end, pps):
                pages = [pg if pg < p_end else pg0
                         for pg in range(pg0, pg0 + pps)]
                ids = [int(bt[b, pg]) for pg in pages]
                ck = torch.cat([pc[i].float() for i in ids])   # (32, r)
                kr = torch.cat([pr[i].float() for i in ids])   # (32, dr)
                s = qa_b @ ck.T
                if q8:
                    cs = torch.cat([ckv_scale[i].expand(ps) for i in ids])
                    rs = torch.cat([krope_scale[i].expand(ps) for i in ids])
                    s = s * cs + (qr_b @ kr.T) * rs
                else:
                    s = s + qr_b @ kr.T
                j = pg0 * ps + torch.arange(rows)
                live = (j < p_end * ps) & (j <= p_b) & (j < length)
                s = torch.where(live, s * sc32, torch.tensor(NEG_INF))
                m_new = torch.maximum(m, s.amax(-1))
                alpha = torch.exp2((m - m_new) * LOG2E)
                w = torch.exp2((s - m_new[:, None]) * LOG2E)
                l = l * alpha + w.sum(-1)
                pw = w * cs if q8 else w
                o = torch.zeros(H, r)
                for part in reversed(_split(pw, parts)):   # smallest first
                    o = o + part @ ck
                run = run * alpha[:, None] + o
                m = m_new
            parts_b.append((m, l, run))
        if not parts_b:
            out[b] = 0.0
            continue
        mx = torch.stack([p[0] for p in parts_b]).amax(0)
        lg = torch.zeros(H)
        acc = torch.zeros(H, r)
        for m_s, l_s, a_s in parts_b:
            f = torch.exp(m_s - mx)
            lg = lg + f * l_s
            acc = acc + f[:, None] * a_s
        out[b] = acc / lg.clamp(min=1e-30)[:, None]
    return out


def _inputs(rng, *, B, H, r, dr, ps, length, pos):
    """bf16-valued fp32 inputs: disjoint random chains in a pool twice
    their size, the other pages large garbage."""
    n = -(-length // ps)
    P = 2 * B * n
    bt = rng.permutation(P)[:B * n].reshape(B, n).astype(np.int32)
    pc = rng.standard_normal((P, ps, r)).astype(np.float32) * 50
    pr = rng.standard_normal((P, ps, dr)).astype(np.float32) * 50
    for b in range(B):
        for j in range(length):
            pc[bt[b, j // ps], j % ps] = rng.standard_normal(r)
            pr[bt[b, j // ps], j % ps] = rng.standard_normal(dr)
    qa = rng.standard_normal((B, H, r)).astype(np.float32)
    qr = rng.standard_normal((B, H, dr)).astype(np.float32)
    bf = lambda a: torch.from_numpy(a).bfloat16().float()
    return (bf(qa), bf(qr), bf(pc), bf(pr), torch.from_numpy(bt),
            torch.tensor(pos, dtype=torch.int32))


CASES = [
    # (B, H, r, dr, ps, length, pos, sm_count): a partial last page and one
    # request with pos < length - 1 at each tc page size; several ranges
    # (sm_count small), with empty ones where pos is short
    (3, 20, 64, 16, 8, 45, [44, 20, 44], 12),
    (3, 13, 32, 16, 16, 100, [99, 20, 61], 12),
    (2, 8, 64, 16, 32, 70, [69, 33], 4),
    (2, 20, 64, 16, 16, 30, [29, 3], 132),
]


@pytest.mark.parametrize("q8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("case", CASES, ids=str)
def test_emulated_tc_route_matches_reference_and_plain(case, q8):
    B, H, r, dr, ps, length, pos, sm = case
    rng = np.random.default_rng(r + ps + length)
    qa, qr, pc, pr, bt, tpos = _inputs(rng, B=B, H=H, r=r, dr=dr, ps=ps,
                                       length=length, pos=pos)
    scale = 1.0 / math.sqrt(r + dr)
    j = lambda t: jnp.asarray(t.numpy())
    if q8:
        cs, rs = quant.page_abs_scale(pc), quant.page_abs_scale(pr)
        pc, pr = quant.quantize(pc, cs), quant.quantize(pr, rs)
        sk = dict(ckv_scale=cs, krope_scale=rs)
        want = paged_mla_fwd_q8(j(qa), j(qr), j(pc), j(pr), j(cs), j(rs),
                                j(bt), j(tpos), length=length, scale=scale,
                                interpret=True)
    else:
        sk = {}
        want = paged_mla_fwd(j(qa), j(qr), j(pc), j(pr), j(bt), j(tpos),
                             length=length, scale=scale, interpret=True)
    got = _emulate(qa, qr, pc, pr, bt, tpos, length=length, scale=scale,
                   sm_count=sm, **sk).bfloat16()
    plain = ref.paged_mla_ref(qa, qr, pc, pr, bt, tpos, length=length,
                              scale=scale, **sk)
    assert _bf16_close(got, torch.from_numpy(np.array(want)))
    assert _bf16_close(got, plain)


def test_three_parts_of_p_hold_near_zero_outputs_two_do_not():
    """Few live entries (so the weights are far from uniform) and latent
    rows of four times the usual size: some outputs land near zero, where
    the part of P that hi + lo leave out (up to 2^-17 of a weight) moves
    them past one bf16 ulp + 2e-6; hi + mid + lo leave out an fp32
    rounding and hold."""
    rng = np.random.default_rng(5)
    qa, qr, pc, pr, bt, pos = _inputs(rng, B=2, H=16, r=512, dr=64, ps=16,
                                      length=16, pos=[7, 5])
    pc = (pc * 4).bfloat16().float()
    scale = 1.0 / math.sqrt(576)
    want = ref.paged_mla_ref(qa, qr, pc, pr, bt, pos, length=16,
                             scale=scale)
    three = _emulate(qa, qr, pc, pr, bt, pos, length=16, scale=scale)
    two = _emulate(qa, qr, pc, pr, bt, pos, length=16, scale=scale,
                   parts=2)
    assert bool((want.abs() < 1e-3).any())
    assert _bf16_close(three.bfloat16(), want)
    assert not _bf16_close(two.bfloat16(), want)


@pytest.mark.parametrize("args,route", [
    ((torch.bfloat16, torch.bfloat16, 512, 64, 16, True), "tc"),
    ((torch.bfloat16, torch.int8, 512, 64, 16, True), "tc"),
    ((torch.bfloat16, torch.bfloat16, 512, 64, 8, True), "tc"),
    ((torch.bfloat16, torch.int8, 512, 64, 32, True), "tc"),
    ((torch.float32, torch.float32, 512, 64, 16, True), "simt"),
    ((torch.float32, torch.int8, 512, 64, 16, True), "simt"),
    ((torch.bfloat16, torch.bfloat16, 512, 64, 5, True), "simt"),
    ((torch.bfloat16, torch.bfloat16, 512, 64, 4, True), "simt"),
    ((torch.bfloat16, torch.bfloat16, 512, 64, 64, True), "simt"),
    ((torch.bfloat16, torch.bfloat16, 512, 64, 16, False), "simt"),
    ((torch.bfloat16, torch.int8, 512, 64, 16, False), "simt"),
    ((torch.bfloat16, torch.bfloat16, 256, 64, 16, True), "simt"),
    ((torch.bfloat16, torch.bfloat16, 512, 32, 16, True), "simt"),
    ((torch.bfloat16, torch.bfloat16, 16, 8, 4, True), "simt"),
], ids=str)
def test_mla_route(args, route):
    assert ops.mla_route(*args) == route


def test_every_mla_arch_takes_the_tc_route():
    """Each MLA configuration of the catalogue, served from bf16 or int8
    pages of 16, reads through the tc route."""
    from repro_torch.configs import archs

    mla = [c for c in vars(archs).values()
           if getattr(c, "mla", None) is not None and hasattr(c, "n_heads")]
    assert mla
    for cfg in mla:
        m = cfg.mla
        for kv in (torch.bfloat16, torch.int8):
            assert ops.mla_route(torch.bfloat16, kv, m.kv_lora_rank,
                                 m.qk_rope_head_dim, 16, True) == "tc", cfg


# (B, H, length): one page, the odd kernel row, the path shape, the long
# kernel row, and 131072 positions, where the cap on a range binds
@pytest.mark.parametrize("ps", ops.MLA_TC_PAGE_SIZES)
@pytest.mark.parametrize("B,H,length", [(1, 1, 1), (3, 20, 100),
                                        (4, 128, 1056), (32, 128, 4096),
                                        (4, 128, 131072)])
def test_range_rule(B, H, length, ps):
    """On a full chain the ranges are whole stages, at most
    MLA_TC_MAX_RANGE pages (the bound the kernel's launch checks), none
    empty, and they cover the chain in order; the CTAs fill the SMs at
    most once unless the cap on a range forces more."""
    sm = 132
    n_pages = -(-length // ps)
    n_split = ops.mla_tc_splits(B, H, n_pages, ps, sm)
    pps = ops.MLA_TC_ROWS // ps
    n_stages = -(-n_pages // pps)
    assert -(-n_stages // n_split) * pps <= ops.MLA_TC_MAX_RANGE
    ranges = [_page_range(length - 1, length, ps, n_split, s)
              for s in range(n_split)]
    assert ranges[0][0] == 0 and ranges[-1][1] == n_pages
    for (b0, e0), (b1, _e1) in zip(ranges, ranges[1:]):
        assert e0 == b1
    assert all(b < e and b % pps == 0 for b, e in ranges)
    ctas = B * -(-H // ops.MLA_TC_HEADS) * n_split
    assert ctas <= max(sm, B * -(-H // ops.MLA_TC_HEADS)) or \
        -(-n_stages // n_split) * pps > ops.MLA_TC_MAX_RANGE // 2


@pytest.mark.parametrize("ps", ops.MLA_TC_PAGE_SIZES)
@pytest.mark.parametrize("length,n_split", [(100, 3), (1056, 11),
                                            (4096, 32)])
def test_page_ranges_follow_pos(length, n_split, ps):
    """At every position the ranges partition exactly the live pages
    (p * ps <= pos and p * ps < length), in order; one that is not empty
    begins on a stage boundary with a live page, and their sizes differ by
    at most one stage."""
    pps = ops.MLA_TC_ROWS // ps
    for pos in [-1] + list(range(0, length + 40, 7)):
        n_live = 0 if pos < 0 else min(-(-length // ps), pos // ps + 1)
        ranges = [_page_range(pos, length, ps, n_split, s)
                  for s in range(n_split)]
        pages = [p for b, e in ranges for p in range(b, e)]
        assert pages == list(range(n_live))
        full = [-(-(e - b) // pps) for b, e in ranges if b < e]
        assert all(b % pps == 0 for b, e in ranges if b < e)
        assert not full or max(full) - min(full) <= 1


def test_range_rule_at_the_path_shape():
    # deepseek-v3 decode: 4 slots x 128 heads, 66 pages of 16: 11 ranges
    # of three 2-page stages, 88 CTAs; 32 slots x 4096: 2 ranges of 128
    # pages
    assert ops.mla_tc_splits(4, 128, 66, 16, 132) == 11
    assert _page_range(1055, 1056, 16, 11, 0) == (0, 6)
    assert _page_range(1055, 1056, 16, 11, 10) == (60, 66)
    assert ops.mla_tc_splits(32, 128, 256, 16, 132) == 2


def test_tc_launch_arguments(monkeypatch):
    """The wrapper hands the tc entry point the pools' page count, the
    range count and scratch for B * H * n_split ranges, and never reads
    pos (the kernel cuts the ranges)."""
    calls = []

    def fake(*args):
        calls.append(args)
        return 0
    monkeypatch.setattr(ops.torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(ops.torch.cuda, "get_device_properties",
                        lambda dev: types.SimpleNamespace(
                            multi_processor_count=132))
    qa = torch.zeros(4, 128, 512, dtype=torch.bfloat16)
    qr = torch.zeros(4, 128, 64, dtype=torch.bfloat16)
    pc = torch.zeros(300, 16, 512, dtype=torch.bfloat16)
    pr = torch.zeros(300, 16, 64, dtype=torch.bfloat16)
    bt = torch.zeros(4, 70, dtype=torch.int32)
    out = []
    for p in (0, 1055):
        pos = torch.full((4,), p, dtype=torch.int32)
        out.append(ops._launch_mla_tc(fake, "paged_mla", qa, qr, pc, pr, (),
                                      bt, pos, 1056, 0.1))
    a, b = calls
    # 9 pointers, then B, H, r, dr, P, ps, bt_cols, length, n_split
    assert a[9:18] == b[9:18] == (4, 128, 512, 64, 300, 16, 70, 1056, 11)
