"""The port's paged GQA decode read and int8 page quantizer against the
reference (repro.kernels.paged_attention) on the CPU.

Tolerances: the plain version (``paged_gqa_ref``, which the CUDA kernels'
wrappers take on CPU tensors) is held to the reference's gather oracle
and to its Pallas kernel in interpret mode at ``PALLAS_TOL`` = 2e-6, the
reference's own bound for its kernel (tests/test_kernels_paged_attention
.py:26); the quantizers and the cost model are held bitwise."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention import ops as jops
from repro.kernels.paged_attention import quant as jq
from repro.kernels.paged_attention import ref as jref
from repro.models.attention import _paged_write_q8 as j_write_q8
from repro_torch.kernels.paged_attention import ops, quant, ref
from repro_torch.models.attention import _paged_write_q8

torch.set_num_threads(1)

PALLAS_TOL = 2e-6


def _setup(rng, *, B=3, H=4, KV=2, hd=16, L=24, ps=8, num_pages=32):
    """Disjoint random chains; pages outside them hold large garbage."""
    n_chain = -(-L // ps)
    bt = rng.permutation(num_pages)[:B * n_chain].reshape(B, n_chain)
    pk = rng.standard_normal((num_pages, ps, KV, hd)).astype(np.float32) * 50
    pv = rng.standard_normal((num_pages, ps, KV, hd)).astype(np.float32) * 50
    for b in range(B):
        for j in range(L):
            pk[bt[b, j // ps], j % ps] = rng.standard_normal((KV, hd))
            pv[bt[b, j // ps], j % ps] = rng.standard_normal((KV, hd))
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    pos = rng.integers(0, 3 * L, size=B).astype(np.int32)
    return q, pk, pv, bt.astype(np.int32), pos


def _both(*arrays, dtype=None):
    """(torch tensors, jnp arrays) of the same numpy inputs."""
    ts = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
    js = [jnp.asarray(a) for a in arrays]
    if dtype is not None:
        ts = [t.to(dtype) for t in ts]
        js = [j.astype(jnp.bfloat16) for j in js]
    return ts, js


@pytest.mark.parametrize("pool", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("ps", [4, 8])
@pytest.mark.parametrize("window", [None, 7])
def test_plain_matches_reference_oracle_and_pallas(window, ps, pool):
    rng = np.random.default_rng(ps + (window or 0))
    L = 24 if window is None else 7
    q, pk, pv, bt, pos = _setup(rng, L=L, ps=ps)
    if window is None:
        pos = np.minimum(pos, L - 1)
    (tq, tbt, tpos), (jq_, jbt, jpos) = _both(q, bt, pos)
    kw_t, kw_j = {}, {}
    if pool == "int8":
        (tk, tv), (jk, jv) = _both(pk, pv)
        ks, vs = quant.page_abs_scale(tk), quant.page_abs_scale(tv)
        tk, tv = quant.quantize(tk, ks), quant.quantize(tv, vs)
        jks, jvs = jq.page_abs_scale(jk), jq.page_abs_scale(jv)
        jk, jv = jq.quantize(jk, jks), jq.quantize(jv, jvs)
        kw_t, kw_j = dict(k_scale=ks, v_scale=vs), dict(k_scale=jks,
                                                         v_scale=jvs)
    else:
        (tk, tv), (jk, jv) = _both(
            pk, pv, dtype=torch.bfloat16 if pool == "bf16" else None)
    got = ops.paged_gqa_attention(tq, tk, tv, tbt, tpos, length=L,
                                  window=window, backend="kernel", **kw_t)
    gather = ops.paged_gqa_attention(tq, tk, tv, tbt, tpos, length=L,
                                     window=window, backend="gather", **kw_t)
    assert torch.equal(got, gather)       # CPU tensors: the plain version
    for backend in ("xla", "pallas"):
        want = jops.paged_gqa_attention(jq_, jk, jv, jbt, jpos, length=L,
                                        window=window, backend=backend,
                                        **kw_j)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=PALLAS_TOL, rtol=0)


def test_wrappers_take_the_plain_version_on_cpu_without_counting():
    rng = np.random.default_rng(5)
    q, pk, pv, bt, pos = _setup(rng, L=16, ps=4)
    (tq, tk, tv, tbt, tpos), _ = _both(q, pk, pv, bt, np.minimum(pos, 15))
    n0 = ops.paged_gqa_kernel.launches
    n8 = ops.paged_gqa_q8_kernel.launches
    out = ops.paged_gqa_kernel(tq, tk, tv, tbt, tpos, length=16)
    want = ref.paged_gqa_ref(tq, tk, tv, tbt, tpos, length=16)
    assert torch.equal(out, want)
    s = quant.page_abs_scale(tk)
    ck = quant.quantize(tk, s)
    ops.paged_gqa_q8_kernel(tq, ck, ck, s, s, tbt, tpos, length=16)
    assert ops.paged_gqa_kernel.launches == n0
    assert ops.paged_gqa_q8_kernel.launches == n8


def test_quantizers_bitwise():
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((6, 4, 2, 16)) * rng.uniform(
        0.01, 30, size=(6, 1, 2, 1))).astype(np.float32)
    x[2] = 0.0                                    # all-zero page
    (tx,), (jx,) = _both(x)
    ts, js = quant.page_abs_scale(tx), jq.page_abs_scale(jx)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    tc, jc = quant.quantize(tx, ts), jq.quantize(jx, js)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert tc.dtype == torch.int8 and int(tc.abs().max()) <= quant.QMAX
    np.testing.assert_array_equal(quant.dequantize(tc, ts).numpy(),
                                  np.asarray(jq.dequantize(jc, js)))
    grown = ts * torch.from_numpy(rng.uniform(1, 3, ts.shape).astype(
        np.float32))
    # steady state: an unchanged scale leaves every code where it was
    np.testing.assert_array_equal(
        quant.rescale_codes(tc, ts, ts.clone()).numpy(), tc.numpy())
    np.testing.assert_array_equal(
        quant.rescale_codes(tc, ts, grown.clamp(min=1e-8)).numpy(),
        np.asarray(jq.rescale_codes(jc, js, jnp.asarray(
            grown.clamp(min=1e-8).numpy()))))
    # bf16 page rows (the serving dtype) quantize the same way
    (tb,), (jb,) = _both(x, dtype=torch.bfloat16)
    np.testing.assert_array_equal(
        quant.quantize(tb, quant.page_abs_scale(tb)).numpy(),
        np.asarray(jq.quantize(jb, jq.page_abs_scale(jb))))


@pytest.mark.parametrize("fresh", [False, True])
def test_incremental_q8_write_bitwise(fresh):
    """The decode-time page write (grow the scale, rescale the codes, set
    the token) equals the reference's for the slots that write."""
    rng = np.random.default_rng(2 + fresh)
    P, ps, KV, hd = 10, 4, 2, 16
    rows = rng.standard_normal((P, ps, KV, hd)).astype(np.float32)
    scale = np.asarray(jq.page_abs_scale(jnp.asarray(rows)))
    codes = np.asarray(jq.quantize(jnp.asarray(rows), jnp.asarray(scale)))
    wpage = np.array([3, 7, 1], np.int32)
    in_page = np.array([0, 2, 3], np.int32)
    fr = np.array([fresh, False, fresh])
    tok = (rng.standard_normal((3, KV, hd)) * 4).astype(np.float32)
    jp, js = j_write_q8(jnp.asarray(codes), jnp.asarray(scale),
                        jnp.asarray(wpage), jnp.asarray(in_page),
                        jnp.asarray(fr), jnp.asarray(tok).astype(
                            jnp.bfloat16))
    tp, ts = torch.from_numpy(codes.copy()), torch.from_numpy(scale.copy())
    _paged_write_q8(tp, ts, torch.from_numpy(wpage).long(),
                    torch.from_numpy(in_page).long(), torch.from_numpy(fr),
                    torch.from_numpy(tok).to(torch.bfloat16))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_gather_helpers_match_reference():
    rng = np.random.default_rng(3)
    pool = rng.standard_normal((9, 4, 2, 8)).astype(np.float32)
    bt = rng.integers(0, 9, size=(2, 3)).astype(np.int32)
    pos = np.array([5, 17], np.int32)
    (tp, tb, tpos), (jp, jb, jpos) = _both(pool, bt, pos)
    np.testing.assert_array_equal(ref.gather_pages(tp, tb, 11).numpy(),
                                  np.asarray(jref.gather_pages(jp, jb, 11)))
    s = quant.page_abs_scale(tp)
    c = quant.quantize(tp, s)
    np.testing.assert_array_equal(
        ref.gather_dequant(c, s, tb, 12).numpy(),
        np.asarray(jref.gather_dequant(jnp.asarray(c.numpy()),
                                       jnp.asarray(s.numpy()), jb, 12)))
    for window in (None, 5):
        for a, b in zip(ref.paged_positions(tpos, 6, window),
                        jref.paged_positions(jpos, 6, window)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_scales_must_pair_and_ring_fit_the_window():
    rng = np.random.default_rng(4)
    q, pk, pv, bt, pos = _setup(rng, L=8, ps=4)
    (tq, tk, tv, tbt, tpos), _ = _both(q, pk, pv, bt, pos)
    s = quant.page_abs_scale(tk)
    with pytest.raises(ValueError, match="both"):
        ops.paged_gqa_attention(tq, tk, tv, tbt, tpos, length=8,
                                backend="kernel", k_scale=s)
    with pytest.raises(ValueError, match="exceeds window"):
        ops.paged_gqa_attention(tq, tk, tv, tbt, tpos, length=8, window=5)
    with pytest.raises(ValueError, match="backend"):
        ops.paged_gqa_attention(tq, tk, tv, tbt, tpos, length=8,
                                backend="pallas")


@pytest.mark.parametrize("kw", [dict(), dict(window=64),
                                dict(dtype_bytes=1, scale_bytes=4),
                                dict(window=300, dtype_bytes=1,
                                     scale_bytes=4)])
def test_cost_model_matches_reference(kw):
    args = (4, 15, 5, 64)
    for live in (1, 100, 256, 4096):
        assert ops.cost_model(*args, live_tokens=live, page_size=16, **kw) \
            == jops.cost_model(*args, live_tokens=live, page_size=16, **kw)


def test_wrappers_refuse_mixed_devices():
    """The plain version runs only when every input lies on the CPU: one
    input elsewhere is refused by the wrapper, not handed to torch."""
    rng = np.random.default_rng(13)
    q, pk, pv, bt, pos = _setup(rng, L=16, ps=4)
    (tq, tk, tv, tbt, tpos), _ = _both(q, pk, pv, bt, np.minimum(pos, 15))
    s = quant.page_abs_scale(tk)
    ck = quant.quantize(tk, s)
    for fn, args in ((ops.paged_gqa_kernel, [tq, tk, tv, tbt, tpos]),
                     (ops.paged_gqa_q8_kernel,
                      [tq, ck, ck.clone(), s, s.clone(), tbt, tpos])):
        for i in range(len(args)):
            mixed = [a.to("meta") if j == i else a
                     for j, a in enumerate(args)]
            with pytest.raises(ValueError, match="different devices"):
                fn(*mixed, length=16)
        with pytest.raises(ValueError, match="unsupported device"):
            fn(*[a.to("meta") for a in args], length=16)
