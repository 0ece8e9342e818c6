"""The port's paged MLA decode read (weight-absorbed attention over latent
pages) and its int8 latent pages against the reference
(repro.kernels.paged_attention, repro.models.attention) on the CPU.

Tolerances: the plain version (``paged_mla_ref``, which the CUDA MLA
kernels' wrappers take when every input lies on the CPU) is held to the
reference's gather oracle and to its Pallas kernel in interpret mode at
``PALLAS_TOL["mla"]`` = 2e-6, the reference's own bound for its kernel
(tests/test_kernels_paged_attention.py:26); int8 latent pools are held
to the dequantized oracle at the same bound; the page quantizer on (P,)
scales to the reference's half-LSB bound; the cost model and the
incremental int8 page write bitwise."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention import ops as jops
from repro.kernels.paged_attention import quant as jq
from repro.models.attention import _paged_write_q8 as j_write_q8
from repro_torch.kernels.paged_attention import ops, quant, ref
from repro_torch.models.attention import _paged_write_q8

torch.set_num_threads(1)

PALLAS_TOL = {"mla": 2e-6}


def _setup_mla(rng, *, B=3, H=4, r=16, dr=8, L=20, ps=4, num_pages=48):
    """The reference test's inputs: disjoint random chains holding dense
    latent rows; pages outside them hold large garbage."""
    n_chain = -(-L // ps)
    q_abs = rng.standard_normal((B, H, r)).astype(np.float32)
    q_rope = rng.standard_normal((B, H, dr)).astype(np.float32)
    dense_c = rng.standard_normal((B, L, r)).astype(np.float32)
    dense_r = rng.standard_normal((B, L, dr)).astype(np.float32)
    bt = rng.permutation(num_pages)[:B * n_chain].reshape(B, n_chain)
    pool_c = rng.standard_normal((num_pages, ps, r)).astype(np.float32) * 50
    pool_r = rng.standard_normal((num_pages, ps, dr)).astype(np.float32) * 50
    for b in range(B):
        for j in range(L):
            pool_c[bt[b, j // ps], j % ps] = dense_c[b, j]
            pool_r[bt[b, j // ps], j % ps] = dense_r[b, j]
    pos = rng.integers(0, L, size=B).astype(np.int32)
    return q_abs, q_rope, pool_c, pool_r, bt.astype(np.int32), pos


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("pool", ["fp32", "int8"])
@pytest.mark.parametrize("ps", [2, 4, 5, 8])
def test_plain_matches_reference_oracle_and_pallas(ps, pool):
    """At the reference test's shapes and page sizes (chains ending
    mid-page at ps 8), fp32 and int8 latent pools."""
    rng = np.random.default_rng(8 + ps)
    L, r, dr = 20, 16, 8
    args = _setup_mla(rng, L=L, ps=ps)
    scale = 1.0 / math.sqrt(r + dr)
    targs, jargs = _t(*args), _j(*args)
    kw_t, kw_j = {}, {}
    if pool == "int8":
        tcs, trs = (quant.page_abs_scale(targs[i]) for i in (2, 3))
        targs[2] = quant.quantize(targs[2], tcs)
        targs[3] = quant.quantize(targs[3], trs)
        jcs, jrs = (jq.page_abs_scale(jargs[i]) for i in (2, 3))
        jargs[2] = jq.quantize(jargs[2], jcs)
        jargs[3] = jq.quantize(jargs[3], jrs)
        np.testing.assert_array_equal(targs[2].numpy(), np.asarray(jargs[2]))
        kw_t = dict(ckv_scale=tcs, krope_scale=trs)
        kw_j = dict(ckv_scale=jcs, krope_scale=jrs)
    got = ops.paged_mla_attention(*targs, length=L, scale=scale,
                                  backend="kernel", **kw_t)
    gather = ops.paged_mla_attention(*targs, length=L, scale=scale,
                                     backend="gather", **kw_t)
    assert torch.equal(got, gather)        # CPU tensors: the plain version
    assert got.shape == (3, 4, r) and got.dtype == torch.float32
    for backend in ("xla", "pallas"):
        want = jops.paged_mla_attention(*jargs, length=L, scale=scale,
                                        backend=backend, **kw_j)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=PALLAS_TOL["mla"], rtol=0)


def test_int8_pools_match_the_dequantized_oracle():
    """The int8 read equals the bf16-pool read over the dequantized pools
    (the reference's q8 contract: quantization error cancels)."""
    rng = np.random.default_rng(10)
    L = 20
    qa, qr, pc, pr, bt, pos = _t(*_setup_mla(rng, L=L))
    cs, rs = quant.page_abs_scale(pc), quant.page_abs_scale(pr)
    cc, rc = quant.quantize(pc, cs), quant.quantize(pr, rs)
    scale = 1.0 / math.sqrt(24)
    got = ops.paged_mla_q8_kernel(qa, qr, cc, rc, cs, rs, bt, pos, length=L,
                                  scale=scale)
    want = ref.paged_mla_ref(qa, qr, quant.dequantize(cc, cs),
                             quant.dequantize(rc, rs), bt, pos, length=L,
                             scale=scale)
    np.testing.assert_allclose(got.numpy(), want.numpy(),
                               atol=PALLAS_TOL["mla"], rtol=0)


def test_bf16_queries_give_bf16_latents():
    rng = np.random.default_rng(12)
    qa, qr, pc, pr, bt, pos = _t(*_setup_mla(rng))
    bf = torch.bfloat16
    out = ops.paged_mla_kernel(qa.to(bf), qr.to(bf), pc.to(bf), pr.to(bf),
                               bt, pos, length=20, scale=0.2)
    assert out.dtype == bf and out.shape == qa.shape


def test_wrappers_take_the_plain_version_on_cpu_without_counting():
    rng = np.random.default_rng(5)
    qa, qr, pc, pr, bt, pos = _t(*_setup_mla(rng))
    n0, n8 = ops.paged_mla_kernel.launches, ops.paged_mla_q8_kernel.launches
    out = ops.paged_mla_kernel(qa, qr, pc, pr, bt, pos, length=20, scale=0.2)
    assert torch.equal(out, ref.paged_mla_ref(qa, qr, pc, pr, bt, pos,
                                              length=20, scale=0.2))
    cs = quant.page_abs_scale(pc)
    ops.paged_mla_q8_kernel(qa, qr, quant.quantize(pc, cs),
                            quant.quantize(pr, cs), cs, cs, bt, pos,
                            length=20, scale=0.2)
    assert (ops.paged_mla_kernel.launches,
            ops.paged_mla_q8_kernel.launches) == (n0, n8)


def test_mla_wrappers_refuse_mixed_devices():
    """The plain version runs only when every input lies on the CPU: one
    input elsewhere is refused by the wrapper, not handed to torch."""
    rng = np.random.default_rng(6)
    qa, qr, pc, pr, bt, pos = _t(*_setup_mla(rng))
    cs = quant.page_abs_scale(pc)
    cc, rc = quant.quantize(pc, cs), quant.quantize(pr, cs)
    plain = [qa, qr, pc, pr, bt, pos]
    q8 = [qa, qr, cc, rc, cs, cs.clone(), bt, pos]
    for fn, args in ((ops.paged_mla_kernel, plain),
                     (ops.paged_mla_q8_kernel, q8)):
        for i in range(len(args)):
            mixed = [a.to("meta") if j == i else a
                     for j, a in enumerate(args)]
            with pytest.raises(ValueError, match="different devices"):
                fn(*mixed, length=20, scale=0.2)
        with pytest.raises(ValueError, match="unsupported device"):
            fn(*[a.to("meta") for a in args], length=20, scale=0.2)


def test_scales_must_pair():
    rng = np.random.default_rng(11)
    qa, qr, pc, pr, bt, pos = _t(*_setup_mla(rng))
    cs = quant.page_abs_scale(pc)
    with pytest.raises(ValueError, match="ckv_scale/krope_scale"):
        ops.paged_mla_attention(qa, qr, pc, pr, bt, pos, length=20,
                                scale=0.2, ckv_scale=cs)
    with pytest.raises(ValueError, match="backend"):
        ops.paged_mla_attention(qa, qr, pc, pr, bt, pos, length=20,
                                scale=0.2, backend="pallas")


@pytest.mark.parametrize("kw", [dict(), dict(dtype_bytes=1, scale_bytes=4)])
@pytest.mark.parametrize("live", [1, 16, 1056])
def test_cost_model_mla_matches_reference(live, kw):
    args = (4, 128, 512, 64)
    assert ops.cost_model_mla(*args, live_tokens=live, page_size=16, **kw) \
        == jops.cost_model_mla(*args, live_tokens=live, page_size=16, **kw)


def test_page_scales_per_latent_page():
    """MLA latent pools (P, ps, r): one scale per page, page_axis=1, the
    reference's codes and scales bitwise, and the round trip within half
    an LSB (test_paged_quant_properties.py::test_mla_page_axis_shapes)."""
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((6, 4, 16)) * 3).astype(np.float32)
    x[3] = 0.0                                    # an all-zero page
    (tx,), (jx,) = _t(x), _j(x)
    sc = quant.page_abs_scale(tx)
    assert sc.shape == (6,)
    np.testing.assert_array_equal(sc.numpy(), np.asarray(jq.page_abs_scale(jx)))
    codes = quant.quantize(tx, sc)
    np.testing.assert_array_equal(
        codes.numpy(), np.asarray(jq.quantize(jx, jq.page_abs_scale(jx))))
    deq = quant.dequantize(codes, sc).numpy()
    assert (np.abs(deq - x) <= 0.5 * sc.numpy()[:, None, None]
            * (1 + 1e-6)).all()


@pytest.mark.parametrize("layout", ["mla", "gqa"])
@pytest.mark.parametrize("fresh", [False, True])
def test_incremental_q8_write_bitwise(fresh, layout):
    """The generalised decode-time page write on (P,) latent scales and on
    (P, KV) GQA scales equals the reference's, codes and scales bitwise,
    for the slots that write."""
    rng = np.random.default_rng(3 + fresh + 2 * (layout == "gqa"))
    P, ps = 10, 4
    feat = (16,) if layout == "mla" else (2, 16)
    rows = rng.standard_normal((P, ps) + feat).astype(np.float32)
    scale = np.asarray(jq.page_abs_scale(jnp.asarray(rows)))
    codes = np.asarray(jq.quantize(jnp.asarray(rows), jnp.asarray(scale)))
    wpage = np.array([3, 7, 1], np.int32)
    in_page = np.array([0, 2, 3], np.int32)
    fr = np.array([fresh, False, fresh])
    tok = (rng.standard_normal((3,) + feat) * 4).astype(np.float32)
    jtok = jnp.asarray(tok).astype(jnp.bfloat16)
    jp, js = j_write_q8(jnp.asarray(codes), jnp.asarray(scale),
                        jnp.asarray(wpage), jnp.asarray(in_page),
                        jnp.asarray(fr), jtok)
    tp, ts = torch.from_numpy(codes.copy()), torch.from_numpy(scale.copy())
    _paged_write_q8(tp, ts, torch.from_numpy(wpage).long(),
                    torch.from_numpy(in_page).long(), torch.from_numpy(fr),
                    torch.from_numpy(tok).to(torch.bfloat16))
    assert ts.shape == scale.shape
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("q8", [False, True], ids=["fp32", "int8"])
def test_plain_fp64_accumulation(q8):
    """``acc=torch.float64`` evaluates the same function of the same fp32
    operands in fp64 (the card's fp32 check of the simt route): within
    2e-6 of the fp32 plain version at deepseek-v3's scale 1/sqrt(192),
    fp32 out, and the default stays the fp32 evaluation bit for bit."""
    rng = np.random.default_rng(11)
    qa, qr, pc, pr, bt, pos = _t(*_setup_mla(rng, H=8, r=64, dr=16, L=40,
                                             ps=8, num_pages=40))
    sk = {}
    if q8:
        sc = quant.page_abs_scale(pc, page_axis=1)
        sr = quant.page_abs_scale(pr, page_axis=1)
        pc, pr = quant.quantize(pc, sc, page_axis=1), quant.quantize(
            pr, sr, page_axis=1)
        sk = dict(ckv_scale=sc, krope_scale=sr)
    kw = dict(length=40, scale=1.0 / math.sqrt(192), **sk)
    f32 = ref.paged_mla_ref(qa, qr, pc, pr, bt, pos, **kw)
    f64 = ref.paged_mla_ref(qa, qr, pc, pr, bt, pos, acc=torch.float64,
                            **kw)
    assert f64.dtype == torch.float32
    assert torch.equal(f32, ref.paged_mla_ref(qa, qr, pc, pr, bt, pos,
                                              acc=torch.float32, **kw))
    np.testing.assert_allclose(f64.numpy(), f32.numpy(), atol=2e-6, rtol=0)
