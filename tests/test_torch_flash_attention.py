"""PyTorch port vs the JAX reference: flash attention
(kernels/flash_attention).

The port's op on CPU tensors runs the plain versions of its two CUDA
kernels (``ref.flash_attention_ref`` and ``ref.flash_attention_bwd_ref``);
the reference runs its Pallas kernels in interpret mode
(``backend="pallas"``), as its own tests do.  Inputs are made with numpy
from a seed.  Tolerances are the reference test's
(tests/test_kernels_flash_attention.py): the forward 2e-5 in fp32,
gradients atol 5e-5 / rtol 5e-4.  In bf16 both compute in fp32 and round
once, so outputs agree within one bf16 ulp of the larger magnitude plus
the fp32 bound 2e-6."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as jops
from repro.kernels.flash_attention.flash_attention import flash_fwd as jfwd
from repro_torch.kernels.flash_attention import ops, ref

torch.set_num_threads(1)

F32 = dict(atol=2e-5, rtol=2e-5)
GRAD = dict(atol=5e-5, rtol=5e-4)


def _inputs(B, H, KV, S, D, seed=0):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((B, H, S, D)) * 0.5).astype(np.float32)
    k = (rng.standard_normal((B, KV, S, D)) * 0.5).astype(np.float32)
    v = rng.standard_normal((B, KV, S, D)).astype(np.float32)
    return q, k, v


def _port(q, k, v, causal=True, window=None, dtype=torch.float32):
    t = [torch.from_numpy(x).to(dtype) for x in (q, k, v)]
    return ops.flash_attention(*t, causal, window)


def _jax(q, k, v, causal=True, window=None, dtype=jnp.float32):
    t = [jnp.asarray(x).astype(dtype) for x in (q, k, v)]
    return jops.flash_attention(*t, causal, window, "pallas")


def _np(x):
    return x.float().numpy() if torch.is_tensor(x) else np.asarray(
        x, np.float32)


@pytest.mark.parametrize("B,H,KV,S,D", [
    (1, 1, 1, 8, 8), (1, 2, 2, 64, 16), (2, 4, 2, 128, 32),
    (1, 6, 2, 96, 64), (1, 8, 1, 256, 16), (1, 2, 1, 64, 160),
])
def test_forward_matches_reference(B, H, KV, S, D):
    q, k, v = _inputs(B, H, KV, S, D, seed=S + H)
    np.testing.assert_allclose(_np(_port(q, k, v)), _np(_jax(q, k, v)),
                               **F32)


def test_bf16_within_one_ulp_of_reference():
    q, k, v = _inputs(1, 2, 2, 64, 32, seed=7)
    got = _np(_port(q, k, v, dtype=torch.bfloat16))
    want = _np(_jax(q, k, v, dtype=jnp.bfloat16))
    mag = np.maximum(np.abs(got), np.abs(want))
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 2.0 ** -126))) - 7)
    assert (np.abs(got - want) <= ulp + 2e-6).all()


@pytest.mark.parametrize("window", [8, 16, 64])
def test_sliding_window(window):
    """S 128 with windows 8/16/64: the reference's 128-row blocks (and the
    CUDA kernels' 64-row tiles) start rows inside fully masked KV tiles."""
    q, k, v = _inputs(1, 2, 1, 128, 16, seed=window)
    np.testing.assert_allclose(_np(_port(q, k, v, window=window)),
                               _np(_jax(q, k, v, window=window)), **F32)


def test_non_causal():
    q, k, v = _inputs(1, 2, 2, 64, 16, seed=11)
    np.testing.assert_allclose(_np(_port(q, k, v, causal=False)),
                               _np(_jax(q, k, v, causal=False)), **F32)


@pytest.mark.parametrize("B,H,KV,S,D", [(1, 4, 2, 64, 16), (2, 2, 1, 96, 32)])
def test_gradients_match_reference(B, H, KV, S, D):
    """GQA gradients: the plain backward (dk/dv summed over each group)
    against the reference's Pallas backward and group sum."""
    q, k, v = _inputs(B, H, KV, S, D, seed=S)
    w = np.cos(np.arange(D)).astype(np.float32)

    def jloss(q, k, v):
        return jnp.sum(jnp.sin(jops.flash_attention(q, k, v, True, None,
                                                    "pallas")) * w)

    want = jax.grad(jloss, (0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    t = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = ops.flash_attention(*t)
    (torch.sin(out) * torch.from_numpy(w)).sum().backward()
    for x, wg in zip(t, want):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(wg), **GRAD)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 16),
                                           (False, None)])
def test_lse_matches_reference_flash_fwd(causal, window):
    q, k, v = _inputs(2, 4, 2, 128, 32, seed=5)
    _, lse = ops.flash_fwd_kernel(*map(torch.from_numpy, (q, k, v)), causal,
                                  window)
    _, jlse = jfwd(*map(jnp.asarray, (q, k, v)), bq=64, bk=64, causal=causal,
                   window=window, group=2, interpret=True)
    assert lse.dtype == torch.float32 and lse.shape == (2, 4, 128)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), **F32)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 24),
                                           (False, 40)])
def test_plain_backward_is_the_gradient_of_the_plain_forward(causal, window):
    """flash_attention_bwd_ref against torch autograd through
    flash_attention_ref, both fp32 on the same inputs: the two part only
    by fp32 rounding (max 1.5e-7 here)."""
    q, k, v = (torch.from_numpy(x).requires_grad_()
               for x in _inputs(2, 6, 3, 50, 16, seed=3))
    out, lse = ref.flash_attention_ref(q, k, v, causal, window)
    do = torch.randn(out.shape, generator=torch.Generator().manual_seed(0))
    want = torch.autograd.grad(out, (q, k, v), do)
    got = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, causal, window)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), w.numpy(), atol=1e-6,
                                   rtol=1e-5)


def test_mha_ref_matches_reference_oracle():
    from repro.kernels.flash_attention import ref as jref
    q, k, v = _inputs(1, 3, 3, 40, 16, seed=9)
    for window in (None, 8):
        got = ref.mha_ref(*map(torch.from_numpy, (q, k, v)), window=window)
        want = jref.mha_ref(*map(jnp.asarray, (q, k, v)), window=window)
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-6, rtol=1e-6)


def test_strided_views_give_the_contiguous_result():
    """The model passes (B, S, H, D) projections as (B, H, S, D) views;
    the op gives the same values and gradients as on contiguous copies."""
    q, k, v = _inputs(2, 4, 2, 33, 16, seed=4)
    views = [torch.from_numpy(x).transpose(1, 2).contiguous().transpose(1, 2)
             .requires_grad_() for x in (q, k, v)]
    dense = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    outs = [ops.flash_attention(*t, True, 8) for t in (views, dense)]
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
    for o in outs:
        o.sum().backward()
    for a, b in zip(views, dense):
        torch.testing.assert_close(a.grad, b.grad, rtol=0, atol=0)


def test_config_admits_naive_and_flash_only():
    """The config takes the naive softmax, the flash op and the dry-run's
    stand-in ("stub", the reference's third value), nothing else."""
    from repro_torch.configs import get_config
    cfg = get_config("smollm-360m-smoke")
    for impl in ("naive", "flash", "stub"):
        assert dataclasses.replace(cfg, attention_impl=impl).attention_impl \
            == impl
    with pytest.raises(ValueError, match="attention_impl"):
        dataclasses.replace(cfg, attention_impl="pallas")


def test_wrappers_raise_on_other_devices():
    q = torch.empty(1, 2, 8, 16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ops.flash_fwd_kernel(q, q, q)
    with pytest.raises(ValueError, match="unsupported device"):
        ops.flash_bwd_kernel(q, q, q, q, torch.empty(1, 2, 8, device="meta"),
                             q)


@pytest.mark.parametrize("kw", [
    dict(B=8, H=16, KV=4, S=4096, D=128),
    dict(B=4, H=15, KV=5, S=2048, D=64, train=False),
    dict(B=1, H=8, KV=4, S=2048, D=256, window=1024, train=False),
    dict(B=2, H=4, KV=2, S=512, D=64, causal=False, window=128,
         dtype_bytes=4),
])
def test_cost_model_matches_reference(kw):
    assert ops.cost_model(**kw) == jops.cost_model(**kw)


def test_wrappers_refuse_mixed_devices():
    """The plain version runs only when every input lies on the CPU: one
    input elsewhere is refused by the wrapper, not handed to torch."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 4, 2, 8, 16))
    out, lse = ops.flash_fwd_kernel(q, k, v)
    fwd, bwd = [q, k, v], [q, k, v, out, lse, q.clone()]
    for fn, args in ((ops.flash_fwd_kernel, fwd),
                     (ops.flash_bwd_kernel, bwd)):
        for i in range(len(args)):
            mixed = [a.to("meta") if j == i else a
                     for j, a in enumerate(args)]
            with pytest.raises(ValueError, match="different devices"):
                fn(*mixed)
        with pytest.raises(ValueError, match="unsupported device"):
            fn(*[a.to("meta") for a in args])


# -- the tensor-core route (bf16 at head dims 16-128) ----------------------

@pytest.mark.parametrize("D", [16, 32, 64, 128, 256, 80, 160])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_route_picks_tc_for_bf16_up_to_head_dim_128(dtype, D):
    want = "tc" if dtype == torch.bfloat16 and D in (16, 32, 64, 128) \
        else "simt"
    assert ops.route(dtype, D) == want


def _split(x):
    """fp32 x as the tc kernels multiply it: bf16 hi and lo, hi + lo ~ x."""
    hi = x.to(torch.bfloat16)
    return hi, (x - hi.float()).to(torch.bfloat16)


def _mm(a, b, split):
    """a @ b with an fp32 ``a`` rounded to bf16 as the tc kernels take it
    (``split``: hi and lo, two products; else once), ``b`` bf16; every
    bf16 x bf16 product is exact in fp32 and summed in fp32."""
    parts = _split(a) if split else (a.to(torch.bfloat16),)
    return sum(x.float() @ b.float() for x in parts)


def _tc_fwd(q, k, v, causal, window, split=True):
    """Plain PyTorch emulation of the tc forward's numerics (bf16 q, k,
    v): q.k^T exact products summed in fp32, P rounded to a bf16 operand
    of p.V (split into hi + lo as the kernel does, or once)."""
    G = q.shape[1] // k.shape[1]
    s = ref._scores(q, k, causal, window)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True).clamp(min=1e-30)
    out = _mm(p, ref._expand(v, G), split) / l
    return out.to(q.dtype), (m + torch.log(l))[..., 0]


def _tc_bwd(q, k, v, out, lse, do, causal, window, split=True):
    """The same for the tc backward given the forward's out and lse: dS
    and P rounded to bf16 operands of ds.K, ds^T.q and p^T.do."""
    KV = k.shape[1]
    G = q.shape[1] // KV
    p = torch.exp(ref._scores(q, k, causal, window) - lse[..., None])
    delta = (out.float() * do.float()).sum(-1, keepdim=True)
    dp = do.float() @ ref._expand(v, G).float().transpose(-1, -2)
    ds = p * (dp - delta) * ref._scale(q.shape[-1], q.device)
    dq = _mm(ds, ref._expand(k, G), split)
    dk = _mm(ds.transpose(-1, -2), q, split)
    dv = _mm(p.transpose(-1, -2), do, split)
    return (dq.to(q.dtype), ref._group_sum(dk, KV).to(k.dtype),
            ref._group_sum(dv, KV).to(v.dtype))


def _past_bf16_ulp(got, want):
    """Entries where |got - want| exceeds one bf16 ulp of the larger
    magnitude plus 2e-6 (the card's bound on the kernels' bf16 outputs)."""
    a, w = _np(got), _np(want)
    mag = np.maximum(np.maximum(np.abs(a), np.abs(w)), 2.0 ** -126)
    return int((np.abs(a - w) > np.exp2(np.floor(np.log2(mag)) - 7)
                + 2e-6).sum())


@pytest.mark.parametrize("causal,window", [(True, None), (True, 40)])
def test_tc_split_numerics_match_reference_flash_kernels(causal, window):
    """The tc route's numerics (emulated: bf16 x bf16 products in fp32, P
    and dS split into bf16 hi + lo) against the reference's Pallas
    flash_fwd and flash_bwd in interpret mode, whose products are fp32:
    out, dq, dk and dv within one bf16 ulp + 2e-6, lse within 2e-5 +
    2e-5 |lse|.  Rounding P and dS once to bf16 instead (FA2/FA3's
    operands) moves entries of every output past that bound."""
    from repro.kernels.flash_attention.flash_attention import flash_bwd
    B, H, KV, S, D = 1, 4, 2, 256, 64
    q, k, v = _inputs(B, H, KV, S, D, seed=17)
    do = np.random.default_rng(18).standard_normal(q.shape).astype(
        np.float32)
    tq, tk, tv, tdo = (torch.from_numpy(x).to(torch.bfloat16)
                       for x in (q, k, v, do))
    jq, jk, jv, jdo = (jnp.asarray(x).astype(jnp.bfloat16)
                       for x in (q, k, v, do))
    jout, jlse = jfwd(jq, jk, jv, bq=128, bk=128, causal=causal,
                      window=window, group=H // KV, interpret=True)
    jdq, jdk, jdv = flash_bwd(jq, jk, jv, jout, jlse, jdo, bq=128, bk=128,
                              causal=causal, window=window, group=H // KV,
                              interpret=True)
    sum_group = lambda x: np.asarray(x).reshape(B, KV, H // KV, S, D).sum(2)
    want = [jout, jlse, jnp.asarray(jdq).astype(jnp.bfloat16),
            jnp.asarray(sum_group(jdk)).astype(jnp.bfloat16),
            jnp.asarray(sum_group(jdv)).astype(jnp.bfloat16)]
    tout = torch.from_numpy(np.array(jout.astype(jnp.float32))).to(
        torch.bfloat16)
    tlse = torch.from_numpy(np.array(jlse))
    # the backward from the reference's out and lse, as the card holds
    # the kernels against the plain version given the same out and lse
    for split in (True, False):
        got = _tc_fwd(tq, tk, tv, causal, window, split) + _tc_bwd(
            tq, tk, tv, tout, tlse, tdo, causal, window, split)
        for name, g, w in zip(("out", "lse", "dq", "dk", "dv"), got, want):
            if name == "lse":
                np.testing.assert_allclose(_np(g), _np(w), atol=2e-5,
                                           rtol=2e-5)
            elif split:
                assert _past_bf16_ulp(g, w) == 0, name
            else:
                assert _past_bf16_ulp(g, w) > 0, name


def test_rows_copies_misaligned_views_and_keeps_aligned_ones():
    """TMA needs 16-byte bases and strides: a view one bf16 off a 16-byte
    boundary is copied; the model's transposed (B, S, H, D) projections
    pass as they are (same storage, same strides)."""
    x = torch.zeros(2 * 6 * 40 * 64 + 1, dtype=torch.bfloat16)
    odd = x[1:].view(2, 6, 40, 64)
    got = ops._rows(odd)
    assert got.data_ptr() != odd.data_ptr() and ops._aligned(got)
    torch.testing.assert_close(got, odd, rtol=0, atol=0)
    view = torch.zeros(2, 40, 6, 64, dtype=torch.bfloat16).transpose(1, 2)
    kept = ops._rows(view)
    assert kept.data_ptr() == view.data_ptr()
    assert kept.stride() == view.stride()
    narrow = torch.zeros(2, 6, 40, 72, dtype=torch.bfloat16)[..., :64]
    assert ops._rows(narrow).data_ptr() == narrow.data_ptr()
    ragged = torch.zeros(2, 6, 40, 68, dtype=torch.bfloat16)[..., :64]
    assert ops._rows(ragged).data_ptr() != ragged.data_ptr()
