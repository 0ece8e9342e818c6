"""PyTorch port vs the JAX reference: the Mamba-1 block and the
falcon-mamba decoder LM (models/mamba.py, falcon-mamba-7b-smoke: d 64,
2 layers, d_inner 128, d_state 4).

The reference's block runs ``ssm_impl`` "xla" (prefill from a blank
carry through the linear scan) and "fused" (its Pallas kernels in
interpret mode); the port's runs the same two, on the CPU (the plain
versions of its CUDA kernels).  Parameters come from the reference
through the bridge; inputs are made with numpy from a seed.  Tolerances:
fp32 outputs within 1e-5 of the largest reference magnitude plus 1e-5
relative (the two packages take the same ops in the same order; only
their sums over d_state and the matmuls' accumulation orders differ);
bf16 outputs within one bf16 ulp of the larger magnitude on top of that;
fused against xla at the reference's atol 2e-4 / rtol 2e-3
(tests/test_kernels_fused_ssm.py); the LM at the repo's bf16 bound
(atol = rtol = 5e-2, as tests/test_torch_lm.py) against the reference's
eager ``DecoderLM(cfg, scan_layers=False)``, and decode against forward
at tests/test_archs_smoke.py's 2e-2."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models.mamba import MambaBlock as JMB
from repro.models.transformer import DecoderLM as JLM
from repro_torch.bridge import load_jax_params
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.models.mamba import MambaBlock, _silu

torch.set_num_threads(1)

ARCH = "falcon-mamba-7b-smoke"
LM_TOL = dict(atol=5e-2, rtol=5e-2)


def _blocks(impl="xla", seed=0):
    jcfg = dataclasses.replace(jget(ARCH), ssm_impl=impl)
    cfg = dataclasses.replace(get_config(ARCH), ssm_impl=impl)
    jb = JMB(jcfg)
    jp = jb.init(jax.random.PRNGKey(seed))
    tb = MambaBlock(cfg)
    load_jax_params(tb, jax.tree_util.tree_map(np.asarray, jp))
    return jb, jp, tb


def _x(shape, seed, dtype):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    if dtype == "bf16":
        return jnp.asarray(x).astype(jnp.bfloat16), \
            torch.from_numpy(x).bfloat16()
    return jnp.asarray(x), torch.from_numpy(x)


def _close(got, want):
    """|got - want| within 1e-5 of the largest reference magnitude plus
    1e-5 relative; for bf16 results one bf16 ulp of the larger magnitude
    on top."""
    g = got.detach().float().numpy()
    w = np.asarray(want, np.float32)
    bound = 1e-5 * np.abs(w).max() + 1e-5 * np.abs(w)
    if got.dtype == torch.bfloat16:
        mag = np.maximum(np.maximum(np.abs(g), np.abs(w)), 2.0 ** -126)
        bound = bound + np.exp2(np.floor(np.log2(mag)) - 7)
    err = np.abs(g - w)
    assert (err <= bound).all(), float(err.max())


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("impl", ["xla", "fused"])
def test_block_forward_matches_reference(impl, dtype):
    jb, jp, tb = _blocks(impl)
    jx, tx = _x((2, 40, 64), 1, dtype)
    with torch.no_grad():
        got = tb(tx)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    _close(got, jb(jp, jx))


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_ssm_tail_dtypes_match_reference(dtype):
    """With fp32 parameters the conv promotes even bf16 inputs: xc, dt, B
    and C are fp32 in both packages, and equal."""
    jb, jp, tb = _blocks()
    jx, tx = _x((2, 24, 64), 2, dtype)
    jxr, _ = jnp.split(jx @ jp["w_in"].astype(jx.dtype), 2, axis=-1)
    jxc = jax.nn.silu(jb._conv(jp, jxr))
    jraw = jb._ssm_raw(jp, jxc)
    with torch.no_grad():
        xr, _ = tb._in(tx)
        pre, _ = tb._conv(xr, xr.new_zeros(2, 3, tb.d_inner))
        xc = _silu(pre)
        raw = tb._ssm_raw(xc)
    assert jxc.dtype == jnp.float32 and xc.dtype == torch.float32
    _close(xc, jxc)
    for name, t, j in zip(("dt", "B", "C", "A"), raw, jraw):
        assert j.dtype == jnp.float32 and t.dtype == torch.float32, name
        _close(t, j)


def test_fused_matches_xla():
    _, _, tb = _blocks("xla", seed=3)
    tf = MambaBlock(dataclasses.replace(tb.cfg, ssm_impl="fused"))
    tf.load_state_dict(tb.state_dict())
    x = torch.from_numpy((np.random.default_rng(3).standard_normal(
        (2, 70, 64)) * 0.3).astype(np.float32))
    with torch.no_grad():
        np.testing.assert_allclose(tf(x).numpy(), tb(x).numpy(), atol=2e-4,
                                   rtol=2e-3)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("length", [None, 5, 1, 12])
def test_prefill_outputs_and_carries_match_reference(length, dtype):
    """Two chunks against the carry: outputs and the ssm and conv carries
    after each, with and without a valid ``length`` (the carries at the
    last valid token)."""
    jb, jp, tb = _blocks(seed=4)
    cdt = jnp.float32 if dtype == "fp32" else jnp.bfloat16
    jc = jb.init_cache(2, dtype=cdt)
    tc = tb.init_cache(2, dtype=torch.float32 if dtype == "fp32"
                       else torch.bfloat16)
    for k in range(2):
        jx, tx = _x((2, 12, 64), 10 + k, dtype)
        jy, jc = jb.prefill(jp, jx, jc, 12 * k, length=length)
        with torch.no_grad():
            ty, tc = tb.prefill(tx, tc, 12 * k, length=length)
        _close(ty, jy)
        for key in ("ssm", "conv"):
            assert tc[key].dtype == tx.dtype and tc[key].is_contiguous()
            _close(tc[key], jc[key])


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_decode_matches_reference(dtype):
    jb, jp, tb = _blocks(seed=5)
    cdt = jnp.float32 if dtype == "fp32" else jnp.bfloat16
    jc = jb.init_cache(3, dtype=cdt)
    tc = tb.init_cache(3, dtype=torch.float32 if dtype == "fp32"
                       else torch.bfloat16)
    for t in range(6):
        jx, tx = _x((3, 1, 64), 20 + t, dtype)
        jy, jc = jb.decode(jp, jx, jc, t)
        with torch.no_grad():
            ty, tc = tb.decode(tx, tc, t)
        _close(ty, jy)
        for key in ("ssm", "conv"):
            _close(tc[key], jc[key])


def _lms(impl, seed=0):
    jcfg = dataclasses.replace(jget(ARCH), ssm_impl=impl)
    cfg = dataclasses.replace(get_config(ARCH), ssm_impl=impl)
    jm = JLM(jcfg, scan_layers=False)
    jp = jm.init(jax.random.PRNGKey(seed))
    tm = build_model(cfg, device="cpu")
    load_jax_params(tm, jax.tree_util.tree_map(np.asarray, jp))
    return jcfg, jm, jp, tm


@pytest.mark.parametrize("impl", ["xla", "fused"])
def test_lm_logits_match_reference(impl):
    jcfg, jm, jp, tm = _lms(impl, seed=6)
    toks = np.random.default_rng(6).integers(0, jcfg.vocab, size=(2, 20))
    want = np.asarray(jm(jp, jnp.asarray(toks)), np.float32)
    with torch.no_grad():
        got = tm(torch.as_tensor(toks))
    assert got.shape == (2, 20, jcfg.vocab_padded)
    np.testing.assert_allclose(got.numpy(), want, **LM_TOL)


def test_lm_decode_matches_forward():
    """O(1)-state decode == the full-sequence forward (teacher forcing),
    the port's mirror of test_decode_matches_forward_mamba."""
    _, _, _, tm = _lms("fused", seed=0)
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, tm.cfg.vocab, size=(1, 9)))
    with torch.no_grad():
        full = tm(toks).numpy()
        cache = tm.init_cache(1, 10, dtype=torch.float32)
        outs = []
        for t in range(9):
            lg, cache = tm.decode_step(toks[:, t:t + 1], cache, t)
            outs.append(lg[:, 0].numpy())
    np.testing.assert_allclose(np.stack(outs, 1), full, atol=2e-2,
                               rtol=2e-2)


def test_lm_chunked_prefill_carry_equivalence():
    """Chunked prefill through DecoderLM.prefill (grid-padded last chunk,
    ``length`` = its valid tokens) == the full-sequence forward at the
    last token, for every chunking; the port's mirror of
    test_chunked_prefill_carry_equivalence for falcon-mamba."""
    _, _, _, tm = _lms("xla", seed=0)
    B, P = 2, 13
    toks = np.random.default_rng(5).integers(0, tm.cfg.vocab, size=(B, P))
    with torch.no_grad():
        full = tm(torch.as_tensor(toks))[:, -1].numpy()
        outs = {}
        for chunk in (P, 5, 1):
            padded = np.pad(toks, ((0, 0), (0, (-P) % chunk)))
            cache = tm.init_cache(B)
            for s in range(0, padded.shape[1], chunk):
                last, cache = tm.prefill(
                    torch.as_tensor(padded[:, s:s + chunk]), cache, s,
                    length=min(P - s, chunk))
            outs[chunk] = last[:, 0].numpy()
            np.testing.assert_allclose(outs[chunk], full, atol=0.1,
                                       rtol=0.1)
            assert (outs[chunk][:, :tm.cfg.vocab].argmax(-1)
                    == full[:, :tm.cfg.vocab].argmax(-1)).all()
    np.testing.assert_allclose(outs[5], outs[P], atol=2e-2, rtol=2e-2)


def test_lm_prefill_and_decode_match_reference():
    """DecoderLM.prefill of a 13-token prompt (chunk 8, the last chunk
    grid-padded) and 4 decode steps against the reference's eager LM:
    logits and every layer's carries."""
    jcfg, jm, jp, tm = _lms("xla", seed=7)
    toks = np.random.default_rng(7).integers(0, jcfg.vocab, size=(2, 17))
    jc, tc = jm.init_cache(2, 32), tm.init_cache(2)
    padded = np.pad(toks[:, :13], ((0, 0), (0, 3)))
    for s in (0, 8):
        jl, jc = jm.prefill(jp, jnp.asarray(padded[:, s:s + 8]), jc, s,
                            length=min(13 - s, 8))
        with torch.no_grad():
            tl, tc = tm.prefill(torch.as_tensor(padded[:, s:s + 8]), tc, s,
                                length=min(13 - s, 8))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl, np.float32),
                                   **LM_TOL)
    for t in range(13, 17):
        jl, jc = jm.decode_step(jp, jnp.asarray(toks[:, t:t + 1]), jc,
                                jnp.int32(t))
        with torch.no_grad():
            tl, tc = tm.decode_step(torch.as_tensor(toks[:, t:t + 1]), tc, t)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl, np.float32),
                                   **LM_TOL)
    for j in range(jcfg.n_layers):
        for key in ("ssm", "conv"):
            np.testing.assert_allclose(
                tc[j][key].float().numpy(),
                np.asarray(jc[f"unit0_r{j}"][key], np.float32),
                **LM_TOL)
