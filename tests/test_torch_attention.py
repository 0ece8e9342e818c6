"""The port's GQA attention (global and sliding window) against the
reference's ``repro.models.attention.GQAAttention`` and the attention
decoder LMs (smollm-360m-smoke, gemma3-4b-smoke) against the reference's
``DecoderLM(cfg, scan_layers=False)`` run eagerly, on the same weights
through the bridge.

Tolerances: the module in fp32 at 1e-5 (rope, einsums and softmax round
differently in the two frameworks); the bf16 LMs at the repo's bf16
bound, atol = rtol = 5e-2 (test_serve_prefill.py:66), with greedy argmax
equal wherever the reference's top-2 margin > 0.1.  Pool writes (bf16
and int8 codes and scales) are held bitwise."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.kernels.paged_attention import quant as jq
from repro.models.attention import GQAAttention as JGQA
from repro.models.transformer import DecoderLM as JLM
from repro_torch.bridge import load_jax_params
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.models.attention import GQAAttention

torch.set_num_threads(1)

ARCHS = ["smollm-360m-smoke", "gemma3-4b-smoke"]
TOL = dict(atol=5e-2, rtol=5e-2)
F32 = dict(atol=1e-5, rtol=1e-5)


def _module(arch, local, seed=0, jax_kw=None, **cfg_kw):
    """(reference config, reference module, its params, port module on
    the same params); ``cfg_kw`` configures the port, ``jax_kw`` (default
    the same) the reference."""
    jcfg = dataclasses.replace(jget(arch), **(cfg_kw if jax_kw is None
                                               else jax_kw))
    jm = JGQA(jcfg, local=local)
    jp = jm.init(jax.random.PRNGKey(seed))
    tm = GQAAttention(dataclasses.replace(get_config(arch), **cfg_kw),
                      local=local)
    load_jax_params(tm, jax.tree_util.tree_map(np.asarray, jp))
    return jcfg, jm, jp, tm


def _np(t):
    return t.float().numpy() if torch.is_tensor(t) else np.asarray(
        t, np.float32)


@pytest.mark.parametrize("local", [False, True])
def test_forward_matches_reference(local):
    jcfg, jm, jp, tm = _module("gemma3-4b-smoke", local, seed=1)
    x = np.random.default_rng(1).standard_normal(
        (2, 13, jcfg.d_model)).astype(np.float32)
    want = jm(jp, jnp.asarray(x))
    with torch.inference_mode():
        got = tm(torch.from_numpy(x))
    np.testing.assert_allclose(_np(got), _np(want), **F32)


@pytest.mark.parametrize("local", [False, True])
def test_flash_forward_and_grads_match_reference(local):
    """attention_impl="flash" in both packages (the reference's Pallas
    kernels in interpret mode, with 1-row blocks at the odd S 13; the
    port's plain versions of its CUDA kernels), positions offset by 5 so
    rope reads them while the mask stays on the sequence index: outputs at
    the module's fp32 bound, the input's gradient at the flash tests'
    atol 5e-5 / rtol 5e-4."""
    jcfg, jm, jp, tm = _module("gemma3-4b-smoke", local, seed=4,
                               attention_impl="flash")
    x = np.random.default_rng(4).standard_normal(
        (2, 13, jcfg.d_model)).astype(np.float32)
    pos = np.arange(5, 18)
    w = np.cos(np.arange(jcfg.d_model)).astype(np.float32)

    def jloss(x):
        return jnp.sum(jnp.sin(jm(jp, x, jnp.asarray(pos))) * w)

    want, jgx = jax.value_and_grad(jloss)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    out = tm(xt, torch.from_numpy(pos))
    np.testing.assert_allclose(_np(out.detach()), _np(jm(jp, jnp.asarray(x),
                                                       jnp.asarray(pos))),
                               **F32)
    got = (torch.sin(out) * torch.from_numpy(w)).sum()
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), atol=5e-5,
                               rtol=5e-4)


@pytest.mark.parametrize("local", [False, True])
def test_chunked_prefill_and_ring_wrap_match_reference(local):
    """Three chunks of 6 into a cache of 16 (window 8 for the ring, so the
    second and third chunks wrap it); the last chunk is grid-padded to
    length 4.  Outputs and caches against the reference."""
    jcfg, jm, jp, tm = _module("gemma3-4b-smoke", local, seed=2)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 18, jcfg.d_model)).astype(np.float32)
    jc = jm.init_cache(2, 16, jnp.float32)
    tc = tm.init_cache(2, 16, torch.float32)
    for s, n in ((0, 6), (6, 6), (12, 4)):
        chunk = x[:, s:s + 6]
        jy, jc = jm.prefill(jp, jnp.asarray(chunk), jc, s, length=n)
        with torch.inference_mode():
            ty, tc = tm.prefill(torch.from_numpy(chunk), tc, s, length=n)
        np.testing.assert_allclose(_np(ty)[:, :n], _np(jy)[:, :n], **F32)
        for k in ("k", "v"):
            np.testing.assert_allclose(_np(tc[k]), _np(jc[k]), **F32)


@pytest.mark.parametrize("local", [False, True])
def test_dense_decode_with_per_slot_positions(local):
    """The port's batched decode with per-slot positions equals the
    reference's scalar-position decode run per slot (its serving vmap)."""
    jcfg, jm, jp, tm = _module("gemma3-4b-smoke", local, seed=3)
    rng = np.random.default_rng(3)
    B, L = 3, 12
    cache = {k: rng.standard_normal((B, tm.ring_length(L), jcfg.n_kv_heads,
                                     jcfg.head_dim)).astype(np.float32)
             for k in ("k", "v")}
    x = rng.standard_normal((B, 1, jcfg.d_model)).astype(np.float32)
    pos = np.array([0, 5, 11 if not local else 19])
    with torch.inference_mode():
        ty, tc = tm.decode(torch.from_numpy(x),
                           {k: torch.from_numpy(v) for k, v in cache.items()},
                           torch.from_numpy(pos))
    for b in range(B):
        jy, jc = jm.decode(jp, jnp.asarray(x[b:b + 1]),
                           {k: jnp.asarray(v[b:b + 1])
                            for k, v in cache.items()}, int(pos[b]))
        np.testing.assert_allclose(_np(ty)[b:b + 1], _np(jy), **F32)
        for k in ("k", "v"):
            np.testing.assert_allclose(_np(tc[k])[b:b + 1], _np(jc[k]),
                                       **F32)


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("impl", ["gather", "kernel"])
@pytest.mark.parametrize("local", [False, True])
def test_decode_paged_matches_reference(local, impl, kv_dtype):
    """One paged decode step over shuffled chains with an inactive slot:
    the active slots' pool writes are bitwise the reference's (the
    inactive slot writes nothing), and the output matches the reference's
    gather path (port "gather") or its Pallas kernel in interpret mode
    (port "kernel", the plain version of the CUDA kernels)."""
    jimpl = {"gather": "gather", "kernel": "pallas"}[impl]
    jcfg, jm, jp, tm = _module(
        "gemma3-4b-smoke", local, seed=4, paged_impl=impl, kv_dtype=kv_dtype,
        jax_kw=dict(paged_impl=jimpl, kv_dtype=kv_dtype))
    rng = np.random.default_rng(4)
    B, P, ps, max_len = 3, 24, 4, 20
    n_chain = -(-max_len // ps)
    bt = rng.permutation(P)[:B * n_chain].reshape(B, n_chain).astype(
        np.int32)
    KV, hd = jcfg.n_kv_heads, jcfg.head_dim
    raw = {k: rng.standard_normal((P, ps, KV, hd)).astype(np.float32)
           for k in ("k", "v")}
    if kv_dtype == "int8":
        jcache = {}
        for k, v in raw.items():
            s = jq.page_abs_scale(jnp.asarray(v))
            jcache[k] = jq.quantize(jnp.asarray(v), s)
            jcache[k + "_scale"] = s
    else:
        jcache = {k: jnp.asarray(v).astype(jnp.bfloat16)
                  for k, v in raw.items()}
    tcache = {k: torch.from_numpy(np.asarray(v.astype(jnp.float32)
                                             if v.dtype == jnp.bfloat16
                                             else v).copy())
              for k, v in jcache.items()}
    if kv_dtype == "bf16":
        tcache = {k: v.to(torch.bfloat16) for k, v in tcache.items()}
    x = rng.standard_normal((B, 1, jcfg.d_model)).astype(np.float32)
    pos = np.array([3, 9, 17], np.int32)
    active = np.array([True, False, True])
    jy, jnew = jm.decode_paged(jp, jnp.asarray(x).astype(jnp.bfloat16),
                               jcache, jnp.asarray(pos), jnp.asarray(bt),
                               jnp.asarray(active), max_len)
    with torch.inference_mode():
        ty, tnew = tm.decode_paged(
            torch.from_numpy(x).to(torch.bfloat16), tcache,
            torch.from_numpy(pos), torch.from_numpy(bt),
            torch.from_numpy(active), max_len)
    for k in jnew:
        np.testing.assert_array_equal(_np(tnew[k]), _np(jnew[k]), err_msg=k)
    np.testing.assert_allclose(_np(ty)[active], _np(jy)[active], **TOL)


def _lm_pair(arch, seed, **cfg_kw):
    jcfg = jget(arch)
    jm = JLM(jcfg, scan_layers=False)
    jp = jm.init(jax.random.PRNGKey(seed))
    tm = build_model(dataclasses.replace(get_config(arch), **cfg_kw),
                     device="cpu")
    load_jax_params(tm, jax.tree_util.tree_map(np.asarray, jp))
    return jcfg, jm, jp, tm


def _argmax_agrees(got, want):
    srt = np.sort(want, axis=-1)
    margin = srt[..., -1] - srt[..., -2]
    differ = got.argmax(-1) != want.argmax(-1)
    assert not (differ & (margin > 0.1)).any()


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_forward_prefill_and_decode_match_reference(arch):
    """Full-sequence logits; a grid-padded chunked prefill's last logits
    and caches; then teacher-forced decode steps from that cache."""
    jcfg, jm, jp, tm = _lm_pair(arch, seed=5)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, jcfg.vocab, size=(2, 13))
    want = np.asarray(jm(jp, jnp.asarray(toks)), np.float32)
    with torch.inference_mode():
        got = tm(torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    _argmax_agrees(got[..., :jcfg.vocab], want[..., :jcfg.vocab])

    L, chunk = 24, 8
    padded = np.pad(toks, ((0, 0), (0, (-13) % chunk)))
    jc, tc = jm.init_cache(2, L), tm.init_cache(2, L)
    for s in range(0, padded.shape[1], chunk):
        n = min(13 - s, chunk)
        jl, jc = jm.prefill(jp, jnp.asarray(padded[:, s:s + chunk]), jc, s,
                            length=n)
        with torch.inference_mode():
            tl, tc = tm.prefill(torch.from_numpy(padded[:, s:s + chunk]),
                                tc, s, length=n)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl, np.float32), **TOL)
    for j in range(jcfg.n_layers):
        name = jm._all_layers()[j][0]
        for k in ("k", "v"):
            np.testing.assert_allclose(_np(tc[j][k]), _np(jc[name][k]),
                                       **TOL)
    nxt = rng.integers(0, jcfg.vocab, size=(2, 4))
    for t in range(4):
        jl, jc = jm.decode_step(jp, jnp.asarray(nxt[:, t:t + 1]), jc,
                                jnp.int32(13 + t))
        with torch.inference_mode():
            tl, tc = tm.decode_step(torch.from_numpy(nxt[:, t:t + 1]), tc,
                                    13 + t)
        w = np.asarray(jl, np.float32)[:, 0]
        np.testing.assert_allclose(tl.numpy()[:, 0], w, **TOL)
        _argmax_agrees(tl.numpy()[:, 0, :jcfg.vocab], w[:, :jcfg.vocab])


def test_bridge_maps_attention_leaves_and_unstacks_layers():
    """The reference's default (scanned) tree stacks the unit's attention
    leaves; the port's layer j gets slice j, tail layers directly."""
    jcfg = jget("gemma3-4b-smoke")
    jp = JLM(jcfg).init(jax.random.PRNGKey(6))
    tm = build_model(get_config("gemma3-4b-smoke"), device="cpu")
    load_jax_params(tm, jax.tree_util.tree_map(np.asarray, jp))
    n_unit = jcfg.n_repeats * len(jcfg.pattern)
    for j, layer in enumerate(tm.layers):
        if j < n_unit:
            r, i = divmod(j, len(jcfg.pattern))
            want = np.asarray(jp[f"unit{i}"]["mixer"]["wq"][r])
        else:
            want = np.asarray(jp[f"tail{j - n_unit}"]["mixer"]["wq"])
        np.testing.assert_array_equal(layer.mixer.wq.detach().numpy(), want)
        assert layer.mixer.local == (jcfg.layer_specs()[j].kind
                                     == "attn_local")
