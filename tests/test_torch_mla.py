"""The port's DeepSeek multi-head latent attention against the reference's
``repro.models.attention.MLAAttention``, and a dense MLA decoder LM
against the reference's ``DecoderLM(cfg, scan_layers=False)`` run
eagerly, on the same weights through the bridge.

The LM is ``reduced(DEEPSEEK_V3_671B)`` with two dense MLA head layers
and no pattern layers, built the same way in both packages, so the MLA
comparison stands apart from the MoE layers of ``deepseek-v3-671b-smoke``
(held in tests/test_torch_moe.py and tests/test_torch_serve_moe.py).

Tolerances: the module in fp32 at 1e-5 (rope, einsums and softmax round
differently in the two frameworks); the bf16 module steps and LMs at the
repo's bf16 bound, atol = rtol = 5e-2 (test_serve_prefill.py:66), with
greedy argmax equal wherever the reference's top-2 margin > 0.1.  Pool
writes (bf16 latents, int8 codes and per-page scales) are held
bitwise."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.archs import DEEPSEEK_V3_671B as J_DEEPSEEK
from repro.configs.archs import reduced as j_reduced
from repro.configs.base import MLA as J_MLA
from repro.configs.base import LayerSpec as JLayerSpec
from repro.kernels.paged_attention import quant as jq
from repro.models.attention import MLAAttention as JMLA
from repro.models.transformer import DecoderLM as JLM
from repro_torch.bridge import load_jax_params, reference_ndim
from repro_torch.configs.archs import DEEPSEEK_V3_671B, get_config, reduced
from repro_torch.configs.base import MLA, LayerSpec
from repro_torch.models import build_model
from repro_torch.models.attention import MLAAttention

torch.set_num_threads(1)

TOL = dict(atol=5e-2, rtol=5e-2)
F32 = dict(atol=1e-5, rtol=1e-5)


def dense_mla_configs(jax_kw=None, **cfg_kw):
    """(reference config, port config) of the dense smoke MLA stack;
    ``cfg_kw`` configures the port, ``jax_kw`` (default the same) the
    reference."""
    jcfg = dataclasses.replace(j_reduced(J_DEEPSEEK), n_layers=2,
                               head_layers=(JLayerSpec(J_MLA),) * 2,
                               **(cfg_kw if jax_kw is None else jax_kw))
    cfg = dataclasses.replace(reduced(DEEPSEEK_V3_671B), n_layers=2,
                              head_layers=(LayerSpec(MLA),) * 2, **cfg_kw)
    return jcfg, cfg


def _module(seed=0, jax_kw=None, **cfg_kw):
    jcfg, cfg = dense_mla_configs(jax_kw, **cfg_kw)
    jm = JMLA(jcfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    tm = MLAAttention(cfg)
    load_jax_params(tm, jax.tree_util.tree_map(np.asarray, jp))
    return jcfg, jm, jp, tm


def _np(t):
    return t.float().numpy() if torch.is_tensor(t) else np.asarray(
        t, np.float32)


def test_config_is_the_reference_one():
    """deepseek-v3-671b carries the reference's values; the depth cut to
    its three dense head layers yields exactly those layers."""
    from repro.configs import get_config as jget
    cfg, want = get_config("deepseek-v3-671b"), jget("deepseek-v3-671b")
    for f in dataclasses.fields(want):
        if f.name not in ("scan_backend", "paged_impl"):   # port backends
            assert str(getattr(cfg, f.name)) == str(getattr(want, f.name)), \
                f.name
    cut = dataclasses.replace(cfg, n_layers=3).layer_specs()
    assert [(s.kind, s.moe, s.d_ff) for s in cut] == [(MLA, False, 18432)] * 3


def test_moe_layers_are_refused_before_allocation():
    """(The name is kept from when the port refused MoE layers.)  The full
    config now builds with its 58 MoE layers, on the meta device (the
    real one needs terabytes): 671 B parameters; its smoke build has the
    reference's layer specs, MoE layers included."""
    from repro.configs import get_config as jget
    from repro_torch.models.moe import MoEMLP
    cfg = get_config("deepseek-v3-671b")
    model = build_model(cfg, device="meta")
    moe = [isinstance(layer.mlp, MoEMLP) for layer in model.layers]
    assert moe == [False] * 3 + [True] * 58
    assert round(sum(p.numel() for p in model.parameters()) / 1e9) == 671
    assert model.layers[3].mlp.shared is not None
    smoke = build_model(get_config("deepseek-v3-671b-smoke"), device="cpu")
    want = jget("deepseek-v3-671b-smoke").layer_specs()
    assert [(s.kind, s.moe, s.d_ff) for s in smoke.cfg.layer_specs()] == \
        [(s.kind, s.moe, s.d_ff) for s in want]
    assert [isinstance(layer.mlp, MoEMLP) for layer in smoke.layers] == \
        [s.moe for s in want]


def test_launch_serve_refuses_moe_arch(capsys):
    """(The name is kept from when the launcher refused MoE archs.)  The
    launcher now serves deepseek-v3-671b's smoke stack, MoE layers
    included, from paged latent pools on the CPU."""
    from repro_torch.launch import serve
    done = serve.main(["--arch", "deepseek-v3-671b", "--smoke", "--device",
                       "cpu", "--kv-layout", "paged", "--requests", "1",
                       "--gen", "1"])
    assert len(done) == 1 and len(done[0].tokens) >= 1
    assert "engine (cpu): 1 requests" in capsys.readouterr().out


def test_forward_matches_reference():
    jcfg, jm, jp, tm = _module(seed=1)
    x = np.random.default_rng(1).standard_normal(
        (2, 13, jcfg.d_model)).astype(np.float32)
    pos = np.arange(3, 16)
    want = jm(jp, jnp.asarray(x), jnp.asarray(pos))
    with torch.inference_mode():
        got = tm(torch.from_numpy(x), torch.from_numpy(pos))
    np.testing.assert_allclose(_np(got), _np(want), **F32)


def test_chunked_prefill_matches_reference():
    """Three chunks of 6 into a latent cache of 16 (the third runs past
    it, so the reference drops writes the port never selects); the last
    chunk is grid-padded to length 4.  Outputs and caches."""
    jcfg, jm, jp, tm = _module(seed=2)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 18, jcfg.d_model)).astype(np.float32)
    jc = jm.init_cache(2, 16, jnp.float32)
    tc = tm.init_cache(2, 16, torch.float32)
    assert {k: tuple(v.shape) for k, v in tc.items()} == \
        {k: tuple(v.shape) for k, v in jc.items()}
    for s, n in ((0, 6), (6, 6), (12, 4)):
        chunk = x[:, s:s + 6]
        jy, jc = jm.prefill(jp, jnp.asarray(chunk), jc, s, length=n)
        with torch.inference_mode():
            ty, tc = tm.prefill(torch.from_numpy(chunk), tc, s, length=n)
        np.testing.assert_allclose(_np(ty)[:, :n], _np(jy)[:, :n], **F32)
        for k in ("ckv", "krope"):
            np.testing.assert_allclose(_np(tc[k]), _np(jc[k]), **F32)


def test_dense_decode_with_per_slot_positions():
    """The port's batched decode with per-slot positions equals the
    reference's scalar-position decode run per slot (its serving vmap),
    including a slot past the cache (the write clamps)."""
    jcfg, jm, jp, tm = _module(seed=3)
    rng = np.random.default_rng(3)
    B, L = 3, 12
    m = jcfg.mla
    cache = {"ckv": rng.standard_normal((B, L, m.kv_lora_rank)),
             "krope": rng.standard_normal((B, L, m.qk_rope_head_dim))}
    cache = {k: v.astype(np.float32) for k, v in cache.items()}
    x = rng.standard_normal((B, 1, jcfg.d_model)).astype(np.float32)
    pos = np.array([0, 5, 14])
    with torch.inference_mode():
        ty, tc = tm.decode(torch.from_numpy(x),
                           {k: torch.from_numpy(v) for k, v in cache.items()},
                           torch.from_numpy(pos))
    for b in range(B):
        jy, jc = jm.decode(jp, jnp.asarray(x[b:b + 1]),
                           {k: jnp.asarray(v[b:b + 1])
                            for k, v in cache.items()}, int(pos[b]))
        np.testing.assert_allclose(_np(ty)[b:b + 1], _np(jy), **F32)
        for k in ("ckv", "krope"):
            np.testing.assert_allclose(_np(tc[k])[b:b + 1], _np(jc[k]),
                                       **F32)


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("impl", ["gather", "kernel"])
def test_decode_paged_matches_reference(impl, kv_dtype):
    """One paged decode step over shuffled latent chains with an inactive
    slot: the active slots' pool writes are bitwise the reference's (the
    inactive slot writes nothing), and the output matches the
    reference's gather path (port "gather") or its Pallas kernel in
    interpret mode (port "kernel", the plain version of the CUDA
    kernels)."""
    jimpl = {"gather": "gather", "kernel": "pallas"}[impl]
    jcfg, jm, jp, tm = _module(
        seed=4, paged_impl=impl, kv_dtype=kv_dtype,
        jax_kw=dict(paged_impl=jimpl, kv_dtype=kv_dtype))
    rng = np.random.default_rng(4)
    B, P, ps, max_len = 3, 24, 4, 20
    n_chain = -(-max_len // ps)
    bt = rng.permutation(P)[:B * n_chain].reshape(B, n_chain).astype(
        np.int32)
    m = jcfg.mla
    raw = {"ckv": rng.standard_normal((P, ps, m.kv_lora_rank)),
           "krope": rng.standard_normal((P, ps, m.qk_rope_head_dim))}
    raw = {k: v.astype(np.float32) for k, v in raw.items()}
    if kv_dtype == "int8":
        jcache = {}
        for k, v in raw.items():
            s = jq.page_abs_scale(jnp.asarray(v))
            jcache[k] = jq.quantize(jnp.asarray(v), s)
            jcache[k + "_scale"] = s
        tcache = {k: torch.from_numpy(np.asarray(v).copy())
                  for k, v in jcache.items()}
    else:
        jcache = {k: jnp.asarray(v).astype(jnp.bfloat16)
                  for k, v in raw.items()}
        tcache = {k: torch.from_numpy(v).to(torch.bfloat16)
                  for k, v in raw.items()}
    spec = tm.paged_cache_spec(P, ps)
    assert {k: (tuple(v.shape), v.dtype) for k, v in tcache.items()} == \
        {k: (s, dt) for k, (s, dt) in spec.items()}
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


def _lm_pair(seed, **cfg_kw):
    jcfg, cfg = dense_mla_configs(**cfg_kw)
    jm = JLM(jcfg, scan_layers=False)
    jp = jm.init(jax.random.PRNGKey(seed))
    tm = build_model(cfg, device="cpu")
    load_jax_params(tm, jax.tree_util.tree_map(np.asarray, jp))
    return jcfg, jm, jp, tm


def _argmax_agrees(got, want):
    srt = np.sort(want, axis=-1)
    margin = srt[..., -1] - srt[..., -2]
    differ = got.argmax(-1) != want.argmax(-1)
    assert not (differ & (margin > 0.1)).any()


def test_lm_forward_prefill_and_decode_match_reference():
    """Full-sequence logits; a grid-padded chunked prefill's last logits
    and latent caches; then teacher-forced decode steps from that cache."""
    jcfg, jm, jp, tm = _lm_pair(seed=5)
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
        for k in ("ckv", "krope"):
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


def test_bridge_maps_mla_leaves():
    """The reference's head{i} MLA subtrees land on the port's layers by
    name and shape; none is stacked, so the decay mask sees the port's
    ndim."""
    jcfg, jm, jp, tm = _lm_pair(seed=6)
    for j, layer in enumerate(tm.layers):
        sub = jp[f"head{j}"]["mixer"]
        for name, p in layer.mixer.named_parameters():
            np.testing.assert_array_equal(p.detach().numpy(),
                                          np.asarray(sub[name]))
    nd = reference_ndim(tm)
    assert all(nd[n] == p.ndim for n, p in tm.named_parameters())
    assert nd["layers.0.mixer.w_uq"] == 3 and nd["layers.1.mixer.q_norm"] == 1
