"""MoE stacks through the port's ServeEngine on the CPU, against the
reference on the same weights (through the bridge), the same prompts and
greedy decoding:

  * qwen3-moe-30b-a3b-smoke (GQA + MoE), dense and paged (bf16 pages,
    ``paged_impl="gather"``); deepseek-v3-671b-smoke (MLA, dense head
    layer, MoE with a shared expert), paged; jamba-1.5-large-398b cut to
    one pattern unit of 8 layers (Mamba, attention, dense and MoE MLPs;
    the reference marks its 16-layer smoke stack's serving tests slow),
    dense and paged — the hybrid paged layout: attention pages beside
    per-slot Mamba carries.  The port's engine streams equal, token for
    token, the reference model's greedy streams run eagerly (its chunked
    prefill at the engine's chunk width, then one decode step a token;
    the rule of tests/test_torch_serve_paged.py), and the reference's
    own engine's streams under the margin rule (equal up to the first
    token where the port's top-2 margin is <= 0.1) for qwen3 and
    deepseek.  The reference's engine is jitted, and XLA keeps bf16
    intermediates in fp32 inside its fused programs (ROADMAP, standing
    contracts), so its logits are not the eager model's: on the jamba
    unit its stream parts from the eager one at a token whose margin is
    0.109.  Every layer's output projections (attention ``wo``, Mamba
    ``w_out``, the dense, expert and shared ``w_down``) are x4 in both,
    or random greedy streams repeat one token;
  * port only, bitwise: a request's stream does not depend on its
    co-batched traffic or on the prefill chunk (``dispatch="auto"``:
    per-request prefill, gather-GEMM decode); ``moe_dispatch`` and the
    pooled warning; a jamba request preempted under ``priority`` and
    resumed, and a jamba fork, equal undisturbed streams; a speculative
    run on the qwen3 target equals its target-only streams."""
import dataclasses
import warnings

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models.transformer import DecoderLM as JLM
from repro.serve import DecoderStepModel as JStepModel
from repro.serve import PagedConfig as JPagedConfig
from repro.serve import ServeEngine as JEngine
from repro_torch.bridge import load_jax_params
from repro_torch.configs import SamplingParams, get_config
from repro_torch.models import build_model
from repro_torch.serve import (DecoderStepModel, DraftStepModel,
                               PagedConfig, ServeEngine)
from test_torch_serve_paged import _reference_greedy

torch.set_num_threads(1)

QWEN = "qwen3-moe-30b-a3b-smoke"
DEEPSEEK = "deepseek-v3-671b-smoke"
JAMBA = "jamba-1.5-large-398b-smoke"
LENS = [(7, 6), (13, 5), (4, 6), (10, 4)]
MAX_LEN, CHUNK, PAGE = 32, 8, 4


def _configs(arch):
    """(reference config, port config); jamba cut to one pattern unit."""
    jcfg, cfg = jget(arch), get_config(arch)
    if arch == JAMBA:
        jcfg = dataclasses.replace(jcfg, n_layers=8)
        cfg = dataclasses.replace(cfg, n_layers=8)
    return jcfg, dataclasses.replace(cfg, paged_impl="gather")


def _sharpen_tree(jp):
    for sub in jp.values():
        if not isinstance(sub, dict) or "mixer" not in sub:
            continue
        for key in ("wo", "w_out"):
            if key in sub["mixer"]:
                sub["mixer"][key] = sub["mixer"][key] * 4.0
        mlp = sub.get("mlp", {})
        if "w_down" in mlp:
            mlp["w_down"] = mlp["w_down"] * 4.0
        if "shared" in mlp:
            mlp["shared"]["w_down"] = mlp["shared"]["w_down"] * 4.0
    return jp


@pytest.fixture(scope="module", params=[QWEN, DEEPSEEK, JAMBA])
def pair(request):
    """(arch, reference model, its params, the port model on them, the
    reference's eager greedy streams of ``_prompts``)."""
    arch = request.param
    jcfg, cfg = _configs(arch)
    jm = JLM(jcfg, scan_layers=False)
    jp = _sharpen_tree(jm.init(jax.random.PRNGKey(0)))
    tm = build_model(cfg, device="cpu")
    load_jax_params(tm, jax.tree_util.tree_map(np.asarray, jp))
    prompts = _prompts(cfg.vocab)
    want = [_reference_greedy(jm, jp, p, g, max_len=MAX_LEN, chunk=CHUNK)
            for p, (_p, g) in zip(prompts, LENS)]
    return arch, jm, jp, tm, want


def _prompts(vocab, lens=LENS, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=p) for p, _g in lens]


def _ref_streams(jm, jp, prompts, gens, layout):
    kw = {}
    if layout == "paged":
        kw = dict(kv_layout="paged", paged=JPagedConfig(page_size=PAGE))
    sm = JStepModel(jm, max_len=MAX_LEN, prefill_chunk=CHUNK, **kw)
    eng = JEngine(sm, jp, slots=3)
    reqs = [eng.submit(p, max_new_tokens=g) for p, g in zip(prompts, gens)]
    eng.run()
    return [list(map(int, r.tokens)) for r in reqs]


def _engine(model, layout="paged", *, slots=3, chunk=CHUNK, **kw):
    paged = {}
    if layout == "paged":
        paged = dict(kv_layout="paged", paged=PagedConfig(page_size=PAGE))
    sm = DecoderStepModel(model, max_len=MAX_LEN, prefill_chunk=chunk,
                          **paged)
    return ServeEngine(sm, slots=slots, **kw)


def _drain(eng, reqs):
    eng.run()
    if eng.pool is not None:
        assert eng.pool.pages_in_use == 0 and eng.pool.reserved_total == 0
    return [list(map(int, r.tokens)) for r in reqs]


def _streams(model, prompts, gens, layout="paged", **kw):
    eng = _engine(model, layout, **kw)
    reqs = [eng.submit(p, max_new_tokens=g) for p, g in zip(prompts, gens)]
    return _drain(eng, reqs), eng


def _margin_rule(sm, vocab, prompts, got, want):
    """``got`` equals ``want`` per stream up to the first token where the
    top-2 margin of ``sm`` (a fresh prefill of the prompt and ``want``'s
    tokens so far) is <= 0.1."""
    for prompt, a, b in zip(prompts, got, want):
        i = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if i is None:
            assert len(a) == len(b)
            continue
        ctx = np.concatenate([prompt, b[:i]]).astype(np.int64)
        last, _ = sm.prefill(ctx[None, :])
        top2 = torch.topk(last[0, :vocab].float(), 2).values
        assert (top2[0] - top2[1]).item() <= 0.1, (i, a, b)


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_greedy_streams_match_reference(pair, layout):
    arch, jm, jp, tm, want = pair
    prompts = _prompts(tm.cfg.vocab)
    gens = [g for _p, g in LENS]
    got, eng = _streams(tm, prompts, gens, layout)
    assert got == want
    assert len({t for s in got for t in s}) > 2      # streams discriminate
    if arch != JAMBA:
        _margin_rule(eng.sm, tm.cfg.vocab, prompts, got,
                     _ref_streams(jm, jp, prompts, gens, layout))


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_streams_invariant_to_cobatching_and_chunk(pair, layout):
    """A target request alone, beside two others, and prefilled at chunk
    4 and 16: the same stream, bit for bit."""
    tm = pair[3]
    target, *others = _prompts(tm.cfg.vocab, seed=5)
    alone, _ = _streams(tm, [target], [6], layout)
    mixed, _ = _streams(tm, [target] + others[:2], [6, 4, 3], layout)
    assert mixed[0] == alone[0]
    for chunk in (4, 16):
        again, _ = _streams(tm, [target], [6], layout, chunk=chunk)
        assert again[0] == alone[0], chunk


def test_moe_dispatch_and_pooled_warning():
    """``moe_dispatch`` is None for a dense stack, the config's knob for
    an MoE one (warning-free under "auto"); "pooled" warns that served
    outputs vary with traffic, as the reference's adapter does."""
    cfg = get_config(QWEN)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        sm = DecoderStepModel(build_model(cfg, device="cpu"), max_len=32)
    assert sm.moe_dispatch == "auto"
    dense = build_model(get_config("smollm-360m-smoke"), device="cpu")
    assert DecoderStepModel(dense, max_len=32).moe_dispatch is None
    pooled = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, dispatch="pooled"))
    with pytest.warns(UserWarning, match="pooled"):
        sm = DecoderStepModel(build_model(pooled, device="cpu"),
                              max_len=32)
    assert sm.moe_dispatch == "pooled"


@pytest.fixture(scope="module")
def jamba():
    _jcfg, cfg = _configs(JAMBA)
    model = build_model(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for layer in model.layers:
            for w in ("wo", "w_out"):
                if hasattr(layer.mixer, w):
                    getattr(layer.mixer, w).mul_(4.0)
            layer.mlp.w_down.mul_(4.0)
    return model


def test_hybrid_paged_layout_keeps_mamba_carries_per_slot(jamba):
    """The paged state of a hybrid stack: page pools for its attention
    layer, (slots, ...) carries for its Mamba layers; prefix caching is
    refused (a carry cannot be rebuilt from pages)."""
    eng = _engine(jamba)
    pools = jamba.paged_layer_names()
    assert pools == {4}
    for j, sub in enumerate(eng.state):
        if j in pools:
            assert set(sub) == {"k", "v"}
        else:
            assert set(sub) == {"ssm", "conv"}
            assert {v.shape[0] for v in sub.values()} == {3}
    with pytest.raises(ValueError, match="all-attention"):
        _engine(jamba, prefix_cache=True)


def test_hybrid_preempt_resume_bitwise(jamba):
    """Two requests decode, then a priority-1 arrival preempts one of
    them from a 2-slot engine: the victim's Mamba carries travel in its
    snapshot beside its pages, and every stream (greedy and sampled)
    equals an undisturbed run's.  Inactive slots keep their carries."""
    prompts = _prompts(jamba.cfg.vocab, [(6, 10), (9, 9), (5, 5)], seed=3)
    gens = [10, 9, 5]
    sps = [None, SamplingParams(temperature=0.9, top_k=20, seed=4), None]
    ref_eng = _engine(jamba, slots=3)
    ref = _drain(ref_eng, [ref_eng.submit(p, max_new_tokens=g, sampling=s)
                           for p, g, s in zip(prompts, gens, sps)])
    eng = _engine(jamba, slots=2, policy="priority")
    reqs = [eng.submit(p, max_new_tokens=g, sampling=s)
            for p, g, s in zip(prompts[:2], gens[:2], sps[:2])]
    eng.step()
    eng.step()
    reqs.append(eng.submit(prompts[2], max_new_tokens=gens[2], priority=1))
    got = _drain(eng, reqs)
    assert eng.n_preemptions >= 1
    # the snapshot bytes count the carry rows too
    carry = sum(v[0].numel() * v.element_size()
                for j, sub in enumerate(eng.state)
                if j not in jamba.paged_layer_names() for v in sub.values())
    assert eng.n_snapshot_bytes > eng.n_preemptions * carry
    assert got == ref


def test_hybrid_fork_bitwise(jamba):
    """A jamba request forked after two steps into two greedy children:
    the children copy its Mamba carries and share its pages, and all
    three streams equal the undisturbed parent's."""
    prompt = _prompts(jamba.cfg.vocab, [(7, 8)], seed=6)[0]
    ref, _ = _streams(jamba, [prompt], [8])
    eng = _engine(jamba, slots=3)
    parent = eng.submit(prompt, max_new_tokens=8)
    eng.step()
    eng.step()
    kids = eng.fork(parent, 2)
    streams = _drain(eng, [parent] + kids)
    assert streams[0] == ref[0]
    for kid in streams[1:]:
        assert kid == ref[0][len(ref[0]) - len(kid):]
    assert eng.n_forks == 2


def test_spec_decoding_on_moe_target_equals_target_only():
    """qwen3-moe-smoke as the target of the minGRU drafter at spec_k 4:
    greedy streams equal the target-only streams on the gather read (the
    verify routes its (B, K) tokens through the gather-GEMM decode)."""
    cfg = dataclasses.replace(get_config(QWEN), paged_impl="gather")
    model = build_model(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for layer in model.layers:
            layer.mixer.wo.mul_(4.0)
            layer.mlp.w_down.mul_(4.0)
    prompts = _prompts(cfg.vocab, seed=7)
    gens = [g for _p, g in LENS]
    ref, _ = _streams(model, prompts, gens)
    dmodel = build_model(get_config("minimalist-lm-360m-smoke"),
                         device="cpu",
                         generator=torch.Generator().manual_seed(1))
    drafter = DraftStepModel(dmodel, spec_k=4, prefill_chunk=CHUNK)
    got, eng = _streams(model, prompts, gens, drafter=drafter, spec_k=4)
    assert got == ref
    assert eng.stats().accept_rate is not None
