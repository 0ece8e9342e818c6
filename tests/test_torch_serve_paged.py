"""The port's paged serving engine on the CPU: paged == dense bitwise for
global and sliding-window GQA and for MLA latent pages
(``paged_impl="gather"``, greedy and
sampled, mixed traffic, chunked prefill, a churning pool), int8 pages
against bf16 (greedy), prefix attach bitwise to a cold run, greedy
streams equal to the reference model's, and the pool drained after every
run.  ``paged_impl="kernel"`` on CPU tensors runs the kernels' plain
version (fp32 online-softmax numerics), as the reference runs its Pallas
kernel in interpret mode off the TPU.

The MLA stack is the dense smoke one of tests/test_torch_mla.py
(``reduced(DEEPSEEK_V3_671B)`` with two dense MLA layers, built the same
way in both packages), named ``deepseek-v3-671b-dense-smoke`` here; the
MoE stack ``deepseek-v3-671b-smoke`` is served in
tests/test_torch_serve_moe.py."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models.transformer import DecoderLM as JLM
from repro_torch.bridge import load_jax_params
from repro_torch.configs import SamplingParams, get_config
from repro_torch.models import build_model
from repro_torch.serve import DecoderStepModel, PagedConfig, ServeEngine
from test_torch_mla import dense_mla_configs

torch.set_num_threads(1)

MLA_DENSE = "deepseek-v3-671b-dense-smoke"
ARCHS = ["smollm-360m-smoke",      # global GQA
         "gemma3-4b-smoke"]        # sliding window (ring 8) + global
ALL_ARCHS = ARCHS + [MLA_DENSE]    # + MLA latent pages
LENS = [(5, 4), (13, 7), (3, 2), (9, 5), (21, 3), (6, 6)]
SPS = [None, dict(temperature=0.9, top_k=12, seed=3), None,
       dict(temperature=1.2, top_p=0.8, seed=5),
       dict(temperature=0.7, seed=8), None]


def _configs(arch):
    """(reference config, port config) of ``arch``."""
    if arch == MLA_DENSE:
        return dense_mla_configs()
    return jget(arch), get_config(arch)


def _model(arch, seed=0, **cfg_kw):
    cfg = dataclasses.replace(_configs(arch)[1], **cfg_kw)
    return cfg, build_model(cfg, device="cpu",
                            generator=torch.Generator().manual_seed(seed))


def _sharpen(model):
    """Scale every layer's output projections by 4, in place, so that
    greedy streams of a random model do not just repeat their last token
    (see test_greedy_streams_match_reference)."""
    with torch.no_grad():
        for layer in model.layers:
            layer.mixer.wo.mul_(4.0)
            layer.mlp.w_down.mul_(4.0)
    return model


def _variant(model, **cfg_kw):
    """The same weights under another paged_impl / kv_dtype."""
    cfg = dataclasses.replace(model.cfg, **cfg_kw)
    other = build_model(cfg, device="cpu")
    other.load_state_dict(model.state_dict())
    return other


def _serve(model, layout, *, slots=3, max_len=64, chunk=8, page_size=4,
           num_pages=0, lens=LENS, sps=SPS, seed=1, prefix_cache=False,
           prompts=None):
    kw = {}
    if layout == "paged":
        kw = dict(kv_layout="paged",
                  paged=PagedConfig(page_size=page_size,
                                    num_pages=num_pages))
    sm = DecoderStepModel(model, max_len=max_len, prefill_chunk=chunk, **kw)
    eng = ServeEngine(sm, slots=slots, prefix_cache=prefix_cache)
    rng = np.random.default_rng(seed)
    reqs = []
    for i, (p, g) in enumerate(lens):
        sp = SamplingParams(**sps[i % len(sps)]) if sps[i % len(sps)] \
            else None
        prompt = rng.integers(0, model.cfg.vocab, size=p) if prompts is None \
            else prompts[i]
        reqs.append(eng.submit(prompt, max_new_tokens=g, sampling=sp))
    eng.run()
    if eng.pool is not None:
        if eng.prefix_cache is not None:
            eng.prefix_cache.clear()
        assert eng.pool.pages_in_use == 0 and eng.pool.reserved_total == 0
    return [list(r.tokens) for r in reqs], eng


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_paged_engine_bitwise_matches_dense(arch):
    """Greedy AND sampled streams under mixed traffic and chunked prefill
    are bit-identical between the paged (gather) and dense engines; page
    size 4 divides few prompt lengths, so chains end mid-page."""
    _cfg, model = _model(arch, paged_impl="gather")
    ref, _ = _serve(model, "dense")
    got, eng = _serve(model, "paged")
    assert got == ref
    assert eng.metrics()["counters"]["tokens_decoded"] > 0


def test_paged_bitwise_under_constrained_pool():
    """A pool far below dense-equivalent capacity (admissions defer, pages
    recycle constantly) yields the identical streams."""
    _cfg, model = _model("smollm-360m-smoke", paged_impl="gather")
    lens = [(9, 6), (5, 4), (12, 8), (3, 3), (7, 5)]
    ref, _ = _serve(model, "dense", max_len=32, lens=lens)
    got, _ = _serve(model, "paged", max_len=32, num_pages=8, lens=lens)
    assert got == ref


@pytest.mark.parametrize("arch", ARCHS)
def test_int8_pages_greedy_match_bf16(arch):
    """int8 per-page KV storage through the kernel impl (its plain
    version on the CPU): greedy streams equal the bf16 paged engine's, and
    a tight pool recycling codes and scales changes nothing."""
    _cfg, model = _model(arch)
    qmodel = _variant(_sharpen(model), kv_dtype="int8")
    lens = [(5, 4), (13, 6), (3, 3), (9, 5)]
    ref, _ = _serve(model, "paged", lens=lens, sps=[None])
    got, _ = _serve(qmodel, "paged", lens=lens, sps=[None])
    assert got == ref
    tight, _ = _serve(qmodel, "paged", lens=lens, sps=[None], max_len=32,
                      num_pages=8)
    assert tight == got


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_prefix_attach_bitwise(arch):
    """Requests sharing a page- and chunk-aligned 24-token prefix: the
    first admission inserts it, the next two attach and prefill only
    their tails; streams (greedy and sampled) equal a cache-off engine's
    in the same submission order."""
    _cfg, model = _model(arch, paged_impl="gather")
    rng = np.random.default_rng(7)
    p0 = rng.integers(0, model.cfg.vocab, size=24)
    prompts = [p0, np.concatenate([p0, rng.integers(0, 500, size=9)]),
               np.concatenate([p0, rng.integers(0, 500, size=3)])]
    lens = [(len(p), 6) for p in prompts]
    sps = [None, dict(temperature=0.9, top_k=12, top_p=0.9, seed=3)]
    ref, _ = _serve(model, "paged", lens=lens, sps=sps, prompts=prompts)
    got, eng = _serve(model, "paged", lens=lens, sps=sps, prompts=prompts,
                      prefix_cache=True)
    assert got == ref
    assert eng.n_prefix_hits == 2
    assert eng.n_prefix_tokens >= 2 * 24 - 8


def test_int8_latent_pages_greedy_match_bf16():
    """MLA latent pages stored as int8 with one scale per page, through the
    kernel impl (its plain version on the CPU).  At init scale (the
    reference's own deepseek case, tests/test_serve_paged.py:169) greedy
    streams equal the bf16 paged engine's, also from a tight pool; with
    the output projections x4 they equal it up to the first token where
    the bf16 engine's top-2 margin is <= 0.1 (int8 pages are a lossy
    storage quantization: a near-tie may flip)."""
    _cfg, model = _model(MLA_DENSE)
    lens = [(5, 4), (13, 6), (3, 3), (9, 5)]
    ref, _ = _serve(model, "paged", lens=lens, sps=[None])
    qmodel = _variant(model, kv_dtype="int8")
    got, _ = _serve(qmodel, "paged", lens=lens, sps=[None])
    assert got == ref
    tight, _ = _serve(qmodel, "paged", lens=lens, sps=[None], max_len=32,
                      num_pages=8)
    assert tight == got
    sharp = _sharpen(_variant(model))
    ref, eng = _serve(sharp, "paged", lens=lens, sps=[None])
    got, _ = _serve(_variant(sharp, kv_dtype="int8"), "paged", lens=lens,
                    sps=[None])
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, model.cfg.vocab, size=p) for p, _g in lens]
    for prompt, a, b in zip(prompts, ref, got):
        i = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if i is None:
            continue
        ctx = np.concatenate([prompt, a[:i]]).astype(np.int64)
        last, _ = eng.sm.prefill(ctx[None, :])
        top2 = torch.topk(last[0, :model.cfg.vocab].float(), 2).values
        assert (top2[0] - top2[1]).item() <= 0.1


def _reference_greedy(jm, jp, prompt, n_new, *, max_len, chunk):
    """The reference model's greedy stream for one request, run eagerly:
    the grid-padded chunked prefill at the engine's chunk width, then one
    decode step per token."""
    P = len(prompt)
    cw = min(chunk, 1 << max(0, P - 1).bit_length())
    padded = np.pad(prompt, (0, (-P) % cw))[None]
    cache = jm.init_cache(1, max_len)
    for s in range(0, padded.shape[1], cw):
        last, cache = jm.prefill(jp, jnp.asarray(padded[:, s:s + cw]),
                                 cache, s, length=min(P - s, cw))
    toks = [int(jnp.argmax(last[0, -1, :jm.cfg.vocab]))]
    for t in range(n_new - 1):
        logits, cache = jm.decode_step(jp, jnp.asarray([[toks[-1]]]), cache,
                                       jnp.int32(P + t))
        toks.append(int(jnp.argmax(logits[0, -1, :jm.cfg.vocab])))
    return toks


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_greedy_streams_match_reference(arch):
    """On the reference's weights (through the bridge), the port's paged
    engine — gather and kernel reads — emits the reference model's greedy
    tokens, token for token.  Every layer's output projections (attention
    ``wo`` and MLP ``w_down``) are scaled by 4 in both: at init scale the
    residual stream carries each input token's own embedding to the tied
    head, and a random model's greedy stream mostly repeats its last
    token."""
    jm = JLM(_configs(arch)[0], scan_layers=False)
    jp = jm.init(jax.random.PRNGKey(0))
    for sub in jp.values():
        if "mixer" in sub:
            sub["mixer"]["wo"] = sub["mixer"]["wo"] * 4.0
            sub["mlp"]["w_down"] = sub["mlp"]["w_down"] * 4.0
    _cfg, model = _model(arch)
    load_jax_params(model, jax.tree_util.tree_map(np.asarray, jp))
    rng = np.random.default_rng(9)
    lens = [(7, 8), (13, 6), (4, 8)]
    prompts = [rng.integers(0, model.cfg.vocab, size=p) for p, _g in lens]
    want = [_reference_greedy(jm, jp, p, g, max_len=32, chunk=8)
            for p, (_p, g) in zip(prompts, lens)]
    for impl in ("gather", "kernel"):
        got, _ = _serve(_variant(model, paged_impl=impl), "paged",
                        max_len=32, lens=lens, sps=[None], prompts=prompts)
        assert got == want, impl
