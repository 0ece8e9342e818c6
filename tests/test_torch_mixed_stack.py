"""Stacks that mix minGRU and attention layers (the reference's
``_make_mixer`` builds any pattern; no arch of the table mixes them): a
smoke config at minimalist-lm-360m-smoke's widths with the pattern
(minGRU, attention) twice, built the same way in both packages and
loaded through ``bridge.load_jax_params``.

  * the full-sequence logits against the reference's eager
    ``DecoderLM(cfg, scan_layers=False)`` at the module tests' fp32 bound
    (atol = rtol = 1e-5), both packages computing in fp32 (the
    embedding's bf16 rows as they are);
  * the loss and one step's gradients at tests/test_torch_lm_grads.py's
    bounds (bf16 compute: loss within 2e-2, every gradient with cosine
    > 0.99 and relative L2 < 5e-2);
  * the cache layouts: a ``{"h": (B, d)}`` carry for each minGRU layer
    beside the attention layers' dense caches or page pools;
  * greedy streams from dense slots and from paged pools (the gather and
    the kernel reads) against the reference model's, under the margin
    rule (equal up to the first token whose top-2 margin is <= 0.1), with
    every layer's output projections x4 in both packages."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs.base import ATTN as J_ATTN
from repro.configs.base import MINGRU as J_MINGRU
from repro.configs.base import LayerSpec as JLayerSpec
from repro.models.transformer import DecoderLM as JLM
from repro_torch.bridge import load_jax_params
from repro_torch.configs import get_config
from repro_torch.configs.base import ATTN, MINGRU, LayerSpec
from repro_torch.models import build_model
from repro_torch.models.transformer import DecoderLM
from repro_torch.serve import DecoderStepModel, PagedConfig, ServeEngine
from test_torch_serve_moe import _margin_rule
from test_torch_serve_paged import _reference_greedy

torch.set_num_threads(1)

BASE = "minimalist-lm-360m-smoke"
LENS = [(7, 8), (13, 6), (4, 8), (10, 7)]
F32 = dict(atol=1e-5, rtol=1e-5)


def _configs(**kw):
    """(reference config, port config): minGRU, attention, twice; ``kw``
    sets port-only knobs."""
    j = dataclasses.replace(jget(BASE), n_layers=4, pattern=(
        JLayerSpec(J_MINGRU), JLayerSpec(J_ATTN)))
    t = dataclasses.replace(get_config(BASE), n_layers=4, pattern=(
        LayerSpec(MINGRU), LayerSpec(ATTN)), **kw)
    return j, t


def _pair(seed=0, sharpen=False, **kw):
    jcfg, cfg = _configs(**kw)
    jm = JLM(jcfg, scan_layers=False)
    jp = jm.init(jax.random.PRNGKey(seed))
    if sharpen:
        for sub in jp.values():
            if isinstance(sub, dict) and "mlp" in sub:
                sub["mlp"]["w_down"] = sub["mlp"]["w_down"] * 4.0
                if "wo" in sub["mixer"]:
                    sub["mixer"]["wo"] = sub["mixer"]["wo"] * 4.0
    tm = build_model(cfg, device="cpu")
    load_jax_params(tm, jax.tree_util.tree_map(np.asarray, jp))
    return jm, jp, tm


def test_builds_the_pattern_and_its_caches():
    _jm, _jp, tm = _pair()
    kinds = [type(l.mixer).__name__ for l in tm.layers]
    assert kinds == ["MinGRUMixer", "GQAAttention"] * 2
    assert not tm.stacked_cache
    cache = tm.init_cache(3, 16)
    assert set(cache[0]) == {"h"} and cache[0]["h"].shape == (3, 64)
    assert cache[1]["k"].shape == (3, 16, 2, 16)
    assert tm.cache_axes()[0] == {"h": ("batch", "mlp")}
    assert tm.paged_layer_names() == {1, 3}
    pools = tm.init_paged_cache(10, 4, batch=3)
    assert pools[0]["h"].shape == (3, 64)
    assert pools[1]["k"].shape == (10, 4, 2, 16)


def test_fp32_logits_match_reference(monkeypatch):
    jm, jp, tm = _pair(seed=1)
    monkeypatch.setattr(JLM, "compute_dtype", lambda self: jnp.float32)
    monkeypatch.setattr(DecoderLM, "compute_dtype",
                        property(lambda self: torch.float32))
    toks = np.random.default_rng(1).integers(0, 512, size=(2, 12))
    want = np.asarray(jm(jp, jnp.asarray(toks)), np.float32)
    with torch.inference_mode():
        got = tm(torch.as_tensor(toks))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **F32)


def test_loss_and_grads_match_reference():
    jm, jp, tm = _pair(seed=2)
    toks = np.random.default_rng(2).integers(0, 512, size=(4, 33))
    b = {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
    b["labels"][0, :5] = -1
    (jl, jmet), jg = jax.value_and_grad(jm.loss, has_aux=True)(
        jp, {k: jnp.asarray(v) for k, v in b.items()})
    loss, met = tm.loss({k: torch.as_tensor(v) for k, v in b.items()})
    loss.backward()
    assert abs(loss.item() - float(jl)) < 2e-2
    assert int(met["tokens"]) == int(jmet["tokens"]) == 4 * 32 - 5
    want = build_model(tm.cfg, device="cpu")
    load_jax_params(want, jax.tree_util.tree_map(
        lambda g: np.asarray(g, np.float32), jg))
    for (name, p), (_, q) in zip(tm.named_parameters(),
                                 want.named_parameters()):
        a, w = p.grad.double().flatten(), q.detach().double().flatten()
        cos = float(a @ w / (a.norm() * w.norm()))
        rel = float((a - w).norm() / w.norm())
        assert cos > 0.99 and rel < 5e-2, (name, cos, rel)


@functools.lru_cache(maxsize=1)
def _reference_streams():
    """The prompts and the reference model's greedy streams (eager)."""
    jm, jp, _tm = _pair(seed=3, sharpen=True)
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, 512, size=p) for p, _g in LENS]
    return prompts, [_reference_greedy(jm, jp, p, g, max_len=64, chunk=8)
                     for p, (_p, g) in zip(prompts, LENS)]


@pytest.mark.parametrize("layout,impl", [("dense", "kernel"),
                                         ("paged", "gather"),
                                         ("paged", "kernel")])
def test_greedy_streams_match_reference(layout, impl):
    prompts, want = _reference_streams()
    _jm, _jp, tm = _pair(seed=3, sharpen=True, paged_impl=impl)
    sm = DecoderStepModel(tm, max_len=64, prefill_chunk=8, kv_layout=layout,
                          paged=PagedConfig(page_size=4)
                          if layout == "paged" else None)
    eng = ServeEngine(sm, slots=3)
    reqs = [eng.submit(p, max_new_tokens=g) for p, (_p, g) in
            zip(prompts, LENS)]
    eng.run()
    got = [list(map(int, r.tokens)) for r in reqs]
    assert len({t for s in want for t in s}) > 8    # streams discriminate
    _margin_rule(sm, 512, prompts, got, want)
    if layout == "paged":
        assert eng.pool.pages_in_use == 0
        assert set(eng.state[0]) == {"h"} and eng.state[0]["h"].shape[0] == 3
