"""A Mamba stack (falcon-mamba-7b-smoke: O(1) carries, dense layout)
through the port's ServeEngine on the CPU, with ``ssm_impl`` "fused" (the
plain version of the fused selective-scan kernel on CPU tensors) and
"xla" (the materializing path through the linear scan):

  * chunked prefill through ``DecoderStepModel.prefill`` (the reference's
    tests/test_serve_engine.py:527-540): the last logits agree with the
    full-sequence forward at its 0.1 bound with equal argmax, chunkings
    with each other at 2e-2, and with the reference's ``chunked_prefill``
    at the repo's bf16 bound (atol = rtol = 5e-2);
  * greedy engine streams equal the reference model's greedy streams
    (eager chunked prefill + decode on the same weights), token for token;
  * the fused prefill's carry: the fused forward kernel's plain version
    from a state ``h0`` with the final state out, chunk by chunk, is
    bitwise one pass; the LM's fused and xla prefills agree at the repo's
    bf16 bound (the xla scan runs in bf16, the fused one in fp32);
  * a request's stream does not depend on its co-batched traffic, and the
    engine refuses the paged-only features (preemption, fork, spec) on
    this dense stack with the reference's errors."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models.transformer import DecoderLM as JLM
from repro.serve import DecoderStepModel as JStepModel
from repro.serve.prefill import chunked_prefill as j_chunked_prefill
from repro_torch.bridge import load_jax_params
from repro_torch.configs import ServeConfig, get_config
from repro_torch.kernels.fused_ssm import ops as ssm_ops
from repro_torch.launch.serve import build_engine
from repro_torch.models import build_model
from repro_torch.serve import DecoderStepModel, DraftStepModel, ServeEngine

torch.set_num_threads(1)

ARCH = "falcon-mamba-7b-smoke"
TOL = dict(atol=5e-2, rtol=5e-2)
IMPLS = ["fused", "xla"]
LENS = [(13, 6), (5, 8), (21, 4), (9, 7)]


def _pair(impl, seed=0):
    jcfg = dataclasses.replace(jget(ARCH), ssm_impl=impl)
    cfg = dataclasses.replace(get_config(ARCH), ssm_impl=impl)
    jm = JLM(jcfg, scan_layers=False)
    jp = jm.init(jax.random.PRNGKey(seed))
    tm = build_model(cfg, device="cpu")
    load_jax_params(tm, jax.tree_util.tree_map(np.asarray, jp))
    return jm, jp, tm


@pytest.mark.parametrize("impl", IMPLS)
def test_chunked_prefill_carry_equivalence(impl):
    jm, jp, tm = _pair(impl)
    B, P = 2, 13
    toks = np.random.default_rng(5).integers(0, tm.cfg.vocab, size=(B, P))
    sm = DecoderStepModel(tm, max_len=24)
    jsm = JStepModel(jm, max_len=24)
    with torch.inference_mode():
        full = tm(torch.as_tensor(toks))[:, -1].float().numpy()
    V = tm.cfg.vocab
    outs = {}
    for chunk in (P, 5, 1):
        sm.prefill_chunk = chunk
        last, cache = sm.prefill(toks)
        outs[chunk] = last.float().numpy()
        np.testing.assert_allclose(outs[chunk], full, atol=0.1, rtol=0.1)
        assert (outs[chunk][:, :V].argmax(-1) == full[:, :V].argmax(-1)).all()
        assert len(cache) == tm.cfg.n_layers
        jlast, _ = j_chunked_prefill(jsm, jp, jnp.asarray(toks), chunk=chunk)
        np.testing.assert_allclose(outs[chunk], np.asarray(jlast, np.float32),
                                   **TOL)
    np.testing.assert_allclose(outs[5], outs[P], atol=2e-2, rtol=2e-2)


def _reference_greedy(jm, jp, prompt, n_new, *, chunk):
    P = len(prompt)
    cw = min(chunk, 1 << max(0, P - 1).bit_length())
    padded = np.pad(prompt, (0, (-P) % cw))[None]
    cache = jm.init_cache(1, 64)
    for s in range(0, padded.shape[1], cw):
        last, cache = jm.prefill(jp, jnp.asarray(padded[:, s:s + cw]),
                                 cache, s, length=min(P - s, cw))
    toks = [int(jnp.argmax(last[0, -1, :jm.cfg.vocab]))]
    for t in range(n_new - 1):
        logits, cache = jm.decode_step(jp, jnp.asarray([[toks[-1]]]), cache,
                                       jnp.int32(P + t))
        toks.append(int(jnp.argmax(logits[0, -1, :jm.cfg.vocab])))
    return toks


def _serve(tm, lens=LENS, slots=2, seed=3):
    eng = build_engine(tm, ServeConfig(slots=slots, max_len=64,
                                       prefill_chunk=8))
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, tm.cfg.vocab, size=p) for p, _g in lens]
    reqs = [eng.submit(p, max_new_tokens=g)
            for p, (_p, g) in zip(prompts, lens)]
    eng.run()
    assert all(r.finished for r in reqs) and not eng.active.any()
    return prompts, [list(map(int, r.tokens)) for r in reqs], eng


@pytest.mark.parametrize("impl", IMPLS)
def test_greedy_streams_match_reference(impl):
    jm, jp, tm = _pair(impl, seed=2)
    prompts, got, eng = _serve(tm)
    want = [_reference_greedy(jm, jp, p, g, chunk=8)
            for p, (_p, g) in zip(prompts, LENS)]
    assert got == want
    assert eng.metrics()["counters"]["tokens_decoded"] > 0


def test_streams_independent_of_cobatched_traffic():
    """Each request served alone emits the stream it emits in a 2-slot
    engine sharing waves with the others (O(1) carries, masked merge)."""
    _jm, _jp, tm = _pair("fused", seed=2)
    prompts, mixed, _ = _serve(tm)
    for i, (p, g) in enumerate(LENS):
        eng = ServeEngine(DecoderStepModel(tm, max_len=64, prefill_chunk=8),
                          slots=1)
        r = eng.submit(prompts[i], max_new_tokens=g)
        eng.run()
        assert list(map(int, r.tokens)) == mixed[i]


def test_dense_mamba_refuses_paged_only_features():
    _jm, _jp, tm = _pair("xla")
    eng = ServeEngine(DecoderStepModel(tm, max_len=64), slots=2,
                      policy="priority")
    r = eng.submit(np.arange(5), max_new_tokens=3)
    eng.step()
    with pytest.raises(ValueError, match="paged"):
        eng._preempt(0)
    with pytest.raises(ValueError, match="paged"):
        eng.fork(r)
    with pytest.raises(ValueError, match="needs an attention stack"):
        DecoderStepModel(tm, max_len=64, kv_layout="paged")
    drafter = DraftStepModel(tm, spec_k=2)    # a Mamba stack may draft
    with pytest.raises(ValueError, match="kv_layout='paged'"):
        ServeEngine(DecoderStepModel(tm, max_len=64), slots=2,
                    drafter=drafter, spec_k=2)
    eng.run()
    assert r.finished and eng.n_preemptions == 0


def test_fused_forward_carry_in_and_out_is_one_pass():
    """The plain version of the fused forward kernel (what the wrapper
    runs on CPU tensors) over 3 chunks, each from the last one's
    ``h_last``, gives one pass's y and final state bit for bit."""
    rng = np.random.default_rng(0)
    B, T, di, n = 2, 45, 12, 4
    dt = torch.from_numpy(rng.uniform(0.01, 0.2, (B, T, di))).float()
    x, Bm, Cm = (torch.from_numpy(rng.standard_normal(s)).float()
                 for s in ((B, T, di), (B, T, n), (B, T, n)))
    A = -torch.from_numpy(rng.uniform(0.5, 2.0, (di, n))).float()
    h_one = torch.empty(B, di, n)
    y_one, _ = ssm_ops.fused_ssm_fwd_kernel(dt, x, Bm, Cm, A, h_last=h_one)
    h, ys = torch.zeros(B, di, n), []
    for a, b in ((0, 7), (7, 40), (40, 45)):
        nxt = torch.empty(B, di, n)
        y, ent = ssm_ops.fused_ssm_fwd_kernel(
            dt[:, a:b].contiguous(), x[:, a:b].contiguous(),
            Bm[:, a:b].contiguous(), Cm[:, a:b].contiguous(), A, h0=h,
            h_last=nxt)
        assert torch.equal(ent[:, 0], h)        # entry 0 is the carry in
        ys.append(y)
        h = nxt
    assert torch.equal(torch.cat(ys, 1), y_one) and torch.equal(h, h_one)


def test_fused_and_xla_prefill_carries_agree():
    """DecoderLM.prefill in chunks of 8 (last one grid-padded) under the
    two impls, same weights: last logits and every layer's carries."""
    _jm, _jp, fused = _pair("fused", seed=4)
    xla = build_model(dataclasses.replace(fused.cfg, ssm_impl="xla"),
                      device="cpu")
    xla.load_state_dict(fused.state_dict())
    toks = np.random.default_rng(4).integers(0, fused.cfg.vocab, (2, 19))
    padded = torch.as_tensor(np.pad(toks, ((0, 0), (0, 5))))
    out = []
    for m in (fused, xla):
        cache = m.init_cache(2, 32)
        with torch.inference_mode():
            for s0 in (0, 8, 16):
                last, cache = m.prefill(padded[:, s0:s0 + 8], cache, s0,
                                        length=min(19 - s0, 8))
        out.append((last.float().numpy(), cache))
    np.testing.assert_allclose(out[0][0], out[1][0], **TOL)
    for cf, cx in zip(out[0][1], out[1][1]):
        for k in ("ssm", "conv"):
            np.testing.assert_allclose(cf[k].float().numpy(),
                                       cx[k].float().numpy(), **TOL)
