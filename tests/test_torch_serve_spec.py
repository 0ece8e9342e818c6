"""Speculative decoding in the port on the CPU.

  * ``DecoderLM.verify_step_paged`` on the reference's weights and pools:
    logits within the repo's bf16 bound (atol = rtol = 5e-2, greedy argmax
    equal where the reference's top-2 margin > 0.1) of the reference's
    eager ``verify_step_paged`` (``scan_layers=False``), and bitwise the
    port's own sequential gather decode; ``commit_step_paged`` writes
    bitwise the reference's pools (accepted prefix only).
  * The engine: a greedy spec stream at k 4 is bitwise the port's
    target-only stream (global, sliding-window and MLA targets), with
    heterogeneous per-request widths, in mixed greedy/sampled traffic,
    through preemption and fork; ``spec_k == 1`` is plain decode, sampled
    rows included.
  * Every error of ``_check_spec_compat``, ``submit(spec_k=...)`` and
    ``DraftStepModel`` is the reference's message; ``heterogeneous_k``
    equals the reference's.
  * The verifier's sampling: greedy rows take the exact argmax; the
    marginal of a sampled row is the filtered target p, checked over
    40000 counter-hash streams against 4.5 binomial standard deviations
    per token (deterministic: the hash is fixed); the general-q
    ``rejection_sample_row`` likewise."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import build_model as jbuild
from repro.models.transformer import DecoderLM as JLM
from repro.serve import DecoderStepModel as JStepModel
from repro.serve import DraftStepModel as JDraft
from repro.serve import PagedConfig as JPaged
from repro.serve import ServeEngine as JEngine
from repro.serve.spec import heterogeneous_k as j_het_k
from repro_torch.bridge import load_jax_params
from repro_torch.configs import SamplingParams, get_config
from repro_torch.models import build_model
from repro_torch.serve import (DecoderStepModel, DraftStepModel, PagedConfig,
                               ServeEngine, heterogeneous_k)
from repro_torch.serve.sampling import (filter_logits, rejection_sample_row,
                                        sample_tokens, verify_tokens)
from test_torch_serve_paged import ALL_ARCHS, _configs, _sharpen

torch.set_num_threads(1)

TOL = dict(atol=5e-2, rtol=5e-2)
LENS = [(7, 9), (13, 6), (5, 12), (9, 5), (11, 8), (6, 10)]
DRAFTER = "minimalist-lm-360m-smoke"


def _np(t):
    return np.asarray(t.float() if torch.is_tensor(t) else
                      jnp.asarray(t, jnp.float32))


# ---------------------------------------------------------------------------
# verify_step_paged / commit_step_paged against the reference
# ---------------------------------------------------------------------------

def _pools(model, P, ps, rng):
    """Random page pools of every layer of ``model`` (port layout)."""
    spec = model.paged_cache_spec(P, ps)
    return [{k: rng.standard_normal(shape).astype(np.float32)
             for k, (shape, _dt) in layer.items()} for layer in spec]


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_verify_and_commit_match_reference(arch):
    jcfg, cfg = _configs(arch)
    jm = JLM(jcfg, scan_layers=False)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(dataclasses.replace(cfg, paged_impl="gather"),
                     device="cpu")
    load_jax_params(tm, jax.tree_util.tree_map(np.asarray, jp))
    rng = np.random.default_rng(3)
    B, K, P, ps, max_len = 3, 4, 30, 4, 32
    n_chain = max_len // ps
    bt = rng.permutation(P)[:B * n_chain].reshape(B, n_chain).astype(
        np.int32)
    raw = _pools(tm, P, ps, rng)
    names = [n for n, _l, _m in jm._all_layers()]
    jcache = {n: {k: jnp.asarray(v).astype(jnp.bfloat16)
                  for k, v in layer.items()} for n, layer in zip(names, raw)}

    def tpools():
        return [{k: torch.from_numpy(v).to(torch.bfloat16)
                 for k, v in layer.items()} for layer in raw]
    toks = rng.integers(0, cfg.vocab, size=(B, K))
    pos = np.array([3, 11, 25], np.int32)        # ring wraps at 8 and 16
    active = np.array([True, False, True])
    n_commit = np.array([2, 3, 4], np.int32)
    jl, jblocks = jm.verify_step_paged(
        jp, jnp.asarray(toks), jcache, jnp.asarray(pos), jnp.asarray(bt),
        jnp.asarray(active), max_len)
    jnew = jm.commit_step_paged(jcache, jblocks, jnp.asarray(pos),
                                jnp.asarray(bt), jnp.asarray(n_commit),
                                jnp.asarray(active), max_len)
    tc = tpools()
    args = [torch.from_numpy(a) for a in (pos, bt, active)]
    with torch.inference_mode():
        tl, blocks = tm.verify_step_paged(torch.from_numpy(toks), tc,
                                          args[0], args[1], args[2],
                                          max_len)
        tm.commit_step_paged(tc, blocks, args[0], args[1],
                             torch.from_numpy(n_commit), args[2], max_len)
        # the sequential gather decode at pos .. pos+K-1, on its own pools
        seq, sc = [], tpools()
        for i in range(K):
            lg, sc = tm.decode_step_paged(
                torch.from_numpy(toks[:, i:i + 1]), sc, args[0] + i,
                args[1], args[2], max_len)
            seq.append(lg)
    got, want = _np(tl)[active], _np(jl)[active]
    np.testing.assert_allclose(got, want, **TOL)
    srt = np.sort(want[..., :cfg.vocab], -1)
    differ = got[..., :cfg.vocab].argmax(-1) != want[..., :cfg.vocab].argmax(
        -1)
    assert not (differ & (srt[..., -1] - srt[..., -2] > 0.1)).any()
    np.testing.assert_array_equal(
        _np(tl)[active], _np(torch.cat(seq, 1))[active])
    for j, name in enumerate(names):
        for k in jnew[name]:
            np.testing.assert_array_equal(_np(tc[j][k]), _np(jnew[name][k]),
                                          err_msg=f"{name}.{k}")


@pytest.mark.parametrize("which", ["gqa", "window", "mla"])
def test_module_verify_and_commit_match_reference(which):
    """Each attention module's own ``verify_paged`` (fp32, K 4, a window
    layer's ring wrapping mid-wave) within 1e-5 of the reference
    module's; ``commit_paged`` writes the same rows as the reference's
    (the accepted prefix of the active slots), with values within 1e-5."""
    import test_torch_attention as ta
    import test_torch_mla as tmla

    if which == "mla":
        jcfg, jm, jp, tm = tmla._module(seed=2)
    else:
        jcfg, jm, jp, tm = ta._module("gemma3-4b-smoke", which == "window",
                                      seed=2)
    rng = np.random.default_rng(5)
    B, K, P, ps, max_len = 3, 4, 30, 4, 32
    bt = rng.permutation(P)[:B * 8].reshape(B, 8).astype(np.int32)
    raw = {k: rng.standard_normal(shape).astype(np.float32)
           for k, (shape, _dt) in tm.paged_cache_spec(P, ps).items()}
    x = rng.standard_normal((B, K, jcfg.d_model)).astype(np.float32)
    pos, n_commit = np.array([2, 6, 27], np.int32), np.array([4, 1, 3])
    active = np.array([True, True, False])
    args = (jnp.asarray(pos), jnp.asarray(bt), jnp.asarray(active))
    jy, jblock = jm.verify_paged(jp, jnp.asarray(x), {
        k: jnp.asarray(v) for k, v in raw.items()}, args[0], args[1],
        args[2], max_len)
    jnew = jm.commit_paged({k: jnp.asarray(v) for k, v in raw.items()},
                           jblock, args[0], args[1], jnp.asarray(n_commit),
                           args[2], max_len)
    tc = {k: torch.from_numpy(v.copy()) for k, v in raw.items()}
    targs = [torch.from_numpy(a) for a in (pos, bt, active)]
    with torch.no_grad():
        ty, block = tm.verify_paged(torch.from_numpy(x), tc, *targs, max_len)
        tm.commit_paged(tc, block, targs[0], targs[1],
                        torch.from_numpy(n_commit), targs[2], max_len)
    np.testing.assert_allclose(_np(ty), _np(jy), atol=1e-5, rtol=1e-5)
    for k in jnew:
        # the committed rows are fp32 projections (within 1e-5 of the
        # reference's); every other row keeps its bytes in both
        got, want = _np(tc[k]), _np(jnew[k])
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
        same = want == raw[k]
        assert (got[same] == raw[k][same]).all()
        assert ((got != raw[k]) == ~same).all(), k


def test_verify_refuses_int8_pools():
    cfg = dataclasses.replace(get_config("smollm-360m-smoke"),
                              kv_dtype="int8")
    tm = build_model(cfg, device="cpu")
    pools = tm.init_paged_cache(8, 4)
    with pytest.raises(NotImplementedError, match="bf16 pools"):
        tm.verify_step_paged(torch.zeros(1, 2, dtype=torch.int64), pools,
                             torch.zeros(1, dtype=torch.int32),
                             torch.zeros(1, 2, dtype=torch.int32),
                             torch.ones(1, dtype=torch.bool), 8)


# ---------------------------------------------------------------------------
# the engine: greedy spec streams bitwise target-only
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def drafter_model():
    return build_model(get_config(DRAFTER), device="cpu",
                       generator=torch.Generator().manual_seed(1))


_TARGETS = {}


def _target(arch):
    if arch not in _TARGETS:
        cfg = dataclasses.replace(_configs(arch)[1], paged_impl="gather")
        _TARGETS[arch] = _sharpen(build_model(
            cfg, device="cpu", generator=torch.Generator().manual_seed(0)))
    return _TARGETS[arch]


def _streams(arch, spec_k, dmodel, *, het=False, sampled=False, slots=3,
             force_drafter=False, disturb=None):
    model = _target(arch)
    sm = DecoderStepModel(model, max_len=64, kv_layout="paged",
                          paged=PagedConfig(page_size=4))
    kw = {}
    if spec_k > 1 or force_drafter:
        kw = dict(drafter=DraftStepModel(dmodel, spec_k=spec_k),
                  spec_k=spec_k)
    eng = ServeEngine(sm, slots=slots, **kw)
    rng = np.random.default_rng(0)
    reqs = []
    for i, (p, g) in enumerate(LENS):
        samp = (SamplingParams(temperature=0.8, top_k=7, top_p=0.9,
                               seed=123) if sampled and i % 2 else None)
        sk = 1 + (i % spec_k) if het and spec_k > 1 else None
        reqs.append(eng.submit(rng.integers(0, model.cfg.vocab, p),
                               max_new_tokens=g, sampling=samp, spec_k=sk))
    extra = disturb(eng, reqs) if disturb else []
    eng.run()
    assert eng.pool.pages_in_use == 0 and eng.pool.reserved_total == 0
    return [list(map(int, r.tokens)) for r in reqs + extra], eng


_BASE = {}


def _base(arch, dmodel, sampled=False):
    if (arch, sampled) not in _BASE:
        _BASE[arch, sampled] = _streams(arch, 1, dmodel, sampled=sampled)[0]
    return _BASE[arch, sampled]


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_greedy_spec_bitwise_identity(arch, drafter_model):
    spec, eng = _streams(arch, 4, drafter_model)
    assert spec == _base(arch, drafter_model)
    assert eng.n_drafts_proposed > 0
    assert eng.n_steps < eng._n_decoded
    assert 0.0 < eng.stats().accept_rate <= 1.0


def test_heterogeneous_per_slot_widths(drafter_model):
    het, eng = _streams("smollm-360m-smoke", 4, drafter_model, het=True)
    assert het == _base("smollm-360m-smoke", drafter_model)
    assert eng._req_k.max() <= 4


@pytest.mark.parametrize("arch", ["smollm-360m-smoke", "gemma3-4b-smoke"])
def test_mixed_greedy_sampled_traffic(arch, drafter_model):
    """Greedy rows of a mixed batch stay bitwise the target-only rows."""
    base = _base(arch, drafter_model, sampled=True)
    spec, _ = _streams(arch, 4, drafter_model, sampled=True)
    for i in range(0, len(base), 2):
        assert spec[i] == base[i]


def test_spec_k1_engine_is_plain_decode(drafter_model):
    """A width-1 wave tests no draft: its only draw is the unsalted
    sequential one, so even sampled rows equal plain decode."""
    base = _base("smollm-360m-smoke", drafter_model, sampled=True)
    one, eng = _streams("smollm-360m-smoke", 1, drafter_model, sampled=True,
                        force_drafter=True)
    assert eng.drafter is not None and one == base


def test_spec_through_preemption_and_fork(drafter_model):
    """The drafter's carries travel with a preempted request and are
    copied into a fork child: greedy streams stay bitwise."""
    def disturb(eng, reqs):
        eng.step()
        kids = eng.fork(reqs[0])
        eng.step()
        for s in np.flatnonzero(eng.active):
            eng._preempt(int(s))
        assert eng.n_preemptions > 0
        return kids
    got, eng = _streams("smollm-360m-smoke", 4, drafter_model, slots=8,
                        disturb=disturb)
    base = _base("smollm-360m-smoke", drafter_model)
    assert got[:len(base)] == base
    assert eng.n_forks == 1 and got[-1] == base[0]


# ---------------------------------------------------------------------------
# errors: the reference's messages
# ---------------------------------------------------------------------------

def _error(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def test_engine_spec_errors_match_reference(drafter_model):
    jd = jbuild(jget(DRAFTER))
    jdp = jd.init(jax.random.PRNGKey(1))

    def target(arch, **kw):
        jcfg = dataclasses.replace(jget(arch), paged_impl="gather", **kw)
        cfg = dataclasses.replace(get_config(arch), paged_impl="gather",
                                  **kw)
        jm = jbuild(jcfg)
        return jm, jm.init(jax.random.PRNGKey(0)), build_model(cfg,
                                                               device="cpu")

    def paged(j, m, **kw):
        mk = JStepModel if j else DecoderStepModel
        pc = JPaged if j else PagedConfig
        return mk(m, max_len=64, kv_layout="paged",
                  paged=pc(page_size=4), **kw)

    def both(arch, *, k=4, dk=4, dense=False, prefix=False, vocab=None,
             **kw):
        jm, jp, tm = target(arch, **kw)
        dcfg = jget(DRAFTER)
        tdm = drafter_model
        jdm = jd
        if vocab:
            jdm = jbuild(dataclasses.replace(dcfg, vocab=vocab))
            tdm = build_model(dataclasses.replace(get_config(DRAFTER),
                                                  vocab=vocab), device="cpu")
        jsm = JStepModel(jm, max_len=64) if dense else paged(True, jm)
        tsm = DecoderStepModel(tm, max_len=64) if dense else paged(False, tm)
        return (_error(lambda: JEngine(jsm, jp, slots=2, prefix_cache=prefix,
                                       drafter=JDraft(jdm, spec_k=dk),
                                       drafter_params=jdp, spec_k=k)),
                _error(lambda: ServeEngine(tsm, slots=2, prefix_cache=prefix,
                                           drafter=DraftStepModel(
                                               tdm, spec_k=dk), spec_k=k)))

    cases = [both("smollm-360m-smoke", k=2),                 # K mismatch
             both("smollm-360m-smoke", dense=True),          # dense target
             both("smollm-360m-smoke", prefix=True),         # prefix cache
             both("smollm-360m-smoke", vocab=300),           # vocab
             both("smollm-360m-smoke", kv_dtype="int8"),     # int8 pools
             both("gemma3-4b-smoke", k=9, dk=9)]             # ring of 8
    for ref, got in cases:
        assert got == ref
    jm, jp, tm = target("smollm-360m-smoke")
    assert _error(lambda: ServeEngine(paged(False, tm), slots=2, spec_k=4)) \
        == _error(lambda: JEngine(paged(True, jm), jp, slots=2, spec_k=4))


def test_submit_spec_k_errors_match_reference(drafter_model):
    jm = jbuild(dataclasses.replace(jget("smollm-360m-smoke"),
                                    paged_impl="gather"))
    jd = jbuild(jget(DRAFTER))
    jeng = JEngine(JStepModel(jm, max_len=64, kv_layout="paged",
                              paged=JPaged(page_size=4)),
                   jm.init(jax.random.PRNGKey(0)), slots=2,
                   drafter=JDraft(jd, spec_k=4),
                   drafter_params=jd.init(jax.random.PRNGKey(1)), spec_k=4)
    teng = ServeEngine(DecoderStepModel(_target("smollm-360m-smoke"),
                                        max_len=64, kv_layout="paged",
                                        paged=PagedConfig(page_size=4)),
                       slots=2, drafter=DraftStepModel(drafter_model,
                                                       spec_k=4), spec_k=4)
    prompt = np.arange(4)
    for bad in [0, -1, 5, 1.5, "wide", True]:
        assert _error(lambda: teng.submit(prompt, max_new_tokens=2,
                                          spec_k=bad)) == \
            _error(lambda: jeng.submit(prompt, max_new_tokens=2,
                                       spec_k=bad))
    assert not teng.waiting
    ok = teng.submit(prompt, max_new_tokens=2, spec_k=3)
    assert ok.uid == 0 and ok.spec_k == 3
    teng.run()


def test_draft_model_errors_match_reference(drafter_model):
    jd = jbuild(jget(DRAFTER))
    assert _error(lambda: DraftStepModel(drafter_model, spec_k=0)) == \
        _error(lambda: JDraft(jd, spec_k=0))
    attn = build_model(get_config("smollm-360m-smoke"), device="cpu")
    jattn = jbuild(jget("smollm-360m-smoke"))
    assert _error(lambda: DraftStepModel(attn, spec_k=2)) == \
        _error(lambda: JDraft(jattn, spec_k=2))


def test_heterogeneous_k_matches_reference():
    rng = np.random.default_rng(0)
    for _ in range(20):
        req = rng.integers(-1, 10, 7).astype(np.int32)
        rem = rng.integers(-1, 10, 7)
        k = int(rng.integers(1, 8))
        got = heterogeneous_k(req, rem, k)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, np.asarray(j_het_k(req, rem, k)))


# ---------------------------------------------------------------------------
# the verifier's sampling
# ---------------------------------------------------------------------------

def _knobs(n, seed0=0, temperature=1.0, top_k=0, top_p=1.0):
    t = torch.full((n,), temperature)
    return dict(seed=torch.arange(seed0, seed0 + n, dtype=torch.int64),
                uid=torch.full((n,), 7, dtype=torch.int64),
                uid_hi=torch.zeros(n, dtype=torch.int64),
                temperature=t, top_k=torch.full((n,), top_k),
                top_p=torch.full((n,), top_p))


@pytest.mark.parametrize("filt", [dict(), dict(top_k=4),
                                  dict(top_p=0.8, temperature=0.7)])
def test_verifier_marginal_is_target(filt):
    """Row 0 of a width-2 wave tests the draft d: its emitted token's
    marginal over 40000 hash streams is the filtered p, whatever d is."""
    V, N = 6, 40000
    logits = torch.tensor([1.2, 0.3, -0.5, 0.9, 0.0, -1.4])
    kn = _knobs(N, **filt)
    p = torch.softmax(filter_logits(logits.expand(N, V), kn["temperature"],
                                    kn["top_k"], kn["top_p"]), -1)[0]
    for d in (0, 2, 5):
        toks = torch.stack([torch.zeros(N, dtype=torch.int64),
                            torch.full((N,), d)], 1)
        em, ne = verify_tokens(logits.expand(N, 2, V), toks,
                               torch.full((N,), 2), kn["seed"], kn["uid"],
                               kn["uid_hi"], torch.full((N,), 10),
                               kn["temperature"], kn["top_k"], kn["top_p"])
        freq = torch.bincount(em[:, 0].long(), minlength=V).double() / N
        sd = torch.sqrt(p.double() * (1 - p.double()) / N)
        assert (torch.abs(freq - p.double()) <= 4.5 * sd + 1e-12).all(), \
            (d, freq, p)
        accepted = (ne == 2).double().mean()
        pd = p[d].item()
        assert abs(accepted - pd) <= 4.5 * np.sqrt(pd * (1 - pd) / N)


def test_verifier_greedy_rows_and_full_acceptance():
    """Greedy rows accept a draft iff it is the fp32 argmax and correct
    to the argmax; a fully accepted sampled row's bonus token is the
    plain sequential draw at its position."""
    rng = np.random.default_rng(2)
    B, K, V = 5, 4, 11
    lg = torch.from_numpy(rng.standard_normal((B, K, V)).astype(np.float32))
    am = lg.argmax(-1)
    toks = torch.cat([torch.zeros(B, 1, dtype=torch.int64), am[:, :K - 1]],
                     1)
    toks[1, 2] = (am[1, 1] + 1) % V                # reject at row 1
    kn = _knobs(B, temperature=0.0)
    k_slot = torch.tensor([4, 4, 2, 1, 3])
    pos = torch.arange(B) + 5
    em, ne = verify_tokens(lg, toks, k_slot, kn["seed"], kn["uid"],
                           kn["uid_hi"], pos, kn["temperature"],
                           kn["top_k"], kn["top_p"])
    assert ne.tolist() == [4, 2, 2, 1, 3]
    for b in range(B):
        assert em[b, :ne[b]].tolist() == am[b, :ne[b]].tolist()
    em2, ne2 = verify_tokens(lg, toks, k_slot, kn["seed"], kn["uid"],
                             kn["uid_hi"], pos, kn["temperature"],
                             kn["top_k"], kn["top_p"], greedy_only=True)
    assert torch.equal(ne, ne2)
    for b in range(B):
        assert torch.equal(em[b, :ne[b]], em2[b, :ne2[b]])
    # sampled, width 1: the bonus draw is sample_tokens' draw at pos+1
    ks = _knobs(B, temperature=0.9, top_k=5)
    em, ne = verify_tokens(lg[:, :1], toks[:, :1], torch.ones(B), ks["seed"],
                           ks["uid"], ks["uid_hi"], pos, ks["temperature"],
                           ks["top_k"], ks["top_p"])
    want = sample_tokens(lg[:, 0], ks["seed"], ks["uid"], ks["uid_hi"],
                         pos + 1, ks["temperature"], ks["top_k"],
                         ks["top_p"])
    assert ne.tolist() == [1] * B and torch.equal(em[:, 0], want)


def test_rejection_sample_row_marginal():
    """General q: accept with min(1, p/q), else the normalized residual;
    the marginal over 6000 hash streams is p within 4.5 sd."""
    V, N = 4, 6000
    p_logits = torch.tensor([0.5, -0.3, 1.0, 0.1])
    q_logits = torch.tensor([1.5, 0.2, -0.4, 0.0])
    p = torch.softmax(p_logits, -1).double()
    counts = torch.zeros(V, dtype=torch.float64)
    q = torch.softmax(q_logits, -1)
    for s in range(N):
        d = int(torch.multinomial(q, 1, generator=torch.Generator()
                                  .manual_seed(s)))
        tok, _acc = rejection_sample_row(p_logits, q_logits, d, s, 3, 0, 9)
        counts[int(tok)] += 1
    sd = torch.sqrt(p * (1 - p) / N)
    assert (torch.abs(counts / N - p) <= 4.5 * sd).all(), counts / N
