"""The port's serving stack: engine lifecycle, slot isolation, sampled
reproducibility, the sampling filters against the reference's, frame
streaming against the JAX engine (2e-5), and the launcher on the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.mingru import MinimalistNetwork as JNet
from repro.core.quant import QuantConfig as JQ
from repro.serve import MinimalistStepModel as JStreamModel
from repro.serve import ServeEngine as JEngine
from repro.serve.sampling import _filter_row
from repro_torch.bridge import load_jax_params
from repro_torch.common import resolve_device
from repro_torch.common.trace import validate_chrome_trace
from repro_torch.configs import SamplingParams, get_config
from repro_torch.core.mingru import MinimalistNetwork as TNet
from repro_torch.core.quant import QuantConfig as TQ
from repro_torch.models import build_model
from repro_torch.serve import (DecoderStepModel, MinimalistStepModel,
                               ServeEngine, Telemetry)
from repro_torch.serve.sampling import filter_logits, sample_tokens

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def lm():
    cfg = get_config("minimalist-lm-360m-smoke")
    model = build_model(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    return cfg, model


def _engine(model, slots=3, **kw):
    return ServeEngine(DecoderStepModel(model, max_len=64, prefill_chunk=8),
                       slots=slots, **kw)


def test_slot_admission_retirement_recycling(lm):
    """More requests than slots, mixed lengths: every request finishes with
    exactly its budget and every slot comes back."""
    cfg, model = lm
    eng = _engine(model)
    rng = np.random.default_rng(0)
    lens = [(5, 4), (13, 7), (3, 2), (9, 5), (21, 3), (2, 6), (7, 1)]
    reqs = [eng.submit(rng.integers(0, cfg.vocab, size=p), max_new_tokens=g)
            for p, g in lens]
    assert eng.free_mask == 0b111 and len(eng.waiting) == 7
    done = eng.run()
    assert len(done) == len(reqs) and all(r.finished for r in reqs)
    for r, (_p, g) in zip(reqs, lens):
        assert len(r.outputs) == g
        assert ((r.tokens >= 0) & (r.tokens < cfg.vocab)).all()
    assert eng.free_mask == 0b111
    assert not eng.waiting and not eng.active.any()
    assert eng.n_emitted == sum(g for _p, g in lens)
    assert eng.utilization > 0.5
    m = eng.metrics()
    assert m["counters"]["tokens_emitted"] == eng.n_emitted
    assert m["counters"]["prefill_chunks"] >= len(lens)


def test_greedy_slot_isolation_is_bitwise(lm):
    """A request's greedy tokens do not depend on its neighbours: it is
    submitted first with a unique prompt length (its admission wave is
    alone) into engines of the same slot count."""
    cfg, model = lm
    rng = np.random.default_rng(1)
    target = rng.integers(0, cfg.vocab, size=11)

    def run(neighbors):
        eng = _engine(model)
        tgt = eng.submit(target, max_new_tokens=8)
        for p, g in neighbors:
            eng.submit(p, max_new_tokens=g)
        eng.run()
        return list(tgt.tokens)

    alone = run([])
    assert alone == run([(rng.integers(0, cfg.vocab, size=5), 6),
                         (rng.integers(0, cfg.vocab, size=7), 3)])
    assert alone == run([(rng.integers(0, cfg.vocab, size=3), 9)])


def test_sampled_stream_reproducible_under_cobatching(lm):
    cfg, model = lm
    rng = np.random.default_rng(7)
    target = rng.integers(0, cfg.vocab, size=11)
    sp = SamplingParams(temperature=0.9, top_k=24, top_p=0.9, seed=123)

    def run(neighbors):
        eng = _engine(model)
        tgt = eng.submit(target, max_new_tokens=9, sampling=sp)
        for p, g, nsp in neighbors:
            eng.submit(p, max_new_tokens=g, sampling=nsp)
        eng.run()
        return list(tgt.tokens)

    a = run([(rng.integers(0, cfg.vocab, size=5), 4, None),
             (rng.integers(0, cfg.vocab, size=7), 6,
              SamplingParams(temperature=1.3, seed=9))])
    b = run([(rng.integers(0, cfg.vocab, size=3), 8,
              SamplingParams(temperature=0.7, top_k=5, seed=1)),
             (rng.integers(0, cfg.vocab, size=9), 2, None)])
    assert a == b == run([])


def test_sampling_filters_match_reference():
    rng = np.random.default_rng(3)
    V = 40
    logits = (rng.standard_normal((6, V)) * 2).astype(np.float32)
    temp = np.array([0.5, 1.0, 1.3, 0.8, 2.0, 1.0], np.float32)
    top_k = np.array([0, 5, 1, 12, 0, 40], np.int32)
    top_p = np.array([1.0, 0.9, 1.0, 0.5, 0.3, 1.0], np.float32)
    want = np.stack([np.asarray(_filter_row(jnp.asarray(logits[i]), temp[i],
                                            top_k[i], top_p[i]))
                     for i in range(6)])
    got = filter_logits(torch.from_numpy(logits), torch.from_numpy(temp),
                        torch.from_numpy(top_k), torch.from_numpy(top_p))
    got = got.numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    keep = ~np.isinf(want)
    np.testing.assert_allclose(got[keep], want[keep], rtol=1e-6)


def test_sampled_draws_follow_the_filtered_distribution():
    """Gumbel-max over the counter hash: greedy rows are argmax, top_k=1
    is argmax, and over many positions the draw frequencies match the
    softmax of the filtered logits."""
    V, n = 6, 4000
    logits = torch.tensor([[2.0, 1.0, 0.5, 0.0, -1.0, -3.0]]).repeat(n, 1)
    ones = torch.ones(n, dtype=torch.int64)
    pos = torch.arange(n, dtype=torch.int64)
    draw = sample_tokens(logits, 7 * ones, ones, 0 * ones, pos,
                         torch.ones(n), torch.zeros(n, dtype=torch.int64),
                         torch.ones(n))
    freq = np.bincount(draw.numpy(), minlength=V) / n
    np.testing.assert_allclose(freq, torch.softmax(logits[0], -1).numpy(),
                               atol=0.03)
    greedy = sample_tokens(logits[:4], ones[:4], ones[:4], ones[:4],
                           pos[:4], torch.tensor([0.0, 1.0, 1.0, 0.7]),
                           torch.tensor([0, 1, 1, 1]), torch.ones(4))
    assert greedy.tolist() == [0, 0, 0, 0]


@pytest.mark.parametrize("fused", [False, True])
def test_streaming_engine_matches_jax_engine(fused):
    """Frame streaming through the port's engine == the reference engine
    on the same parameters and frames, within 2e-5."""
    dims = (4, 8, 8, 4)
    jnet = JNet(dims, qcfg=JQ.hardware())
    jp = jnet.init(jax.random.PRNGKey(4))
    tnet = TNet(dims, qcfg=TQ.hardware())
    load_jax_params(tnet, jax.tree_util.tree_map(np.asarray, jp))
    rng = np.random.default_rng(4)
    streams = [(rng.random((T, 4)) > 0.5).astype(np.float32)
               for T in (5, 3, 6)]
    jeng = JEngine(JStreamModel(jnet, use_fused_kernel=fused), jp, slots=2)
    teng = ServeEngine(MinimalistStepModel(tnet, use_fused_kernel=fused),
                       slots=2)
    jreqs = [jeng.submit(s) for s in streams]
    treqs = [teng.submit(s) for s in streams]
    jeng.run()
    teng.run()
    for j, t in zip(jreqs, treqs):
        assert t.tokens.shape == (len(j.prompt), dims[-1])
        np.testing.assert_allclose(t.tokens, np.asarray(j.tokens), atol=2e-5)


def test_streaming_slot_isolation_and_reexport():
    net = TNet((3, 8, 8, 4), qcfg=TQ.hardware())
    net.reset_parameters(torch.Generator().manual_seed(5))
    rng = np.random.default_rng(5)
    s = (rng.random((7, 3)) > 0.5).astype(np.float32)
    sm = MinimalistStepModel(net, use_fused_kernel=True)
    eng = ServeEngine(sm, slots=2)
    a = eng.submit(s)
    eng.submit((rng.random((9, 3)) > 0.5).astype(np.float32))
    eng.run()
    solo = ServeEngine(sm, slots=2)
    b = solo.submit(s)
    solo.run()
    np.testing.assert_array_equal(a.tokens, b.tokens)
    # a parameter change re-exports the codes (no stale weights served)
    with torch.no_grad():
        net.block0.wh.mul_(-1.0)
    again = ServeEngine(sm, slots=2)
    c = again.submit(s)
    again.run()
    assert not np.array_equal(c.tokens, a.tokens)


def test_eos_cancel_and_validation(lm):
    cfg, model = lm
    eng = _engine(model, slots=2)
    rng = np.random.default_rng(6)
    probe = eng.submit(rng.integers(0, cfg.vocab, size=4), max_new_tokens=1)
    eng.run()
    eos = int(probe.tokens[0])
    stop = eng.submit(probe.prompt, max_new_tokens=10, eos_id=eos)
    gone = eng.submit(rng.integers(0, cfg.vocab, size=4), max_new_tokens=5)
    eng.cancel(gone)
    eng.run()
    assert list(stop.tokens) == [eos] and gone.cancelled
    assert gone not in eng.finished
    with pytest.raises(ValueError):
        eng.submit([], max_new_tokens=1)
    with pytest.raises(ValueError):
        eng.submit([1, 2], max_new_tokens=0)
    assert ServeEngine(DecoderStepModel(model),
                       policy="sjf").policy.name == "sjf"
    with pytest.raises(ValueError, match="policy must be one of"):
        ServeEngine(DecoderStepModel(model), policy="lifo")


def test_telemetry_trace_is_valid_and_inert(lm):
    cfg, model = lm
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, cfg.vocab, size=p) for p in (6, 9, 6)]
    runs = []
    for tel in (None, Telemetry(trace=True)):
        eng = _engine(model, slots=2, telemetry=tel)
        reqs = [eng.submit(p, max_new_tokens=4) for p in prompts]
        eng.run()
        runs.append([list(r.tokens) for r in reqs])
    assert runs[0] == runs[1]
    summary = validate_chrome_trace(eng.telemetry.trace.to_json())
    assert summary["spans"] > 0
    assert eng.metrics()["telemetry"]["counters"]["requests_finished"] == 3


def test_launch_serve_smoke_on_cpu(capsys):
    from repro_torch.launch import serve
    done = serve.main(["--smoke", "--device", "cpu", "--requests", "3",
                       "--slots", "2", "--prompt-len", "8", "--gen", "4"])
    assert len(done) == 3 and all(r.finished for r in done)
    assert "engine (cpu)" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        serve.main(["--smoke", "--device", "cpu", "--kv-layout", "paged"])


def test_entry_points_run_on_cuda_unless_told_otherwise():
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device()
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device("cuda")
        with pytest.raises(RuntimeError, match="CUDA"):
            build_model(get_config("minimalist-lm-360m-smoke"))
