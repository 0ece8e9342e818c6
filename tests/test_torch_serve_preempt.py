"""Preemption and fork in the port's engine on the CPU: a preempted-then-
resumed stream is bitwise the undisturbed port stream (greedy and
sampled) for global GQA, sliding-window GQA and MLA latent pages on the
gather read, and for int8 pages (codes and scales travel together); the
policy-driven evictions (priority blocked on slots and on pages, edf)
move no bytes; fork children reproduce their parent and survive their
own preemption; cancel drops a snapshot; the greedy streams with
preemption equal the reference model's (the rule of
tests/test_torch_serve_paged.py); and the telemetry carries the
preempt / resume / fork spans the reference's does."""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from repro.models.transformer import DecoderLM as JLM
from repro_torch.bridge import load_jax_params
from repro_torch.common.trace import validate_chrome_trace
from repro_torch.configs import SamplingParams
from repro_torch.models import build_model
from repro_torch.serve import (DecoderStepModel, PagedConfig, ServeEngine,
                               Telemetry)
from test_torch_serve_paged import (ALL_ARCHS, MLA_DENSE, _configs,
                                    _reference_greedy, _sharpen)

torch.set_num_threads(1)

LENS = [(5, 8), (9, 6), (3, 7)]
SPS = [None, dict(temperature=0.9, top_k=12, seed=3),
       dict(temperature=1.2, top_p=0.8, seed=5)]


def _model(arch, **cfg_kw):
    cfg = dataclasses.replace(_configs(arch)[1], paged_impl="gather",
                              **cfg_kw)
    return _sharpen(build_model(cfg, device="cpu",
                                generator=torch.Generator().manual_seed(0)))


def _engine(model, *, policy="fifo", slots=2, num_pages=0, telemetry=None):
    sm = DecoderStepModel(model, max_len=32, prefill_chunk=8,
                          kv_layout="paged",
                          paged=PagedConfig(page_size=4,
                                            num_pages=num_pages))
    return ServeEngine(sm, slots=slots, policy=policy, telemetry=telemetry)


def _submit(eng, lens, sps, seed=1, **kw):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, eng.sm.vocab, size=p) for p, _g in lens]
    return [eng.submit(p, max_new_tokens=g,
                       sampling=SamplingParams(**sp) if sp else None, **kw)
            for p, (_pl, g), sp in zip(prompts, lens, sps)]


def _drain(eng, reqs):
    eng.run()
    assert eng.pool.pages_in_use == 0 and eng.pool.reserved_total == 0
    return [list(map(int, r.tokens)) for r in reqs]


def _preempt_all(eng, steps=2):
    for _ in range(steps):
        eng.step()
    victims = [int(s) for s in np.flatnonzero(eng.active)]
    assert victims
    for s in victims:
        eng._preempt(s)
    assert not eng.active.any() and eng.pool.pages_in_use == 0
    return victims


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_preempt_resume_bitwise(arch):
    """Evict every active slot mid-stream; the engine resumes them into
    fresh pages and the streams equal an undisturbed run's."""
    model = _model(arch)
    eng0 = _engine(model)
    ref = _drain(eng0, _submit(eng0, LENS, SPS))
    eng = _engine(model)
    reqs = _submit(eng, LENS, SPS)
    victims = _preempt_all(eng)
    assert eng.n_snapshot_bytes > 0
    assert _drain(eng, reqs) == ref
    assert eng.n_preemptions == len(victims)
    assert sum(r.n_preemptions for r in reqs) == len(victims)
    assert all(r.snapshot is None for r in reqs)


@pytest.mark.parametrize("arch", ["smollm-360m-smoke", MLA_DENSE])
def test_int8_pages_preempt_resume_bitwise(arch):
    """int8 pages: a snapshot holds codes AND per-page scales, so the
    resumed stream (and every later requantizing write) is bitwise."""
    model = _model(arch, kv_dtype="int8")
    eng0 = _engine(model)
    ref = _drain(eng0, _submit(eng0, LENS, SPS))
    eng = _engine(model)
    reqs = _submit(eng, LENS, SPS)
    _preempt_all(eng, steps=3)
    snap = next(r.snapshot for r in eng.waiting if r.snapshot)
    assert any(k.endswith("_scale") for k in snap["state"][0])
    assert _drain(eng, reqs) == ref


def _two_batch(policy, *, slots=2, num_pages=0, prios=(0, 0, 5),
               deadlines=(None, None, None)):
    """Two low requests decode two steps, then a third arrives."""
    model = _model("smollm-360m-smoke")
    lens = [(6, 18), (6, 16), (4, 4)]
    sps = [None, dict(temperature=0.8, top_k=10, seed=7), None]
    eng = _engine(model, policy=policy, slots=slots, num_pages=num_pages)
    low = [eng.submit(p, max_new_tokens=g, priority=pr, deadline=dl,
                      sampling=SamplingParams(**sp) if sp else None)
           for p, (_l, g), sp, pr, dl in zip(
               [np.arange(6) + 3, np.arange(6) + 40], lens, sps, prios,
               deadlines)]
    eng.step()
    eng.step()
    high = eng.submit(np.arange(4) + 90, max_new_tokens=4,
                      priority=prios[2], deadline=deadlines[2])
    reqs = low + [high]
    toks = _drain(eng, reqs)
    return toks, [eng.finished.index(r) for r in reqs], eng, reqs


@pytest.mark.parametrize("policy,kw", [
    ("priority", {}),
    ("edf", dict(deadlines=(50.0, 60.0, 5.0)))])
def test_policy_preempts_blocked_on_slots(policy, kw):
    """A later urgent arrival evicts the youngest low request, finishes
    first, and the victim resumes: every stream bitwise the fifo run."""
    ref, _o, ref_eng, _ = _two_batch("fifo", **kw)
    assert ref_eng.n_preemptions == 0
    toks, order, eng, reqs = _two_batch(policy, **kw)
    assert toks == ref
    assert eng.n_preemptions == 1 == reqs[1].n_preemptions
    assert order[2] < order[1]
    assert eng.stats().n_preemptions == 1
    assert eng.metrics()["counters"]["preemptions"] == 1


def test_priority_preempts_blocked_on_pages():
    """A slot is free but the pair's reservations hold the whole pool:
    the eviction is what returns pages; the pool drains afterwards."""
    ref, *_ = _two_batch("fifo", slots=3)
    toks, _o, eng, _ = _two_batch("priority", slots=3, num_pages=12)
    assert eng.n_preemptions == 1
    assert toks == ref


def test_fork_children_reproduce_parent_and_cow():
    """Greedy children share the parent's chain copy-on-write and emit
    its stream bitwise; a sampled child draws its own stream; counters."""
    model = _model("smollm-360m-smoke")
    eng = _engine(model, slots=4)
    rng = np.random.default_rng(4)
    parent = eng.submit(rng.integers(0, model.cfg.vocab, 6),
                        max_new_tokens=14)
    for _ in range(3):
        eng.step()
    kids = eng.fork(parent, 2)
    sampled, = eng.fork(parent, max_new_tokens=8, sampling=SamplingParams(
        temperature=0.9, top_k=12, seed=3))
    assert len({parent.uid, sampled.uid, *(k.uid for k in kids)}) == 4
    _drain(eng, [parent, *kids, sampled])
    for k in kids:
        assert list(k.tokens) == list(parent.tokens)
    assert eng.n_forks == 3 and eng.n_cow_copies >= 1
    assert eng.metrics()["counters"]["forks"] == 3
    with pytest.raises(ValueError, match="RUNNING"):
        eng.fork(parent)


def test_fork_child_preempt_resume_bitwise():
    """A fork child's budget counts from the fork point: re-admission
    re-reserves what its slot held (the snapshot's ``reserve``), and its
    resumed stream is bitwise the undisturbed one."""
    model = _model("smollm-360m-smoke")

    def drive(preempt):
        eng = _engine(model, slots=3)
        rng = np.random.default_rng(4)
        parent = eng.submit(rng.integers(0, model.cfg.vocab, 6),
                            max_new_tokens=18)
        for _ in range(7):
            eng.step()
        child, = eng.fork(parent, max_new_tokens=8, sampling=SamplingParams(
            temperature=0.9, top_k=12, seed=3))
        for _ in range(2):
            eng.step()
        if preempt:
            slot = next(s for s, r in enumerate(eng.st.slot_req) if r is child)
            sm = eng.sm
            assert (sm.pages_for(int(eng.st.pos[slot]) + int(eng.st.remaining[slot]))
                    > sm.pages_for(len(child.prompt) + child.max_new_tokens))
            eng._preempt(slot)
            assert child.snapshot["reserve"] == sm.pages_for(
                child.snapshot["pos"] + child.snapshot["remaining"])
        return _drain(eng, [parent, child]), child

    ref, _ = drive(False)
    got, child = drive(True)
    assert got == ref
    assert child.n_preemptions == 1 and child.snapshot is None


def test_cancel_preempted_request_drops_snapshot():
    model = _model("smollm-360m-smoke")
    eng = _engine(model)
    reqs = _submit(eng, LENS, SPS)
    eng.step()
    victim = int(np.flatnonzero(eng.active)[0])
    vreq = eng.st.slot_req[victim]
    eng._preempt(victim)
    assert vreq.snapshot is not None and vreq in eng.waiting
    fp = (eng.pool.refcount.copy(), list(eng.pool._free),
          eng.pool.reserved_total)
    eng.cancel(vreq)
    assert vreq.cancelled and vreq.snapshot is None
    assert vreq not in eng.waiting
    assert (eng.pool.refcount == fp[0]).all()
    assert eng.pool._free == fp[1] and eng.pool.reserved_total == fp[2]
    eng.run()
    assert eng.pool.pages_in_use == 0 and eng.pool.reserved_total == 0
    assert all(r.finished for r in reqs)


def test_preempt_and_fork_misuse_raises():
    model = _model("smollm-360m-smoke")
    eng = _engine(model)
    _submit(eng, LENS, SPS)
    with pytest.raises(ValueError, match="not running"):
        eng._preempt(0)
    dense = ServeEngine(DecoderStepModel(model, max_len=32, prefill_chunk=8),
                        slots=2)
    r = dense.submit(np.arange(4), max_new_tokens=4)
    dense.step()
    with pytest.raises(ValueError, match="paged"):
        dense._preempt(0)
    with pytest.raises(ValueError, match="paged"):
        dense.fork(r)


def test_submit_validates_scheduling_fields_before_uid():
    model = _model("smollm-360m-smoke")
    eng = _engine(model)
    for bad in [dict(priority=1.5), dict(deadline=0.0), dict(spec_k=2)]:
        with pytest.raises(ValueError):
            eng.submit(np.arange(4), max_new_tokens=2, **bad)
    assert not eng.waiting
    assert eng.submit(np.arange(4), max_new_tokens=2, priority=3).uid == 0


def test_preempted_greedy_streams_match_reference():
    """On the reference's weights (sharpened x4 in both, as in
    tests/test_torch_serve_paged.py), greedy streams that were preempted
    and resumed mid-decode equal the reference model's, token for
    token."""
    arch = "smollm-360m-smoke"
    jm = JLM(_configs(arch)[0], scan_layers=False)
    jp = jm.init(jax.random.PRNGKey(0))
    for sub in jp.values():
        if "mixer" in sub:
            sub["mixer"]["wo"] = sub["mixer"]["wo"] * 4.0
            sub["mlp"]["w_down"] = sub["mlp"]["w_down"] * 4.0
    model = build_model(dataclasses.replace(_configs(arch)[1],
                                            paged_impl="gather"),
                        device="cpu")
    load_jax_params(model, jax.tree_util.tree_map(np.asarray, jp))
    lens = [(7, 8), (13, 6), (4, 8)]
    eng = _engine(model)
    reqs = _submit(eng, lens, [None] * len(lens), seed=9)
    _preempt_all(eng)
    got = _drain(eng, reqs)
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, model.cfg.vocab, size=p) for p, _g in lens]
    want = [_reference_greedy(jm, jp, p, g, max_len=32, chunk=8)
            for p, (_p, g) in zip(prompts, lens)]
    assert got == want


def test_preempt_fork_telemetry(tmp_path):
    """Traced preemption and fork: the trace validates and carries the
    preempt / resume / fork events and the preempted -> running chain;
    the streams equal the untraced run's."""
    model = _model("smollm-360m-smoke")

    def drive(tel):
        eng = _engine(model, slots=4, telemetry=tel)
        reqs = _submit(eng, LENS, SPS)
        eng.step()
        kids = eng.fork(reqs[0])
        _preempt_all(eng, steps=1)
        return _drain(eng, reqs + kids), eng, reqs

    ref, _e, _r = drive(None)
    tel = Telemetry(trace=True)
    got, eng, reqs = drive(tel)
    assert got == ref
    reg = eng.metrics()["telemetry"]["counters"]
    assert reg["preemptions"] == eng.n_preemptions > 0
    assert reg["resumes"] == eng.n_preemptions and reg["forks"] == 1
    path = tel.save_trace(str(tmp_path / "preempt.json"))
    with open(path) as f:
        doc = json.load(f)
    validate_chrome_trace(doc)
    names = {e.get("name") for e in doc["traceEvents"]}
    assert {"preempt", "resume", "fork", "preempted", "running",
            "finish"} <= names
