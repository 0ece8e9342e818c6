"""The port's scheduling policies against the reference's, with no model:
the same scenarios (waiting queues, running slots, page reservations) go
to ``repro.serve.scheduler`` and ``repro_torch.serve.scheduler``, and
``admit_order`` and ``select_victim`` must agree — uid tie-breaks, the
strict priority and deadline gaps, the guard that an eviction must be
able to unblock the head, SJF's aging bound and its zero prefill cost for
resumed requests, EDF's no-deadline-last — plus ``make_policy``, the
SlotTable views and ``Request.validate_scheduling``.  Then the launcher:
the static baseline ``generate`` against the reference's, and the CLI on
the CPU with each lifted flag (``--mesh`` serves on gloo ranks the
launcher starts; ``--moe-dispatch`` is refused on an arch without MoE
layers)."""
import numpy as np
import pytest

from repro import serve as jserve
from repro_torch import serve as tserve

PKGS = {"ref": jserve, "port": tserve}
POLICIES = ["fifo", "priority", "sjf", "edf"]


def _req(pkg, uid, plen=4, gen=4, **kw):
    return pkg.Request(uid, np.zeros(plen, np.int32), gen, **kw)


def _scenario(pkg, seed, *, slots=4, num_pages=24, max_pages=8):
    """A random SlotTable: some slots running with reservations, a queue
    of requests with random priorities, deadlines and prompt lengths, a
    few holding a preemption snapshot."""
    rng = np.random.default_rng(seed)
    pool = pkg.PagePool(num_pages, slots, max_pages)
    tab = pkg.SlotTable(slots, pool=pool,
                        pages_for_req=lambda r: int(r.max_new_tokens))
    uid = 0
    for _ in range(int(rng.integers(0, slots + 1))):
        need = int(rng.integers(1, 6))
        if not pool.can_admit(need):
            break
        s = tab.alloc_slot()
        pool.reserve(s, need)
        tab.slot_req[s] = _req(pkg, uid, gen=need,
                               priority=int(rng.integers(0, 3)),
                               deadline=(None if rng.random() < 0.3 else
                                         float(rng.integers(1, 9))))
        tab.active[s] = True
        uid += 1
    for _ in range(int(rng.integers(1, 7))):
        r = _req(pkg, uid, plen=int(rng.integers(1, 20)),
                 gen=int(rng.integers(1, 9)),
                 priority=int(rng.integers(0, 4)),
                 deadline=(None if rng.random() < 0.3 else
                           float(rng.integers(1, 9))))
        if rng.random() < 0.2:
            r.snapshot = {"reserve": int(r.max_new_tokens)}
        tab.waiting.append(r)
        uid += 1
    # arrival order is not uid order
    tab.waiting = type(tab.waiting)(
        tab.waiting[i] for i in rng.permutation(len(tab.waiting)))
    return tab


def _decide(pkg, policy, seed, rounds=3):
    """admit_order uids and select_victim slot, over a few rounds."""
    pol = pkg.make_policy(policy)
    tab = _scenario(pkg, seed)
    out = []
    for _ in range(rounds):
        pol.begin_round(tab)
        out.append(([r.uid for r in pol.admit_order(tab.waiting, tab)],
                    pol.select_victim(tab)))
    return out


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("seed", range(8))
def test_policy_decisions_match_reference(policy, seed):
    assert _decide(tserve, policy, seed) == _decide(jserve, policy, seed)


@pytest.mark.parametrize("name", ["ref", "port"])
def test_priority_strict_gap_only(name):
    """The reference's unit case, run in both packages: victim = lowest
    priority, youngest; none on equal priority or without a pool."""
    pkg = PKGS[name]
    pool = pkg.PagePool(8, 2, 4)
    tab = pkg.SlotTable(2, pool=pool, pages_for_req=lambda r: 4)
    for uid, prio in [(0, 1), (1, 0)]:
        s = tab.alloc_slot()
        pool.reserve(s, 4)
        tab.slot_req[s] = _req(pkg, uid, priority=prio)
        tab.active[s] = True
    pol = pkg.PriorityPolicy()
    assert pol.select_victim(tab) is None
    tab.waiting.append(_req(pkg, 2, priority=5))
    assert pol.select_victim(tab) == 1
    for s in (0, 1):
        tab.slot_req[s].priority = 5
    assert pol.select_victim(tab) is None
    tab.slot_req[0].priority, tab.slot_req[1].priority = 1, 0
    assert pol.select_victim(tab) == 1
    assert pkg.PriorityPolicy(preempt=False).select_victim(tab) is None
    unpaged = pkg.SlotTable(2)
    unpaged.waiting.append(_req(pkg, 9, priority=5))
    assert pol.select_victim(unpaged) is None


@pytest.mark.parametrize("policy", ["priority", "edf"])
def test_victim_only_when_eviction_can_unblock(policy):
    """Evicting every eligible slot must be able to free the head's
    reservation, else no victim (same answer as the reference)."""
    got = {}
    for name, pkg in PKGS.items():
        pool = pkg.PagePool(8, 2, 8)
        tab = pkg.SlotTable(2, pool=pool,
                            pages_for_req=lambda r: int(r.max_new_tokens))
        for uid, (prio, dl, need) in enumerate([(9, 1.0, 5), (0, 9.0, 3)]):
            s = tab.alloc_slot()
            pool.reserve(s, need)
            tab.slot_req[s] = _req(pkg, uid, gen=need, priority=prio,
                                   deadline=dl)
            tab.active[s] = True
        pol = pkg.make_policy(policy)
        res = []
        for need in (8, 3):        # 3 free-able from slot 1 alone: 0 + 3
            tab.waiting.clear()
            tab.waiting.append(_req(pkg, 7, gen=need, priority=5,
                                    deadline=2.0))
            res.append(pol.select_victim(tab))
        got[name] = res
    assert got["port"] == got["ref"] == [None, 1]


def test_sjf_aging_bound_matches_reference():
    """A P-token prompt outranks any fresh 1-token rival after at most
    P - 1 rounds (aging 1), in the same round as the reference's."""
    rounds = {}
    for name, pkg in PKGS.items():
        P = 10
        pol = pkg.SJFPolicy(aging=1.0)
        tab = pkg.SlotTable(2)
        old = _req(pkg, 0, plen=P)
        tab.waiting.append(old)
        uid = 1
        for rnd in range(P + 3):
            pol.begin_round(tab)
            tab.waiting.append(_req(pkg, uid, plen=1))
            uid += 1
            head = pol.admit_order(tab.waiting, tab)[0]
            if head is old:
                rounds[name] = rnd
                break
            tab.pop_waiting(head)
    assert rounds["port"] == rounds["ref"] <= 9
    with pytest.raises(ValueError, match="aging"):
        tserve.SJFPolicy(aging=0.0)


def test_sjf_resumed_request_has_zero_prefill_cost():
    tab = tserve.SlotTable(2)
    preempted = _req(tserve, 5, plen=50)
    preempted.snapshot = {"n_pages": 1}
    tab.waiting.extend([_req(tserve, 1, plen=2), preempted])
    pol = tserve.SJFPolicy()
    pol.begin_round(tab)
    assert pol.admit_order(tab.waiting, tab)[0] is preempted


def test_edf_no_deadline_last_and_never_preempts():
    pool = tserve.PagePool(8, 1, 8)
    tab = tserve.SlotTable(1, pool=pool, pages_for_req=lambda r: 2)
    s = tab.alloc_slot()
    pool.reserve(s, 2)
    tab.slot_req[s] = _req(tserve, 0, deadline=5.0)
    tab.active[s] = True
    tab.waiting.extend([_req(tserve, 3), _req(tserve, 1, deadline=9.0),
                        _req(tserve, 2, deadline=9.0)])
    pol = tserve.EDFPolicy()
    assert [r.uid for r in pol.admit_order(tab.waiting, tab)] == [1, 2, 3]
    assert pol.select_victim(tab) is None       # 9 is later than 5
    tab.waiting.clear()
    tab.waiting.append(_req(tserve, 4))         # no deadline: never
    assert pol.select_victim(tab) is None
    tab.waiting.clear()
    tab.waiting.append(_req(tserve, 5, deadline=1.0))
    assert pol.select_victim(tab) == 0


def test_make_policy_names_and_errors():
    for name in POLICIES:
        assert tserve.make_policy(name).name == name
    pol = tserve.PriorityPolicy(preempt=False)
    assert tserve.make_policy(pol) is pol
    assert tserve.POLICIES == jserve.POLICIES
    with pytest.raises(ValueError, match="policy must be one of"):
        tserve.make_policy("lifo")


@pytest.mark.parametrize("kw", [dict(priority=1.5), dict(priority=True),
                                dict(priority=2**31), dict(deadline=-1.0),
                                dict(deadline=float("inf")),
                                dict(deadline="soon"), dict(deadline=True)])
def test_validate_scheduling_matches_reference(kw):
    errs = []
    for pkg in (jserve, tserve):
        with pytest.raises(ValueError) as e:
            _req(pkg, 0, **kw).validate_scheduling()
        errs.append(str(e.value))
    assert errs[0] == errs[1]
    _req(tserve, 0, priority=-3, deadline=2).validate_scheduling()


def test_slot_table_views():
    pool = tserve.PagePool(8, 3, 4)
    tab = tserve.SlotTable(3, pool=pool, pages_for_req=lambda r: 3)
    assert tab.pages_needed(_req(tserve, 0)) == 3
    assert tserve.SlotTable(3).pages_needed(_req(tserve, 0)) == 0
    for uid in (0, 1):
        s = tab.alloc_slot()
        tab.slot_req[s] = _req(tserve, uid)
        tab.active[s] = uid == 1
    assert [(s, r.uid) for s, r in tab.running()] == [(1, 1)]


# ---------------------------------------------------------------------------
# the launcher: the static baseline and the lifted flags
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["minimalist-lm-360m-smoke",
                                  "smollm-360m-smoke",
                                  "falcon-mamba-7b-smoke"])
def test_static_baseline_generate_matches_reference(arch):
    """generate: per-token prefill, then lock-step greedy decode through
    decode_step; on the reference's weights the tokens equal the
    reference's ``generate`` (an O(1) or a dense attention cache) up to
    the first token where the reference's top-2 margin is <= 0.1 (bf16
    compute: a near-tie may flip)."""
    import jax
    import jax.numpy as jnp
    import torch

    from repro.configs import get_config as jget
    from repro.launch.serve import generate as j_generate
    from repro.models.transformer import DecoderLM as JLM
    from repro_torch.bridge import load_jax_params
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import generate
    from repro_torch.models import build_model

    jcfg, cfg = jget(arch), get_config(arch)
    jm = JLM(jcfg, scan_layers=False)
    jp = jm.init(jax.random.PRNGKey(1))
    if arch.startswith("smollm"):       # sharpened, as test_torch_serve_paged
        for sub in jp.values():
            if "mixer" in sub:
                sub["mixer"]["wo"] = sub["mixer"]["wo"] * 4.0
                sub["mlp"]["w_down"] = sub["mlp"]["w_down"] * 4.0
    tm = build_model(cfg, device="cpu")
    load_jax_params(tm, jax.tree_util.tree_map(np.asarray, jp))
    prompts = np.random.default_rng(2).integers(0, cfg.vocab, size=(3, 9))
    got = generate(tm, prompts, max_len=24, gen_tokens=6)
    want = np.asarray(j_generate(jm, jp, jnp.asarray(prompts, jnp.int32),
                                 max_len=24, gen_tokens=6))
    assert got.shape == (3, 6) and got.dtype == torch.int64
    n_equal = 0
    for prompt, a, b in zip(prompts, got.numpy(), want):
        diff = np.flatnonzero(a != b)
        if not len(diff):
            n_equal += 1
            continue
        ctx = np.concatenate([prompt, b[:diff[0]]])[None]
        top2 = np.sort(np.asarray(jm(jp, jnp.asarray(ctx)), np.float32)[
            0, -1, :cfg.vocab])[-2:]
        assert top2[1] - top2[0] <= 0.1
    assert n_equal >= 2


@pytest.mark.parametrize("flags", [
    ["--policy", "priority", "--kv-layout", "paged"],
    ["--policy", "sjf"],
    ["--policy", "edf", "--kv-layout", "paged"],
    ["--fork", "2", "--slots", "6", "--gen", "12", "--kv-layout",
     "paged"],
    ["--drafter", "minimalist-lm-360m", "--spec-k", "4", "--kv-layout",
     "paged"],
    ["--baseline"]])
def test_launcher_runs_each_flag_on_cpu(flags, capsys):
    from repro_torch.launch.serve import main
    main(["--arch", "smollm-360m", "--smoke", "--device", "cpu",
          "--requests", "4", "--slots", "2", "--prompt-len", "8", "--gen",
          "4"] + flags)
    out = capsys.readouterr().out
    assert ("baseline (cpu)" if "--baseline" in flags
            else "engine (cpu): 4 requests") in out or "6 requests" in out
    if "--fork" in flags:
        assert "into 2 COW streams" in out
    if "--drafter" in flags:
        assert "accept rate" in out


@pytest.mark.parametrize("flags", [["--mesh", "1x1"],
                                   ["--moe-dispatch", "auto"]])
def test_launcher_refuses_only_mesh_and_moe_dispatch(flags, capsys):
    """``--mesh 1x1 --device cpu`` serves its requests on one gloo rank
    (which the launcher starts in a process of its own, joined within a
    time limit) and ``--mesh 0x1`` exits with the reference's error.  (The
    name is kept from when both flags were refused.)  ``--moe-dispatch``
    on an arch without MoE layers exits with the reference's error, and on
    qwen3-moe-30b-a3b it serves."""
    from repro_torch.launch.serve import main
    if flags[0] == "--mesh":
        from test_torch_serve_sharded import run_launcher
        rc, out, err = run_launcher(
            "--smoke", "--device", "cpu", "--requests", "3", "--slots", "2",
            "--prompt-len", "6", "--gen", "4", *flags)
        assert rc == 0, err[-3000:]
        assert "mesh data=1 x model=1 (1 gloo ranks)" in out
        assert "engine (cpu): 3 requests" in out
        with pytest.raises(SystemExit):
            main(["--smoke", "--device", "cpu", "--mesh", "0x1"])
        assert "mesh axes must be >= 1" in capsys.readouterr().err
        return
    with pytest.raises(SystemExit):
        main(["--smoke", "--device", "cpu"] + flags)
    assert "--moe-dispatch given but minimalist-lm-360m-smoke has no MoE " \
        "layers" in capsys.readouterr().err
    done = main(["--arch", "qwen3-moe-30b-a3b", "--smoke", "--device",
                 "cpu", "--requests", "3", "--slots", "2", "--prompt-len",
                 "8", "--gen", "3"] + flags)
    assert len(done) == 3
    assert "engine (cpu): 3 requests" in capsys.readouterr().out
