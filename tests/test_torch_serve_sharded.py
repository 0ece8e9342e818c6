"""Mesh-sharded serving on gloo ranks (the reference's
``tests/test_serve_sharded.py`` and ``test_serve_engine.py``'s 1x1
checks, on the port).

Each check spawns its ranks as subprocesses that meet through a
``FileStore`` under ``tmp_path``; every rank runs the same engine on the
same requests.  The pytest worker itself opens no process group and sets
no environment variable.  The contract:

  * greedy decode on a TP=2 x DP=2 mesh emits the no-mesh engine's
    streams bitwise for minGRU (dense), GQA (dense, bf16 pages, int8
    pages) and MoE-auto stacks, and so does paged GQA at TP 4, where the 4
    query heads shard and the 2 KV heads replicate;
  * sampled decode on a DP-only mesh (2x1) is bitwise, and on a TP-only
    mesh (1x2) a request's stream does not depend on its co-batched
    traffic;
  * a 1x1 mesh is bitwise the no-mesh engine for greedy and sampled
    decode, priority preemption, a fork and a speculative wave, and its
    greedy streams are the reference model's;
  * TP-sharded parameters hold 1/tp of their rows on each rank, and the
    slot state shards over "data".

The GQA and MoE stacks have every layer's output projections scaled by
4 (as the paged tests do): at init scale a random model's greedy stream
mostly repeats its last token."""
import json
import os
import signal
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import jax
import numpy as np
import pytest

SRC = Path(__file__).resolve().parents[1] / "src"
TIMEOUT = 180

PROLOGUE = r'''
import dataclasses, json, sys
import numpy as np
import torch
import torch.distributed as dist

rank, world, store = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
torch.set_num_threads(1)
dist.init_process_group("gloo", store=dist.FileStore(store, world),
                        rank=rank, world_size=world)

from repro_torch.configs import SamplingParams, get_config
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import build_model
from repro_torch.parallel import spmd
from repro_torch.serve import (DecoderStepModel, DraftStepModel,
                               MinimalistStepModel, PagedConfig,
                               ServeEngine)

LENS = [(5, 6), (9, 5), (3, 7), (7, 4), (11, 6), (4, 5)]
SPS = [None, dict(temperature=0.9, top_k=12, seed=3), None,
       dict(temperature=1.2, top_p=0.8, seed=5),
       dict(temperature=0.7, seed=8),
       dict(temperature=1.0, top_k=5, top_p=0.9, seed=13)]
OUT = {}


def model_for(arch, sharpen=True, **kw):
    cfg = dataclasses.replace(get_config(arch), **kw)
    m = build_model(cfg, device="cpu",
                    generator=torch.Generator().manual_seed(0))
    if sharpen:
        with torch.no_grad():
            for layer in m.layers:
                if hasattr(layer.mixer, "wo"):
                    layer.mixer.wo.mul_(4.0)
                mlp = layer.mlp
                if mlp is not None:
                    mlp.w_down.mul_(4.0)
                    if getattr(mlp, "shared", None) is not None:
                        mlp.shared.w_down.mul_(4.0)
    return m


def step_model(model, layout):
    return DecoderStepModel(model, max_len=64, prefill_chunk=8,
                            kv_layout=layout,
                            paged=PagedConfig(page_size=4)
                            if layout == "paged" else None)


def serve(arch, mesh, *, layout="dense", sampled=False, lens=LENS,
          rng_seed=1, slots=4, policy="fifo", sharpen=True, **kw):
    model = model_for(arch, sharpen, **kw)
    rng = np.random.default_rng(rng_seed)
    prompts = [rng.integers(0, model.cfg.vocab, size=p) for p, _ in lens]
    eng = ServeEngine(step_model(model, layout), slots=slots, mesh=mesh,
                      policy=policy)
    reqs = [eng.submit(p, max_new_tokens=g,
                       sampling=SamplingParams(**SPS[i % len(SPS)])
                       if sampled and SPS[i % len(SPS)] else None)
            for i, (p, (_l, g)) in enumerate(zip(prompts, lens))]
    eng.run()
    return [list(map(int, r.tokens)) for r in reqs], eng


def bitwise(name, arch, mesh, **kw):
    ref, _ = serve(arch, None, **kw)
    got, eng = serve(arch, mesh, **kw)
    OUT[name] = got == ref
    OUT[name + "/distinct"] = len({t for s in ref for t in s})
    return eng
'''

EPILOGUE = r'''
print(json.dumps({"rank": rank, **OUT}))
dist.destroy_process_group()
'''


def run_ranks(tmp_path, world, body, *args, prologue=PROLOGUE):
    """Run ``prologue`` + body + EPILOGUE on ``world`` gloo ranks (argv:
    rank, world, the FileStore's path, ``args``); returns each rank's
    JSON dict of ``OUT``.  Kills every rank and fails past TIMEOUT."""
    prog = tmp_path / "rank.py"
    prog.write_text(prologue + textwrap.dedent(body) + EPILOGUE)
    store = tmp_path / "store"
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    procs, logs = [], []
    for r in range(world):
        out = open(tmp_path / f"rank{r}.out", "w")
        err = open(tmp_path / f"rank{r}.err", "w")
        logs.append((out, err))
        procs.append(subprocess.Popen(
            [sys.executable, str(prog), str(r), str(world), str(store),
             *map(str, args)], stdout=out, stderr=err, env=env,
            cwd=tmp_path))
    deadline = time.monotonic() + TIMEOUT
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.wait()
        pytest.fail(f"ranks did not finish in {TIMEOUT} s: "
                    + (tmp_path / "rank0.err").read_text()[-2000:])
    finally:
        for out, err in logs:
            out.close()
            err.close()
    res = []
    for r, p in enumerate(procs):
        err = (tmp_path / f"rank{r}.err").read_text()
        assert p.returncode == 0, f"rank {r}: {err[-3000:]}"
        res.append(json.loads((tmp_path / f"rank{r}.out").read_text()
                              .strip().splitlines()[-1]))
    return res


def _all_true(res, keys):
    for r in res:
        for k in keys:
            if k in r:
                assert r[k] is True, (k, r)


def test_mingru_mesh_greedy_dp_sampled_tp_reproducible(tmp_path):
    res = run_ranks(tmp_path, 4, r'''
    ARCH = "minimalist-lm-360m-smoke"
    m22 = make_local_mesh(model=2, data=2, device="cpu")
    m21 = make_local_mesh(model=1, data=2, device="cpu", ranks=[0, 1])
    m12 = make_local_mesh(model=2, data=1, device="cpu", ranks=[2, 3])
    eng = bitwise("greedy_2x2", ARCH, m22, sharpen=False)
    blk = eng.sm.model.layers[0].mixer.block
    OUT["wh_local"] = list(blk.wh.to_local().shape)
    OUT["state_local"] = list(eng.state.shape)
    OUT["state_spec"] = list(eng.sm.sharding.state)
    if rank < 2:
        bitwise("sampled_2x1", ARCH, m21, sampled=True, sharpen=False)
        # frame streaming, DP-only: the paper's network, 4 streams
        from repro_torch.core.mingru import MinimalistNetwork
        rng = np.random.default_rng(12)
        streams = [rng.standard_normal((T, 3)).astype(np.float32)
                   for T in (6, 3, 9, 4)]

        def run(mesh):
            net = MinimalistNetwork((3, 8, 8, 4))
            torch.manual_seed(0)
            net.reset_parameters(torch.Generator().manual_seed(0))
            eng = ServeEngine(MinimalistStepModel(net), slots=2, mesh=mesh)
            reqs = [eng.submit(s) for s in streams]
            eng.run()
            return [torch.stack([torch.as_tensor(o) for o in r.outputs])
                    for r in reqs]
        OUT["stream_2x1"] = all(torch.equal(a, b) for a, b in
                                zip(run(None), run(m21)))
    else:
        a, _ = serve(ARCH, m12, sampled=True, sharpen=False)
        b, _ = serve(ARCH, m12, sampled=True, sharpen=False,
                     lens=[(5, 6), (13, 2), (2, 6), (6, 3)])
        OUT["sampled_1x2_reproducible"] = a[0] == b[0]
        OUT["sampled_1x2_stream"] = a[0]
    ''')
    _all_true(res, ["greedy_2x2", "sampled_2x1", "stream_2x1",
                    "sampled_1x2_reproducible"])
    assert all("greedy_2x2" in r for r in res)
    assert res[0]["sampled_2x1"] and res[2]["sampled_1x2_reproducible"]
    assert res[0]["greedy_2x2/distinct"] > 3
    # minGRU hidden 64 sharded over model 2; 4 slots over data 2
    assert res[0]["wh_local"] == [64, 32]
    assert res[0]["state_local"] == [2, 2, 32]
    assert res[0]["state_spec"] == [None, "data", "model"]


def test_gqa_mesh_greedy_dense_bf16_int8_pages_and_tp4(tmp_path):
    res = run_ranks(tmp_path, 4, r'''
    ARCH = "smollm-360m-smoke"
    m22 = make_local_mesh(model=2, data=2, device="cpu")
    m14 = make_local_mesh(model=4, data=1, device="cpu")
    eng = bitwise("greedy_2x2_dense", ARCH, m22)
    at = eng.sm.model.layers[0].mixer
    OUT["wq_local"] = list(at.wq.to_local().shape)
    OUT["wk_local"] = list(at.wk.to_local().shape)
    OUT["w_gate_local"] = list(eng.sm.model.layers[0].mlp.w_gate
                               .to_local().shape)
    OUT["table_local"] = list(eng.sm.model.embed.table.to_local().shape)
    OUT["norm_local"] = list(eng.sm.model.final_norm.scale.to_local().shape)
    OUT["k_state_local"] = list(eng.state[0]["k"].shape)
    OUT["k_state_spec"] = list(eng.sm.sharding.state[0]["k"])
    eng = bitwise("greedy_2x2_bf16", ARCH, m22, layout="paged")
    OUT["pool_local"] = list(eng.state[0]["k"].shape)
    OUT["pool_spec"] = list(eng.sm.sharding.state[0]["k"])
    bitwise("greedy_2x2_int8", ARCH, m22, layout="paged", kv_dtype="int8")
    bitwise("sampled_2x2_bf16", ARCH, m22, layout="paged", sampled=True)
    eng = bitwise("greedy_1x4_bf16", ARCH, m14, layout="paged")
    at = eng.sm.model.layers[0].mixer
    OUT["wq_local_tp4"] = list(at.wq.to_local().shape)
    OUT["wk_local_tp4"] = list(at.wk.to_local().shape)
    bitwise("greedy_1x4_int8", ARCH, m14, layout="paged", kv_dtype="int8")
    ''')
    _all_true(res, ["greedy_2x2_dense", "greedy_2x2_bf16",
                    "greedy_2x2_int8", "greedy_1x4_bf16",
                    "greedy_1x4_int8"])
    r = res[0]
    assert r["greedy_2x2_bf16/distinct"] > 8
    # 4 heads / 2 KV heads / d_ff 128 / vocab 512 over model 2: half each
    assert r["wq_local"] == [64, 2, 16] and r["wk_local"] == [64, 1, 16]
    assert r["w_gate_local"] == [64, 64] and r["table_local"] == [256, 64]
    assert r["norm_local"] == [64]
    # dense state: 4 slots over data 2, KV heads over model 2
    assert r["k_state_local"][0] == 2 and r["k_state_local"][2] == 1
    assert r["k_state_spec"] == ["data", None, "model", None]
    # a pool is pages x TP-sharded KV heads, whole over data
    assert r["pool_spec"] == [None, None, "model", None]
    assert r["pool_local"][2] == 1
    # TP 4: query heads shard, KV heads replicate
    assert r["wq_local_tp4"] == [64, 1, 16] and r["wk_local_tp4"] == [64, 2,
                                                                      16]


def test_moe_auto_mesh_greedy(tmp_path):
    res = run_ranks(tmp_path, 4, r'''
    ARCH = "qwen3-moe-30b-a3b-smoke"
    m22 = make_local_mesh(model=2, data=2, device="cpu")
    eng = bitwise("greedy_2x2_dense", ARCH, m22)
    mlp = next(l.mlp for l in eng.sm.model.layers
               if hasattr(l.mlp, "router"))
    OUT["experts_local"] = list(mlp.w_gate.to_local().shape)
    OUT["dispatch"] = eng.sm.moe_dispatch
    bitwise("greedy_2x2_paged", ARCH, m22, layout="paged")
    ''')
    _all_true(res, ["greedy_2x2_dense", "greedy_2x2_paged"])
    assert res[0]["dispatch"] == "auto"
    # 4 experts over model 2: expert parallelism
    assert res[0]["experts_local"] == [2, 64, 32]
    assert res[0]["greedy_2x2_paged/distinct"] > 8


def _reference_streams(tmp_path):
    """The reference model's greedy streams on its own weights (saved for
    the rank, which loads them through the bridge)."""
    import dataclasses

    from repro.configs import get_config as jget
    from repro.models.transformer import DecoderLM as JLM
    from test_torch_serve_paged import _reference_greedy

    jm = JLM(jget("smollm-360m-smoke"), scan_layers=False)
    jp = jm.init(jax.random.PRNGKey(0))
    for sub in jp.values():
        if "mixer" in sub:
            sub["mixer"]["wo"] = sub["mixer"]["wo"] * 4.0
            sub["mlp"]["w_down"] = sub["mlp"]["w_down"] * 4.0
    flat = {"/".join(str(getattr(k, "key", k)) for k in path):
            np.asarray(v) for path, v in
            jax.tree_util.tree_flatten_with_path(jp)[0]}
    np.savez(tmp_path / "ref_params.npz", **flat)
    rng = np.random.default_rng(9)
    lens = [(7, 8), (13, 6), (4, 8)]
    prompts = [rng.integers(0, 512, size=p) for p, _g in lens]
    np.save(tmp_path / "ref_prompts.npy", np.array(
        [np.pad(p, (0, 13 - len(p))) for p in prompts]))
    del dataclasses
    return lens, [_reference_greedy(jm, jp, p, g, max_len=64, chunk=8)
                  for p, (_p, g) in zip(prompts, lens)]


def test_mesh_1x1_bitwise_greedy_sampled_preempt_fork_spec(tmp_path):
    lens, want = _reference_streams(tmp_path)
    res = run_ranks(tmp_path, 1, r'''
    ARCH = "smollm-360m-smoke"
    m11 = make_local_mesh(model=1, data=1, device="cpu")
    for layout in ("dense", "paged"):
        for sampled in (False, True):
            eng = bitwise(f"{layout}_{'sampled' if sampled else 'greedy'}",
                          ARCH, m11, layout=layout, sampled=sampled)
    OUT["bound"] = eng.mesh is m11 and eng.sm.mesh is m11
    bitwise("mingru_sampled", "minimalist-lm-360m-smoke", m11,
            sampled=True, sharpen=False)

    # priority preemption: two low requests, then a high one on 2 slots
    def preempt(mesh):
        model = model_for(ARCH)
        eng = ServeEngine(step_model(model, "paged"), slots=2,
                          policy="priority", mesh=mesh)
        low = [eng.submit(np.arange(6) + 3, max_new_tokens=18),
               eng.submit(np.arange(6) + 40, max_new_tokens=16,
                          sampling=SamplingParams(temperature=0.8,
                                                  top_k=10, seed=7))]
        eng.step()
        eng.step()
        high = eng.submit(np.arange(4) + 90, max_new_tokens=4, priority=5)
        eng.run()
        return [list(map(int, r.tokens)) for r in low + [high]], \
            eng.n_preemptions
    a, na = preempt(None)
    b, nb = preempt(m11)
    OUT["preempt"] = a == b and na == nb >= 1

    def fork(mesh):
        model = model_for(ARCH)
        eng = ServeEngine(step_model(model, "paged"), slots=4, mesh=mesh)
        parent = eng.submit(np.arange(6) + 7, max_new_tokens=12)
        for _ in range(3):
            eng.step()
        kids = eng.fork(parent, 2)
        samp, = eng.fork(parent, max_new_tokens=8, sampling=SamplingParams(
            temperature=0.9, top_k=12, seed=3))
        eng.run()
        return [list(map(int, r.tokens)) for r in [parent, *kids, samp]]
    a, b = fork(None), fork(m11)
    OUT["fork"] = a == b and a[1] == a[0]

    def spec(mesh):
        model = model_for(ARCH)
        dm = build_model(get_config("minimalist-lm-360m-smoke"),
                         device="cpu",
                         generator=torch.Generator().manual_seed(1))
        eng = ServeEngine(step_model(model, "paged"), slots=3, mesh=mesh,
                          drafter=DraftStepModel(dm, spec_k=4), spec_k=4)
        rng = np.random.default_rng(2)
        reqs = [eng.submit(rng.integers(0, 512, size=p), max_new_tokens=g,
                           sampling=SamplingParams(**SPS[i])
                           if SPS[i] else None)
                for i, (p, g) in enumerate([(5, 9), (8, 7), (3, 10)])]
        eng.run()
        return [list(map(int, r.tokens)) for r in reqs], \
            eng.n_drafts_proposed
    (a, pa), (b, pb) = spec(None), spec(m11)
    OUT["spec"] = a == b and pa == pb > 0

    # the reference's weights through the bridge: greedy streams
    from repro_torch.bridge import load_jax_params
    from repro_torch.common.pytree import unflatten_dict
    flat = dict(np.load("ref_params.npz"))
    tree = unflatten_dict({tuple(k.split("/")): v for k, v in flat.items()})
    prompts = np.load("ref_prompts.npy")
    LENS_REF = [(7, 8), (13, 6), (4, 8)]
    for impl in ("gather", "kernel"):
        model = build_model(dataclasses.replace(
            get_config(ARCH), paged_impl=impl), device="cpu")
        load_jax_params(model, tree)
        eng = ServeEngine(step_model(model, "paged"), slots=3, mesh=m11)
        reqs = [eng.submit(prompts[i, :p], max_new_tokens=g)
                for i, (p, g) in enumerate(LENS_REF)]
        eng.run()
        OUT["ref_" + impl] = [list(map(int, r.tokens)) for r in reqs]
    ''')
    r = res[0]
    _all_true(res, ["dense_greedy", "dense_sampled", "paged_greedy",
                    "paged_sampled", "bound", "mingru_sampled", "preempt",
                    "fork", "spec"])
    assert r["ref_gather"] == want and r["ref_kernel"] == want


def run_launcher(*flags):
    """The serve launcher in a process session of its own (its ranks
    join it), killed whole past TIMEOUT.  Returns (rc, stdout, stderr)."""
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", *flags],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        start_new_session=True)
    try:
        out, err = proc.communicate(timeout=TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        pytest.fail(f"the launcher did not finish in {TIMEOUT} s")
    return proc.returncode, out, err


def test_launcher_serves_on_a_2x2_mesh():
    rc, out, err = run_launcher(
        "--smoke", "--device", "cpu", "--mesh", "2x2", "--requests", "4",
        "--slots", "4", "--prompt-len", "6", "--gen", "4")
    assert rc == 0, err[-3000:]
    assert "mesh data=2 x model=2 (4 gloo ranks)" in out
    assert out.count("engine (cpu): 4 requests") == 1      # rank 0 only
