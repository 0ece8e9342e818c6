"""The dry-run (``repro_torch.launch.dryrun``) and the pieces it brought:

  * the ``stub`` forwards of GQA, MLA and Mamba against the reference's
    on smoke configs, through the bridge, at the module tests' fp32
    bound (atol = rtol = 1e-5, tests/test_torch_attention.py);
  * per-device argument bytes, exact, against sums over the reference's
    ``param_specs`` / ``opt_state_specs`` / ``cache_specs`` /
    ``batch_specs`` / ``slot_specs`` (``jax.eval_shape`` on duck-typed
    meshes) for smollm-360m, deepseek-v3-671b and falcon-mamba-7b at full
    width on both production meshes.  ZeRO-1 is held against the
    reference's unscanned model (``scan_layers=False``): its scanned
    leaves carry a stacked layer axis that ZeRO-1 may take, which the
    port's per-layer tensors do not have;
  * full-depth FLOPs, bytes and collectives equal to
    :func:`unit_extrapolated_costs` on a smoke config (exact);
  * the FLOPs of a dense smoke forward equal to the analytic matmul count
    (exact), and those of the stand-ins plus ``kernel_costs``;
  * recorded collectives of smollm-360m-smoke at TP 2 x DP 2 against a
    hand count (exact), with and without ZeRO-1;
  * ``remat`` none / full / dots_saveable: equal loss and gradients
    (bitwise, on the CPU) and ``full``'s meta peak below ``none``'s;
  * the CLI and ``roofline_report`` end to end on one full-width cell in
    a subprocess, writing into ``tmp_path``, without importing JAX."""
import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_config as jget
from repro.configs import input_specs as j_input_specs
from repro.models import build_model as jbuild
from repro.models.attention import GQAAttention as JGQA
from repro.models.attention import MLAAttention as JMLA
from repro.models.mamba import MambaBlock as JMB
from repro.parallel import sharding as jshd
from repro_torch.bridge import load_jax_params
from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import ShapeMesh, make_production_mesh
from repro_torch.models import build_model
from repro_torch.models.attention import GQAAttention, MLAAttention
from repro_torch.models.mamba import MambaBlock
from repro_torch.models.transformer import REMAT_MODES
from repro_torch.parallel import spmd

torch.set_num_threads(1)

SRC = Path(__file__).resolve().parents[1] / "src"
F32 = dict(atol=1e-5, rtol=1e-5)
PROD = {"single": dict(data=16, model=16),
        "multi": dict(pod=2, data=16, model=16)}


class FakeMesh:
    """Duck-typed mesh exposing .shape only."""

    def __init__(self, **axes):
        self.shape = axes


def _np(t):
    return t.detach().float().numpy() if torch.is_tensor(t) else \
        np.asarray(t, np.float32)


# --- stub forwards ---------------------------------------------------------

def _mla_cfgs():
    from test_torch_mla import dense_mla_configs
    return dense_mla_configs(attention_impl="stub")


def _stub_pair(kind, seed):
    if kind == "gqa":
        jcfg = dataclasses.replace(jget("gemma3-4b-smoke"),
                                   attention_impl="stub")
        cfg = dataclasses.replace(get_config("gemma3-4b-smoke"),
                                  attention_impl="stub")
        jm, tm = JGQA(jcfg), GQAAttention(cfg)
    elif kind == "mla":
        jcfg, cfg = _mla_cfgs()
        jm, tm = JMLA(jcfg), MLAAttention(cfg)
    else:
        jcfg = dataclasses.replace(jget("falcon-mamba-7b-smoke"),
                                   ssm_impl="stub")
        cfg = dataclasses.replace(get_config("falcon-mamba-7b-smoke"),
                                  ssm_impl="stub")
        jm, tm = JMB(jcfg), MambaBlock(cfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    load_jax_params(tm, jax.tree_util.tree_map(np.asarray, jp))
    return jcfg, jm, jp, tm


@pytest.mark.parametrize("kind", ["gqa", "mla", "mamba"])
def test_stub_forward_matches_reference(kind):
    jcfg, jm, jp, tm = _stub_pair(kind, seed=3)
    x = np.random.default_rng(3).standard_normal(
        (2, 13, jcfg.d_model)).astype(np.float32)
    want = jm(jp, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = tm(xt)
    np.testing.assert_allclose(_np(got), _np(want), **F32)
    # the stand-in is differentiable in its input and every weight
    got.float().square().sum().backward()
    assert xt.grad is not None and torch.isfinite(xt.grad).all()
    assert all(p.grad is not None for p in tm.parameters()
               if p.requires_grad and p.dim() >= 2)


# --- per-device argument bytes ---------------------------------------------

def _ref_local_bytes(tree, specs, axes):
    leaves = jax.tree_util.tree_leaves(tree)
    sl = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    assert len(leaves) == len(sl)
    total = 0
    for t, s in zip(leaves, sl):
        n = 1
        for i, d in enumerate(t.shape):
            ax = s[i] if i < len(s) else None
            names = ax if isinstance(ax, tuple) else (ax,) if ax else ()
            n *= d // math.prod(axes[a] for a in names)
        total += n * np.dtype(t.dtype).itemsize
    return total


def _ref_arguments(arch, shape, axes, zero1):
    mesh = FakeMesh(**axes)
    jm = jbuild(jget(arch), scan_layers=not zero1)
    ps = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    pspec = jshd.param_specs(jm, ps, mesh, jshd.make_rules())
    out = {"params": _ref_local_bytes(ps, pspec, axes)}
    sh = J_SHAPES[shape]
    ispec = j_input_specs(jget(arch), shape)
    if sh["kind"] == "train":
        ospec = jshd.opt_state_specs(pspec, ps, mesh, zero1=zero1)
        f32 = jax.tree_util.tree_map(
            lambda t: jax.ShapeDtypeStruct(t.shape, jnp.float32), ps)
        # m and v, plus the int32 step
        out["opt_state"] = 2 * _ref_local_bytes(f32, ospec["m"], axes) + 4
    if sh["kind"] == "decode":
        B, L = sh["global_batch"], sh["seq_len"]
        cs = jm.cache_spec(B, L)
        out["cache"] = _ref_local_bytes(
            cs, jshd.cache_specs(jm.cache_axes(), cs, mesh), axes)
        io = {"tokens": jax.ShapeDtypeStruct((B, 1), jnp.int32),
              "pos": jax.ShapeDtypeStruct((), jnp.int32)}
        out["batch"] = _ref_local_bytes(io, jshd.slot_specs(io, mesh), axes)
    else:
        out["batch"] = _ref_local_bytes(
            ispec, jshd.batch_specs(ispec, mesh), axes)
    return out


ARG_CASES = [(a, s, z) for a in ("smollm-360m", "deepseek-v3-671b",
                                 "falcon-mamba-7b")
             for s, z in (("train_4k", False), ("train_4k", True),
                          ("prefill_32k", False), ("decode_32k", False))]


@pytest.mark.parametrize("arch,shape,zero1", ARG_CASES)
def test_argument_bytes_match_reference_specs(arch, shape, zero1):
    for kind, axes in PROD.items():
        mesh = make_production_mesh(multi_pod=kind == "multi")
        res = dryrun.lower_cell(arch, shape, mesh, zero1=zero1,
                                skip_full=True)
        mem = res["memory_analysis"]
        want = _ref_arguments(arch, shape, axes, zero1)
        assert mem["argument_parts"] == want, kind
        assert mem["argument_size_in_bytes"] == sum(want.values())


def test_refused_cell_keeps_its_memory_part():
    """falcon-mamba-7b's decode_32k under "model" 16, once refused (its
    Mamba layers had no tensor-parallel form), now runs the meta pass:
    a cost, a temp size, a roofline, and the d_inner shards' collectives."""
    res = dryrun.lower_cell("falcon-mamba-7b", "decode_32k",
                            make_production_mesh())
    assert res["status"] == "ok"
    mem, cost = res["memory_analysis"], res["cost_analysis"]
    assert "error" not in cost and cost["flops"] > 0
    assert cost["bytes accessed"] > 0
    assert mem["temp_size_in_bytes"] > 0 and mem["output_size_in_bytes"] > 0
    assert res["roofline"]["bound_s"] > 0
    # per layer: the w_in regroup (all-to-all), the B/C/dt and output sums
    n = get_config("falcon-mamba-7b").n_layers
    assert res["collectives"]["all-to-all"]["count"] == n
    assert res["collectives"]["all-reduce"]["count"] == 2 * n + 1


# --- costs -----------------------------------------------------------------

@pytest.mark.parametrize("arch,shape", [("smollm-360m-smoke", "train_4k"),
                                        ("gemma3-4b-smoke", "prefill_32k"),
                                        ("qwen3-moe-30b-a3b-smoke",
                                         "decode_32k")])
def test_full_depth_equals_unit_extrapolation(arch, shape):
    mesh = ShapeMesh(("data", "model"), (2, 2))
    cfg = dryrun.cell_config(dryrun.depth_variant(get_config(arch), 5),
                             mesh)
    rules = dryrun.shd.make_rules()
    res = dryrun.lower_cell(arch, shape, mesh, remat="full", cfg=cfg)
    cost, coll, raw = dryrun.unit_extrapolated_costs(
        cfg, shape, mesh, remat="full", zero1=False, rules=rules)
    assert raw["unit3"]["cost"]["flops"] > raw["unit2"]["cost"]["flops"]
    for m in ("flops", "bytes accessed"):
        assert cost[m] == res["cost_analysis"][m], m
    for k in dryrun._COLLECTIVES:
        assert coll[k] == res["collectives"][k], k


def _matmul_flops(cfg, B, S):
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    proj = d * H * hd + 2 * d * KV * hd + H * hd * d + 3 * d * cfg.d_ff
    attn = 2 * H * S * S * hd          # scores and P·V over all S keys
    return 2 * B * S * proj * cfg.n_layers + 2 * B * attn * cfg.n_layers \
        + 2 * B * S * d * cfg.vocab_padded


def test_dense_forward_flops_equal_the_matmul_count():
    mesh = ShapeMesh(("data", "model"), (1, 1))
    cfg = get_config("smollm-360m-smoke")
    B, S = 3, 40
    res = dryrun.lower_cell("smollm-360m-smoke", "prefill_32k", mesh,
                            batch_override=B, seq_override=S)
    assert res["cost_analysis"]["flops"] == _matmul_flops(cfg, B, S)
    # the stand-ins drop the two attention products; kernel_costs adds
    # the flash kernel's forward at the shape's own (unoverridden) size
    opt = dryrun.lower_cell("smollm-360m-smoke", "prefill_32k", mesh,
                            batch_override=B, seq_override=S,
                            impl="optimized")
    kf, kb = dryrun.kernel_costs(dryrun.optimized_cfg(cfg, mesh),
                                 "prefill_32k", mesh)
    attn = 2 * B * 2 * cfg.n_heads * S * S * cfg.head_dim * cfg.n_layers
    assert opt["cost_analysis"]["flops"] == \
        _matmul_flops(cfg, B, S) - attn + kf
    assert opt["kernel_adjustment"] == {"flops": kf, "bytes": kb}


def test_collectives_of_tp2_dp2_match_a_hand_count():
    """smollm-360m-smoke (2 layers, d 64, vocab 512) trained at batch 4 x
    8 on 2 x 2: heads, KV heads, MLP and vocab shard over "model", the
    rows over "data" (2 a rank).  Forward: the vocab-sharded embedding's
    sum and each layer's attention and MLP sums, fp32 (B, S, d); the head
    gathers its bf16 (B, S, V/2) logits.  Backward: the input's gradient
    of each column-parallel product (``Spmd.column``: q, k and v of each
    layer, the MLP's gate and up, and the head), fp32 (B, S, d).  The
    loss sums its NLL (fp32) and token count (int64) over "data", and
    every gradient is summed over "data"."""
    mesh = ShapeMesh(("data", "model"), (2, 2))
    cfg = get_config("smollm-360m-smoke")
    res = dryrun.lower_cell("smollm-360m-smoke", "train_4k", mesh,
                            remat="none", batch_override=4, seq_override=8)
    B, S, d, L = 2, 8, cfg.d_model, cfg.n_layers
    n_params = 1 + 9 * L + 1
    param_bytes = res["memory_analysis"]["argument_parts"]["params"]
    want_ar = {"count": (1 + 2 * L) + (5 * L + 1) + 2 + n_params,
               "operand_bytes": (1 + 2 * L) * B * S * d * 4
               + (5 * L + 1) * B * S * d * 4 + 4 + 8 + param_bytes}
    want_ag = {"count": 1, "operand_bytes": B * S * cfg.vocab_padded // 2 * 2}
    coll = res["collectives"]
    assert coll["all-reduce"] == want_ar
    assert coll["all-gather"] == want_ag
    assert coll["total_wire_bytes"] == 2 * want_ar["operand_bytes"] \
        + want_ag["operand_bytes"]
    # ZeRO-1: every parameter has a free dimension that 2 divides, so
    # each rank updates half of it and gathers the halves over "data"
    z1 = dryrun.lower_cell("smollm-360m-smoke", "train_4k", mesh,
                           remat="none", batch_override=4, seq_override=8,
                           zero1=True)
    assert z1["collectives"]["all-reduce"] == want_ar
    assert z1["collectives"]["all-gather"] == {
        "count": 1 + n_params,
        "operand_bytes": want_ag["operand_bytes"] + param_bytes // 2}
    assert z1["memory_analysis"]["argument_parts"]["opt_state"] == \
        param_bytes + 4


def _coll(arch, **kw):
    res = dryrun.lower_cell(arch, "train_4k", ShapeMesh(("data", "model"),
                                                        (2, 2)),
                            remat="none", batch_override=4, seq_override=8,
                            **kw)
    return res["collectives"], res["memory_analysis"]["argument_parts"]


def test_collectives_of_mamba_tp2_dp2_match_a_hand_count():
    """falcon-mamba-7b-smoke (2 layers, d 64, d_inner 128 -> 64 a rank,
    d_state 4, dt_rank 4, vocab 512 untied) at batch 4 x 8 on 2 x 2.  A
    layer: forward, the w_in regroup (an all-to-all of the two bf16 (2, B
    S, 64) column pieces) and the fp32 sums of B/C/dt (B, S, 12) and of
    the output (B, S, d); backward, the regroup's all-to-all back, the
    input's gradient of w_in (fp32 (B, S, d)) and B/C/dt's (fp32 (B, S,
    12)).  Plus the embedding's sum, the head's gather and gradient, the
    loss's two sums and every gradient over "data"."""
    coll, args = _coll("falcon-mamba-7b-smoke")
    B, S, d, dl, w, L = 2, 8, 64, 64, 12, 2
    n_params = 1 + 10 * L + 1 + 1
    layer = 2 * (B * S * w * 4) + 2 * (B * S * d * 4)
    assert coll["all-to-all"] == {"count": 2 * L,
                                  "operand_bytes": 2 * L * 2 * B * S * dl * 2}
    assert coll["all-reduce"] == {
        "count": 1 + 4 * L + 1 + 2 + n_params,
        "operand_bytes": 2 * B * S * d * 4 + L * layer + 4 + 8
        + args["params"]}
    assert coll["all-gather"] == {"count": 1,
                                  "operand_bytes": B * S * 256 * 2}


def test_collectives_of_mla_tp2_dp2_match_a_hand_count():
    """deepseek-v3-671b-smoke (a dense MLA layer with a d_ff 18432 MLP,
    then two MLA + MoE layers; d 64, 4 heads, q_lora 32, kv_lora 16, rope
    8, 4 experts top-2 with one shared, vocab 512 untied) at batch 4 x 8
    on 2 x 2.  MLA: forward, the wo sum (fp32 (B, S, d)); backward, the
    latents' gradients where they meet this rank's heads (fp32 cq (B, S,
    32), ckv (B, S, 16), k_rope (B, S, 8)).  Dense MLP: the w_down sum and
    gate's and up's input gradients (fp32 (B, S, d)).  MoE (pooled, the
    batch gathered over "data": 32 tokens): the gates' gradient (fp32
    (32, 2)), the tokens' (bf16 (32, d)), the experts' bf16 sum (B, S, d)
    and the shared expert as the dense MLP.  Plus the embedding's sum,
    the head's gather and gradient, the loss's two sums and the 50
    gradients over "data"."""
    coll, args = _coll("deepseek-v3-671b-smoke")
    B, S, d, N = 2, 8, 64, 32
    act = B * S * d * 4
    mla = act + B * S * (32 + 16 + 8) * 4
    mlp = 3 * act
    moe = N * 2 * 4 + N * d * 2 + B * S * d * 2 + mlp
    assert coll["all-reduce"] == {
        "count": 1 + 3 * 4 + 3 + 2 * 6 + 1 + 2 + 50,
        "operand_bytes": act + 3 * mla + mlp + 2 * moe + act + 4 + 8
        + args["params"]}
    # the head's logits and the MoE layers' gathered batch (bf16)
    assert coll["all-gather"] == {
        "count": 3, "operand_bytes": B * S * 256 * 2 + 2 * B * S * d * 2}
    assert coll["all-to-all"]["count"] == 0


# --- remat -------------------------------------------------------------------

def test_remat_modes_give_equal_loss_and_gradients():
    cfg = get_config("smollm-360m-smoke")
    tok = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab, size=(2, 24)))
    out = {}
    for remat in REMAT_MODES:
        m = build_model(cfg, device="cpu", remat=remat,
                        generator=torch.Generator().manual_seed(0))
        loss, _ = m.loss({"tokens": tok, "labels": tok})
        loss.backward()
        out[remat] = (loss.detach(), [p.grad for p in m.parameters()])
    for remat in ("full", "dots_saveable"):
        assert torch.equal(out[remat][0], out["none"][0])
        assert all(torch.equal(a, b) for a, b in
                   zip(out[remat][1], out["none"][1]))
    with pytest.raises(ValueError):
        build_model(cfg, device="cpu", remat="some")


def test_remat_lowers_the_meta_peak():
    mesh = ShapeMesh(("data", "model"), (1, 1))
    peak = {r: dryrun.lower_cell(
        "smollm-360m-smoke", "train_4k", mesh, remat=r, batch_override=4,
        seq_override=512)["memory_analysis"]["temp_size_in_bytes"]
        for r in REMAT_MODES}
    assert peak["full"] < peak["dots_saveable"] < peak["none"], peak


def test_meta_pass_leaves_spmd_as_it_found_it():
    mesh = ShapeMesh(("data", "model"), (2, 2))
    before = (spmd.current(), spmd._all_gather, spmd._all_reduce)
    dryrun.lower_cell("qwen3-moe-30b-a3b-smoke", "train_4k", mesh,
                      batch_override=4, seq_override=8, impl="optimized")
    assert (spmd.current(), spmd._all_gather, spmd._all_reduce) == before


# --- CLI ---------------------------------------------------------------------

_CLI = """
import runpy, sys
out = sys.argv[1]
sys.argv = ["dryrun", "--arch", "smollm-360m", "--shape", "decode_32k",
            "--mesh", "both", "--impl", "optimized", "--out", out]
try:
    runpy.run_module("repro_torch.launch.dryrun", run_name="__main__")
except SystemExit as e:
    assert not e.code, e.code
sys.argv = ["roofline_report", "--dir", out]
runpy.run_module("repro_torch.launch.roofline_report", run_name="__main__")
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "repro" or m.startswith("repro."))
print("leaked:", bad)
"""


def test_cli_and_roofline_report_end_to_end(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, "-c", _CLI, str(tmp_path)],
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    assert "leaked: []" in lines
    files = sorted(p.name for p in tmp_path.iterdir())
    assert files == ["smollm-360m__decode_32k__multi__optimized.json",
                     "smollm-360m__decode_32k__single__optimized.json"]
    for name in files:
        cell = json.loads((tmp_path / name).read_text())
        assert cell["status"] == "ok" and cell["impl"] == "optimized"
        assert cell["memory_analysis"]["temp_size_in_bytes"] > 0
        assert cell["cost_analysis"]["flops"] > 0
        assert cell["hardware"]["peak_flops_bf16"] == 989e12
    rows = [ln for ln in lines if ln.startswith("roofline/")]
    assert len(rows) == 3
    for kind in ("single", "multi"):
        row = next(r for r in rows if f"/{kind}/optimized," in r)
        assert "dominant=" in row and "roofline_frac=" in row
    assert rows[-1] == "roofline/summary,,cells_ok=2;cells_err=0;" \
        "cost_refused=0"
