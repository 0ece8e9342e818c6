"""PyTorch port vs the JAX reference: optim (AdamW, cosine schedule,
global-norm clipping, the decay mask) and optim.compress.

Identical numpy parameters and gradients go through both optimizers;
parameters and moments must agree to 1e-6 after 3 steps (fp32 arithmetic
in the same op order; pow/cos may differ by an ulp).  compress_grads is
held bitwise."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models.transformer import DecoderLM as JLM
from repro.optim import AdamW as JAdamW
from repro.optim import clip_by_global_norm as jclip
from repro.optim import cosine_schedule as jcosine
from repro.optim.compress import compress_grads as jcompress
from repro.optim.compress import init_error as jinit_error
from repro_torch.bridge import load_jax_params, reference_ndim
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.optim import (AdamW, clip_by_global_norm, cosine_schedule,
                               param_groups)
from repro_torch.optim.compress import (compress_grads, dequantize_int8,
                                        init_error, quantize_int8)

torch.set_num_threads(1)


def test_cosine_schedule_matches_reference():
    want_fn, got_fn = jcosine(3e-4, 7, 60), cosine_schedule(3e-4, 7, 60)
    for step in (0, 1, 3, 6, 7, 8, 20, 33, 59, 60, 75):
        np.testing.assert_allclose(got_fn(step), float(want_fn(step)),
                                   rtol=1e-6, atol=0, err_msg=str(step))
    assert cosine_schedule(1e-3, 0, 10)(10) == pytest.approx(1e-4, rel=1e-6)


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_matches_reference(max_norm):
    rng = np.random.default_rng(0)
    gs = [rng.standard_normal(s).astype(np.float32) for s in
          [(4, 3), (5,), (2, 2, 2)]]
    want, wn = jclip({str(i): jnp.asarray(g) for i, g in enumerate(gs)},
                     max_norm)
    got, gn = clip_by_global_norm([torch.from_numpy(g) for g in gs],
                                  max_norm)
    np.testing.assert_allclose(float(gn), float(wn), rtol=1e-6)
    for i, g in enumerate(got):
        np.testing.assert_allclose(g.numpy(), np.asarray(want[str(i)]),
                                   rtol=1e-6, atol=1e-7)


def _tree():
    rng = np.random.default_rng(1)
    return {"a": rng.standard_normal((6, 4)).astype(np.float32),
            "b": rng.standard_normal((4,)).astype(np.float32),
            "c": rng.standard_normal((3, 2, 2)).astype(np.float32)}


@pytest.mark.parametrize("kw", [
    dict(lr="cosine", weight_decay=0.1, max_grad_norm=1.0),
    dict(lr=2e-3, weight_decay=0.0, max_grad_norm=None),
    dict(lr="cosine", weight_decay=0.3, max_grad_norm=0.05),
])
def test_adamw_three_steps_match_reference(kw):
    kw = dict(kw)
    lr = kw.pop("lr")
    lrs = (jcosine(1e-2, 1, 10), cosine_schedule(1e-2, 1, 10)) \
        if lr == "cosine" else (lr, lr)
    params = _tree()
    jopt = JAdamW(lr=lrs[0], **kw)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = jopt.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    topt = AdamW(list(tp.values()), lr=lrs[1], **kw)
    rng = np.random.default_rng(2)
    for step in range(3):
        grads = {k: (rng.standard_normal(v.shape) * (step + 1))
                 .astype(np.float32) for k, v in params.items()}
        jp, js, jm = jopt.update({k: jnp.asarray(g) for k, g in
                                  grads.items()}, js, jp)
        for k, p in tp.items():
            p.grad = torch.from_numpy(grads[k])
        tm = topt.step()
        np.testing.assert_allclose(tm["lr"], float(jm["lr"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
    tree = topt.state_tree(tp)
    assert tree["step"] == int(js["step"]) == 3
    for k, p in tp.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                   atol=1e-6, rtol=1e-6, err_msg=k)
        for mom in ("m", "v"):
            np.testing.assert_allclose(tree[mom][k].numpy(),
                                       np.asarray(js[mom][k]), atol=1e-6,
                                       rtol=1e-6)


def test_decay_mask_follows_the_reference_tree():
    """On minimalist-lm-360m-smoke the reference stacks its layers
    (scan_layers, the default): every layer leaf has ndim >= 2 there, so
    norm scales and minGRU biases are decayed and only final_norm is not.
    The port's groups carry exactly that mask, and one step moves each
    parameter as the reference's AdamW moves the bridged tree."""
    arch = "minimalist-lm-360m-smoke"
    jm = JLM(jget(arch))
    assert jm.scan_layers
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(get_config(arch), device="cpu")
    load_jax_params(tm, jax.tree_util.tree_map(np.asarray, jp))
    ndim = reference_ndim(tm)
    groups = param_groups(tm)
    names = {id(p): n for n, p in tm.named_parameters()}
    not_decayed = sorted(names[id(p)] for p in groups[1]["params"])
    assert not_decayed == ["final_norm.scale"]
    assert ndim["layers.1.norm1.scale"] == 2
    assert ndim["layers.0.mixer.block.bh"] == 2
    # one step with zero grads: only weight decay moves the parameters
    jopt = JAdamW(lr=1e-2, max_grad_norm=None)
    jg = jax.tree_util.tree_map(jnp.zeros_like, jp)
    jp1, _, _ = jopt.update(jg, jopt.init(jp), jp)
    topt = AdamW(groups, lr=1e-2, max_grad_norm=None)
    for p in tm.parameters():
        p.grad = torch.zeros_like(p)
    topt.step()
    want = build_model(get_config(arch), device="cpu")
    load_jax_params(want, jax.tree_util.tree_map(np.asarray, jp1))
    for (n, p), (_, q) in zip(tm.named_parameters(),
                              want.named_parameters()):
        np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(),
                                   atol=1e-7, rtol=1e-6, err_msg=n)


@pytest.mark.parametrize("arch", ["smollm-360m-smoke", "gemma3-4b-smoke",
                                  "qwen3-moe-30b-a3b-smoke"])
def test_decay_mask_of_attention_lms_follows_the_reference_tree(arch):
    """The attention LMs: the reference scans the repeated pattern unit,
    so every leaf of those layers (wq, wk, wv, wo, the MLP weights — the
    MoE router and expert stacks of qwen3-moe too — and the norm scales)
    is stacked and decayed; gemma3's tail layers are not
    scanned, so their 1-D norm scales are not decayed, nor is final_norm.
    Every port parameter's flag equals ``leaf.ndim >= 2`` of the
    reference leaf the bridge loads it from, and one step with zero grads
    moves each parameter as the reference's AdamW moves the tree."""
    jm = JLM(jget(arch))
    assert jm.scan_layers
    jp = jm.init(jax.random.PRNGKey(1))
    tm = build_model(get_config(arch), device="cpu")
    load_jax_params(tm, jax.tree_util.tree_map(np.asarray, jp))
    groups = param_groups(tm)
    decayed = {id(p) for p in groups[0]["params"]}
    cfg = tm.cfg
    n_unit = cfg.n_repeats * len(cfg.pattern)
    for name, p in tm.named_parameters():
        keys = name.split(".")
        if keys[0] == "layers":
            j = int(keys[1])
            if j < n_unit:
                r, i = divmod(j, len(cfg.pattern))
                node, keys = jp[f"unit{i}"], keys[2:]
            else:
                node, keys = jp[f"tail{j - n_unit}"], keys[2:]
        else:
            node = jp
        for k in keys:
            node = node[k]
        assert (id(p) in decayed) == (np.ndim(node) >= 2), name
    not_decayed = sorted(n for n, p in tm.named_parameters()
                         if id(p) not in decayed)
    tail_norms = [f"layers.{j}.{n}.scale" for j in range(n_unit,
                                                          cfg.n_layers)
                  for n in ("norm1", "norm2")]
    assert not_decayed == sorted(["final_norm.scale"] + tail_norms)
    jopt = JAdamW(lr=1e-2, max_grad_norm=None)
    jg = jax.tree_util.tree_map(jnp.zeros_like, jp)
    jp1, _, _ = jopt.update(jg, jopt.init(jp), jp)
    topt = AdamW(groups, lr=1e-2, max_grad_norm=None)
    for p in tm.parameters():
        p.grad = torch.zeros_like(p)
    topt.step()
    want = build_model(get_config(arch), device="cpu")
    load_jax_params(want, jax.tree_util.tree_map(np.asarray, jp1))
    for (n, p), (_, q) in zip(tm.named_parameters(),
                              want.named_parameters()):
        np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(),
                                   atol=1e-7, rtol=1e-6, err_msg=n)


def test_decay_mask_of_mamba_lm_follows_the_reference_tree():
    """falcon-mamba-7b-smoke: the reference scans its two Mamba layers,
    so every per-layer leaf is stacked and decayed — the 1-D ``d_skip``,
    ``dt_bias`` and ``conv_b``, ``a_log`` and the ``norm1`` scale
    included — and only ``final_norm`` is not.  One step with zero grads
    moves each parameter as the reference's AdamW moves the tree."""
    arch = "falcon-mamba-7b-smoke"
    jm = JLM(jget(arch))
    assert jm.scan_layers
    jp = jm.init(jax.random.PRNGKey(2))
    tm = build_model(get_config(arch), device="cpu")
    load_jax_params(tm, jax.tree_util.tree_map(np.asarray, jp))
    ndim = reference_ndim(tm)
    for j in range(2):
        for leaf in ("d_skip", "dt_bias", "conv_b"):
            assert np.ndim(jp["unit0"]["mixer"][leaf]) == 2
            assert ndim[f"layers.{j}.mixer.{leaf}"] == 2
        assert ndim[f"layers.{j}.mixer.a_log"] == 3
        assert ndim[f"layers.{j}.norm1.scale"] == 2
    groups = param_groups(tm)
    names = {id(p): n for n, p in tm.named_parameters()}
    assert sorted(names[id(p)] for p in groups[1]["params"]) == \
        ["final_norm.scale"]
    jopt = JAdamW(lr=1e-2, max_grad_norm=None)
    jg = jax.tree_util.tree_map(jnp.zeros_like, jp)
    jp1, _, _ = jopt.update(jg, jopt.init(jp), jp)
    topt = AdamW(groups, lr=1e-2, max_grad_norm=None)
    for p in tm.parameters():
        p.grad = torch.zeros_like(p)
    topt.step()
    want = build_model(get_config(arch), device="cpu")
    load_jax_params(want, jax.tree_util.tree_map(np.asarray, jp1))
    for (n, p), (_, q) in zip(tm.named_parameters(),
                              want.named_parameters()):
        np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(),
                                   atol=1e-7, rtol=1e-6, err_msg=n)


def test_compress_grads_bitwise():
    rng = np.random.default_rng(3)
    gs = {"w": (rng.standard_normal((16, 8)) * 3).astype(np.float32),
          "b": (rng.standard_normal((8,)) * 1e-3).astype(np.float32)}
    jerr = jinit_error({k: jnp.asarray(v) for k, v in gs.items()})
    terr = init_error({k: torch.from_numpy(v) for k, v in gs.items()})
    for step in range(3):
        g = {k: v * (step + 1) for k, v in gs.items()}
        jsent, jerr = jcompress({k: jnp.asarray(v) for k, v in g.items()},
                                jerr)
        tsent, terr = compress_grads({k: torch.from_numpy(v)
                                      for k, v in g.items()}, terr)
        for k in gs:
            np.testing.assert_array_equal(tsent[k].numpy(),
                                          np.asarray(jsent[k]))
            np.testing.assert_array_equal(terr[k].numpy(),
                                          np.asarray(jerr[k]))


def test_error_feedback_invariant():
    """sum_t dequant(c_t) + e_T == sum_t g_t (information is delayed,
    never lost)."""
    rng = np.random.default_rng(4)
    g_seq = [torch.from_numpy(rng.standard_normal(32).astype(np.float32))
             * (0.1 + i) for i in range(10)]
    err = init_error({"w": g_seq[0]})
    sent = torch.zeros(32)
    for g in g_seq:
        s, err = compress_grads({"w": g}, err)
        sent = sent + s["w"]
    np.testing.assert_allclose((sent + err["w"]).numpy(),
                               sum(g_seq).numpy(), atol=1e-4)
    q, scale = quantize_int8(g_seq[3])
    assert q.dtype == torch.int8 and int(q.abs().max()) == 127
    assert (dequantize_int8(q, scale) - g_seq[3]).abs().max() <= scale / 2
