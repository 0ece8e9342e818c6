"""The port's mixture-of-experts MLP (``repro_torch.models.moe.MoEMLP``)
against the reference's ``repro.models.moe.MoEMLP`` on the same weights
(through the bridge) and the same numpy-seeded inputs, in fp32:

  * every dispatch knob on every route (pooled, per-request and the
    gather-GEMM decode): outputs within the reference's own bounds (atol
    1e-5, rtol 1e-4, tests/test_moe.py:40-41), expert ids and
    ``dropped_frac`` exactly equal, ``aux_loss`` within 1e-6;
  * capacity drops (capacity factor 0.5): the sort order and the kept
    set equal the reference's, so do the outputs;
  * ties (a zero router; repeated rows), where the stable sort and the
    lower-index-first top-k decide;
  * shared experts, dispatch groups (an indivisible batch included),
    ``resolve_dispatch`` over every (dispatch, route) pair, and the
    gradients of a pooled forward against ``jax.grad``;
  * port only, bitwise: per-request routing does not depend on chunking
    or on co-batched rows; pooled routing does at capacity 0.5;
  * the MoE archs' configs and parameter counts are the reference's, and
    the qwen3-moe LM's loss and gradients match the reference's (the
    bounds of tests/test_torch_lm_grads.py)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs.base import MoEConfig as JMoEConfig
from repro.models.moe import MoEMLP as JMoE
from repro.models.moe import resolve_dispatch as j_resolve
from repro.models.transformer import DecoderLM as JLM
from repro_torch.bridge import load_jax_params
from repro_torch.configs import get_config
from repro_torch.configs.archs import ARCHS
from repro_torch.configs.base import MoEConfig
from repro_torch.models import build_model
from repro_torch.models.moe import MoEMLP, resolve_dispatch

torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-4)
D = 16


def _pair(seed=0, d=D, **kw):
    moe = dict(n_experts=8, top_k=2, d_ff_expert=16)
    moe.update(kw)
    jm = JMoE(d, JMoEConfig(**moe))
    jp = jm.init(jax.random.PRNGKey(seed))
    tm = MoEMLP(d, MoEConfig(**moe))
    load_jax_params(tm, jax.tree_util.tree_map(np.asarray, jp))
    return jm, jp, tm


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _run(jm, jp, tm, x, route):
    jo, ja = jm(jp, jnp.asarray(x), route=route)
    with torch.no_grad():
        to, ta = tm(torch.from_numpy(x), route=route)
    return np.asarray(jo), ja, to.numpy(), ta


def _check(jm, jp, tm, x, route):
    jo, ja, to, ta = _run(jm, jp, tm, x, route)
    np.testing.assert_allclose(to, jo, **TOL)
    assert float(ta["dropped_frac"]) == float(ja["dropped_frac"])
    assert abs(float(ta["aux_loss"]) - float(ja["aux_loss"])) <= 1e-6
    # expert ids of every token, exactly
    xt = x.reshape(-1, x.shape[-1])
    _g, jids, _p = jm._route(jp, jnp.asarray(xt), jnp.float32)
    with torch.no_grad():
        _g, tids, _p = tm._route(torch.from_numpy(xt))
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    return to, ta


def _meta(jm, jp, tm, x, G, C):
    """(reference, port) sort order and kept mask of a pooled dispatch."""
    B, S, _ = x.shape
    xt = jnp.asarray(x).reshape(G, B * S // G, -1)
    _xe, meta = jax.vmap(
        lambda t: jm._dispatch_group(jp, t, jnp.float32, C))(xt)
    with torch.no_grad():
        *_, valid = tm._grouped_ffn(torch.from_numpy(x), G, C)
    return np.asarray(meta["valid"]), valid.numpy()


@pytest.mark.parametrize("route", ["train", "prefill", "decode"])
@pytest.mark.parametrize("dispatch", ["pooled", "per_request", "auto"])
def test_every_dispatch_and_route_matches_reference(dispatch, route):
    jm, jp, tm = _pair(dispatch=dispatch, n_shared=1)
    _check(jm, jp, tm, _x((3, 10, D)), route)


@pytest.mark.parametrize("dispatch", ["pooled", "auto"])
def test_capacity_drops_match_reference(dispatch):
    """Capacity factor 0.5: a quarter of the assignments cannot fit; the
    reference's stable sort decides which, and so does the port's."""
    jm, jp, tm = _pair(dispatch=dispatch, capacity_factor=0.5)
    x = _x((2, 16, D), seed=2)
    _to, ta = _check(jm, jp, tm, x, "train")
    assert float(ta["dropped_frac"]) > 0.2
    C = MoEMLP.capacity(32, tm.moe)
    want, got = _meta(jm, jp, tm, x, 1, C)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", ["zero_router", "repeated_rows"])
def test_ties_decided_as_the_reference(case):
    """A zero router gives every expert the same probability (top-k ties:
    the lower ids win); identical rows route identically and compete for
    the same experts at capacity 0.5 (the stable sort keeps the earlier
    tokens)."""
    jm, jp, tm = _pair(capacity_factor=0.5, dispatch="pooled")
    x = _x((2, 12, D), seed=3)
    if case == "zero_router":
        jp = dict(jp, router=jnp.zeros_like(jp["router"]))
        with torch.no_grad():
            tm.router.zero_()
    else:
        x[:, 4:] = x[:, :1]
    for route in ("train", "decode"):
        _to, ta = _check(jm, jp, tm, x, route)
    want, got = _meta(jm, jp, tm, x, 1, MoEMLP.capacity(24, tm.moe))
    np.testing.assert_array_equal(got, want)
    assert not got.all()
    if case == "zero_router":
        with torch.no_grad():
            _g, ids, _p = tm._route(torch.from_numpy(x.reshape(-1, D)))
        assert (ids.numpy() == [0, 1]).all()


def test_shared_experts_match_reference():
    jm, jp, tm = _pair(n_shared=2, top_k=1, capacity_factor=2.0)
    x = _x((1, 6, D), seed=4)
    to, _ = _check(jm, jp, tm, x, "train")
    with torch.no_grad():
        for p in tm.shared.parameters():
            p.zero_()
        bare, _ = tm(torch.from_numpy(x))
    assert np.abs(to - bare.numpy()).max() > 1e-6


@pytest.mark.parametrize("B,groups", [(4, 2), (3, 2), (4, 4)])
def test_dispatch_groups_match_reference(B, groups):
    """Pooled dispatch over ``groups`` groups of the batch at tight
    capacity; a batch the count does not divide falls back to one
    group, as in the reference."""
    jm, jp, tm = _pair(groups=groups, capacity_factor=0.75,
                       dispatch="pooled")
    _check(jm, jp, tm, _x((B, 6, D), seed=5), "train")


@pytest.mark.parametrize("route", ["train", "prefill", "decode", "serve"])
@pytest.mark.parametrize("dispatch", ["pooled", "per_request", "auto",
                                      "magic"])
def test_resolve_dispatch_is_the_reference_table(dispatch, route):
    try:
        want = j_resolve(dispatch, route)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            resolve_dispatch(dispatch, route)
        assert str(got.value) == str(e)
        return
    assert resolve_dispatch(dispatch, route) == want


def test_pooled_gradients_match_jax_grad():
    """d(sum(out·w) + aux)/d(params, x) of a pooled forward with drops
    and a shared expert, against ``jax.grad`` of the reference's."""
    jm, jp, tm = _pair(n_shared=1, capacity_factor=0.75, dispatch="pooled")
    x = _x((2, 12, D), seed=6)
    w = _x((2, 12, D), seed=7)

    def jloss(p, xx):
        out, aux = jm(p, xx)
        return jnp.sum(out * w) + aux["aux_loss"]
    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    out, aux = tm(xt)
    (torch.sum(out * torch.from_numpy(w)) + aux["aux_loss"]).backward()
    flat = {"x": (xt.grad, jgx)}
    for name, p in tm.named_parameters():
        node = jgp
        for k in name.split("."):
            node = node[k]
        flat[name] = (p.grad, node)
    for name, (g, want) in flat.items():
        a = g.double().flatten()
        b = torch.from_numpy(np.asarray(want, np.float64)).flatten()
        cos = float(a @ b / (a.norm() * b.norm()))
        rel = float((a - b).norm() / b.norm())
        assert cos > 0.99 and rel < 5e-2, (name, cos, rel)


def test_per_request_routing_is_chunk_and_row_invariant():
    """Per-request dispatch is per-token top-k: a row's output is bitwise
    the same when the sequence is split into chunks or a neighbour row
    changes (the serving guarantee), and so is the gather path's."""
    _jm, _jp, tm = _pair()
    x = torch.from_numpy(_x((2, 12, D), seed=8))
    with torch.no_grad():
        full, aux = tm(x, route="prefill")
        c1, _ = tm(x[:, :5], route="prefill")
        c2, _ = tm(x[:, 5:], route="prefill")
        assert torch.equal(full, torch.cat([c1, c2], 1))
        x2 = x.clone()
        x2[1] = torch.from_numpy(_x((12, D), seed=9))
        other, _ = tm(x2, route="prefill")
        assert torch.equal(full[0], other[0])
        dec, _ = tm(x[:, :1], route="decode")
        dec1, _ = tm(x[:1, :1], route="decode")
        assert torch.equal(dec[:1], dec1)
    assert float(aux["dropped_frac"]) == 0.0


def test_pooled_routing_varies_with_chunking():
    """Under tight capacity the pooled path routes differently when the
    same tokens arrive in smaller chunks: the batch dependence the
    serving paths remove (tests/test_serve_moe.py:148-180)."""
    _jm, _jp, tm = _pair(dispatch="pooled", capacity_factor=0.5)
    x = torch.from_numpy(_x((1, 16, D), seed=10))
    with torch.no_grad():
        full, aux = tm(x, route="prefill")
        c1, _ = tm(x[:, :4], route="prefill")
        c2, _ = tm(x[:, 4:], route="prefill")
    assert float(aux["dropped_frac"]) > 0.0
    assert (full - torch.cat([c1, c2], 1)).abs().max().item() > 1e-6


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_config_and_param_count_are_the_reference_ones(name):
    """Every arch of the port carries the reference's values, and the
    analytical parameter counts (the MoE branch included) agree."""
    for n in (name, name + "-smoke"):
        cfg, want = get_config(n), jget(n)
        for f in ("d_model", "n_layers", "n_heads", "n_kv_heads",
                  "head_dim", "d_ff", "vocab", "moe", "mamba", "mla",
                  "tie_embeddings", "rope_theta"):
            assert str(getattr(cfg, f)) == str(getattr(want, f)), (n, f)
        assert [(s.kind, s.moe, s.d_ff) for s in cfg.layer_specs()] == \
            [(s.kind, s.moe, s.d_ff) for s in want.layer_specs()]
        assert cfg.param_count() == want.param_count()
        assert cfg.active_param_count() == want.active_param_count()


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b-smoke",
                                  "deepseek-v3-671b-smoke"])
def test_moe_lm_loss_and_grads_match_reference(arch):
    """The MoE LM's training loss (the pooled route, bf16 compute) and
    one step's gradients against ``jax.value_and_grad`` of the
    reference's eager ``DecoderLM(cfg, scan_layers=False).loss``: loss
    within 2e-2, every gradient tensor cosine > 0.99 and relative L2 <
    5e-2 (tests/test_torch_lm_grads.py)."""
    from repro_torch.data import SyntheticLMDataset
    jcfg = jget(arch)
    jm = JLM(jcfg, scan_layers=False)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(get_config(arch), device="cpu")
    load_jax_params(tm, jax.tree_util.tree_map(np.asarray, jp))
    b = SyntheticLMDataset(vocab=jcfg.vocab, seq_len=16).sample(2, 0)
    (jl, _), jg = jax.value_and_grad(jm.loss, has_aux=True)(
        jp, {k: jnp.asarray(v) for k, v in b.items()})
    loss, _ = tm.loss({k: torch.from_numpy(v).long() for k, v in b.items()})
    loss.backward()
    assert abs(loss.item() - float(jl)) < 2e-2
    from repro_torch.bridge import _layer_source
    for name, p in tm.named_parameters():
        keys = name.split(".")
        if keys[0] == "layers":
            key, idx = _layer_source(tm.cfg, jg, int(keys[1]))
            node, keys = jg[key], keys[2:]
        else:
            node, idx = jg, None
        for k in keys:
            node = node[k]
        want = np.asarray(node if idx is None else node[idx], np.float64)
        a = p.grad.double().flatten()
        w = torch.from_numpy(want).flatten()
        if w.norm() == 0:
            assert a.norm() == 0, name
            continue
        cos = float(a @ w / (a.norm() * w.norm()))
        rel = float((a - w).norm() / w.norm())
        assert cos > 0.99 and rel < 5e-2, (name, cos, rel)


@pytest.mark.parametrize("name", ["qwen3-moe-30b-a3b-smoke",
                                  "jamba-1.5-large-398b-smoke",
                                  "deepseek-v3-671b-smoke"])
def test_moe_smoke_archs_build_with_their_moe_layers(name):
    cfg = get_config(name)
    model = build_model(cfg, device="cpu")
    moe = [isinstance(layer.mlp, MoEMLP) for layer in model.layers]
    assert moe == [s.moe for s in cfg.layer_specs()] and any(moe)
    if name.startswith("qwen3"):
        # exact for GQA + MoE, but for the final norm the count leaves out
        assert sum(p.numel() for p in model.parameters()) == \
            cfg.param_count() + cfg.d_model


def test_bridge_loads_moe_leaves_stacked_and_unstacked():
    """The bridge reads the MoE leaves (router, expert stacks, shared
    expert) by path from the reference's scanned tree (a leading layer
    axis) and from its unscanned one, to the same port parameters; the
    optimizer's ``reference_ndim`` gives the expert stacks the scanned
    tree's ndim."""
    from repro_torch.bridge import reference_ndim
    arch = "deepseek-v3-671b-smoke"               # head layer + MoE unit
    scanned = JLM(jget(arch))
    assert scanned.scan_layers
    jp = scanned.init(jax.random.PRNGKey(3))
    assert np.ndim(jp["unit0"]["mlp"]["w_gate"]) == 4
    flat = {"head0": jp["head0"]}
    for r in range(2):
        flat[f"unit0_r{r}"] = jax.tree_util.tree_map(lambda a: a[r],
                                                     jp["unit0"])
    flat.update({k: jp[k] for k in jp if not k.startswith(("head", "unit"))})
    models = []
    for tree in (jp, flat):
        tm = build_model(get_config(arch), device="cpu")
        load_jax_params(tm, jax.tree_util.tree_map(np.asarray, tree))
        models.append(tm)
    for (n, p), (_, q) in zip(models[0].named_parameters(),
                              models[1].named_parameters()):
        assert torch.equal(p, q), n
    ndim = reference_ndim(models[0])
    for j in (1, 2):
        assert ndim[f"layers.{j}.mlp.w_gate"] == 4
        assert ndim[f"layers.{j}.mlp.router"] == 3
        assert ndim[f"layers.{j}.mlp.shared.w_down"] == 3
    assert ndim["layers.0.mlp.w_gate"] == 2         # the dense head layer

