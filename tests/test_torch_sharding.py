"""The port's rule tables against the reference's, with no ranks: the
logical axes of every arch's parameters and caches, the PartitionSpecs
that ``param_specs``, ``opt_state_specs`` (ZeRO-1), ``cache_specs`` and
``serve_cache_specs`` derive from them on five mesh shapes (1x1, 2x2,
1x4, 16x16 and 2x16x16, duck-typed), at smoke and at full width (meta
tensors in the port, ``jax.eval_shape`` in the reference); then
``spec_for``, ``slot_specs``, ``batch_specs``, the pytree helpers,
``mesh_info``, ``plan_remesh`` and the DTensor placements of a spec.

The port keeps its layers in lists, so a reference leaf of a scanned
pattern unit carries one more leading "layers" axis (mapped to None by
every table): the port's entry equals the reference's with it removed.
Names are mapped as the bridge maps them (``repro_torch.bridge``)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import build_model as jbuild
from repro.parallel import sharding as jshd
from repro_torch.bridge import _layer_source
from repro_torch.common import pytree as tpt
from repro_torch.configs import ARCHS, get_config
from repro_torch.models import build_model
from repro_torch.models.whisper import EncDecLM
from repro_torch.parallel import sharding as shd


class FakeMesh:
    """Duck-typed mesh exposing .shape only."""

    def __init__(self, **axes):
        self.shape = axes


MESHES = {"1x1": dict(data=1, model=1), "2x2": dict(data=2, model=2),
          "1x4": dict(data=1, model=4), "16x16": dict(data=16, model=16),
          "2x16x16": dict(pod=2, data=16, model=16)}
SIZES = ["smoke", "full"]
CASES = [(a, s) for a in ARCHS for s in SIZES]


@functools.lru_cache(maxsize=None)
def _pair(arch, size):
    name = arch + ("-smoke" if size == "smoke" else "")
    jm = jbuild(jget(name))
    jshapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    tm = build_model(get_config(name), device="meta")
    return jm, jshapes, tm


def _flat(tree):
    return tpt.flatten_dict(tree)


def _ref_key(path, tm, ref_tree):
    """(reference path, stacked?) of the port's parameter ``path``."""
    path = list(path)
    if isinstance(tm, EncDecLM) and path[0] in ("enc", "dec"):
        rest = ["self" if k == "self_attn" else k for k in path[2:]]
        return (path[0], *rest), True
    if path[0] == "layers":
        key, index = _layer_source(tm.cfg, ref_tree, int(path[1]))
        rest = path[2:]
        if rest[:2] == ["mixer", "block"]:
            rest = ["mixer"] + rest[2:]
        return (key, *rest), index is not None
    return tuple(path), False


def _match(port_flat, ref_flat, tm, ref_tree):
    """Pairs (port leaf, reference leaf with any stacked axis dropped)."""
    out = []
    for path, leaf in port_flat.items():
        rpath, stacked = _ref_key(path, tm, ref_tree)
        ref = ref_flat[rpath]
        out.append((path, tuple(leaf), tuple(ref)[1:] if stacked
                    else tuple(ref)))
    return out


@pytest.mark.parametrize("arch,size", CASES)
def test_param_axes_and_specs_match_reference(arch, size):
    jm, jshapes, tm = _pair(arch, size)
    ref_axes = jm.axes()
    port_axes = tm.axes()
    # every parameter has its axes, and no axes without a parameter
    assert set(_flat(port_axes)) == {tuple(n.split("."))
                                     for n, _ in tm.named_parameters()}
    for path, got, want in _match(_flat(port_axes), _flat(ref_axes), tm,
                                  ref_axes):
        assert got == want, (path, got, want)
    shapes = tpt.module_tree(tm)
    for mname, axes in MESHES.items():
        mesh = FakeMesh(**axes)
        port = shd.param_specs(tm, shapes, mesh)
        ref = jshd.param_specs(jm, jshapes, mesh)
        for path, got, want in _match(_flat(port), _flat(ref), tm, ref):
            assert got == want, (mname, path, got, want)
        # ZeRO-1 moments: the stacked layer axis (None) is never the
        # first free divisible dim of a reference leaf only when its
        # depth does not divide "data"; compare unstacked leaves only
        pz = shd.opt_state_specs(port, shapes, mesh, zero1=True)
        rz = jshd.opt_state_specs(ref, jshapes, mesh, zero1=True)
        assert tuple(pz["step"]) == tuple(rz["step"]) == ()
        for path, got, want in _match(_flat(pz["m"]), _flat(rz["m"]), tm,
                                      ref):
            rpath, stacked = _ref_key(path, tm, ref)
            if not stacked:
                assert got == want, (mname, path, got, want)
            else:
                # the port's own rule on its own shape
                assert got == tuple(shd.opt_state_specs(
                    {"x": port_flat_get(port, path)},
                    {"x": port_flat_get(shapes, path)}, mesh,
                    zero1=True)["m"]["x"])


def port_flat_get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _cache_pairs(tm, jm, paged):
    """Per stack position: (port axes, port shapes, ref axes, ref shapes,
    stacked?) of its decode cache."""
    B, L, NP, PS = 4, 64, 32, 16
    if paged:
        ref_axes = jm.paged_cache_axes()
        ref_shapes = jm.paged_cache_spec(B, L, NP, PS)
        port_axes = tm.paged_cache_axes()
        port_shapes = [{k: torch.empty(s, device="meta") for k, (s, _d)
                        in spec.items()}
                       for spec in tm.paged_cache_spec(NP, PS, batch=B)]
    else:
        ref_axes = jm.cache_axes()
        ref_shapes = jm.cache_spec(B, L)
        port_axes = [l.cache_axes() for l in tm.layers]
        port_shapes = None if tm.stacked_cache else tm.init_cache(B, L)
    out = []
    for j in range(len(tm.layers)):
        key, index = _layer_source(tm.cfg, ref_axes, j)
        out.append((port_axes[j], None if port_shapes is None
                    else port_shapes[j], ref_axes[key], ref_shapes[key],
                    index is not None))
    return out


@pytest.mark.parametrize("arch,size", [c for c in CASES
                                       if "whisper" not in c[0]])
def test_cache_axes_and_serve_specs_match_reference(arch, size):
    jm, _jshapes, tm = _pair(arch, size)
    layouts = [False]
    if tm.paged_layer_names():
        layouts.append(True)
    if tm.stacked_cache:
        # one (n_layers, B, d) tensor: the reference's scanned unit leaf
        B = 4
        ref = jm.cache_axes()
        (unit,) = ref.values()
        assert tm.cache_axes() == unit["h"]
        shape = tm.init_cache(B).shape
        rshape = jax.tree_util.tree_leaves(jm.cache_spec(B, 8))[0].shape
        for axes in MESHES.values():
            mesh = FakeMesh(**axes)
            for rules in (shd.CACHE_RULES, shd.SERVE_CACHE_RULES):
                got = shd.spec_for(tm.cache_axes(), shape, rules, mesh)
                want = jshd.spec_for(unit["h"], rshape, rules, mesh)
                assert tuple(got) == tuple(want)
        return
    for paged in layouts:
        for pa, ps, ra, rs, stacked in _cache_pairs(tm, jm, paged):
            for k in pa:
                want = tuple(ra[k])[1:] if stacked else tuple(ra[k])
                assert pa[k] == want, (paged, k, pa[k], want)
            for axes in MESHES.values():
                mesh = FakeMesh(**axes)
                got = shd.serve_cache_specs(pa, ps, mesh)
                want = jshd.serve_cache_specs(ra, rs, mesh)
                got_c = shd.cache_specs(pa, ps, mesh)
                want_c = jshd.cache_specs(ra, rs, mesh)
                for k in pa:
                    for g, w in ((got, want), (got_c, want_c)):
                        w = tuple(w[k])[1:] if stacked else tuple(w[k])
                        assert tuple(g[k]) == w, (paged, axes, k, g[k], w)


def test_whisper_cache_axes_match_reference():
    for size in SIZES:
        jm, _s, tm = _pair("whisper-small", size)
        ref = jm.cache_axes()["dec"]
        for entry in tm.cache_axes():
            assert entry["xk"] == entry["xv"] == tuple(ref["xk"])[1:]
            for k, a in entry["self"].items():
                assert a == tuple(ref["self"][k])[1:]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_spec_for_slot_and_batch_specs_match_reference(mesh):
    m = FakeMesh(**MESHES[mesh])
    rng = np.random.default_rng(0)
    names = [None, "batch", "kv_len", "kv_heads", "heads", "mlp", "vocab",
             "embed", "experts", "d_inner", "pages", "head_dim"]
    for rules_name in ("DEFAULT_RULES", "CACHE_RULES", "SERVE_CACHE_RULES"):
        rules = getattr(shd, rules_name)
        assert rules == getattr(jshd, rules_name)
        for _ in range(200):
            nd = int(rng.integers(0, 5))
            axes = tuple(names[i] for i in rng.integers(0, len(names), nd))
            shape = tuple(int(v) for v in rng.choice(
                [1, 2, 3, 4, 6, 8, 15, 16, 32, 96, 128, 49152], nd))
            assert tuple(shd.spec_for(axes, shape, rules, m)) == tuple(
                jshd.spec_for(axes, shape, rules, m)), (axes, shape)
    assert shd.DP_AXES == jshd.DP_AXES
    assert shd.make_rules({"head_dim": "model"}) == jshd.make_rules(
        {"head_dim": "model"})
    tree = {"tok": (8,), "cur": (8, 3), "pos": (), "odd": (3,),
            "w": {"x": (4, 5), "y": (6,)}}
    port = shd.slot_specs(jax.tree_util.tree_map(
        lambda s: torch.empty(s, device="meta"), tree,
        is_leaf=lambda x: isinstance(x, tuple)), m)
    ref = jshd.slot_specs(jax.tree_util.tree_map(
        lambda s: jax.ShapeDtypeStruct(s, jnp.int32), tree,
        is_leaf=lambda x: isinstance(x, tuple)), m)
    pb = shd.batch_specs({"tokens": torch.empty(8, 16, device="meta"),
                          "labels": torch.empty(6, 16, device="meta")}, m)
    rb = jshd.batch_specs({"tokens": jax.ShapeDtypeStruct((8, 16), jnp.int32),
                           "labels": jax.ShapeDtypeStruct((6, 16),
                                                          jnp.int32)}, m)
    for a, b in ((tpt.flatten_dict(port), tpt.flatten_dict(ref)),
                 (pb, rb)):
        assert {k: tuple(v) for k, v in a.items()} == {
            k: tuple(v) for k, v in b.items()}
    for shape in [(), (1,), (4,), (6, 2), (32, 3, 5)]:
        assert tuple(shd.dim0_dp_spec(shape, m)) == tuple(
            jshd.dim0_dp_spec(shape, m))


def test_pytree_helpers_match_reference():
    from repro.common import pytree as jpt
    rng = np.random.default_rng(3)
    tree = {"a": {"b": rng.standard_normal((3, 4)).astype(np.float32),
                  "c": np.zeros((5,), np.int8)},
            "d": rng.standard_normal((2, 2, 2))}
    ttree = jax.tree_util.tree_map(torch.as_tensor, tree)
    meta = jax.tree_util.tree_map(lambda a: torch.empty(a.shape, dtype=a.dtype,
                                                        device="meta"), ttree)
    assert tpt.tree_param_count(ttree) == tpt.tree_param_count(meta) \
        == jpt.tree_param_count(tree)
    assert tpt.tree_size_bytes(ttree) == tpt.tree_size_bytes(meta) \
        == jpt.tree_size_bytes(tree)
    assert tpt.flatten_dict(tree).keys() == jpt.flatten_dict(tree).keys()
    assert tpt.unflatten_dict(tpt.flatten_dict(tree)).keys() == tree.keys()
    axes = {"a": {"b": ("x", None), "c": None}, "d": ("y", "z", None)}
    got = tpt.map_with_axes(lambda p, a: (p.shape, a), tree, axes)
    want = jpt.map_with_axes(lambda p, a: (p.shape, a), tree, axes)
    assert got == want


def test_mesh_info_and_plan_remesh_match_reference():
    from repro.launch.mesh import mesh_info as jinfo
    from repro.train.elastic import plan_remesh as jplan
    from repro_torch.launch.mesh import mesh_info
    from repro_torch.train.elastic import plan_remesh
    for axes in MESHES.values():
        assert mesh_info(FakeMesh(**axes)) == jinfo(FakeMesh(**axes))
    for left, model, old in [(2, 2, 2), (6, 2, 4), (7, 1, 8), (16, 4, 4),
                             (4, 4, 1)]:
        a, b = plan_remesh(left, model, old), jplan(left, model, old)
        assert (a.new_data, a.new_model, a.accum_multiplier) == (
            b.new_data, b.new_model, b.accum_multiplier)
    with pytest.raises(AssertionError):
        plan_remesh(1, 2, 2)


def test_placements_of_a_spec():
    from torch.distributed.tensor import Replicate, Shard

    class NamedMesh:
        mesh_dim_names = ("pod", "data", "model")
        shape = (2, 2, 2)

    m = NamedMesh()
    P = shd.P
    assert shd.placements(P(None, "model", None), m) == (
        Replicate(), Replicate(), Shard(1))
    assert shd.placements(P(("pod", "data"), None), m) == (
        Shard(0), Shard(0), Replicate())
    assert shd.placements(P(), m) == (Replicate(),) * 3
    assert shd.placements(P("data", "model"), m) == (
        Replicate(), Shard(0), Shard(1))
    assert shd.mesh_shape(m) == {"pod": 2, "data": 2, "model": 2}


def test_make_local_mesh_rejects_bad_axes_before_any_group():
    from repro_torch.launch.mesh import make_local_mesh
    with pytest.raises(ValueError, match="mesh axes must be >= 1"):
        make_local_mesh(model=0, data=1, device="cpu")
    with pytest.raises(ValueError, match=">= 1"):
        make_local_mesh(model=1, data=-2, device="cpu")
    assert not torch.distributed.is_initialized()
