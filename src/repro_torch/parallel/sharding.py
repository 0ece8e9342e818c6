"""Logical-axis -> mesh-axis sharding rules on a torch ``DeviceMesh``
(port of ``repro.parallel.sharding``).

Every module declares logical axis names per parameter dimension
(``axes()``, keyed by the port's parameter names).  This layer maps them
onto a mesh whose dimensions are named ("data", "model") — or ("pod",
"data", "model") for the production layouts:

  * TP ("model"): vocab, attention heads / kv heads, MLP hidden, experts,
    Mamba d_inner, minGRU hidden;
  * DP ("pod", "data"): dim 0 of batches, slot arrays and wave prompts;
    with ``zero1`` the optimizer moments also shard over "data" on their
    first free divisible dimension (ZeRO-1);
  * SP ("data"): the KV-cache length of the batch-1 long-context decode
    (``CACHE_RULES`` only; serving pins it whole).

A rule applies only when the dimension divides by the mesh axis and the
axis is not used by an earlier dimension of the same tensor, so one table
serves 96 heads (sharded) and 8 heads (replicated) alike.

A spec is a :class:`PartitionSpec`, a tuple with one entry per tensor
dimension: None, a mesh axis name, or a tuple of names.  Anything with a
``shape`` mapping of axis sizes serves as a mesh for the rules (a
``DeviceMesh`` is read through its dimension names), so the tables can be
checked on the production layouts without the cards.
:func:`placements` turns a spec into DTensor placements and
:func:`distribute_tree` places a tree of tensors.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

from repro_torch.common.pytree import map_with_axes, tree_map, tree_map2

# DP axes: pod x data (both used for the batch dimension)
DP_AXES = ("pod", "data")

# logical name -> preferred mesh axis (None = replicate)
DEFAULT_RULES = {
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "mlp": "model",
    "experts": "model",
    "d_inner": "model",
    "q_lora": None,
    "kv_lora": None,
    "head_dim": None,
    "embed": None,
    "layers": None,
}


class PartitionSpec(tuple):
    """Per-dimension mesh axes of one tensor (``jax.sharding.
    PartitionSpec``'s counterpart): ``PartitionSpec("data", None)``."""

    def __new__(cls, *parts):
        # a one-name tuple is that name, as jax normalises it
        return super().__new__(cls, tuple(
            p[0] if isinstance(p, tuple) and len(p) == 1 else p
            for p in parts))

    def __repr__(self):
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


def make_rules(overrides=None):
    rules = dict(DEFAULT_RULES)
    if overrides:
        rules.update(overrides)
    return rules


def mesh_shape(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` (its dimension names) or of
    any object whose ``shape`` is such a mapping."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def _axis_size(shape: dict, name) -> int:
    if name is None:
        return 1
    if isinstance(name, tuple):
        return int(math.prod(shape[n] for n in name))
    return int(shape[name]) if name in shape else 0


def _dp_axes(shape: dict):
    axes = tuple(a for a in DP_AXES if a in shape)
    return axes if axes else None


def spec_for(axes_tuple, shape, rules, mesh) -> PartitionSpec:
    """PartitionSpec of one tensor from its logical axes and real shape."""
    ms = mesh_shape(mesh)
    used = set()
    out = []
    for name, dim in zip(axes_tuple, shape):
        ax = rules.get(name) if name else None
        if isinstance(ax, tuple):  # drop axes absent from this mesh
            ax = tuple(a for a in ax if a in ms)
            ax = ax if len(ax) > 1 else (ax[0] if ax else None)
        elif ax is not None and ax not in ms:
            ax = None
        members = (set(ax) if isinstance(ax, tuple)
                   else {ax} if ax else set())
        sz = _axis_size(ms, ax)
        if ax and not (members & used) and 0 < sz <= dim and dim % sz == 0:
            out.append(ax)
            used |= members
        else:
            out.append(None)
    return P(*out)


def _tree_specs(axes_tree, shapes_tree, rules, mesh):
    return map_with_axes(lambda s, a: spec_for(a or (), tuple(s.shape),
                                               rules, mesh),
                         shapes_tree, axes_tree)


def _is_spec(x):
    return isinstance(x, PartitionSpec)


def _is_shaped(x):
    return hasattr(x, "shape") and not isinstance(x, (dict, list, tuple))


def param_specs(model, params_shapes, mesh, rules=None):
    """PartitionSpec tree of a model's parameters: ``model.axes()``
    against ``params_shapes`` (the same tree with shaped leaves — meta
    tensors will do; :func:`repro_torch.common.pytree.module_tree`)."""
    rules = rules or make_rules()
    return _tree_specs(model.axes(), params_shapes, rules, mesh)


def opt_state_specs(param_spec_tree, params_shapes, mesh,
                    zero1: bool = False):
    """Optimizer (m, v) specs: the parameters', optionally ZeRO-1-sharded
    over "data" on the first dimension that divides and is unused."""
    ms = mesh_shape(mesh)

    def z1(spec, shape):
        if not zero1:
            return spec
        data = _axis_size(ms, "data")
        parts = list(spec)
        parts += [None] * (len(shape.shape) - len(parts))
        if "data" in parts or data <= 1:
            return spec
        for i, (p, dim) in enumerate(zip(parts, shape.shape)):
            if p is None and dim % data == 0:
                parts[i] = "data"
                return P(*parts)
        return spec

    mv = tree_map2(z1, param_spec_tree, params_shapes, _is_spec)
    return {"m": mv, "v": mv, "step": P()}


def dim0_dp_spec(shape, mesh) -> PartitionSpec:
    """Dim 0 over (pod, data) when it divides — scalars and dims that do
    not divide replicate."""
    ms = mesh_shape(mesh)
    dp = _dp_axes(ms)
    dp_size = _axis_size(ms, dp)
    if shape and shape[0] % max(dp_size, 1) == 0 and dp_size > 1:
        return P(dp, *([None] * (len(shape) - 1)))
    return P(*([None] * len(shape)))


def batch_specs(batch_shapes, mesh):
    """Input batch: dim 0 (batch) over (pod, data) when it divides."""
    return tree_map(lambda s: dim0_dp_spec(tuple(s.shape), mesh),
                    batch_shapes, _is_shaped)


def slot_specs(shapes_tree, mesh):
    """Decode-side per-slot arrays (tokens, positions, active masks,
    sampling knobs, wave prompts, frame-streaming states): dim 0 is the
    slot or request axis and shards like a batch; trailing dims
    replicate, scalars get ``P()``."""
    return tree_map(lambda s: dim0_dp_spec(tuple(s.shape), mesh),
                    shapes_tree, _is_shaped)


# Cache rules: batch -> DP when divisible; the cache length falls back to
# "data" (sequence parallelism, the long-context batch-1 regime);
# kv heads / d_inner / heads -> "model".  spec_for's used-set keeps batch
# DP and length SP mutually exclusive.  Paged pools: the page-id axis and
# the in-page position never shard (a page is the allocator's unit and
# any decode step may read any page); pools TP-shard their kv heads, and
# int8 scale leaves ("pages", "kv_heads") ride the same rules as the
# codes they scale.
CACHE_RULES = {
    "batch": DP_AXES,
    "kv_len": "data",
    "kv_heads": "model",
    "kv_lora": None,
    "head_dim": None,
    "d_inner": "model",
    "state": None,
    "conv": None,
    "mlp": "model",
    "layers": None,
    "heads": "model",
    "frames": None,
    "embed": None,
    "pages": None,
    "page": None,
}


def cache_specs(cache_axes_tree, cache_shapes, mesh, rules=None):
    """PartitionSpec tree of decode caches from their logical axes."""
    rules = rules or CACHE_RULES
    return _tree_specs(cache_axes_tree, cache_shapes, rules, mesh)


# Serving variant: the slot batch is the DP axis and the cache length
# never shards — a decode step reads the whole cache, so a length-sharded
# cache would split every softmax across devices.
SERVE_CACHE_RULES = dict(CACHE_RULES, kv_len=None)


def serve_cache_specs(cache_axes_tree, cache_shapes, mesh, rules=None):
    """Cache specs of the serving engine's slot-batch state: slot batch
    over DP, kv heads / d_inner / minGRU hidden over "model", the cache
    length whole; page pools place as (pages, page whole, kv heads over
    "model", ...) and block tables go through the slot placement."""
    return cache_specs(cache_axes_tree, cache_shapes, mesh,
                       rules or SERVE_CACHE_RULES)


# --- torch placements ----------------------------------------------------

def placements(spec, mesh):
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each
    mesh dimension that tensor dim ``d`` names (a tuple entry such as
    ("pod", "data") names several), ``Replicate()`` on the others."""
    from torch.distributed.tensor import Replicate, Shard

    names = mesh.mesh_dim_names
    out = [Replicate()] * len(names)
    for d, ax in enumerate(spec):
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            if a is not None and a in names:
                out[names.index(a)] = Shard(d)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec bound to a mesh (``jax.sharding.NamedSharding``)."""

    mesh: Any
    spec: PartitionSpec

    @property
    def placements(self):
        return placements(self.spec, self.mesh)


def named_sharding_tree(spec_tree, mesh):
    return tree_map(lambda s: NamedSharding(mesh, s), spec_tree, _is_spec)


def distribute(t, sharding: NamedSharding):
    """One tensor onto its sharding: every rank passes the same full
    tensor and keeps its own shard (a DTensor)."""
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(t.detach(), sharding.mesh, sharding.placements)


def distribute_tree(tree, spec_tree, mesh):
    """Place a tree of full tensors per ``spec_tree`` (``named_sharding_
    tree`` plus ``device_put``): a tree of DTensors."""
    return tree_map2(lambda t, s: distribute(t, NamedSharding(mesh, s)),
                     tree, spec_tree)
