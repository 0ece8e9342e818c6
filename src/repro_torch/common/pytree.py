"""Small tree utilities over the port's nested dicts (and lists) of
tensors (port of ``repro.common.pytree``).

A leaf is anything that is not a dict, list or tuple; the size helpers
read ``.shape`` and ``.dtype`` only, so meta tensors (and any object
with those two attributes) count like real ones.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def tree_leaves(tree):
    """Leaves in order: dict values by insertion order, lists and tuples
    by index."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def _itemsize(dtype) -> int:
    if isinstance(dtype, torch.dtype):
        return dtype.itemsize
    return np.dtype(dtype).itemsize


def tree_param_count(tree) -> int:
    """Total number of scalar parameters (works on meta tensors)."""
    return int(sum(math.prod(l.shape) for l in tree_leaves(tree)))


def tree_size_bytes(tree) -> int:
    """Total bytes (works on meta tensors)."""
    return int(sum(math.prod(l.shape) * _itemsize(l.dtype)
                   for l in tree_leaves(tree)))


def is_leaf(x):
    """Not a dict, list or tuple."""
    return not isinstance(x, (dict, list, tuple))


def tree_map(fn, tree, leaf=is_leaf):
    """``fn`` over the leaves of ``tree`` (``leaf`` says what a leaf is);
    lists and tuples come back as lists."""
    if leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, leaf) for k, v in tree.items()}
    return [tree_map(fn, v, leaf) for v in tree]


def tree_map2(fn, tree, other, leaf=is_leaf):
    """``fn(leaf, other's entry there)`` over ``tree`` and a tree
    ``other`` of the same structure (down to ``tree``'s leaves)."""
    if leaf(tree):
        return fn(tree, other)
    if isinstance(tree, dict):
        return {k: tree_map2(fn, v, other[k], leaf) for k, v in tree.items()}
    return [tree_map2(fn, v, o, leaf) for v, o in zip(tree, other)]


def map_with_axes(fn, params, axes):
    """Map ``fn(param, logical_axes)`` over a params tree; ``axes``
    mirrors ``params`` with tuples of logical axis names (or None) as
    leaves."""
    return tree_map2(lambda a, p: fn(p, a), axes, params,
                     lambda x: x is None or isinstance(x, tuple))


def flatten_dict(d, prefix=()):
    """Nested dict -> {('a', 'b'): leaf}."""
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(flatten_dict(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def unflatten_dict(flat):
    """Inverse of :func:`flatten_dict`."""
    out = {}
    for path, v in flat.items():
        cur = out
        for k in path[:-1]:
            cur = cur.setdefault(k, {})
        cur[path[-1]] = v
    return out


def module_tree(module):
    """A module's parameters as the nested dict its dotted names spell
    (``layers.0.mixer.wq`` -> ``{"layers": {"0": {"mixer": {"wq": p}}}}``),
    the tree the modules' ``axes()`` mirror."""
    return unflatten_dict({tuple(n.split(".")): p
                           for n, p in module.named_parameters()})
