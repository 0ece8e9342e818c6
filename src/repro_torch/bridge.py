"""Load the JAX package's parameters into the port's modules.

The reference keeps parameters as nested dicts (``init(key) -> params``);
the port's ``nn.Module``s own theirs.  :func:`load_jax_params` maps one
onto the other by path, taking the leaves as numpy arrays (the caller
converts: ``jax.tree_util.tree_map(np.asarray, params)``), so this module
imports nothing of JAX.  Path rules:

  * a port parameter ``a.b.c`` reads ``tree["a"]["b"]["c"]``;
  * ``DecoderLM.layers[j]`` reads the reference's layer of stack position
    j: ``head{i}`` / ``tail{i}`` directly, a pattern-unit layer from
    ``unit{i}`` at index r of the ``stacked_init`` layer axis (or from
    ``unit{i}_r{r}`` when the reference did not scan its layers);
  * ``MinGRUMixer``'s wrapped block is transparent (the reference's mixer
    params ARE its block's params: ``mixer.block.wh`` reads ``mixer/wh``).

``MinimalistNetwork`` needs no special rule: its ``block{i}`` names are
the reference's.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.transformer import DecoderLM


def _layer_source(cfg, tree, j):
    """(top-level key, index into a stacked layer axis or None) of stack
    position j in the reference's param tree."""
    nh, nu = len(cfg.head_layers), len(cfg.pattern)
    n_unit = cfg.n_repeats * nu
    if j < nh:
        return f"head{j}", None
    if j < nh + n_unit:
        r, i = divmod(j - nh, nu)
        if f"unit{i}" in tree:          # the reference scans: stacked axis
            return f"unit{i}", r
        return f"unit{i}_r{r}", None
    return f"tail{j - nh - n_unit}", None


def _copy_tree(module, tree, index=None, prefix=""):
    for name, p in module.named_parameters():
        keys = name.replace("mixer.block.", "mixer.").split(".")
        node = tree
        for k in keys:
            if not isinstance(node, dict) or k not in node:
                raise KeyError(f"no reference parameter for {prefix}{name} "
                               f"(looked up {'/'.join(keys)})")
            node = node[k]
        arr = np.asarray(node)
        if index is not None:
            arr = arr[index]
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"{prefix}{name}: reference shape "
                             f"{arr.shape} != port shape {tuple(p.shape)}")
        with torch.no_grad():
            p.copy_(torch.from_numpy(np.array(arr)).to(p.dtype))


def load_jax_params(module, tree):
    """Copy the reference's parameter tree ``tree`` (nested dicts of numpy
    arrays) into ``module``'s parameters in place.  Every parameter of the
    module must be found; returns the module."""
    if isinstance(module, DecoderLM):
        cfg = module.cfg
        _copy_tree(module.embed, tree["embed"], prefix="embed.")
        _copy_tree(module.final_norm, tree["final_norm"],
                   prefix="final_norm.")
        if module.lm_head is not None:
            _copy_tree(module.lm_head, tree["lm_head"], prefix="lm_head.")
        for j, layer in enumerate(module.layers):
            key, index = _layer_source(cfg, tree, j)
            _copy_tree(layer, tree[key], index=index, prefix=f"layers.{j}.")
        return module
    _copy_tree(module, tree)
    return module


def reference_ndim(module) -> dict:
    """{parameter name: ndim of the reference's leaf for it}.  A
    ``DecoderLM`` layer that the reference stacks (a pattern-unit layer
    when the unit repeats, so ``scan_layers`` is on by default) has one
    more axis there than in the port; every other leaf has the port's
    ndim.  The optimizer's decay mask reads this (``optim.param_groups``)."""
    out = {name: p.ndim for name, p in module.named_parameters()}
    if isinstance(module, DecoderLM):
        cfg = module.cfg
        nh, nu = len(cfg.head_layers), len(cfg.pattern)
        stacked = range(nh, nh + cfg.n_repeats * nu) \
            if cfg.n_repeats > 1 else range(0)
        for j in stacked:
            for name, p in module.layers[j].named_parameters():
                out[f"layers.{j}.{name}"] = p.ndim + 1
    return out
