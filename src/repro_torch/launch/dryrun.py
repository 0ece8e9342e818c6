"""Dry-run of every (arch x shape x mesh) cell on ``meta`` tensors (port
of ``repro.launch.dryrun``).

The reference lowers and compiles each cell with XLA on 512 fake host
devices.  Here one device's share of the step runs on ``meta`` tensors
at full width and full depth: no memory is allocated and no kernel runs,
but every aten op of the eager step is seen.  For each cell (into
``build/dryrun/*.json`` unless ``--out`` says otherwise):

  * ``memory_analysis`` — ``argument_size_in_bytes`` is the exact sum of
    the per-device bytes of the parameters, the AdamW moments (ZeRO-1
    with ``--zero1``), the batch and the decode cache, each cut by the
    rule tables (``parallel.sharding``: ``param_specs``,
    ``opt_state_specs``, ``batch_specs``, ``cache_specs``,
    ``slot_specs``); ``temp_size_in_bytes`` is the peak of the bytes of
    the storages the step creates that are alive at once (a
    ``TorchDispatchMode`` counts each new storage and frees it when the
    storage dies); ``output_size_in_bytes`` the bytes the step returns
    (train: the updated parameters and moments, in place);
  * ``cost_analysis`` — ``flops`` from ``torch.utils.flop_counter.
    FlopCounterMode`` over the same step; ``bytes accessed`` is the eager
    count: each aten op that is not a view adds its inputs' and outputs'
    bytes (what an unfused eager step moves).  Eager code runs every
    layer, so the full-depth count needs no extrapolation
    (:func:`unit_extrapolated_costs` stays, and equals it);
  * ``collectives`` — the modules run on their local shards through
    ``parallel.spmd``; the collectives there (``_all_gather``,
    ``_all_reduce``, ``_all_to_all``: Mamba's ``w_in`` regroup) are
    replaced by a recorder that returns ``meta`` tensors of the right
    shape and logs kind, count and operand bytes,
    plus the gradient sum over "data" (and over "model" for the partial
    gradients) that ``spmd.sync_grads`` makes.  All-reduce wire bytes
    count 2x the operand (ring);
  * the three roofline terms against NVIDIA H100 SXM data-sheet peaks
    (dense, 700 W): 989e12 FLOP/s bf16, 3.35e12 B/s HBM, 450e9 B/s
    NVLink each way.  A 16-wide "model" axis spans more than one 8-card
    host, so the collective term is optimistic there.

``--impl optimized`` runs the stand-ins (``attention_impl``/``ssm_impl``
``"stub"``) and adds the flash and fused-scan kernels' analytic cost
(:func:`kernel_costs`); ``baseline`` runs the naive softmax and the
materialising scan.  Meta tensors never reach a hand-written kernel.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-360m \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback
import weakref
from pathlib import Path

import torch
from torch import nn
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.common.pytree import (flatten_dict, module_tree,
                                       tree_map2, tree_size_bytes)
from repro_torch.configs import (ASSIGNED, SHAPES, get_config, input_specs,
                                 shape_supported)
from repro_torch.launch.mesh import make_production_mesh, mesh_info
from repro_torch.models import build_model
from repro_torch.optim import AdamW, param_groups
from repro_torch.parallel import sharding as shd
from repro_torch.parallel import spmd

RESULTS_DIR = str(Path(__file__).resolve().parents[3] / "build" / "dryrun")

# NVIDIA H100 SXM data-sheet peaks (dense, 700 W), per card
PEAK_FLOPS = 989e12          # bf16
HBM_BW = 3.35e12             # bytes/s
NVLINK_BW = 450e9            # bytes/s each way
HARDWARE = {
    "card": "NVIDIA H100 SXM, data-sheet peaks (dense, 700 W)",
    "peak_flops_bf16": PEAK_FLOPS, "hbm_bytes_per_s": HBM_BW,
    "nvlink_bytes_per_s_each_way": NVLINK_BW,
    "note": "predictions, not measurements; a 16-wide 'model' axis spans "
            "more than one 8-card host, so the collective term (NVLink "
            "rate throughout) is optimistic there",
}
BYTES_NOTE = ("eager count: each non-view aten op's input bytes plus its "
              "output bytes (what an unfused eager step moves)")

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


# --- the collective recorder ---------------------------------------------

class Collectives:
    """Stands in for ``spmd._all_gather``/``_all_reduce``/``_all_to_all``:
    returns
    ``meta`` tensors of the collective's result shape and logs each call
    (the group is the mesh axis name, its size from ``sizes``)."""

    def __init__(self, sizes: dict):
        self.sizes = sizes
        self.log = {k: {"count": 0, "operand_bytes": 0} for k in _COLLECTIVES}

    def _add(self, kind, t):
        self.log[kind]["count"] += 1
        self.log[kind]["operand_bytes"] += _nbytes(t)

    def all_gather(self, t, group, dim):
        self._add("all-gather", t)
        shape = list(t.shape)
        shape[dim] *= self.sizes[group]
        return t.new_empty(shape)

    def all_reduce(self, t, group, op=None):
        del group, op
        self._add("all-reduce", t)
        return t.clone()

    def all_to_all(self, t, group, in_splits, out_splits):
        del group, in_splits
        self._add("all-to-all", t)
        return t.new_empty((sum(out_splits),) + tuple(t.shape[1:]))

    def summary(self) -> dict:
        """The reference's ``collectives`` layout."""
        out = {k: dict(v) for k, v in self.log.items()}
        out["total_operand_bytes"] = sum(v["operand_bytes"]
                                         for v in self.log.values())
        out["total_wire_bytes"] = sum(
            v["operand_bytes"] * (2 if k == "all-reduce" else 1)
            for k, v in self.log.items())
        return out


class DrySpmd(spmd.Spmd):
    """Rank (0, 0) of a (data, model) mesh of the given sizes, with no
    devices: the groups are the axis names, which the recorder reads.
    ``batch_rows``: whether the step's batch rows shard over "data"
    (``sharding.batch_specs``' rule)."""

    def __init__(self, dp: int, tp: int, batch_rows: bool = False):
        self.mesh = None
        self.dp, self.tp = int(dp), int(tp)
        self.dp_rank = self.tp_rank = 0
        self.data_group = "data" if self.dp > 1 else None
        self.model_group = "model" if self.tp > 1 else None
        self.step = None
        self.rows_sharded = False
        self.batch_rows = batch_rows

    def batch_sharded(self, t) -> bool:
        return self.batch_rows


@contextlib.contextmanager
def recording(s: DrySpmd, coll: Collectives):
    """Run the modules as rank ``s`` with ``coll`` in place of the
    collectives of ``parallel.spmd``; both are restored on exit."""
    saved = (spmd._CURRENT, spmd._all_gather, spmd._all_reduce,
             spmd._all_to_all)
    spmd._CURRENT = s
    spmd._all_gather, spmd._all_reduce, spmd._all_to_all = \
        coll.all_gather, coll.all_reduce, coll.all_to_all
    try:
        yield s
    finally:
        (spmd._CURRENT, spmd._all_gather, spmd._all_reduce,
         spmd._all_to_all) = saved


# --- the meta pass ---------------------------------------------------------

def _moves_bytes(func) -> bool:
    name = func.__name__
    return not (func.is_view or name.startswith(("_unsafe_view", "alias",
                                                 "detach", "empty",
                                                 "new_empty", "lift_fresh")))


class MetaPass(TorchDispatchMode):
    """Live storage bytes, eager bytes accessed and FLOPs of the ops run
    inside.

    Each storage an op output brings that is not among ``known`` (the
    step's arguments) is counted live until it dies (a finalizer on the
    storage); ``peak`` is the most ever live at once.  ``bytes`` adds
    each op's input and output tensor bytes, views excepted.  ``flops``
    is ``torch.utils.flop_counter.FlopCounterMode``'s count of the same
    ops (its registry, fed from here: entering the counter itself would
    add module hooks that keep activations alive past a checkpointed
    unit and distort the peak)."""

    def __init__(self, known=()):
        from torch.utils.flop_counter import FlopCounterMode

        super().__init__()
        self.counter = FlopCounterMode(display=False)
        self.known = {t.untyped_storage()._cdata for t in known}
        self.alive = {}
        self.live = self.peak = self.bytes = 0

    def _free(self, key):
        self.live -= self.alive.pop(key, 0)

    def _track(self, t):
        st = t.untyped_storage()
        key = st._cdata
        if key in self.known or key in self.alive:
            return
        n = st.nbytes()
        self.alive[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    @property
    def flops(self) -> int:
        return self.counter.get_total_flops()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.counter._count_flops(func._overloadpacket, out, args, kwargs)
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        for t in outs:
            self._track(t)
        if _moves_bytes(func):
            ins = [t for t in tree_leaves((args, kwargs))
                   if isinstance(t, torch.Tensor)]
            self.bytes += sum(_nbytes(t) for t in ins + outs)
        return out


# --- steps -------------------------------------------------------------------

def build_train_step(model, opt, sync=None):
    """One training step on the model's parameters: the loss, its
    backward, ``sync(model)`` (the gradient sum; default
    ``spmd.sync_grads``) and the AdamW update.  Returns the metrics."""
    def train_step(batch):
        for p in model.parameters():
            p.grad = None
        loss, metrics = model.loss(batch)
        loss.backward()
        (sync or spmd.sync_grads)(model)
        return dict(metrics, **opt.step())

    return train_step


def build_serve_step(model):
    def serve_step(cache, tokens, pos):
        logits, cache = model.decode_step(tokens, cache, pos)
        # greedy sampling (argmax): the serving inner loop
        next_tok = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        return next_tok, cache

    return serve_step


def build_prefill_step(model):
    def prefill_step(batch):
        return model(**batch)

    return prefill_step


def optimized_cfg(cfg, mesh):
    """The kernel variant: flash attention and the fused selective scan
    run as stand-ins (``stub``; :func:`kernel_costs` adds the kernels'
    analytic cost) and the MoE dispatch groups equal the DP degree."""
    kw = {"moe_constraints": cfg.moe is not None}
    if cfg.n_heads:
        kw["attention_impl"] = "stub"
    if cfg.mamba is not None:
        kw["ssm_impl"] = "stub"
    if cfg.moe is not None:
        # (dispatch is already pinned to "pooled" by lower_cell)
        kw["moe"] = dataclasses.replace(cfg.moe,
                                        groups=mesh_info(mesh)["dp"])
    return dataclasses.replace(cfg, **kw)


def kernel_costs(cfg, shape, mesh):
    """Analytic per-device (flops, hbm_bytes) of the kernel regions the
    optimized step runs as stand-ins (the reference's accounting): batch
    divides by the DP degree; heads divide by the model degree only when
    they shard (replicated attention repeats on every model shard)."""
    from repro_torch.kernels.flash_attention.ops import cost_model as fa_cost
    from repro_torch.kernels.fused_ssm.ops import cost_model as ssm_cost

    sh = SHAPES[shape]
    info = mesh_info(mesh)
    dp, tp = info["dp"], info["tp"]
    B = max(sh["global_batch"] // dp, 1)
    S = sh["seq_len"]
    train = sh["kind"] == "train"
    if sh["kind"] == "decode":   # decode paths don't use the stand-ins
        return 0.0, 0.0

    flops = bytes_ = 0.0
    for spec in cfg.layer_specs():
        if spec.kind in ("attn", "attn_local") and cfg.n_heads:
            H = cfg.n_heads // tp if cfg.n_heads % tp == 0 else cfg.n_heads
            KV = (cfg.n_kv_heads // tp if cfg.n_kv_heads % tp == 0
                  else cfg.n_kv_heads)
            window = cfg.sliding_window if spec.kind == "attn_local" else None
            f, b = fa_cost(B, H, KV, S, cfg.head_dim, causal=True,
                           window=window, train=train)
            flops += f
            bytes_ += b
        elif spec.kind == "mla" and cfg.mla:
            m = cfg.mla
            H = cfg.n_heads // tp if cfg.n_heads % tp == 0 else cfg.n_heads
            hd = (m.qk_nope_head_dim + m.qk_rope_head_dim
                  + m.v_head_dim) // 2   # qk + pv matmul average width
            f, b = fa_cost(B, H, H, S, hd, causal=True, train=train)
            flops += f
            bytes_ += b
        elif spec.kind == "mamba" and cfg.mamba:
            di = cfg.mamba.d_inner(cfg.d_model)
            di = di // tp if di % tp == 0 else di
            f, b = ssm_cost(B, S, di, cfg.mamba.d_state, train=train)
            flops += f
            bytes_ += b
    return flops, bytes_


def _local_shape(shape, spec, axes: dict):
    """Per-device shape of a tensor of ``shape`` placed by ``spec``."""
    out = []
    for i, d in enumerate(shape):
        ax = spec[i] if i < len(spec) else None
        names = ax if isinstance(ax, tuple) else (ax,) if ax else ()
        out.append(d // math.prod(axes[a] for a in names))
    return tuple(out)


def _local_tree(tree, specs, axes):
    return tree_map2(lambda t, s: torch.empty(
        _local_shape(t.shape, s, axes), dtype=t.dtype, device="meta"),
        tree, specs)


def _zero1(p_flat, o_flat, axes):
    """{parameter name: (dim, size)} of the parameters whose moments
    ZeRO-1 shards over "data" on a dimension the parameter keeps whole."""
    out = {}
    for key, ps in p_flat.items():
        ms = o_flat[key]
        for d, (a, b) in enumerate(zip(tuple(ms), tuple(ps) + (None,) * 8)):
            if a == "data" and b != "data":
                out[".".join(key)] = (d, axes["data"])
    return out


@dataclasses.dataclass
class Cell:
    """One cell's per-device arguments: their bytes (from the tables) and,
    built on demand by :func:`_meta_step`, the local meta tensors."""

    kind: str
    arg_bytes: dict
    specs: dict


def _cell(model, cfg, shape, mesh, *, zero1, rules, batch_override=None,
          seq_override=None) -> Cell:
    """Specs and exact per-device argument bytes of one cell."""
    sh = SHAPES[shape]
    axes = mesh_info(mesh)["axes"]
    ptree = module_tree(model)
    p_spec = shd.param_specs(model, ptree, mesh, rules)
    local_bytes = lambda tree, specs: tree_size_bytes(  # noqa: E731
        _local_tree(tree, specs, axes))
    args = {"params": local_bytes(ptree, p_spec)}
    specs = {"params": p_spec}
    ispec = input_specs(cfg, shape, batch_override=batch_override,
                        seq_override=seq_override)
    if sh["kind"] == "train":
        o_spec = shd.opt_state_specs(p_spec, ptree, mesh, zero1=zero1)
        f32 = lambda t: torch.empty(t.shape, dtype=torch.float32,  # noqa
                                    device="meta")
        mtree = tree_map2(lambda t, _s: f32(t), ptree, p_spec)
        args["opt_state"] = 2 * local_bytes(mtree, o_spec["m"]) + 4  # + step
        specs["opt_state"] = o_spec
    if sh["kind"] == "decode":
        B = batch_override or sh["global_batch"]
        L = seq_override or sh["seq_len"]
        cache = model.init_cache(B, L)
        c_spec = shd.cache_specs(model.cache_axes(), cache, mesh)
        args["cache"] = local_bytes(cache, c_spec)
        io = {"tokens": ispec["tokens"], "pos": ispec["pos"]}
        io_spec = shd.slot_specs(io, mesh)
        args["batch"] = local_bytes(io, io_spec)
        specs.update(cache=c_spec, batch=io_spec, cache_full=cache)
    else:
        b_spec = shd.batch_specs(ispec, mesh)
        args["batch"] = local_bytes(ispec, b_spec)
        specs["batch"] = b_spec
    specs["inputs"] = ispec
    return Cell(sh["kind"], args, specs)


def _localize(model, p_spec, axes):
    """Replace every parameter of ``model`` by a meta tensor of its
    per-device shape, in place."""
    flat = flatten_dict(p_spec)
    for mname, mod in model.named_modules():
        pre = tuple(mname.split(".")) if mname else ()
        for pname, p in list(mod.named_parameters(recurse=False)):
            shape = _local_shape(p.shape, flat[pre + (pname,)], axes)
            mod._parameters[pname] = nn.Parameter(
                torch.empty(shape, dtype=p.dtype, device="meta"),
                requires_grad=p.requires_grad)


def _dry_sync(model, s, grad_partial):
    """``spmd.sync_grads`` on local gradients: the sum over "data" of
    every gradient and over "model" of the partial ones."""
    for name, p in model.named_parameters():
        if p.grad is None:
            continue
        if s.dp > 1:
            p.grad.copy_(spmd._all_reduce(p.grad, s.data_group))
        if s.tp > 1 and name in grad_partial:
            p.grad.copy_(spmd._all_reduce(p.grad, s.model_group))


def _meta_step(model, cfg, shape, mesh, cell: Cell, *, zero1):
    """Run one device's step of ``cell`` on meta tensors at full depth.
    Returns (cost dict, collectives, temp bytes, output bytes)."""
    info = mesh_info(mesh)
    axes, dp, tp = info["axes"], info["dp"], info["tp"]
    full_params = module_tree(model)
    grad_partial = spmd._grad_partial(model, cell.specs["params"])
    _localize(model, cell.specs["params"], axes)
    batch = _local_tree(cell.specs["inputs"] if cell.kind != "decode" else {
        k: cell.specs["inputs"][k] for k in ("tokens", "pos")},
        cell.specs["batch"], axes)
    B_global = cell.specs["inputs"]["tokens" if "tokens" in
                                    cell.specs["inputs"] else "embeds"].shape[0]
    s = DrySpmd(dp, tp, batch_rows=dp > 1 and B_global % dp == 0)
    coll = Collectives({"data": dp, "model": tp})
    known = [p for p in model.parameters()] + tree_leaves(batch)
    del full_params
    if cell.kind == "train":
        named = dict(model.named_parameters())
        z1 = _zero1(flatten_dict(cell.specs["params"]),
                    flatten_dict(cell.specs["opt_state"]["m"]), axes) \
            if zero1 else {}
        # ZeRO-1: the update runs on this rank's slice of each such
        # parameter (a view), then the slices are gathered over "data"
        stand = {n: nn.Parameter(named[n].detach().narrow(
            d, 0, named[n].shape[d] // k)) for n, (d, k) in z1.items()}
        groups = [{"params": [stand.get(n, p) for n, p in zip(
            _names(model, g["params"]), g["params"])], "decay": g["decay"]}
            for g in param_groups(model)]
        opt = AdamW(groups, lr=3e-4)
        for g in opt.param_groups:
            for p in g["params"]:
                known += list(opt._moments(p))

        def sync(m):
            _dry_sync(m, s, grad_partial)
            for n, sp in stand.items():
                d, k = z1[n]
                sp.grad = named[n].grad.narrow(d, 0, named[n].shape[d] // k)

        step = build_train_step(model, opt, sync)

        def run():
            out = step(batch)
            for n, sp in stand.items():
                named[n].data.copy_(spmd._all_gather(sp.detach(), "data",
                                                     z1[n][0]))
            return out
    elif cell.kind == "prefill":
        def run():
            with torch.no_grad():
                return build_prefill_step(model)(batch)
    else:
        cache = _local_tree(cell.specs["cache_full"], cell.specs["cache"],
                            axes)
        known += tree_leaves(cache)
        B = batch["tokens"].shape[0]

        def run():
            with torch.no_grad():
                return build_serve_step(model)(cache, batch["tokens"],
                                               batch["pos"].expand(B))
    tracker = MetaPass(known)
    with recording(s, coll), tracker:
        out = run()
    if cell.kind == "train":
        out_bytes = cell.arg_bytes["params"] + cell.arg_bytes["opt_state"]
    else:
        out_bytes = sum(_nbytes(t) for t in tree_leaves(out)
                        if isinstance(t, torch.Tensor))
    cost = {"flops": float(tracker.flops),
            "bytes accessed": float(tracker.bytes),
            "bytes_accessed_note": BYTES_NOTE}
    return cost, coll.summary(), tracker.peak, out_bytes


def _names(model, params):
    ids = {id(p): n for n, p in model.named_parameters()}
    return [ids[id(p)] for p in params]


def depth_variant(cfg, n_units: int):
    """Config with head/tail preserved and ``n_units`` pattern repeats."""
    kw = dict(n_layers=(len(cfg.head_layers) + len(cfg.tail_layers)
                        + n_units * len(cfg.pattern)))
    if cfg.n_enc_layers:
        kw["n_enc_layers"] = n_units
    return dataclasses.replace(cfg, **kw)


def unit_extrapolated_costs(cfg, shape, mesh, *, remat, zero1, rules):
    """The reference reconstructs scanned-layer costs from 1- and 2-unit
    compiles (U_k = base + k·body, full = U1 + (K-1)·body).  The eager
    meta pass counts every layer, so this equals the full-depth count; it
    stays as the check of that.  The port takes 2 and 3 units: the
    optimizer's decay mask follows the reference's layer stacking, which
    a 1-unit model lacks (its norm scales are then not decayed), so U1 is
    off the line the deeper models lie on."""
    res = []
    for k in (2, 3):
        cfgk = depth_variant(cfg, k)
        modelk = build_model(cfgk, device="meta", remat=remat)
        cellk = _cell(modelk, cfgk, shape, mesh, zero1=zero1, rules=rules)
        c, coll, _temp, _out = _meta_step(modelk, cfgk, shape, mesh, cellk,
                                          zero1=zero1)
        res.append((c, coll))
    (c1, k1), (c2, k2) = res
    K = cfg.n_repeats

    def extr(a, b):
        return a + (K - 2) * max(b - a, 0.0)

    cost = {m: extr(c1.get(m, 0.0), c2.get(m, 0.0))
            for m in ("flops", "bytes accessed")}
    coll = {}
    for kind in _COLLECTIVES:
        coll[kind] = {
            "count": int(extr(k1[kind]["count"], k2[kind]["count"])),
            "operand_bytes": extr(k1[kind]["operand_bytes"],
                                  k2[kind]["operand_bytes"]),
        }
    coll["total_operand_bytes"] = sum(v["operand_bytes"]
                                      for v in coll.values())
    coll["total_wire_bytes"] = sum(
        v["operand_bytes"] * (2 if kind == "all-reduce" else 1)
        for kind, v in coll.items() if isinstance(v, dict))
    return cost, coll, {"unit2": {"cost": c1,
                                  "coll_wire": k1["total_wire_bytes"]},
                        "unit3": {"cost": c2,
                                  "coll_wire": k2["total_wire_bytes"]}}


def cell_config(cfg, mesh, impl="baseline"):
    """The config a cell runs: MoE pinned to the pooled dispatch, and the
    kernel variant under ``impl="optimized"``; the baseline's Mamba
    layers scan with the plain associative scan (the scan kernels refuse
    meta tensors)."""
    if cfg.moe is not None:
        # cost cells model the pooled capacity dispatch on every route
        # (decode included): the serving-side gather-GEMM / per-request
        # paths exist for batch invariance, not as a production lowering
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, dispatch="pooled"))
    if impl == "optimized":
        return optimized_cfg(cfg, mesh)
    return dataclasses.replace(cfg, scan_backend="assoc")


def lower_cell(arch: str, shape: str, mesh, *, remat="full", zero1=False,
               skip_full=False, impl="baseline", batch_override=None,
               seq_override=None, cfg=None):
    """Dry-run one (arch, shape) on ``mesh``: the result dict.  ``cfg``
    replaces ``get_config(arch)`` (a depth cut, say); the overrides
    resize the shape's batch and sequence (``input_specs``);
    ``skip_full`` stops after the argument bytes."""
    cfg = cell_config(cfg or get_config(arch), mesh, impl)
    sh = SHAPES[shape]
    rules = shd.make_rules()
    info = mesh_info(mesh)

    t0 = time.time()
    model = build_model(cfg, device="meta", remat=remat)
    cell = _cell(model, cfg, shape, mesh, zero1=zero1, rules=rules,
                 batch_override=batch_override, seq_override=seq_override)
    mem_d = {"argument_size_in_bytes": int(sum(cell.arg_bytes.values())),
             "argument_parts": cell.arg_bytes}
    coll = Collectives({}).summary()
    if skip_full:
        cost_d = {}
    else:
        cost_d, coll, temp, out_b = _meta_step(model, cfg, shape, mesh, cell,
                                               zero1=zero1)
        mem_d["temp_size_in_bytes"] = int(temp)
        mem_d["output_size_in_bytes"] = int(out_b)
    t_pass = time.time() - t0
    del model

    kadj = {"flops": 0.0, "bytes": 0.0}
    if impl == "optimized" and not skip_full:
        kf, kb = kernel_costs(cfg, shape, mesh)
        kadj = {"flops": kf, "bytes": kb}
        cost_d["flops"] = cost_d.get("flops", 0.0) + kf
        cost_d["bytes accessed"] = cost_d.get("bytes accessed", 0.0) + kb

    n_dev = info["n_devices"]
    cfg_params = cfg.param_count()
    cfg_active = cfg.active_param_count()
    B = batch_override or sh["global_batch"]
    S = seq_override or sh["seq_len"]
    tokens = B * (S if sh["kind"] != "decode" else 1)
    model_flops = 6 * cfg_active * tokens if sh["kind"] == "train" \
        else 2 * cfg_active * tokens
    result = {
        "arch": arch, "shape": shape, "mesh": info, "status": "ok",
        "pass_s": round(t_pass, 2),
        "hardware": HARDWARE,
        "memory_analysis": mem_d,
        "cost_analysis": cost_d,
        "collectives": coll,
        "params": cfg_params, "active_params": cfg_active,
        "model_flops_global": model_flops,
        "model_flops_per_dev": model_flops / n_dev,
        "remat": remat, "zero1": zero1, "impl": impl,
        "kernel_adjustment": kadj,
    }
    if skip_full:
        result["roofline"] = {"error": "skipped"}
        result["useful_flops_ratio"] = result["roofline_fraction"] = None
        return result
    flops_dev = cost_d["flops"]
    terms = {
        "compute_s": flops_dev / PEAK_FLOPS,
        "memory_s": cost_d["bytes accessed"] / HBM_BW,
        "collective_s": coll["total_wire_bytes"] / NVLINK_BW,
    }
    dom = max(("compute_s", "memory_s", "collective_s"),
              key=lambda k: terms[k])
    terms["dominant"] = dom
    terms["bound_s"] = terms[dom]
    ideal_s = model_flops / n_dev / PEAK_FLOPS
    if sh["kind"] == "decode":
        # decode streams the weights: the floor reads the active
        # parameters once a step (bf16), sharded across all devices
        ideal_s = max(ideal_s, cfg_active * 2 / n_dev / HBM_BW)
    result.update(
        roofline=terms,
        useful_flops_ratio=(model_flops / n_dev) / flops_dev
        if flops_dev else None,
        roofline_fraction=ideal_s / terms["bound_s"]
        if terms["bound_s"] else None)
    return result


def _tag(arch, shape, mesh_kind, impl):
    tag = f"{arch}__{shape}__{mesh_kind}"
    return tag if impl == "baseline" else tag + "__" + impl


def run_cell(arch, shape, mesh_kind, *, out_dir=RESULTS_DIR, **kw):
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    try:
        res = lower_cell(arch, shape, mesh, **kw)
    except Exception as e:
        res = {"arch": arch, "shape": shape, "mesh": mesh_info(mesh),
               "status": "error", "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-3000:]}
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, _tag(arch, shape, mesh_kind,
                                      kw.get("impl", "baseline")) + ".json")
    with open(path, "w") as f:
        json.dump(res, f, indent=1, default=str)
    return res


def cells(archs=None, shapes=None):
    for arch in (archs or ASSIGNED):
        cfg = get_config(arch)
        for shape in (shapes or SHAPES):
            if shape_supported(cfg, shape):
                yield arch, shape


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--remat", default="full",
                    choices=["none", "full", "dots_saveable"])
    ap.add_argument("--zero1", action="store_true")
    ap.add_argument("--impl", default="baseline",
                    choices=["baseline", "optimized"])
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--out", default=RESULTS_DIR,
                    help="directory of the per-cell JSON files")
    args = ap.parse_args(argv)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    todo = list(cells([args.arch] if args.arch else None,
                      [args.shape] if args.shape else None)) \
        if (args.all or not (args.arch and args.shape)) \
        else [(args.arch, args.shape)]
    n_bad = 0
    for arch, shape in todo:
        for mk in meshes:
            tag = _tag(arch, shape, mk, args.impl)
            path = os.path.join(args.out, tag + ".json")
            if args.skip_existing and os.path.exists(path):
                try:
                    with open(path) as f:
                        if json.load(f).get("status") == "ok":
                            print(f"SKIP {tag}")
                            continue
                except (OSError, ValueError):
                    pass
            t0 = time.time()
            res = run_cell(arch, shape, mk, out_dir=args.out,
                           remat=args.remat, zero1=args.zero1,
                           impl=args.impl)
            ok = res["status"]
            n_bad += ok != "ok"
            dom = res.get("roofline", {}).get("dominant", "-")
            print(f"{ok:5s} {tag:60s} {time.time()-t0:7.1f}s dominant={dom}",
                  flush=True)
            if ok != "ok":
                print(f"      {res['error']}", flush=True)
                continue
            mem = res["memory_analysis"]
            cost = res["cost_analysis"]
            temp = mem.get("temp_size_in_bytes")
            line = (f"      memory_analysis: args="
                    f"{mem['argument_size_in_bytes']/1e9:.2f}GB temp="
                    + (f"{temp/1e9:.2f}GB" if temp is not None else "-"))
            line += (f" | cost_analysis: flops={cost['flops']:.3e} "
                     f"bytes={cost['bytes accessed']:.3e} | coll_wire="
                     f"{res['collectives']['total_wire_bytes']:.3e}B")
            print(line, flush=True)
    return n_bad


if __name__ == "__main__":
    raise SystemExit(1 if main() else 0)
