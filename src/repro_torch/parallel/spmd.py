"""The SPMD runtime of a model bound to a ("data", "model") mesh.

:func:`bind` places a model's parameters as DTensors by the rule tables
(``sharding.param_specs``): each one becomes a ``Parameter`` holding a
DTensor, so the optimizer, the checkpointer and the elastic re-mesh see
the placements.  The modules themselves compute on LOCAL shards: inside
:func:`local_view` every DTensor parameter is swapped for its
``to_local()`` tensor (differentiable, so gradients land on the
DTensors), and :func:`current` hands the modules an :class:`Spmd` with
the mesh coordinates and the explicit collectives they need:

  * a column-parallel projection (heads, MLP hidden, experts, vocab,
    minGRU hidden) reads its local columns; :meth:`Spmd.enter` marks the
    replicated input (identity forward, all-reduce of the gradient);
  * a row-parallel product (``wo``, ``w_down``, the expert combine) ends
    in :meth:`Spmd.reduce` (all-reduce forward, identity backward);
  * vocab-sharded logits and the minGRU hidden are gathered whole with
    :meth:`Spmd.gather` before anything reads them (greedy argmax and the
    counter-hash sampler then see global vocab indices);
  * each module tells from its local parameter shapes whether a
    dimension is sharded — the rule tables' divisibility gate decides.

No DTensor op runs inside a model: nothing all-gathers a weight or a
pool implicitly, and every kernel is called on local tensors with the
local head counts.  Layers whose tensor-parallel form is not ported
(Mamba, MLA, Whisper's cross attention) refuse a mesh that would shard
them; data parallelism needs nothing of a layer and works for all.

The serving side (``serve.protocol``) adds data parallelism: slot arrays
shard dim 0 over "data" when it divides, and :meth:`Spmd.gather_rows`
brings results back whole.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Optional

import torch
from torch import nn

from repro_torch.common.pytree import flatten_dict, module_tree
from repro_torch.parallel import sharding as shd

_CURRENT: Optional["Spmd"] = None


def current() -> Optional["Spmd"]:
    """The runtime of the bound model running now (None outside
    :func:`local_view`: the single-device path)."""
    return _CURRENT


def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def local(t):
    """``t``'s local shard (``t`` itself when it is not a DTensor)."""
    return t.to_local() if is_dtensor(t) else t


def _wire(t):
    """A tensor gloo can carry (bool and bf16 travel widened; both round
    trip exactly)."""
    if t.dtype == torch.bool:
        return t.to(torch.uint8), t.dtype
    if t.device.type == "cpu" and t.dtype in (torch.bfloat16, torch.float16):
        return t.float(), t.dtype
    return t, None


def _all_gather(t, group, dim):
    import torch.distributed as dist

    w, back = _wire(t.contiguous())
    parts = [torch.empty_like(w) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, w, group=group)
    out = torch.cat(parts, dim=dim)
    return out if back is None else out.to(back)


def _all_reduce(t, group, op=None):
    import torch.distributed as dist

    w, back = _wire(t.clone())
    dist.all_reduce(w, op=op or dist.ReduceOp.SUM, group=group)
    return w if back is None else w.to(back)


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, rank, size):
        ctx.dim, ctx.rank, ctx.n = dim, rank, x.shape[dim]
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n), None, None, \
            None, None


class Spmd:
    """Coordinates and collectives of this rank on a ("data", "model")
    mesh (a "pod" axis is not served)."""

    def __init__(self, mesh):
        names = tuple(mesh.mesh_dim_names)
        if names != ("data", "model"):
            raise ValueError(f"a local mesh has dims ('data', 'model'), got "
                             f"{names}")
        self.mesh = mesh
        sizes = shd.mesh_shape(mesh)
        self.dp, self.tp = sizes["data"], sizes["model"]
        coord = mesh.get_coordinate()
        if coord is None:
            raise ValueError("this rank is not a member of the mesh")
        self.dp_rank, self.tp_rank = int(coord[0]), int(coord[1])
        self.data_group = mesh.get_group("data") if self.dp > 1 else None
        self.model_group = mesh.get_group("model") if self.tp > 1 else None
        #: per-call global slot views of a DP-sharded decode step
        #: (``serve.protocol`` sets them; None when slots are whole)
        self.step = None
        #: True while the rows of the running call shard over "data"
        #: (see :meth:`data_rows`)
        self.rows_sharded = False

    @contextlib.contextmanager
    def data_rows(self, sharded: bool):
        """Mark the running call's batch rows as sharded over "data": a
        layer whose rows interact (the pooled MoE dispatch) then works on
        the whole batch (:meth:`gather_batch`)."""
        prev, self.rows_sharded = self.rows_sharded, bool(sharded)
        try:
            yield self
        finally:
            self.rows_sharded = prev

    # --- tensor parallelism ----------------------------------------------
    def enter(self, x):
        """Identity; the gradient is summed over "model" (the input of a
        column-parallel region)."""
        return _Enter.apply(x, self.model_group) if self.tp > 1 else x

    def reduce(self, x):
        """Sum of the ranks' partial results over "model"."""
        return _Reduce.apply(x, self.model_group) if self.tp > 1 else x

    def gather(self, x, dim=-1):
        """The "model" shards of ``x`` concatenated along ``dim``."""
        if self.tp == 1:
            return x
        return _Gather.apply(x, self.model_group, dim % x.dim(),
                             self.tp_rank, self.tp)

    def reduce_max(self, x):
        """Elementwise max over "model" (no gradient)."""
        import torch.distributed as dist

        if self.tp == 1:
            return x
        return _all_reduce(x.detach(), self.model_group, dist.ReduceOp.MAX)

    # --- data parallelism ------------------------------------------------
    def dp_sharded(self, n: int) -> bool:
        """Whether a slot-leading array of ``n`` rows shards over "data"
        (``sharding.dim0_dp_spec``'s rule)."""
        return self.dp > 1 and n > 0 and n % self.dp == 0

    def rows(self, n: int) -> slice:
        """This rank's rows of a slot-leading array of ``n`` rows."""
        if not self.dp_sharded(n):
            return slice(0, n)
        k = n // self.dp
        return slice(self.dp_rank * k, (self.dp_rank + 1) * k)

    def gather_rows(self, x, n: int):
        """The whole ``n``-row array from this rank's rows (a no-op when
        ``n`` does not shard)."""
        if not self.dp_sharded(n):
            return x
        return _all_gather(x, self.data_group, 0)

    def gather_batch(self, x):
        """The whole batch from this rank's rows when they shard over
        "data" (the backward keeps this rank's rows' gradient), else
        ``x``; with :meth:`my_rows` to cut the result back."""
        if not (self.rows_sharded and self.dp > 1):
            return x
        return _Gather.apply(x, self.data_group, 0, self.dp_rank, self.dp)

    def my_rows(self, x):
        """This rank's rows of a result of :meth:`gather_batch`'s batch."""
        if not (self.rows_sharded and self.dp > 1):
            return x
        n = x.shape[0] // self.dp
        return x[self.dp_rank * n:(self.dp_rank + 1) * n]

    def sum_data(self, x):
        """Sum over "data" (identity backward: each rank's gradient is
        that of its own rows, summed by :func:`sync_grads`)."""
        return _Reduce.apply(x, self.data_group) if self.dp > 1 else x

    def broadcast_row(self, t, owner_dp_rank: int):
        """In place: ``t`` as the "data" rank ``owner_dp_rank`` holds it."""
        import torch.distributed as dist

        if self.dp == 1:
            return t
        src = dist.get_global_rank(self.data_group, owner_dp_rank)
        w, back = _wire(t.contiguous())
        dist.broadcast(w, src=src, group=self.data_group)
        if back is not None or w.data_ptr() != t.data_ptr():
            t.copy_(w.to(t.dtype))
        return t


@dataclasses.dataclass
class Binding:
    """What :func:`bind` leaves on a model."""

    spmd: Spmd
    specs: Any                 # PartitionSpec tree (model.axes() layout)
    entries: list              # (module, name, DTensor parameter, its
                               #  local shard as a plain alias)
    grad_partial: frozenset    # names whose gradient sums over "model"


def binding(model) -> Optional[Binding]:
    return getattr(model, "_spmd_binding", None)


def _refuse_unported_tp(model, specs):
    """Mamba, MLA and Whisper cross-attention layers have no local-shard
    form yet: refuse a mesh that would shard one of their parameters."""
    from repro_torch.models.attention import MLAAttention
    from repro_torch.models.mamba import MambaBlock
    from repro_torch.models.whisper import CrossAttention

    flat = flatten_dict(specs)
    for name, mod in model.named_modules():
        if isinstance(mod, (MambaBlock, MLAAttention, CrossAttention)):
            pre = tuple(name.split(".")) if name else ()
            for pname, _p in mod.named_parameters(recurse=False):
                if any(a is not None for a in flat[pre + (pname,)]):
                    raise NotImplementedError(
                        f"{type(mod).__name__} ({name}): tensor parallelism "
                        "is not ported for this layer kind — serve it on a "
                        "mesh with model=1 (data parallelism only)")


def _grad_partial(model, specs):
    """Replicated parameters whose gradient is a partial sum over "model":
    ``wk``/``wv`` of an attention layer whose query heads shard while its
    KV heads replicate (each rank's queries read every KV head), and the
    router of an MoE layer whose experts shard."""
    from repro_torch.models.attention import GQAAttention
    from repro_torch.models.moe import MoEMLP

    flat = flatten_dict(specs)
    out = set()
    for name, mod in model.named_modules():
        pre = (name + ".") if name else ""
        key = tuple(name.split(".")) if name else ()
        if isinstance(mod, GQAAttention):
            q = flat[key + ("wq",)][1]
            kv = flat[key + ("wk",)][1]
            if q is not None and kv is None:
                out |= {pre + "wk", pre + "wv"}
        elif isinstance(mod, MoEMLP):
            if any(a is not None for a in flat[key + ("w_gate",)]):
                out.add(pre + "router")
    return frozenset(out)


def bind(model, mesh, rules=None, placed=None) -> Binding:
    """Place ``model``'s parameters on ``mesh`` by its logical axes, in
    place: every parameter becomes a DTensor ``Parameter``.  Every rank
    passes the same full weights (rank 0's are broadcast).  ``placed``:
    a tree of DTensors already on ``mesh`` (``module_tree`` layout, e.g.
    from ``train.elastic.reshard_tree``) to install instead — this
    re-binds a model bound to another mesh.  Returns the
    :class:`Binding`, also kept on the model."""
    if binding(model) is not None and placed is None:
        raise ValueError("model is already bound to a mesh")
    specs = shd.param_specs(model, module_tree(model), mesh, rules)
    _refuse_unported_tp(model, specs)
    flat = flatten_dict(specs)
    given = flatten_dict(placed) if placed is not None else None
    entries = []
    for mname, mod in model.named_modules():
        pre = tuple(mname.split(".")) if mname else ()
        for pname, p in list(mod.named_parameters(recurse=False)):
            key = pre + (pname,)
            dt = given[key] if given is not None else shd.distribute(
                local(p.data), shd.NamedSharding(mesh, flat[key]))
            newp = nn.Parameter(dt, requires_grad=p.requires_grad)
            mod._parameters[pname] = newp
            with torch.no_grad():
                alias = newp.to_local().detach()
            entries.append((mod, pname, newp, alias))
    b = Binding(Spmd(mesh), specs, entries, _grad_partial(model, specs))
    model._spmd_binding = b
    return b


@contextlib.contextmanager
def local_view(model):
    """Run ``model`` on its local shards: DTensor parameters swapped for
    their local tensors, :func:`current` set.  With gradients on, the
    swap goes through ``to_local()`` (the gradient lands on the DTensor);
    without, through an alias of the shard made at :func:`bind` (no
    autograd node a parameter and call: the serving path's host cost).
    A no-op for an unbound model (or inside another view)."""
    global _CURRENT
    b = binding(model)
    if b is None or _CURRENT is not None:
        yield _CURRENT
        return
    grad = torch.is_grad_enabled()
    for mod, name, p, alias in b.entries:
        mod._parameters[name] = p.to_local() if grad else alias
    _CURRENT = b.spmd
    try:
        yield b.spmd
    finally:
        _CURRENT = None
        for mod, name, p, _alias in b.entries:
            mod._parameters[name] = p


def sync_grads(model):
    """After ``backward`` of a bound model's loss: sum every gradient over
    "data" (each rank's is that of its own batch rows, the loss already
    divided by the global token count) and, for the parameters of
    :attr:`Binding.grad_partial`, over "model" too."""
    b = binding(model)
    if b is None:
        return
    s = b.spmd
    names = {id(p): n for n, p in model.named_parameters()}
    for _mod, _name, p, _alias in b.entries:
        if p.grad is None:
            continue
        g = local(p.grad)
        if s.dp > 1:
            g.copy_(_all_reduce(g, s.data_group))
        if s.tp > 1 and names[id(p)] in b.grad_partial:
            g.copy_(_all_reduce(g, s.model_group))
