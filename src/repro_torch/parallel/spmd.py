"""The SPMD runtime of a model bound to a ("data", "model") mesh.

:func:`bind` places a model's parameters as DTensors by the rule tables
(``sharding.param_specs``): each one becomes a ``Parameter`` holding a
DTensor, so the optimizer, the checkpointer and the elastic re-mesh see
the placements.  The modules themselves compute on LOCAL shards: inside
:func:`local_view` every DTensor parameter is swapped for its
``to_local()`` tensor (differentiable, so gradients land on the
DTensors), and :func:`current` hands the modules an :class:`Spmd` with
the mesh coordinates and the explicit collectives they need:

  * a column-parallel projection (heads, MLP hidden, vocab, minGRU
    hidden, Mamba ``d_inner``) reads its local columns through
    :meth:`Spmd.column`: the products as without a mesh, and in the
    backward the replicated input's gradient as fp32 partial products
    summed over "model" and rounded once (the mirror of ``reduce``);
    :meth:`Spmd.shared` does the same for any other use of a replicated
    tensor by this rank's heads, and :meth:`Spmd.enter` marks an input
    whose gradient is summed as it comes (identity forward);
  * a row-parallel product (``wo``, ``w_down``, the expert combine,
    Mamba's ``w_bcdt`` and ``w_out``) ends in :meth:`Spmd.reduce`
    (all-reduce forward, identity backward), its partial products kept
    in fp32 and rounded once after the sum;
  * a matrix whose columns are two halves (Mamba's ``w_in`` = [x | z])
    shards its columns contiguously, so a rank's product holds whole
    pieces of either half: :meth:`Spmd.halves` regroups them over
    "model" into this rank's columns of each half (an all-to-all);
  * vocab-sharded logits and the minGRU hidden are gathered whole with
    :meth:`Spmd.gather` before anything reads them (greedy argmax and the
    counter-hash sampler then see global vocab indices);
  * each module tells from its local parameter shapes whether a
    dimension is sharded — the rule tables' divisibility gate decides.

No DTensor op runs inside a model: nothing all-gathers a weight or a
pool implicitly, and every kernel is called on local tensors with the
local head counts.  Every layer kind has its local-shard form: GQA and
MLA and Whisper's cross attention on their heads (MLA's latent
projections and pools replicate), MLPs and experts on their hidden
dim, minGRU on its hidden, Mamba on ``d_inner``; data parallelism needs
nothing of a layer.  A rematerialised unit recomputes in the backward
on the local tensors its forward ran on (:func:`local_params`,
:meth:`Spmd.replay`).

The serving side (``serve.protocol``) adds data parallelism: slot arrays
shard dim 0 over "data" when it divides, and :meth:`Spmd.gather_rows`
brings results back whole.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
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


def _all_to_all(t, group, in_splits, out_splits):
    """Rows of ``t`` (dim 0, ``in_splits[k]`` of them to rank k of
    ``group``) exchanged: the rows every rank sent here, by source rank
    (``out_splits[k]`` from rank k)."""
    import torch.distributed as dist

    w, back = _wire(t.contiguous())
    out = w.new_empty((sum(out_splits),) + tuple(w.shape[1:]))
    dist.all_to_all_single(out, w, list(out_splits), list(in_splits),
                           group=group)
    return out if back is None else out.to(back)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, in_splits, out_splits):
        ctx.args = group, in_splits, out_splits
        return _all_to_all(x, group, in_splits, out_splits)

    @staticmethod
    def backward(ctx, g):
        group, in_splits, out_splits = ctx.args
        return _all_to_all(g, group, out_splits, in_splits), None, None, \
            None


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


def _sum_grad(d, group, dtype):
    """A gradient's fp32 partial sums over ``group``, rounded once."""
    return _all_reduce(d, group).to(dtype)


class _Column(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, y, group):
        ctx.save_for_backward(w)
        ctx.group, ctx.dtype = group, x.dtype
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        w, = ctx.saved_tensors
        dx = g.float() @ w.float().transpose(-1, -2)
        return _sum_grad(dx, ctx.group, ctx.dtype), None, g, None


class _Shared(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, y, fn, group, *operands):
        ctx.save_for_backward(x, *operands)
        ctx.fn, ctx.group = fn, group
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        x, *operands = ctx.saved_tensors
        with torch.enable_grad():
            x32 = x.detach().float().requires_grad_()
            y32 = ctx.fn(x32, *(o.detach().float() for o in operands))
            dx, = torch.autograd.grad(y32, x32, g.float())
        return (_sum_grad(dx, ctx.group, x.dtype), g, None, None) \
            + (None,) * len(operands)


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
    def column(self, x, *ws):
        """``x @ w`` for each ``w`` (K, N): a replicated x times this
        rank's columns.  The products are the single-device ones (their
        weights' gradients as autograd takes them); x's gradient from each
        is g @ wᵀ in fp32, summed over "model" and rounded once to x's
        dtype -- what the single-device product's gradient is, up to fp32
        reassociation -- and autograd adds the products' parts as it
        would without a mesh (one node a product)."""
        if self.tp == 1:
            return tuple(x @ w for w in ws)
        return tuple(_Column.apply(x, w.detach(), x.detach() @ w,
                                   self.model_group) for w in ws)

    def shared(self, x, fn, *operands):
        """``fn(x, *operands)`` for a replicated x that this rank's heads
        read (``fn`` linear in x): the same value, and x's gradient taken
        from ``fn`` in fp32 (recomputed in the backward), summed over
        "model" and rounded once."""
        if self.tp == 1:
            return fn(x, *operands)
        return _Shared.apply(x, fn(x.detach(), *operands), fn,
                             self.model_group, *operands)

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

    def halves(self, p):
        """This rank's columns of each half of a product whose weight's
        columns are two halves [a | b] sharded contiguously over "model":
        rank s's product ``p`` (..., 2·n) holds the global column pieces
        2s and 2s + 1 of width n, and piece k is columns of half k // tp
        owned by rank k % tp.  Each piece goes to its owner (an
        all-to-all; its backward sends the gradients back), so rank r
        gets (a_r, b_r), each (..., n), bitwise the columns of the
        single-device product."""
        n, tp, r = p.shape[-1] // 2, self.tp, self.tp_rank
        pieces = p.reshape(-1, 2, n).transpose(0, 1)       # (2, rows, n)
        dest = [(2 * r + j) % tp for j in (0, 1)]
        order = sorted((0, 1), key=dest.__getitem__)
        # piece r (half a) sits on rank r // 2, piece tp + r (half b) on a
        # later rank, so a arrives first
        src = [r // 2, (tp + r) // 2]
        got = _AllToAll.apply(pieces[list(order)], self.model_group,
                              [dest.count(k) for k in range(tp)],
                              [src.count(k) for k in range(tp)])
        lead = p.shape[:-1]
        return got[0].reshape(*lead, n), got[1].reshape(*lead, n)

    @contextlib.contextmanager
    def replay(self, params):
        """Context of a recomputation in the backward (``remat``): the
        ``(module, name, tensor)`` of :func:`local_params` installed again
        and :func:`current` set, as the forward ran; a no-op inside a
        running view."""
        global _CURRENT
        if _CURRENT is not None:
            yield self
            return
        held = [(m, n, m._parameters[n]) for m, n, _t in params]
        for m, n, t in params:
            m._parameters[n] = t
        _CURRENT = self
        try:
            yield self
        finally:
            _CURRENT = None
            for m, n, t in held:
                m._parameters[n] = t

    def reduce_max(self, x):
        """Elementwise max over "model" (no gradient)."""
        import torch.distributed as dist

        if self.tp == 1:
            return x
        return _all_reduce(x.detach(), self.model_group, dist.ReduceOp.MAX)

    # --- data parallelism ------------------------------------------------
    def batch_sharded(self, t) -> bool:
        """Whether the batch tensor ``t`` came with its rows sharded over
        "data" (a DTensor with dim 0 sharded)."""
        from torch.distributed.tensor import Shard
        return is_dtensor(t) and any(
            isinstance(pl, Shard) and pl.dim == 0 for pl in t.placements)

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


def _grad_partial(model, specs):
    """Replicated parameters whose gradient is a partial sum over "model":
    ``wk``/``wv`` of an attention layer whose query heads shard while its
    KV heads replicate (each rank's queries read every KV head).  Other
    replicated leaves get whole gradients: the replicated activations
    they make are summed where they meet sharded ones (``Spmd.column``,
    ``Spmd.shared``, ``Spmd.enter``)."""
    from repro_torch.models.attention import GQAAttention

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


def local_params(module):
    """``(module, name, tensor)`` of every parameter of ``module`` as the
    running view holds it (the local tensors inside :func:`local_view`),
    for :meth:`Spmd.replay`."""
    return [(m, n, t) for m in module.modules()
            for n, t in m._parameters.items()]


def on_local_shards(method):
    """Decorator of a model's entry point: a model bound to a mesh runs
    it inside :func:`local_view`."""
    @functools.wraps(method)
    def run(self, *args, **kwargs):
        with local_view(self):
            return method(self, *args, **kwargs)
    return run


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
