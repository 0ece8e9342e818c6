"""Dense SwiGLU MLP and the mixture-of-experts MLP with sort-based
dispatch (port of ``repro.models.moe``).

``MoEMLP`` routes each token to its top-k experts and has three dispatch
paths, picked by :func:`resolve_dispatch` from the config's ``dispatch``
knob and the execution route:

  * pooled — every token of a group of the call competes for a
    capacity-limited (E, C) buffer: the assignments are sorted by expert
    (a STABLE sort), the first C of each expert are kept and the rest
    dropped (they pass through the residual untouched); one grouped GEMM
    per expert; the Switch aux loss.  A token's result depends on its
    neighbours, so this is the training path only;
  * per_request — the same sort-based dispatch with one group per batch
    row at the drop-free capacity C = S (top-k ids are distinct, so an
    expert receives at most S tokens of an S-token row): routing is pure
    per-token top-k, invariant to co-batched rows and to chunking;
  * gather — each token gathers its k (D, F) expert slices and runs k
    small GEMMs: no buffer, no sort, no cross-token structure (decode).

Where the two frameworks differ and the port pins the reference's
behaviour:

  * ``jnp.argsort`` is stable; ``torch.argsort`` is stable only when
    asked.  The sort order decides which tokens a full expert drops.
  * ``jax.lax.top_k`` puts the lower index first on a tie;
    ``torch.topk`` does not promise it.  The order of a token's ids fixes
    the order of the flat assignments, and so which ones the stable sort
    lets in.  The port takes the first k of a stable descending sort.
  * the reference scatters a dropped assignment to row E·C, past its
    buffer (``mode="drop"`` discards it), and clips the combine's gather;
    the port's buffer has that spare row and cuts it off, so no index is
    ever out of bounds (and no boolean selection syncs the host).
  * the reference's combine scatter-adds a token's k contributions in
    sorted (ascending expert) order.  ``index_add_`` on the card sums with
    atomics in a run-dependent order, so the port puts the contributions
    back in (token, ascending expert) order and adds them left to right
    from zero: the same order as the reference's sequential scatter, and
    the same bits on every run.
  * the gather path gathers the chosen fp32 expert slices and then casts
    them to the compute dtype; the reference casts the whole stacks and
    then gathers.  Casting is elementwise, so the bits are the same and
    the card moves k/E of the weight bytes.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import MOE_DISPATCH_MODES, MoEConfig
from repro_torch.core.quant import sigmoid
from repro_torch.models.module import fan_in_init
from repro_torch.parallel import spmd

#: Execution routes threaded from models.transformer: full-sequence
#: training/eval, chunked prompt prefill, single-token decode.
ROUTES = ("train", "prefill", "decode")


def resolve_dispatch(dispatch: str, route: str) -> str:
    """Config knob x execution route -> "pooled" | "per_request" |
    "gather" (``repro.models.moe.resolve_dispatch``): ``auto`` keeps
    training pooled and picks the batch-invariant path per serving
    route."""
    if route not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
    if dispatch not in MOE_DISPATCH_MODES:     # mirrors MoEConfig validation
        raise ValueError(f"dispatch must be one of {MOE_DISPATCH_MODES}, "
                         f"got {dispatch!r}")
    if dispatch in ("pooled", "per_request"):
        return dispatch
    return {"train": "pooled", "prefill": "per_request",
            "decode": "gather"}[route]


def _silu(g):
    # silu(g) = g·σ(g) with the reference's op-by-op σ (core.quant)
    return g * sigmoid(g)


class DenseMLP(nn.Module):
    """SwiGLU MLP: down( silu(gate(x)) * up(x) ), computed in x.dtype."""

    def __init__(self, d_model, d_ff, *, dtype=torch.float32, device=None):
        super().__init__()
        self.d_model, self.d_ff = int(d_model), int(d_ff)
        kw = dict(dtype=dtype, device=device)
        self.w_gate = nn.Parameter(torch.empty(self.d_model, self.d_ff, **kw))
        self.w_up = nn.Parameter(torch.empty(self.d_model, self.d_ff, **kw))
        self.w_down = nn.Parameter(torch.empty(self.d_ff, self.d_model, **kw))
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        for w in (self.w_gate, self.w_up, self.w_down):
            fan_in_init(w, generator=generator)

    def axes(self):
        return {"w_gate": ("embed", "mlp"), "w_up": ("embed", "mlp"),
                "w_down": ("mlp", "embed")}

    def forward(self, x, entered=False):
        """Under a "model"-sharded hidden dim each rank runs its columns
        of gate/up and its rows of down, and the partial products are
        summed; ``entered``: the caller already marked ``x`` as the input
        of its parallel region (:meth:`MoEMLP.forward`)."""
        s = spmd.current()
        if s is not None and self.w_gate.shape[1] < self.d_ff:
            x = x if entered else s.enter(x)
            g = x @ self.w_gate.to(x.dtype)
            u = x @ self.w_up.to(x.dtype)
            # fp32 partial products, summed, rounded once (see
            # GQAAttention._out)
            return s.reduce((_silu(g) * u).float()
                            @ self.w_down.to(x.dtype).float()).to(x.dtype)
        g = x @ self.w_gate.to(x.dtype)
        u = x @ self.w_up.to(x.dtype)
        return (_silu(g) * u) @ self.w_down.to(x.dtype)


class MoEMLP(nn.Module):
    """Top-k routed experts plus optional shared experts
    (``repro.models.moe.MoEMLP``).  Parameters: ``router`` (D, E),
    ``w_gate``/``w_up`` (E, D, F), ``w_down`` (E, F, D) and ``shared``, a
    :class:`DenseMLP` of width F × n_shared — the reference's leaves and
    shapes, so the bridge loads them by path."""

    def __init__(self, d_model, moe: MoEConfig, *, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.d_model, self.moe = int(d_model), moe
        d, f, e = self.d_model, moe.d_ff_expert, moe.n_experts
        kw = dict(dtype=dtype, device=device)
        self.router = nn.Parameter(torch.empty(d, e, **kw))
        self.w_gate = nn.Parameter(torch.empty(e, d, f, **kw))
        self.w_up = nn.Parameter(torch.empty(e, d, f, **kw))
        self.w_down = nn.Parameter(torch.empty(e, f, d, **kw))
        self.shared = (DenseMLP(d, f * moe.n_shared, **kw)
                       if moe.n_shared else None)
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        fan_in_init(self.router, generator=generator)
        for w in (self.w_gate, self.w_up, self.w_down):
            for i in range(w.shape[0]):        # fan-in of each expert slice
                fan_in_init(w[i], generator=generator)
        if self.shared is not None:
            self.shared.reset_parameters(generator)

    def axes(self):
        a = {"router": ("embed", None),
             "w_gate": ("experts", "embed", "mlp"),
             "w_up": ("experts", "embed", "mlp"),
             "w_down": ("experts", "mlp", "embed")}
        if self.shared is not None:
            a["shared"] = self.shared.axes()
        return a

    @staticmethod
    def capacity(NL, e):
        """Per-group expert capacity (bounded by the assignment count)."""
        return int(min(NL * e.top_k,
                       max(1, round(NL * e.top_k / e.n_experts
                                    * e.capacity_factor))))

    def _route(self, xt):
        """xt (N, D) -> (renormalised top-k gates (N, k) fp32, expert ids
        (N, k), full probabilities (N, E) fp32)."""
        k = self.moe.top_k
        logits = (xt @ self.router.to(xt.dtype)).float()
        probs = torch.softmax(logits, dim=-1)
        # lower index first on ties, as jax.lax.top_k
        gate, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
        gate, ids = gate[:, :k], ids[:, :k]
        gate = gate / gate.sum(-1, keepdim=True).clamp(min=1e-9)
        return gate, ids, probs

    def _experts_here(self):
        """(first expert id, count) of the experts this rank holds (all of
        them unless "model" shards the expert axis)."""
        s, el = spmd.current(), self.w_gate.shape[0]
        if s is None or el == self.moe.n_experts:
            return 0, el
        return s.tp_rank * el, el

    def _gather_ffn(self, xt):
        """Capacity-free gather-GEMM dispatch over one token a row: each
        token's k expert slices, gathered in fp32 and then cast.  With the
        experts sharded, a rank computes the choices among its own
        experts and the others' gates count zero (a partial sum)."""
        gate, ids, probs = self._route(xt)
        dt = xt.dtype
        e0, el = self._experts_here()
        loc = ids - e0
        if el < self.moe.n_experts:
            mine = (loc >= 0) & (loc < el)
            gate = torch.where(mine, gate, gate.new_zeros(()))
            loc = loc.clamp(0, el - 1)
        wg, wu, wd = (w[loc].to(dt) for w in (self.w_gate, self.w_up,
                                              self.w_down))
        x4 = xt[:, None, None, :]                            # (N, 1, 1, D)
        g = (x4 @ wg)[:, :, 0]                               # (N, k, F)
        u = (x4 @ wu)[:, :, 0]
        y = ((_silu(g) * u)[:, :, None, :] @ wd)[:, :, 0]    # (N, k, D)
        if el < self.moe.n_experts:
            # partial over this rank's choices, in fp32 until the sum
            out = (gate.to(dt).float()[:, None, :] @ y.float())[:, 0]
            return out, probs, ids
        out = (gate.to(dt)[:, None, :] @ y)[:, 0]            # (N, D)
        return out, probs, ids

    def _grouped_ffn(self, x, G, C):
        """Sort-based dispatch of (B, S, D) over G groups of NL = B·S/G
        tokens at capacity C: (out (B, S, D), probs (G, NL, E), flat
        expert ids (G, NL·k), kept (G, NL·k) bool)."""
        e = self.moe
        E, k = e.n_experts, e.top_k
        B, S, D = x.shape
        NL = B * S // G
        dt, dev = x.dtype, x.device
        xt = x.reshape(G * NL, D)
        gate, ids, probs = self._route(xt)
        flat_e = ids.reshape(G, NL * k)
        order = torch.argsort(flat_e, dim=1, stable=True)    # stable!
        sorted_e = torch.gather(flat_e, 1, order)
        counts = torch.zeros(G, E, dtype=torch.int64, device=dev)
        counts.scatter_add_(1, flat_e, torch.ones_like(flat_e))
        starts = torch.cumsum(counts, 1) - counts            # exclusive
        pos_in_e = (torch.arange(NL * k, device=dev)[None, :]
                    - torch.gather(starts, 1, sorted_e))
        token_of = order // k                                # (G, NL·k)
        valid = pos_in_e < C
        # rows of the flattened (G·E·C) buffer; a dropped assignment goes
        # to one spare row past the end, which is cut off (selected
        # explicitly: no out-of-bounds write, and no host sync)
        grp = torch.arange(G, device=dev)[:, None]
        dest = torch.where(valid, (grp * E + sorted_e) * C + pos_in_e,
                           G * E * C).reshape(-1)
        src = (grp * NL + token_of).reshape(-1)
        buf = xt.new_zeros(G * E * C + 1, D)
        buf[dest] = xt[src]
        xe = buf[:-1].reshape(G, E, C, D).transpose(0, 1).reshape(
            E, G * C, D)
        # grouped expert GEMM over every (E, C) row, as the reference's
        # einsum: rows past an expert's count are zero
        e0, el = self._experts_here()
        if el < E:
            # this rank's experts only; the others' rows stay zero
            xe = xe[e0:e0 + el]
        g = torch.bmm(xe, self.w_gate.to(dt))
        u = torch.bmm(xe, self.w_up.to(dt))
        ye = torch.bmm(_silu(g) * u, self.w_down.to(dt))    # (E, G·C, D)
        if el < E:
            ye = torch.cat([ye.new_zeros(e0, *ye.shape[1:]), ye,
                            ye.new_zeros(E - e0 - el, *ye.shape[1:])])
        yflat = ye.reshape(E, G, C, D).transpose(0, 1).reshape(-1, D)
        gates = torch.gather(gate.reshape(G, NL * k), 1, order).to(dt)
        picked = yflat[dest.clamp(max=G * E * C - 1)].reshape(G, NL * k, D)
        contrib = torch.where(valid[..., None], picked,
                              picked.new_zeros(())) * gates[..., None]
        # the combine in a fixed order: a token's k contributions in
        # ascending sorted position (= ascending expert), added left to
        # right from zero -- the reference's sequential scatter-add
        inv = torch.argsort(order, dim=1)                    # flat -> sorted
        at = torch.sort(inv.reshape(G, NL, k), dim=2).values
        parts = torch.gather(contrib, 1, at.reshape(G, NL * k, 1).expand(
            G, NL * k, D)).reshape(G, NL, k, D)
        out = torch.zeros_like(parts[:, :, 0])
        for j in range(k):
            out = out + parts[:, :, j]
        return out.reshape(B, S, D), probs.reshape(G, NL, E), flat_e, valid

    def forward(self, x, route="train"):
        """x: (B, S, D) -> (out (B, S, D), {"aux_loss", "dropped_frac"});
        ``route`` and ``moe.dispatch`` pick the path
        (:func:`resolve_dispatch`)."""
        e = self.moe
        B, S, D = x.shape
        mode = resolve_dispatch(e.dispatch, route)
        s = spmd.current()
        # experts or their hidden dim "model"-sharded: every rank routes
        # all tokens, runs its slices, and the partial outputs are summed
        par = s if s is not None and (
            self.w_gate.shape[0] < e.n_experts
            or self.w_gate.shape[2] < e.d_ff_expert) else None
        if par is not None:
            x = par.enter(x)
        if mode == "gather":
            out, probs, flat_e = self._gather_ffn(x.reshape(B * S, D))
            out = out.reshape(B, S, D)
            me = probs.mean(0)                                # (E,)
            dropped = torch.zeros((), device=x.device)
        else:
            if mode == "per_request":
                # one group a request row at the drop-free bound C = S
                G, C = B, S
            else:
                # the pool is the whole batch: with its rows sharded over
                # "data" every rank dispatches all of them (a token's
                # drop depends on its neighbours) and keeps its own
                if s is not None:
                    x = s.gather_batch(x)
                    B = x.shape[0]
                # groups must divide the batch; the clamp guards B < groups
                G = max(1, e.groups if B % max(e.groups, 1) == 0 else 1)
                C = self.capacity(B * S // G, e)
            out, probs, flat_e, valid = self._grouped_ffn(x, G, C)
            if mode == "pooled" and s is not None:
                out, x = s.my_rows(out), s.my_rows(x)
            me = probs.mean((0, 1))
            # the reference's mean: XLA turns the division by the count
            # into a product with its fp32 reciprocal (same bits here)
            recip = torch.tensor(1.0 / valid.numel(), dtype=torch.float32,
                                 device=x.device)
            dropped = 1.0 - valid.float().sum() * recip
        if par is not None:
            out = par.reduce(out).to(x.dtype)
        if self.shared is not None:
            out = out + self.shared(x, entered=par is not None)
        flat = flat_e.reshape(-1)
        ce = torch.zeros(e.n_experts, device=x.device).scatter_add_(
            0, flat, torch.ones(flat.shape, device=x.device)) / flat.numel()
        aux = e.n_experts * torch.sum(me * ce)
        return out, {"aux_loss": aux, "dropped_frac": dropped}
