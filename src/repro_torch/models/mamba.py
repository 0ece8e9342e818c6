"""Mamba-1 selective SSM block (port of ``repro.models.mamba``; the
falcon-mamba layers).

Execution regimes, as in the reference:

  * ``forward`` — the full sequence.  ``cfg.ssm_impl == "xla"`` is
    ``prefill`` from a blank carry (one linear scan over the (B, T,
    d_inner·d_state) discretized terms); ``"fused"`` runs the fused
    selective-scan op (the CUDA forward and backward kernels on the card,
    their plain versions on the CPU), which never builds a (B, T,
    d_inner, d_state) tensor; ``"stub"`` is the dry-run's O(B·T·d_inner)
    stand-in
  * ``prefill`` — one chunk against the O(1) carry {"ssm": (B, di, n),
    "conv": (B, d_conv - 1, di)}: ``"xla"`` scans the chunk's
    discretized terms with the linear scan, as the reference does under
    both impls; ``"fused"`` runs the fused selective-scan kernel from the
    carried state and takes the new state from it (fp32 throughout; the
    reference's fused kernel has no carry in or out)
  * ``decode``  — one token against the carry

Dtypes are the reference's: with fp32 parameters and bf16 activations,
the depthwise conv multiplies bf16 inputs by the fp32 ``conv`` leaf, so
xc, dt, B, C and the scan are fp32, and the output projection is an fp32
product of that tail with the bf16-rounded ``w_out`` (JAX promotes the
mixed product; PyTorch needs the promotion spelled out).  The conv is the
reference's Python sum of d_conv shifted products plus ``conv_b``, in that
order (``F.conv1d`` sums in another).  JAX clamps the carry gathers of
``prefill`` with ``length``; here the indices are clamped explicitly.

Tensor parallelism (a model bound to a mesh whose "model" axis divides
``d_inner``): every parameter holds this rank's ``d_inner`` slice and
the block runs on it, carries included.  ``w_in`` keeps the reference's
(d, 2·di) [x | z] layout, sharded contiguously, so a rank's product
holds pieces of either half; :meth:`Spmd.halves` regroups them into the
rank's (xr, z) columns.  ``w_bcdt`` and ``w_out`` are row-parallel: B,
C, dt_in and the output are fp32 partial sums over "model", rounded
once after the sum.  The conv, ``w_dt``, ``dt_bias``, ``a_log`` and
``d_skip`` are the rank's own channels.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.quant import sigmoid
from repro_torch.kernels.fused_ssm.ops import (fused_ssm_fwd_kernel,
                                              selective_scan)
from repro_torch.kernels.linear_scan.ops import linear_scan
from repro_torch.models.module import fan_in_init
from repro_torch.parallel import spmd


def _silu(v):
    """x·σ(x) with the reference's op-by-op σ (``core.quant.sigmoid``)."""
    return v * sigmoid(v)


def _softplus(v):
    """``jax.nn.softplus``: logaddexp(v, 0) = max(v, 0) + log1p(e^-|v|)."""
    return torch.clamp(v, min=0) + torch.log1p(torch.exp(-v.abs()))


def _promoted(a, b):
    """a and b cast to their promoted dtype (what ``jnp.einsum`` and ``@``
    do with mixed inputs)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


class MambaBlock(nn.Module):
    """Parameters are the reference's leaves, by name and shape: ``w_in``
    (d, 2·di), ``conv`` (d_conv, di), ``conv_b`` (di,), ``w_bcdt`` (di,
    2n + dt_rank), ``w_dt`` (dt_rank, di), ``dt_bias`` (di,), ``a_log``
    (di, n), ``d_skip`` (di,), ``w_out`` (di, d)."""

    def __init__(self, cfg: ModelConfig, *, dtype=torch.float32,
                 device=None):
        super().__init__()
        if cfg.mamba is None:
            raise ValueError(f"{cfg.name}: a Mamba layer needs cfg.mamba")
        self.cfg, self.mc = cfg, cfg.mamba
        d, mc = cfg.d_model, cfg.mamba
        di = self.d_inner = mc.d_inner(d)
        self.dt_rank = max(1, d // 16)
        kw = dict(dtype=dtype, device=device)
        self.w_in = nn.Parameter(torch.empty(d, 2 * di, **kw))
        self.conv = nn.Parameter(torch.empty(mc.d_conv, di, **kw))
        self.conv_b = nn.Parameter(torch.empty(di, **kw))
        self.w_bcdt = nn.Parameter(torch.empty(
            di, 2 * mc.d_state + self.dt_rank, **kw))
        self.w_dt = nn.Parameter(torch.empty(self.dt_rank, di, **kw))
        self.dt_bias = nn.Parameter(torch.empty(di, **kw))
        self.a_log = nn.Parameter(torch.empty(di, mc.d_state, **kw))
        self.d_skip = nn.Parameter(torch.empty(di, **kw))
        self.w_out = nn.Parameter(torch.empty(di, d, **kw))
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        """The reference's initializer families (``MambaBlock.init``):
        fan-in matrices, 0.1·normal conv, zero conv bias, softplus-inverse
        dt bias of dt ~ exp(U[-6, -4]), S4D-real A = -(1..n), ones skip."""
        for w in (self.w_in, self.w_bcdt, self.w_dt, self.w_out):
            fan_in_init(w, generator=generator)
        with torch.no_grad():
            nn.init.normal_(self.conv, generator=generator).mul_(0.1)
            self.conv_b.zero_()
            u = nn.init.uniform_(torch.empty_like(self.dt_bias),
                                 generator=generator)
            self.dt_bias.copy_(torch.log(torch.exp(torch.exp(u * 2.0 - 6.0))
                                         - 1.0 + 1e-6))
            n = self.mc.d_state
            self.a_log.copy_(torch.log(torch.arange(
                1, n + 1, dtype=self.a_log.dtype,
                device=self.a_log.device)).expand(self.d_inner, n))
            self.d_skip.fill_(1.0)

    @property
    def _di(self):
        """The channels this block runs on: ``d_inner``, or this rank's
        slice of it inside ``spmd.local_view``."""
        return self.d_skip.shape[0]

    def _tp(self):
        """The runtime when ``d_inner`` is sharded over "model"."""
        s = spmd.current()
        return s if s is not None and self._di < self.d_inner else None

    def _in(self, x):
        """(xr, z) halves of the input projection, in x.dtype (this
        rank's channels of each under tensor parallelism)."""
        s = self._tp()
        if s is not None:
            return s.halves(s.column(x, self.w_in.to(x.dtype))[0])
        return (x @ self.w_in.to(x.dtype)).chunk(2, dim=-1)

    def _rows(self, v, w):
        """v @ w (w in v's dtype) for a weight whose rows shard with
        ``d_inner``: the fp32 partial products summed over "model" and
        rounded once (their gradient summed back: every rank's channels
        read the sum)."""
        s = self._tp()
        if s is None:
            return v @ w
        return s.enter(s.reduce(v.float() @ w.float()).to(v.dtype))

    def _conv(self, xr, tail):
        """Causal depthwise conv of xr (B, T, di) warmed by the cached
        ``tail`` (B, d_conv - 1, di): (pre-activation, history (B, T +
        d_conv - 1, di))."""
        T = xr.shape[1]
        hist = torch.cat([tail.to(xr.dtype), xr], dim=1)
        out = sum(hist[:, i:i + T] * self.conv[i]
                  for i in range(self.mc.d_conv))
        return out + self.conv_b, hist

    def _ssm_raw(self, xc):
        """(dt, B, C, A) from xc (B, T, di), post conv and silu."""
        n = self.mc.d_state
        bcdt = self._rows(xc, self.w_bcdt.to(xc.dtype))
        Bm, Cm, dt_in = bcdt.split([n, n, self.dt_rank], dim=-1)
        dt = _softplus(dt_in @ self.w_dt.to(xc.dtype)
                       + self.dt_bias.to(xc.dtype))
        A = -torch.exp(self.a_log.float())
        return dt, Bm, Cm, A

    def _ssm_terms(self, xc):
        """Discretized terms of the materializing path: (a_bar, b_bar
        (B, T, di, n), C)."""
        dt, Bm, Cm, A = self._ssm_raw(xc)
        a_bar = torch.exp(dt[..., None].float() * A)
        b_bar = dt[..., None] * Bm[:, :, None, :] * xc[..., None]
        return a_bar, b_bar, Cm

    def _out(self, y, xc, z, x):
        """Skip, gate and output projection; y's dtype holds x's, so the
        product is JAX's promoted one."""
        y = y + self.d_skip.to(x.dtype) * xc
        y = y * _silu(z)
        w = self.w_out.to(x.dtype).to(y.dtype)
        s = self._tp()
        if s is not None:       # each rank's rows, as GQA's wo
            return s.reduce(y.float() @ w.float()).to(x.dtype)
        return (y @ w).to(x.dtype)

    def forward(self, x, positions=None):
        """x: (B, T, D) -> (B, T, D)."""
        del positions
        if self.cfg.ssm_impl == "xla":
            # full-sequence eval == prefill from a blank carry, as in the
            # reference (one implementation for training and serving)
            y, _ = self.prefill(x, self.init_cache(x.shape[0],
                                                   dtype=x.dtype))
            return y
        xr, z = self._in(x)
        pre, _ = self._conv(xr, xr.new_zeros(x.shape[0],
                                             self.mc.d_conv - 1, self._di))
        xc = _silu(pre)
        dt, Bm, Cm, A = self._ssm_raw(xc)
        if self.cfg.ssm_impl == "stub":
            # the dry-run's O(B·T·di) stand-in with gradients to dt, xc,
            # B, C and A (``launch.dryrun`` adds the fused scan's cost)
            y = ((dt * xc) * Bm.sum(-1, keepdim=True)
                 + xc * Cm.sum(-1, keepdim=True)
                 + xc * A.sum(1)[None, None, :].to(x.dtype))
            return self._out(y, xc, z, x)
        return self._out(selective_scan(dt, xc, Bm, Cm, A), xc, z, x)

    # --- prefill: whole chunk against the O(1) carry ---
    def prefill(self, x, cache, pos0=0, length=None):
        """x: (B, S, D).  One linear scan over the chunk, the conv warmed
        from the cached tail.  ``length`` (a host int; None = all) selects
        the carries at the last valid token when the chunk tail is grid
        padding (scan and conv are causal, so padding never reaches
        them)."""
        del pos0
        B, T, _ = x.shape
        di, n, K = self._di, self.mc.d_state, self.mc.d_conv
        xr, z = self._in(x)
        pre, hist = self._conv(xr, cache["conv"])
        xc = _silu(pre)
        # JAX's clamped gathers: the state after token length-1, the
        # d_conv-1 inputs before `length`
        last = T - 1 if length is None else min(max(int(length) - 1, 0),
                                                T - 1)
        s = T if length is None else min(max(int(length), 0), T)
        if self.cfg.ssm_impl == "fused":
            return self._prefill_fused(x, xc, z, hist, cache, last, s)
        a_bar, b_bar, Cm = self._ssm_terms(xc)
        h = linear_scan(a_bar.reshape(B, T, di * n).to(x.dtype),
                        b_bar.reshape(B, T, di * n).to(x.dtype),
                        cache["ssm"].reshape(B, di * n).to(x.dtype),
                        self.cfg.scan_backend)
        y = torch.einsum("btdn,btn->btd",
                         *_promoted(h.reshape(B, T, di, n), Cm))
        y = self._out(y, xc, z, x)
        # hist keeps the d_conv-1 rows from index s (d_conv 1: empty)
        return y, self._carry(h[:, last], hist[:, s:s + K - 1], cache)

    def _carry(self, ssm, conv, cache):
        """Contiguous carries in the cache's dtypes (the next chunk's scan
        reads ssm flat)."""
        return {"ssm": ssm.reshape(cache["ssm"].shape).to(
                    cache["ssm"].dtype).contiguous(),
                "conv": conv.to(cache["conv"].dtype).contiguous()}

    def _prefill_fused(self, x, xc, z, hist, cache, last, s):
        """The fused kernel over the chunk's tokens up to ``last`` from the
        carried state: y of those tokens (the rest, grid padding, is left
        zero — causal, it reaches no valid token) and the state after
        ``last`` as the new carry."""
        B, T, _ = x.shape
        dt, Bm, Cm, A = self._ssm_raw(xc)
        v = last + 1
        ins = [t[:, :v].float().contiguous() for t in (dt, xc, Bm, Cm)]
        h_last = torch.empty(B, self._di, self.mc.d_state,
                             dtype=torch.float32, device=x.device)
        y_v, _ = fused_ssm_fwd_kernel(*ins, A.contiguous(),
                                      h0=cache["ssm"].float().contiguous(),
                                      h_last=h_last)
        y = y_v.new_zeros(B, T, self._di)
        y[:, :v] = y_v
        y = self._out(y.to(xc.dtype), xc, z, x)
        return y, self._carry(h_last, hist[:, s:s + self.mc.d_conv - 1],
                              cache)

    def axes(self):
        return {"w_in": ("embed", "d_inner"), "conv": (None, "d_inner"),
                "conv_b": ("d_inner",),
                "w_bcdt": ("d_inner", None), "w_dt": (None, "d_inner"),
                "dt_bias": ("d_inner",), "a_log": ("d_inner", None),
                "d_skip": ("d_inner",), "w_out": ("d_inner", "embed")}

    def cache_axes(self):
        return {"ssm": ("batch", "d_inner", "state"),
                "conv": ("batch", "conv", "d_inner")}

    # --- decode: O(1) state ---
    def init_cache(self, batch, length=0, dtype=torch.float32):
        del length
        dev, di = self.w_in.device, self._di
        return {"ssm": torch.zeros(batch, di, self.mc.d_state, dtype=dtype,
                                   device=dev),
                "conv": torch.zeros(batch, self.mc.d_conv - 1, di,
                                    dtype=dtype, device=dev)}

    def decode(self, x, cache, pos=None):
        """x: (B, 1, D) -> ((B, 1, D), updated cache); position-free."""
        del pos
        xr, z = self._in(x[:, 0])
        window = torch.cat([cache["conv"].to(x.dtype), xr[:, None, :]],
                           dim=1)                          # (B, d_conv, di)
        xc = torch.einsum("bkd,kd->bd", window, self.conv.to(x.dtype))
        xc = _silu(xc + self.conv_b)
        a_bar, b_bar, Cm = self._ssm_terms(xc[:, None, :])
        h = a_bar[:, 0] * cache["ssm"].to(a_bar.dtype) + b_bar[:, 0]
        y = torch.einsum("bdn,bn->bd", *_promoted(h.to(x.dtype), Cm[:, 0]))
        y = self._out(y, xc, z, x)[:, None, :]
        return y, {"ssm": h.to(cache["ssm"].dtype),
                   "conv": window[:, 1:].to(cache["conv"].dtype)}

