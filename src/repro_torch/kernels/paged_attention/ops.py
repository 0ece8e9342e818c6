"""Paged GQA decode: the two CUDA kernels' wrappers, the backend dispatch
and the analytic cost model (port of
``repro.kernels.paged_attention.ops``, GQA only).

``paged_gqa_kernel`` runs ``csrc/paged_gqa.cu`` (which replaces the TPU
kernel ``paged_gqa_fwd``) on CUDA tensors, and ``paged_gqa_q8_kernel``
runs ``csrc/paged_gqa_q8.cu`` (replacing ``paged_gqa_fwd_q8``) for int8
pools with per-(page, kv-head) float32 scales.  On CPU tensors both take
their plain version, :func:`ref.paged_gqa_ref`; on a CUDA tensor they
launch the kernel or raise.  Each counts its launches in
``<wrapper>.launches``.

:func:`paged_gqa_attention` dispatches one single-token decode read:

  * backend "gather" — the plain version (dense gather of each chain,
    masked fp32 softmax): the definitional oracle;
  * backend "kernel" — the wrappers above (the serving default,
    ``ModelConfig.paged_impl``).

Decode is inference-only: no autograd here.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import PAGED_IMPLS as BACKENDS
from repro_torch.kernels import build
from repro_torch.kernels.paged_attention import ref

#: Shared memory one block may use (H100: 227 KB).
_SMEM_LIMIT = 232448


def _smem_bytes(G, hd, ps):
    """Dynamic shared memory of one block: q rows, one K and one V page,
    the page's scores, the accumulator and (m, l, alpha) per query row,
    all fp32 (the layout of both sources)."""
    return 4 * (2 * G * hd + 2 * ps * hd + G * ps + 3 * G)


def _check(what, q, pool_k, pool_v, bt, pos, length, window, pool_dtypes,
           scales=()):
    """Device, dtype, shape and contiguity checks shared by both CUDA
    wrappers; raises on anything the kernels do not take."""
    tensors = (q, pool_k, pool_v, bt, pos) + tuple(scales)
    if any(t.device != q.device for t in tensors):
        raise ValueError(f"{what}: inputs on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what}: inputs must be contiguous")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{what}: q must be fp32 or bf16, got {q.dtype}")
    if pool_k.dtype != pool_v.dtype or pool_k.dtype not in pool_dtypes:
        raise ValueError(f"{what}: pools must share one dtype of "
                         f"{pool_dtypes}, got {pool_k.dtype}/{pool_v.dtype}")
    if bt.dtype != torch.int32 or pos.dtype != torch.int32:
        raise ValueError(f"{what}: block tables and positions must be "
                         f"int32, got {bt.dtype}/{pos.dtype}")
    if any(s.dtype != torch.float32 for s in scales):
        raise ValueError(f"{what}: scales must be float32")
    if q.dim() != 3 or pool_k.dim() != 4 or pool_v.shape != pool_k.shape:
        raise ValueError(f"{what}: shapes q {tuple(q.shape)}, pools "
                         f"{tuple(pool_k.shape)}/{tuple(pool_v.shape)}")
    B, H, hd = q.shape
    P, ps, KV, hd_k = pool_k.shape
    if hd_k != hd or KV < 1 or H % KV:
        raise ValueError(f"{what}: q {tuple(q.shape)} does not fit pools "
                         f"{tuple(pool_k.shape)} (H % KV, head_dim)")
    n_pages = -(-length // ps)
    if bt.dim() != 2 or bt.shape[0] != B or bt.shape[1] < n_pages:
        raise ValueError(f"{what}: block tables {tuple(bt.shape)} need "
                         f"({B}, >= {n_pages})")
    if pos.shape != (B,):
        raise ValueError(f"{what}: pos {tuple(pos.shape)} != ({B},)")
    if any(s.shape != (P, KV) for s in scales):
        raise ValueError(f"{what}: scales must be ({P}, {KV})")
    if length < 1 or (window is not None and window < 1):
        raise ValueError(f"{what}: length {length}, window {window}")
    if B > 65535 or _smem_bytes(H // KV, hd, ps) > _SMEM_LIMIT:
        raise ValueError(f"{what}: shape too large for one launch")


def _launch(fn, what, q, pool_k, pool_v, scales, bt, pos, length, window):
    B, H, hd = q.shape
    _P, ps, KV, _ = pool_k.shape
    out = torch.empty_like(q)
    if B == 0:
        return out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptrs = [q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr()]
    ptrs += [s.data_ptr() for s in scales]
    err = fn(*ptrs, bt.data_ptr(), pos.data_ptr(), out.data_ptr(), B, H,
             KV, hd, ps, bt.shape[1], length,
             -1 if window is None else int(window),
             _smem_bytes(H // KV, hd, ps), stream)
    build.check(err, what)
    return out


def paged_gqa_kernel(q, pool_k, pool_v, block_tables, pos, *, length,
                     window=None):
    """q: (B, H, hd) fp32/bf16; pool_k/v: (P, page, KV, hd) of q's dtype;
    block_tables: (B, >= ceil(length/page)) int32; pos: (B,) int32 ->
    (B, H, hd) in q's dtype."""
    if q.device.type == "cpu":
        return ref.paged_gqa_ref(q, pool_k, pool_v, block_tables, pos,
                                 length=length, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"paged_gqa_kernel: unsupported device {q.device}")
    _check("paged_gqa_kernel", q, pool_k, pool_v, block_tables, pos, length,
           window, (q.dtype,))
    lib = build.load("paged_gqa")
    fn = lib.paged_gqa_bf16 if q.dtype == torch.bfloat16 \
        else lib.paged_gqa_f32
    out = _launch(fn, "paged_gqa", q, pool_k, pool_v, (), block_tables, pos,
                  length, window)
    paged_gqa_kernel.launches += 1
    return out


paged_gqa_kernel.launches = 0


def paged_gqa_q8_kernel(q, pool_k, pool_v, k_scale, v_scale, block_tables,
                        pos, *, length, window=None):
    """Int8 pools (P, page, KV, hd) with float32 scales (P, KV), codes
    dequantized in registers; otherwise as :func:`paged_gqa_kernel`."""
    if q.device.type == "cpu":
        return ref.paged_gqa_ref(q, pool_k, pool_v, block_tables, pos,
                                 length=length, window=window,
                                 k_scale=k_scale, v_scale=v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_gqa_q8_kernel: unsupported device "
                         f"{q.device}")
    _check("paged_gqa_q8_kernel", q, pool_k, pool_v, block_tables, pos,
           length, window, (torch.int8,), (k_scale, v_scale))
    lib = build.load("paged_gqa_q8")
    fn = lib.paged_gqa_q8_bf16 if q.dtype == torch.bfloat16 \
        else lib.paged_gqa_q8_f32
    out = _launch(fn, "paged_gqa_q8", q, pool_k, pool_v,
                  (k_scale, v_scale), block_tables, pos, length, window)
    paged_gqa_q8_kernel.launches += 1
    return out


paged_gqa_q8_kernel.launches = 0


def _check_scales(a, b, names):
    if (a is None) != (b is None):
        raise ValueError(f"pass both {names} or neither (int8 pools are "
                         "uninterpretable without their scales)")


def paged_gqa_attention(q, pool_k, pool_v, block_tables, pos, *, length,
                        window=None, backend="gather", k_scale=None,
                        v_scale=None):
    """q: (B, H, hd); pool_k/v: (P, page, KV, hd) with H % KV == 0;
    block_tables: (B, n_chain) page ids; pos: (B,) -> (B, H, hd).

    ``length`` is the dense cache length being emulated (the ring length
    for a sliding window, where it must be <= ``window``).  ``k_scale``/
    ``v_scale`` (P, KV) float32 select the int8 read path."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, "
                         f"got {backend!r}")
    _check_scales(k_scale, v_scale, "k_scale/v_scale")
    if window is not None and length > window:
        raise ValueError(f"ring length {length} exceeds window {window} "
                         "(pass length = min(window, max_len))")
    if backend == "gather":
        return ref.paged_gqa_ref(q, pool_k, pool_v, block_tables, pos,
                                 length=length, window=window,
                                 k_scale=k_scale, v_scale=v_scale)
    bt = block_tables.to(torch.int32).contiguous()
    pos = pos.to(torch.int32).contiguous()
    if k_scale is not None:
        return paged_gqa_q8_kernel(q, pool_k, pool_v, k_scale, v_scale, bt,
                                   pos, length=length, window=window)
    return paged_gqa_kernel(q, pool_k, pool_v, bt, pos, length=length,
                            window=window)


def cost_model(B, H, KV, hd, *, live_tokens, page_size, dtype_bytes=2,
               window=None, scale_bytes=0):
    """Analytic (flops, hbm_bytes) for one paged GQA decode call (the
    reference's own model): the LIVE K/V pages streamed once (whole
    pages), q and out in bf16, the block-table entries; flops 4·B·H·T·hd.
    A sliding-window ring caps both terms at ``window``; ``dtype_bytes``
    prices the pool dtype (1 for int8) and ``scale_bytes=4`` adds the
    float32 (page, KV-head) scales of each K and V page."""
    live = live_tokens if window is None else min(live_tokens, window)
    pages = -(-live // page_size)
    flops = 4 * B * H * live * hd
    kv = 2 * B * pages * page_size * KV * hd * dtype_bytes
    sc = 2 * B * pages * KV * scale_bytes
    qo = 2 * B * H * hd * 2
    bt = B * pages * 4
    return flops, kv + sc + qo + bt
