"""Paged GQA and MLA decode: the four CUDA kernels' wrappers, the backend
dispatch and the analytic cost models (port of
``repro.kernels.paged_attention.ops``).

``paged_gqa_kernel`` runs ``csrc/paged_gqa.cu`` (which replaces the TPU
kernel ``paged_gqa_fwd``) on CUDA tensors, and ``paged_gqa_q8_kernel``
runs ``csrc/paged_gqa_q8.cu`` (replacing ``paged_gqa_fwd_q8``) for int8
pools with per-(page, kv-head) float32 scales.  ``paged_mla_kernel`` and
``paged_mla_q8_kernel`` do the same for weight-absorbed MLA over latent
pages (``csrc/paged_mla.cu`` and ``csrc/paged_mla_q8.cu``, replacing
``paged_mla_fwd`` and ``paged_mla_fwd_q8``; int8 latent pools carry one
float32 scale per page).  When every input lies on the CPU a wrapper
takes its plain version (:func:`ref.paged_gqa_ref`,
:func:`ref.paged_mla_ref`); otherwise it launches the kernel or raises.
Each counts its launches in ``<wrapper>.launches``; the MLA wrappers also
count those of their tensor-core route (:func:`mla_route`) in
``<wrapper>.launches_tc``.

:func:`paged_gqa_attention` and :func:`paged_mla_attention` dispatch one
single-token decode read:

  * backend "gather" — the plain version (dense gather of each chain,
    masked fp32 softmax): the definitional oracle;
  * backend "kernel" — the wrappers above (the serving default,
    ``ModelConfig.paged_impl``).

Decode is inference-only: no autograd here.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.configs.base import PAGED_IMPLS as BACKENDS
from repro_torch.kernels import build, check_devices, on_cpu
from repro_torch.kernels.paged_attention import ref

#: Shared memory one block may use (H100: 227 KB).
_SMEM_LIMIT = 232448
#: cudaErrorInvalidValue: what a kernel's C entry point returns for a shape
#: it does not take.
_CUDA_INVALID_VALUE = 1

#: Warps of one paged GQA CTA, and the most CTAs (page ranges) a cluster
#: cuts a request's chain into: the portable cluster size
#: (``csrc/paged_gqa.cuh``, which chooses the rest of its layout itself).
GQA_WARPS = 4
GQA_MAX_SPLIT = 8
#: Head dims the GQA kernels take: a lane holds at most hd / 32 elements
#: of a row on the one-element layout (a head dim that is not a whole count
#: of 16-byte chunks, or unaligned pools).
_GQA_MAX_HD = 256
#: Query rows of a kv head one cluster takes (``csrc/paged_gqa.cuh``'s
#: max_tile) on 16-byte chunks: bf16 and fp32 pools, int8 pools.
GQA_MAX_TILE = 4
GQA_MAX_TILE_Q8 = 3
#: fp32 values of a row one lane holds at most where a row is not a
#: power-of-two count of 16-byte chunks (one chunk where it holds more;
#: ``csrc/paged_gqa.cuh``'s max_chunks).
GQA_LANE_VALUES = 8


def gqa_splits(length, page_size):
    """CTAs of a cluster, and so page ranges, that the GQA kernels cut each
    request's chain into: a page for each of a CTA's ``GQA_WARPS`` warps
    when the chain is full, up to ``GQA_MAX_SPLIT``.  It depends on the
    static shape alone (never on the batch, the other requests or the
    card), so a request's output is bitwise the same whatever batch it
    shares."""
    n_pages = -(-length // page_size)
    return max(1, min(GQA_MAX_SPLIT, -(-n_pages // GQA_WARPS)))


def gqa_page_range(pos, length, page_size, n_split, rank):
    """[begin, end) of the live pages (``p * ps <= pos`` and ``p * ps <
    length``) that CTA ``rank`` of a cluster reads: the formula
    ``csrc/paged_gqa.cuh`` applies on the card.  Ranges are contiguous and
    balanced; one that is not empty begins with a live page."""
    n_live = 0 if pos < 0 else min(pos, length - 1) // page_size + 1
    return rank * n_live // n_split, (rank + 1) * n_live // n_split


def gqa_layout(head_dim, pool_itemsize, group=1, aligned=True):
    """The layout ``choose_layout`` in ``csrc/paged_gqa.cuh`` takes for
    pools of ``pool_itemsize``-byte elements (4 fp32, 2 bf16, 1 int8) at
    ``head_dim``, ``group`` query rows a kv head and pools whose bases are
    16-byte ``aligned``: a dict of ``route`` ("vector": 16-byte chunks;
    "scalar": one element a lane), ``lanes`` a row, ``chunks`` a lane (of
    ``chunk_elems`` elements each; the last ones masked where they pass the
    row) and ``tile`` (query rows a cluster).  Used to label and check
    measurements; the card decides for itself, and
    :func:`gqa_device_layout` reads what it decides."""
    per_chunk = 16 // pool_itemsize
    nc = head_dim // per_chunk
    if not aligned or head_dim % per_chunk:
        return dict(route="scalar", lanes=32, chunks=-(-head_dim // 32),
                    chunk_elems=1, tile=1)
    if nc <= 32 and nc & (nc - 1) == 0:
        lanes, chunks = nc, 1
    else:
        # the fewest lanes that hold at most GQA_LANE_VALUES fp32 values
        # each (at least one chunk)
        most = max(1, GQA_LANE_VALUES // per_chunk)
        lanes = 1
        while -(-nc // lanes) > most:
            lanes *= 2
        chunks = -(-nc // lanes)
    most = GQA_MAX_TILE_Q8 if pool_itemsize == 1 else GQA_MAX_TILE
    n_tiles = -(-group // most)
    return dict(route="vector", lanes=lanes, chunks=chunks,
                chunk_elems=per_chunk, tile=-(-group // n_tiles))


def gqa_route(head_dim, pool_itemsize, aligned=True):
    """The GQA kernels' route (:func:`gqa_layout`): ``"vector"`` (16-byte
    chunks, every query row of a kv head in one tile up to 4, 3 for int8)
    wherever a row is a whole count of 16-byte chunks and the pools are
    16-byte aligned, else ``"scalar"`` (one element a lane, one query row
    a tile)."""
    return gqa_layout(head_dim, pool_itemsize, aligned=aligned)["route"]


def gqa_device_layout(head_dim, pool_itemsize, group=1, aligned=True):
    """What the built kernel library's own rule (``paged_gqa_layout``,
    ``paged_gqa_q8_layout``) chooses at the same arguments as
    :func:`gqa_layout`, in the same form, so that a card run can check the
    mirror against it.  Needs the CUDA toolkit; launches nothing."""
    out = (ctypes.c_int * 4)()
    if pool_itemsize == 1:
        err = build.load("paged_gqa_q8").paged_gqa_q8_layout(
            head_dim, group, int(aligned), ctypes.addressof(out))
    else:
        err = build.load("paged_gqa").paged_gqa_layout(
            head_dim, pool_itemsize, group, int(aligned),
            ctypes.addressof(out))
    build.check(err, "paged_gqa_layout")
    lanes, chunks, _n_tiles, tile = out
    if chunks == 0:
        return dict(route="scalar", lanes=lanes, chunks=-(-head_dim // 32),
                    chunk_elems=1, tile=tile)
    return dict(route="vector", lanes=lanes, chunks=chunks,
                chunk_elems=16 // pool_itemsize, tile=tile)


def misaligned(t):
    """A contiguous copy of ``t`` whose base lies one element past a
    16-byte boundary: pools the GQA kernels read one element a lane (the
    one-element layout), for tests and measurements of that layout."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


def _check(what, q, pool_k, pool_v, bt, pos, length, window, pool_dtypes,
           scales=()):
    """Device, dtype, shape and contiguity checks shared by both CUDA
    wrappers; raises on anything the kernels do not take."""
    tensors = (q, pool_k, pool_v, bt, pos) + tuple(scales)
    check_devices(what, *tensors)
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
    if hd > _GQA_MAX_HD:
        raise ValueError(f"{what}: head_dim {hd} > {_GQA_MAX_HD}")
    if B > 65535 or H > 65535:
        raise ValueError(f"{what}: shape too large for one launch")


def gqa_launch(lib, what, q, pool_k, pool_v, bt, pos, *, length, window,
               scales=()):
    """One launch of kernel source ``what`` ("paged_gqa" or
    "paged_gqa_q8") from its loaded library ``lib``, after ``_check``;
    returns out.  The wrapper passes n_split = :func:`gqa_splits`; the
    kernel chooses the rest of its layout (query-row tiles, 16-byte
    chunks, ring stages) from the shape and the pools' alignment, and
    refuses a shape whose shared memory does not fit (cudaErrorInvalidValue,
    raised here as ValueError)."""
    B, H, hd = q.shape
    _P, ps, KV, _ = pool_k.shape
    out = torch.empty_like(q)
    if B == 0:
        return out
    dt = "bf16" if q.dtype == torch.bfloat16 else "f32"
    fn = getattr(lib, f"{what}_{dt}")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptrs = [q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr()]
    ptrs += [s.data_ptr() for s in scales]
    err = fn(*ptrs, bt.data_ptr(), pos.data_ptr(), out.data_ptr(), B, H,
             KV, hd, ps, bt.shape[1], length,
             -1 if window is None else int(window), gqa_splits(length, ps),
             stream)
    if err == _CUDA_INVALID_VALUE:
        raise ValueError(f"{what}: shape too large for one launch (q "
                         f"{tuple(q.shape)}, pools {tuple(pool_k.shape)})")
    build.check(err, what)
    return out


def paged_gqa_kernel(q, pool_k, pool_v, block_tables, pos, *, length,
                     window=None):
    """q: (B, H, hd) fp32/bf16; pool_k/v: (P, page, KV, hd) of q's dtype;
    block_tables: (B, >= ceil(length/page)) int32; pos: (B,) int32 ->
    (B, H, hd) in q's dtype."""
    if on_cpu(q, pool_k, pool_v, block_tables, pos):
        return ref.paged_gqa_ref(q, pool_k, pool_v, block_tables, pos,
                                 length=length, window=window)
    _check("paged_gqa_kernel", q, pool_k, pool_v, block_tables, pos, length,
           window, (q.dtype,))
    out = gqa_launch(build.load("paged_gqa"), "paged_gqa", q, pool_k,
                     pool_v, block_tables, pos, length=length, window=window)
    paged_gqa_kernel.launches += 1
    return out


paged_gqa_kernel.launches = 0


def paged_gqa_q8_kernel(q, pool_k, pool_v, k_scale, v_scale, block_tables,
                        pos, *, length, window=None):
    """Int8 pools (P, page, KV, hd) with float32 scales (P, KV), codes
    dequantized in registers; otherwise as :func:`paged_gqa_kernel`."""
    if on_cpu(q, pool_k, pool_v, k_scale, v_scale, block_tables, pos):
        return ref.paged_gqa_ref(q, pool_k, pool_v, block_tables, pos,
                                 length=length, window=window,
                                 k_scale=k_scale, v_scale=v_scale)
    _check("paged_gqa_q8_kernel", q, pool_k, pool_v, block_tables, pos,
           length, window, (torch.int8,), (k_scale, v_scale))
    out = gqa_launch(build.load("paged_gqa_q8"), "paged_gqa_q8", q, pool_k,
                     pool_v, block_tables, pos, length=length, window=window,
                     scales=(k_scale, v_scale))
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


# --- MLA over latent pages -----------------------------------------------

#: Query heads one block of the MLA kernels' simt route holds
#: (``paged_mla.cuh``).
MLA_HEADS_PER_BLOCK = 8
#: Latent ranks the MLA kernels take: multiples of 4 (float4 rows), ``r``
#: at most 1024 (each thread keeps two float4 accumulator columns).
_MLA_MAX_RANK = 1024
#: Resident blocks of the split kernel an SM is counted for when the
#: wrapper cuts each request's pages into ranges.
_MLA_BLOCKS_PER_SM = 4


def _smem_bytes_mla(r, dr, ps):
    """Dynamic shared memory of one MLA block: the block's q_abs and
    q_rope rows and one ckv and one krope page (rows padded by four
    floats against bank conflicts), the page's scores and (m, l, alpha)
    per head, all fp32 (``paged_mla.cuh``)."""
    hb = MLA_HEADS_PER_BLOCK
    return 4 * (hb * (r + 4) + hb * (dr + 4) + ps * (r + 4) + ps * (dr + 4)
                + hb * ps + 3 * hb)


def _mla_splits(B, H, n_pages, sm_count):
    """Ranges the MLA kernel cuts each request's pages into: enough
    (head group, request, range) blocks for ``_MLA_BLOCKS_PER_SM`` on
    every SM, at most one range a page."""
    groups = B * -(-H // MLA_HEADS_PER_BLOCK)
    want = -(-_MLA_BLOCKS_PER_SM * sm_count // max(groups, 1))
    return max(1, min(n_pages, want))


#: The tensor-core route (``paged_mla_tc.cuh``): query heads of a CTA (one
#: wgmma M tile), latent rows of a ring stage, the ranks and page sizes it
#: takes.
MLA_TC_HEADS = 64
MLA_TC_ROWS = 32
MLA_TC_RANKS = (512, 64)
MLA_TC_PAGE_SIZES = (8, 16, 32)
#: Most pages of one range on the tc route (their ids sit in shared memory).
MLA_TC_MAX_RANGE = 256


def mla_route(q_dtype, kv_dtype, r, dr, ps, aligned):
    """"tc" (``paged_mla_tc.cuh``: wgmma fed by TMA) or "simt" (the CUDA-core
    kernel of ``paged_mla.cuh``) for one MLA read: tc for bf16 queries over
    bf16 or int8 pages at r 512, dr 64 (deepseek-v3's MLA), pages of 8, 16
    or 32 entries, and ``aligned`` (q_abs, q_rope and both pools 16-byte
    aligned: what TMA can address); simt for everything else, fp32 queries
    among it.  A function of these arguments alone."""
    tc = (q_dtype == torch.bfloat16
          and kv_dtype in (torch.bfloat16, torch.int8)
          and (r, dr) == MLA_TC_RANKS and ps in MLA_TC_PAGE_SIZES
          and aligned)
    return "tc" if tc else "simt"


def mla_tc_splits(B, H, n_pages, ps, sm_count):
    """Page ranges (n_split) the tc route cuts each request's live pages
    into: one CTA a (64-head tile, request, range), at most ``sm_count``
    of them (one is resident an SM) unless a range would pass
    MLA_TC_MAX_RANGE pages on a full chain, each range as short as that
    allows.  From the static shape alone: each CTA cuts its request's live
    stages into n_split balanced ranges from the request's pos
    (``csrc/paged_mla_tc.cuh``)."""
    pps = MLA_TC_ROWS // ps
    n_stages = -(-n_pages // pps)
    ctas = B * -(-H // MLA_TC_HEADS)
    per_stages = min(-(-n_stages // max(1, sm_count // ctas)),
                     MLA_TC_MAX_RANGE // pps)
    return -(-n_stages // per_stages)


def mla_kernel_info(q8):
    """What the build made of the tc route's split kernel (int8 pages when
    ``q8``): registers and local (spill and stack) bytes a thread, dynamic
    shared bytes, resident CTAs an SM, threads a CTA.  Needs the CUDA
    toolkit and a device."""
    name = "paged_mla_q8" if q8 else "paged_mla"
    out = (ctypes.c_int * 5)()
    build.check(getattr(build.load(name), f"{name}_tc_info")(
        ctypes.addressof(out)), name)
    return dict(zip(("registers", "local_bytes", "smem_bytes",
                     "blocks_per_sm", "threads"), out))


def _check_mla(what, q_abs, q_rope, pool_ckv, pool_krope, bt, pos, length,
               pool_dtypes, scales=()):
    """Device, dtype, shape and contiguity checks of both MLA wrappers:
    latent pools (P, ps, r) and (P, ps, dr), int8 scales (P,)."""
    tensors = (q_abs, q_rope, pool_ckv, pool_krope, bt, pos) + tuple(scales)
    check_devices(what, *tensors)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what}: inputs must be contiguous")
    if q_abs.dtype not in (torch.float32, torch.bfloat16) or \
            q_rope.dtype != q_abs.dtype:
        raise ValueError(f"{what}: q_abs and q_rope must share fp32 or "
                         f"bf16, got {q_abs.dtype}/{q_rope.dtype}")
    if pool_ckv.dtype != pool_krope.dtype or \
            pool_ckv.dtype not in pool_dtypes:
        raise ValueError(f"{what}: latent pools must share one dtype of "
                         f"{pool_dtypes}, got {pool_ckv.dtype}/"
                         f"{pool_krope.dtype}")
    if bt.dtype != torch.int32 or pos.dtype != torch.int32:
        raise ValueError(f"{what}: block tables and positions must be "
                         f"int32, got {bt.dtype}/{pos.dtype}")
    if any(s.dtype != torch.float32 for s in scales):
        raise ValueError(f"{what}: scales must be float32")
    if q_abs.dim() != 3 or q_rope.dim() != 3 or pool_ckv.dim() != 3 or \
            pool_krope.dim() != 3:
        raise ValueError(f"{what}: shapes q_abs {tuple(q_abs.shape)}, "
                         f"q_rope {tuple(q_rope.shape)}, pools "
                         f"{tuple(pool_ckv.shape)}/{tuple(pool_krope.shape)}")
    B, H, r = q_abs.shape
    P, ps, _ = pool_ckv.shape
    dr = q_rope.shape[2]
    if q_rope.shape[:2] != (B, H) or pool_ckv.shape[2] != r or \
            pool_krope.shape != (P, ps, dr):
        raise ValueError(f"{what}: q_abs {tuple(q_abs.shape)}, q_rope "
                         f"{tuple(q_rope.shape)} do not fit pools "
                         f"{tuple(pool_ckv.shape)}/{tuple(pool_krope.shape)}")
    if r % 4 or dr % 4 or not 0 < r <= _MLA_MAX_RANK or dr < 1:
        raise ValueError(f"{what}: latent ranks r {r}, dr {dr} must be "
                         f"multiples of 4 with r <= {_MLA_MAX_RANK}")
    n_pages = -(-length // ps)
    if bt.dim() != 2 or bt.shape[0] != B or bt.shape[1] < n_pages:
        raise ValueError(f"{what}: block tables {tuple(bt.shape)} need "
                         f"({B}, >= {n_pages})")
    if pos.shape != (B,):
        raise ValueError(f"{what}: pos {tuple(pos.shape)} != ({B},)")
    if any(s.shape != (P,) for s in scales):
        raise ValueError(f"{what}: scales must be ({P},)")
    if length < 1:
        raise ValueError(f"{what}: length {length}")
    if B > 65535 or _smem_bytes_mla(r, dr, ps) > _SMEM_LIMIT:
        raise ValueError(f"{what}: shape too large for one launch")


def _launch_mla(fn, what, q_abs, q_rope, pool_ckv, pool_krope, scales, bt,
                pos, length, scale):
    B, H, r = q_abs.shape
    _P, ps, _ = pool_ckv.shape
    dr = q_rope.shape[2]
    out = torch.empty_like(q_abs)
    if B == 0 or H == 0:
        return out
    dev = q_abs.device
    n_pages = -(-length // ps)
    n_split = _mla_splits(B, H, n_pages, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    # scratch of the page ranges: unnormalized accumulators and (m, l)
    part_acc = torch.empty(B * H * n_split * r, dtype=torch.float32,
                           device=dev)
    part_ml = torch.empty(B * H * n_split * 2, dtype=torch.float32,
                          device=dev)
    # 16-byte page loads need aligned pools and rows of whole vectors
    per_vec = 16 // pool_ckv.element_size()
    vec = int(r % per_vec == 0 and dr % per_vec == 0
              and pool_ckv.data_ptr() % 16 == 0
              and pool_krope.data_ptr() % 16 == 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = [q_abs.data_ptr(), q_rope.data_ptr(), pool_ckv.data_ptr(),
            pool_krope.data_ptr()]
    ptrs += [s.data_ptr() for s in scales]
    err = fn(*ptrs, bt.data_ptr(), pos.data_ptr(), part_acc.data_ptr(),
             part_ml.data_ptr(), out.data_ptr(), B, H, r, dr, ps,
             bt.shape[1], length, n_split, vec, _smem_bytes_mla(r, dr, ps),
             float(scale), stream)
    build.check(err, what)
    return out


def _route_mla(q_abs, q_rope, pool_ckv, pool_krope):
    aligned = all(t.data_ptr() % 16 == 0
                  for t in (q_abs, q_rope, pool_ckv, pool_krope))
    return mla_route(q_abs.dtype, pool_ckv.dtype, q_abs.shape[2],
                     q_rope.shape[2], pool_ckv.shape[1], aligned)


def _launch_mla_tc(fn, what, q_abs, q_rope, pool_ckv, pool_krope, scales,
                   bt, pos, length, scale):
    """One launch of the tc route (split kernel and combine); a shape or
    alignment it refuses raises, never falls back."""
    B, H, r = q_abs.shape
    P, ps, _ = pool_ckv.shape
    dr = q_rope.shape[2]
    out = torch.empty_like(q_abs)
    if B == 0 or H == 0:
        return out
    dev = q_abs.device
    n_split = mla_tc_splits(B, H, -(-length // ps), ps,
                                 torch.cuda.get_device_properties(
                                     dev).multi_processor_count)
    # the ranges' unnormalized sums and (m, l), which the combine merges
    part_acc = torch.empty(B * H * n_split * r, dtype=torch.float32,
                           device=dev)
    part_ml = torch.empty(B * H * n_split * 2, dtype=torch.float32,
                          device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = [q_abs.data_ptr(), q_rope.data_ptr(), pool_ckv.data_ptr(),
            pool_krope.data_ptr()]
    ptrs += [s.data_ptr() for s in scales]
    err = fn(*ptrs, bt.data_ptr(), pos.data_ptr(), part_acc.data_ptr(),
             part_ml.data_ptr(), out.data_ptr(), B, H, r, dr, P, ps,
             bt.shape[1], length, n_split, float(scale), stream)
    build.check(err, what)
    return out


def paged_mla_kernel(q_abs, q_rope, pool_ckv, pool_krope, block_tables,
                     pos, *, length, scale):
    """q_abs: (B, H, r), q_rope: (B, H, dr) fp32/bf16; pool_ckv:
    (P, page, r), pool_krope: (P, page, dr) of q's dtype; block_tables:
    (B, >= ceil(length/page)) int32; pos: (B,) int32 -> latent output
    (B, H, r) in q's dtype."""
    if on_cpu(q_abs, q_rope, pool_ckv, pool_krope, block_tables, pos):
        return ref.paged_mla_ref(q_abs, q_rope, pool_ckv, pool_krope,
                                 block_tables, pos, length=length,
                                 scale=scale)
    _check_mla("paged_mla_kernel", q_abs, q_rope, pool_ckv, pool_krope,
               block_tables, pos, length, (q_abs.dtype,))
    lib = build.load("paged_mla")
    if _route_mla(q_abs, q_rope, pool_ckv, pool_krope) == "tc":
        out = _launch_mla_tc(lib.paged_mla_bf16_tc, "paged_mla", q_abs,
                             q_rope, pool_ckv, pool_krope, (), block_tables,
                             pos, length, scale)
        paged_mla_kernel.launches_tc += 1
    else:
        fn = lib.paged_mla_bf16 if q_abs.dtype == torch.bfloat16 \
            else lib.paged_mla_f32
        out = _launch_mla(fn, "paged_mla", q_abs, q_rope, pool_ckv,
                          pool_krope, (), block_tables, pos, length, scale)
    paged_mla_kernel.launches += 1
    return out


paged_mla_kernel.launches = 0
paged_mla_kernel.launches_tc = 0


def paged_mla_q8_kernel(q_abs, q_rope, pool_ckv, pool_krope, ckv_scale,
                        krope_scale, block_tables, pos, *, length, scale):
    """Int8 latent pools (P, page, r) and (P, page, dr) with one float32
    scale per page each (P,), codes dequantized as they are staged;
    otherwise as :func:`paged_mla_kernel`."""
    if on_cpu(q_abs, q_rope, pool_ckv, pool_krope, ckv_scale, krope_scale,
              block_tables, pos):
        return ref.paged_mla_ref(q_abs, q_rope, pool_ckv, pool_krope,
                                 block_tables, pos, length=length,
                                 scale=scale, ckv_scale=ckv_scale,
                                 krope_scale=krope_scale)
    _check_mla("paged_mla_q8_kernel", q_abs, q_rope, pool_ckv, pool_krope,
               block_tables, pos, length, (torch.int8,),
               (ckv_scale, krope_scale))
    lib = build.load("paged_mla_q8")
    scales = (ckv_scale, krope_scale)
    if _route_mla(q_abs, q_rope, pool_ckv, pool_krope) == "tc":
        out = _launch_mla_tc(lib.paged_mla_q8_bf16_tc, "paged_mla_q8", q_abs,
                             q_rope, pool_ckv, pool_krope, scales,
                             block_tables, pos, length, scale)
        paged_mla_q8_kernel.launches_tc += 1
    else:
        fn = lib.paged_mla_q8_bf16 if q_abs.dtype == torch.bfloat16 \
            else lib.paged_mla_q8_f32
        out = _launch_mla(fn, "paged_mla_q8", q_abs, q_rope, pool_ckv,
                          pool_krope, scales, block_tables, pos, length,
                          scale)
    paged_mla_q8_kernel.launches += 1
    return out


paged_mla_q8_kernel.launches = 0
paged_mla_q8_kernel.launches_tc = 0


def paged_mla_attention(q_abs, q_rope, pool_ckv, pool_krope, block_tables,
                        pos, *, length, scale, backend="gather",
                        ckv_scale=None, krope_scale=None):
    """Weight-absorbed MLA decode over latent pages -> (B, H, r) latent
    output (the caller up-projects through W^{UV}).  ``ckv_scale`` /
    ``krope_scale`` (P,) float32 select the int8 read path."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, "
                         f"got {backend!r}")
    _check_scales(ckv_scale, krope_scale, "ckv_scale/krope_scale")
    if backend == "gather":
        return ref.paged_mla_ref(q_abs, q_rope, pool_ckv, pool_krope,
                                 block_tables, pos, length=length,
                                 scale=scale, ckv_scale=ckv_scale,
                                 krope_scale=krope_scale)
    bt = block_tables.to(torch.int32).contiguous()
    pos = pos.to(torch.int32).contiguous()
    if ckv_scale is not None:
        return paged_mla_q8_kernel(q_abs, q_rope, pool_ckv, pool_krope,
                                   ckv_scale, krope_scale, bt, pos,
                                   length=length, scale=scale)
    return paged_mla_kernel(q_abs, q_rope, pool_ckv, pool_krope, bt, pos,
                            length=length, scale=scale)


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


def cost_model_mla(B, H, r, dr, *, live_tokens, page_size, dtype_bytes=2,
                   scale_bytes=0):
    """Analytic (flops, hbm_bytes) for one paged MLA decode call (the
    reference's own model): the live latent ROWS (ckv plus k_rope, whole
    pages) streamed once, q_abs, q_rope and out in bf16, the block-table
    entries; flops 2·B·H·T·(r + dr) for the scores and 2·B·H·T·r for the
    latent output.  ``scale_bytes=4`` adds the two per-page float32
    scales (ckv, krope) of int8 latent pools."""
    pages = -(-live_tokens // page_size)
    flops = 2 * B * H * live_tokens * (r + dr) + 2 * B * H * live_tokens * r
    kv = B * pages * page_size * (r + dr) * dtype_bytes
    sc = 2 * B * pages * scale_bytes
    qo = B * H * (r + dr) * 2 + B * H * r * 2
    bt = B * pages * 4
    return flops, kv + sc + qo + bt
