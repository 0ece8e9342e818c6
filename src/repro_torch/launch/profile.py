"""Where a training step's or a decode step's time goes on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile [--sass] \
        [--sections lm,qat,mamba,attn,paged,imc,ssm,scan,mla,block,flash,
                    paged_kernels]

Builds the kernels, then for a full-width ``minimalist-lm-360m`` step
(batch 8, seq 256; section ``lm``), a QAT step of the paper's network
(dims 1-64-64-64-64-10, T 784, batch 64, hardware phase; ``qat``), a
full-width ``falcon-mamba-7b`` step (8 of its 64 layers,
``ssm_impl="fused"``, batch 4, seq 2048; ``mamba``) and a full-width
``smollm-360m`` step through the flash kernels (batch 4, seq 2048;
``attn``), and a 4-slot paged decode step of full-width ``smollm-360m``
(section ``paged``):

  * the host-clock split of the step into forward + backward and
    ``AdamW.step``, each ending in ``torch.cuda.synchronize()``;
  * one ``torch.profiler`` window: device time summed over the CUDA
    kernels and copies alone, their count per step, the card's idle share
    of the profiled wall time, and the kernels with the most device time.

The ``imc`` section times kernels alone (graph replay, card name and
power limit first): ``imc_mvm`` at chip_smoke's kernel-row shapes on the
route ``ops.route`` picks and on the simt entry point, beside one fp32
and one bf16 ``torch.matmul`` (the bf16 one as a reference point only:
its output is bf16), ``minimalist_step`` at (8, 64 -> 64) and
(64, 1024 -> 1024) and the stream path's five-layer chain (paper dims,
8 slots), and the launch floor: one one-element PyTorch op.

The ``ssm`` section times the fused selective scan's kernels alone
(graph replay, card name and power limit first) at chip_smoke's two
shapes, (4, 2048, 8192, 16) and (3, 1000, 1000, 16) fp32:
``fused_ssm_fwd_kernel``, ``fused_ssm_bwd_kernel`` with the sums of its
partials, and those sums alone on tensors of the partials' shape.

The ``scan`` section times the linear-scan kernels alone (card name and
power limit first) in two L2 states, as chip_smoke's kernel phase does
(:func:`scan_readings`): L2-warm, 200 launches on the same inputs in
graph replay (the inputs stay in the 50 MB L2), and L2-cold, each launch
timed by its own CUDA events after 256 MB are written between launches
(outside the events); also each launch by its own events after a spin
kernel that touches no memory instead of the write, which separates the
events' own cost from the L2's.  Five rounds, the kernels in alternating
order with ``minimalist_step`` (8, 64 -> 64) as a neighbouring row, and
the SM clock (``nvidia-smi``) before and after each round; then the
forward at the training shape and at falcon-mamba's ``ssm_impl="xla"``
shape (1, 2048, 131072) fp32.

The ``paged`` section has no training split: for one ``decode_step_paged``
(4 slots at position 200, bf16 and then int8 pages) it prints the eager
time, the CUDA-graph-replay time (bf16: the int8 page write cannot be
captured) and one profiler window, then the paged
GQA kernels alone (graph replay) at chip_smoke's kernel-row shapes
(smollm-360m's, gemma3-4b's, and qwen3-moe-30b-a3b's, stablelm-12b's
and mistral-large-123b's 4-slot decode), then a ``-DPAGED_GQA_TRACE``
build's per-CTA timeline at the long and stablelm shapes.  The
``paged_kernels`` section times the kernels
alone at those shapes and nothing else; it calls only the package's
public entry points, so a copy of this file in an older checkout's
``repro_torch/launch/`` times that checkout's kernels in the same way.

The ``mla`` section times the paged MLA kernels alone (card name and
power limit first, then the tc route's registers, spills and resident
CTAs) at chip_smoke's three rows, the 4-slot deepseek-v3-671b decode
shape, an odd one and a 32 x 4096 long context, in both L2 states of the
``scan`` section and in five alternating rounds (:func:`mla_readings`);
then the device time of each kernel at the path shape split by CUDA
kernel (the tc route's split kernel and its combine,
:func:`mla_kernel_split`), then one 4-slot ``decode_step_paged`` of
full-width deepseek-v3-671b cut
to its 3 dense MLA layers at position 1055, from bf16 and int8 latent
pages: eager ms, graph replay (bf16) and one profiler window
(:func:`mla_decode_step`); last, with fp32 queries (the simt route) at
the path and odd rows, the kernel and the plain version each against an
fp64 evaluation (:func:`mla_f32_error`).  These call only the package's
public entry points, so copies of this file and ``mla_shapes.py`` in an
older checkout's ``repro_torch/launch/`` time that checkout's kernels.

The ``block`` section times ``minimalist_block_kernel`` alone (card name
and power limit first) at chip_smoke's six rows (``BLOCK_SHAPES``: the
system check's layers at T 98 and the paper's widths at 8 and 256
streams, T 784) on binary x, L2-warm and L2-cold as the ``scan`` section
reads them, in five alternating rounds with the SM clock around each
(:func:`block_readings`).  It calls only the public wrapper, so a copy
of this file in an older checkout's ``repro_torch/launch/`` times that
checkout's kernel.

The ``flash`` section times ``flash_fwd_kernel`` and
``flash_bwd_kernel`` alone (card name and power limit first) at
chip_smoke's flash kernel rows (``FLASH_ROW_SHAPES``, bf16: smollm-360m's
training shape, llava-next-34b's, stablelm-12b's and gemma3-4b's), three
rounds each, on whichever route ``ops.route`` picks, then
splits one forward and backward by kernel under the profiler at their
training layers' 4096 tokens (``FLASH_TRAIN_SHAPES``).  It calls only the
public wrappers, so a copy of this file in an older checkout's
``repro_torch/launch/`` times that checkout's kernels (before the tc
route reached head dims 160 and 256: the simt route).

With ``--sass``, also the order of global loads (LDG), stores (STG) and
FMAs in each scan and selective-scan kernel's SASS (``cuobjdump`` from the
CUDA toolkit): how many loads a thread keeps in flight per step.  Needs a
CUDA device.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import re
import subprocess
import time
from pathlib import Path

import torch

from repro_torch.common import resolve_device
from repro_torch.kernels import build
from repro_torch.launch.mla_shapes import MLA_SHAPES, mla_inputs


def _sync_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def profile_window(fn, iters, tag, top=8):
    """Run ``fn`` ``iters`` times under the profiler; print device time
    from the CUDA events only (kernels and copies), per iteration."""
    from torch.profiler import DeviceType, ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / iters
    by_name = collections.Counter()
    count = 0
    for e in prof.events():
        # device-side ranges of user annotations (Optimizer.step#...) span
        # kernels that are counted on their own
        if e.device_type == DeviceType.CUDA and not getattr(
                e, "is_user_annotation", False):
            by_name[e.name] += e.device_time_total / 1e3 / iters
            count += 1
    busy = sum(by_name.values())
    print(f"{tag}: profiled wall {wall_ms:.2f} ms/step, device busy "
          f"{busy:.2f} ms/step (card idle {1 - busy / wall_ms:.1%}), "
          f"{count / iters:.0f} kernels+copies/step", flush=True)
    for name, ms in by_name.most_common(top):
        print(f"  {ms:10.5f} ms/step  {name[:90]}")


def sass_order(name):
    """The sequence of LDG/STG/FFMA opcodes of each function in kernel
    ``name``'s library, as cuobjdump disassembles it, and the function's
    static count of its most frequent opcodes."""
    tool = str(Path(build.nvcc()).parent / "cuobjdump")
    out = subprocess.run([tool, "-sass", str(build.library_path(name))],
                         capture_output=True, text=True, check=True).stdout
    for func in re.split(r"\n\s*Function : ", out)[1:]:
        ops = re.findall(r"\*/\s+(?:@!?U?P\d+\s+)?(LDG|STG|FFMA)\S*", func)
        print(f"{name} {func.splitlines()[0][:70]}:\n  {' '.join(ops[:64])}")
        every = collections.Counter(re.findall(
            r"\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]+)", func))
        print("  static: " + ", ".join(f"{op} {k}" for op, k in
                                       every.most_common(12)))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--sections",
                    default="lm,qat,mamba,attn,paged,imc,ssm,scan,mla,block,"
                    "flash",
                    help="comma-separated subset of lm, qat, mamba, attn, "
                    "paged, imc, ssm, scan, mla, block, flash, "
                    "paged_kernels")
    args = ap.parse_args(argv)
    sections = set(args.sections.split(","))
    if not sections <= {"lm", "qat", "mamba", "attn", "paged", "imc",
                        "ssm", "scan", "mla", "block", "flash",
                        "paged_kernels"}:
        ap.error(f"unknown sections in {args.sections!r}")
    dev = resolve_device("cuda")
    build.build()
    if args.sass:
        for name in ("linear_scan", "linear_scan_bwd", "fused_ssm_fwd",
                     "fused_ssm_bwd"):
            sass_order(name)

    from repro_torch.configs import get_config
    if "lm" in sections:
        _lm(_train_step(dev, get_config("minimalist-lm-360m"), 8, 256))
    if "qat" in sections:
        _qat(dev)
    if "mamba" in sections:
        _big_step(_train_step(dev, dataclasses.replace(
            get_config("falcon-mamba-7b"), n_layers=8, ssm_impl="fused"),
            4, 2048), "falcon-mamba train step, 8 layers", "falcon-mamba")
    if "attn" in sections:
        _big_step(_train_step(dev, dataclasses.replace(
            get_config("smollm-360m"), attention_impl="flash"), 4, 2048),
            "smollm-360m flash train step (batch 4, seq 2048)",
            "smollm-360m flash")
    if "paged" in sections:
        _paged(dev, get_config("smollm-360m"))
    if "paged_kernels" in sections:
        print(f"paged_kernels on {_card()}", flush=True)
        _paged_kernels(dev)
    if "imc" in sections:
        _imc(dev)
    if "ssm" in sections:
        _ssm(dev)
    if "scan" in sections:
        print(f"scan on {_card()}", flush=True)
        scan_readings(dev)
    if "mla" in sections:
        _mla(dev)
    if "block" in sections:
        print(f"block on {_card()}", flush=True)
        block_readings(dev)
    if "flash" in sections:
        _flash(dev)


def _graph_ms(fn, iters):
    """Mean device time per call of ``fn``: ``iters`` calls captured in one
    CUDA graph and replayed (no host work between the kernels)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# (label, B, H, KV, hd, length, window, pos): chip_smoke's PAGED_ROWS and
# PAGED_MODEL_ROWS (qwen3-moe-30b-a3b's, stablelm-12b's and
# mistral-large-123b's 4-slot decode)
_PAGED_SHAPES = [
    ("path", 4, 15, 5, 64, 256, None, [255] * 4),
    ("long", 64, 15, 5, 64, 2048, None, [2047] * 64),
    ("gemma", 4, 8, 4, 256, 1024, 1024, [4095, 3000, 1500, 1023]),
    ("qwen3", 4, 32, 4, 128, 512, None, [511] * 4),
    ("stablelm", 4, 32, 8, 160, 544, None, [543] * 4),
    ("mistral", 4, 96, 8, 128, 544, None, [543] * 4),
]


def _paged(dev, config):
    """smollm-360m's paged decode step (4 slots, pos 200; bf16 then int8
    pages): eager and graph-replay ms, one profiler window (device busy
    time by kernel, idle share); then the paged GQA kernels alone at
    ``_PAGED_SHAPES`` and a traced build's per-CTA timeline at the long
    and stablelm shapes."""
    from repro_torch.models import build_model

    print(f"paged on {_card()}", flush=True)
    n_pages, ps = 64, 16
    for kv_dtype in ("bf16", "int8"):
        model = build_model(dataclasses.replace(config, kv_dtype=kv_dtype),
                            device=dev, generator=torch.Generator(
                                device=dev).manual_seed(0))
        state = model.init_paged_cache(n_pages, ps)
        tok = torch.zeros(4, 1, dtype=torch.int64, device=dev)
        pos = torch.full((4,), 200, dtype=torch.int32, device=dev)
        bt = torch.arange(n_pages, dtype=torch.int32,
                          device=dev).reshape(4, -1)
        act = torch.ones(4, dtype=torch.bool, device=dev)
        rows = torch.arange(4, device=dev)

        def step():
            model.decode_step_paged(tok, state, pos, bt, act, 256,
                                    rows=rows)
        with torch.inference_mode():
            for _ in range(3):
                step()
            eager = [_sync_ms(step) for _ in range(10)]
            # the int8 page write builds a host scalar per call, which a
            # CUDA graph cannot capture: its device time is the profiler's
            graph = (f"graph replay {_graph_ms(step, 10):.4f} ms"
                     if kv_dtype == "bf16" else "no graph replay")
            print(f"paged decode_step_paged {kv_dtype} pages (4 slots, pos "
                  f"200): eager ms {[round(t, 2) for t in eager]}, {graph}",
                  flush=True)
            profile_window(step, 5, f"paged {kv_dtype} decode step",
                           top=10)
        del model, state
        torch.cuda.empty_cache()
    _paged_kernels(dev, traced=True)


def _paged_kernels(dev, traced=False):
    """``paged_gqa_kernel`` and ``paged_gqa_q8_kernel`` alone (graph
    replay) at ``_PAGED_SHAPES``; with ``traced``, also the per-CTA
    timelines (:func:`_paged_timeline`).  Without it (section
    ``paged_kernels``) it calls only the public wrappers, so a copy of this
    file in an older checkout times that checkout's kernels."""
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.paged_attention import quant as kvq

    ps = 16
    g = torch.Generator(device=dev).manual_seed(0)
    for label, B, H, KV, hd, length, window, pos in _PAGED_SHAPES:
        n = -(-length // ps)
        num = 2 * B * n
        bt = torch.randperm(num, device=dev, generator=g)[:B * n].reshape(
            B, n).to(torch.int32)
        q = torch.randn(B, H, hd, device=dev, generator=g).to(torch.bfloat16)
        pk = torch.randn(num, ps, KV, hd, device=dev, generator=g)
        pv = torch.randn(num, ps, KV, hd, device=dev, generator=g)
        pos_t = torch.as_tensor(pos, dtype=torch.int32, device=dev)
        ks, vs = kvq.page_abs_scale(pk), kvq.page_abs_scale(pv)
        ck, cv = kvq.quantize(pk, ks), kvq.quantize(pv, vs)
        pk, pv = pk.to(torch.bfloat16), pv.to(torch.bfloat16)
        kw = dict(length=length, window=window)
        bf = _graph_ms(lambda: pa_ops.paged_gqa_kernel(
            q, pk, pv, bt, pos_t, **kw), 200)
        i8 = _graph_ms(lambda: pa_ops.paged_gqa_q8_kernel(
            q, ck, cv, ks, vs, bt, pos_t, **kw), 200)
        print(f"paged kernels {label} (B {B}, H {H}, KV {KV}, hd {hd}, "
              f"page {ps}, length {length}, window {window}): paged_gqa "
              f"{bf:.5f} ms, paged_gqa_q8 {i8:.5f} ms (graph replay)",
              flush=True)
        if traced and label in ("long", "stablelm"):
            _paged_timeline(pa_ops, "paged_gqa", label, q, pk, pv, (), bt,
                            pos_t, kw)
            _paged_timeline(pa_ops, "paged_gqa_q8", label, q, ck, cv,
                            (ks, vs), bt, pos_t, kw)
        del q, pk, pv, ck, cv, ks, vs, bt
        torch.cuda.empty_cache()


def _trace_lib(name):
    """Kernel source ``name`` built with ``-DPAGED_GQA_TRACE`` into a
    library of its own beside the package's, once a process."""
    import ctypes

    if name not in _TRACE_LIBS:
        out = build.BUILD_DIR / f"lib{name}-trace.so"
        subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-DPAGED_GQA_TRACE",
                        "-o", str(out), str(build.CSRC / f"{name}.cu")],
                       check=True, capture_output=True)
        lib = ctypes.CDLL(str(out))
        for fn, argtypes in build.SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.paged_gqa_trace_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
        _TRACE_LIBS[name] = lib
    return _TRACE_LIBS[name]


#: Traced builds of the paged GQA sources, by name.
_TRACE_LIBS = {}


def _paged_timeline(pa_ops, name, label, q, pk, pv, scales, bt, pos, kw):
    """One call of kernel source ``name`` built with ``PAGED_GQA_TRACE``
    (``csrc/paged_gqa.cuh``): each CTA's start, warp 0's first page in,
    warp 0's pages done and the merge done, from the SM's globaltimer."""
    import numpy as np

    lib = _trace_lib(name)
    for _ in range(3):      # the last call's timeline is read
        pa_ops.gqa_launch(lib, name, q, pk, pv, bt, pos, scales=scales, **kw)
    torch.cuda.synchronize()
    # the grid's CTAs: (n_split, KV x query-row tiles, B), the tiles as the
    # library's own rule chooses them
    B, H, hd = q.shape
    KV = pk.shape[2]
    n_split = pa_ops.gqa_splits(kw["length"], pk.shape[1])
    tile = pa_ops.gqa_device_layout(hd, pk.element_size(), H // KV)["tile"]
    tr = np.zeros((n_split * KV * -(-(H // KV) // tile) * B, 5),
                  dtype=np.uint64)
    build.check(lib.paged_gqa_trace_read(tr.ctypes.data, len(tr)), name)
    n = len(tr)
    t = (tr[:, :4] - tr[:, 0].min()).astype(np.float64) / 1e3   # us
    life = t[:, 3] - t[:, 0]
    span = t[:, 3].max()
    live = -(-int(pos.max()) // pk.shape[1])
    print(f"{name} {label} CTA timeline ({n} CTAs, {n_split} a cluster, "
          f"about "
          f"{live / n_split / pa_ops.GQA_WARPS:.0f} pages a warp; "
          f"globaltimer ticks 0.26 us here): span {span:.2f} us, life "
          f"median {np.median(life):.2f} us = start to first page "
          f"{np.median(t[:, 1] - t[:, 0]):.2f} + pages "
          f"{np.median(t[:, 2] - t[:, 1]):.2f} + merge "
          f"{np.median(t[:, 3] - t[:, 2]):.2f}; resident CTAs on average "
          f"{life.sum() / span:.1f} over {len(np.unique(tr[:, 4]))} SMs",
          flush=True)


def mla_readings(dev, rounds=5):
    """``paged_mla_kernel`` and ``paged_mla_q8_kernel`` at ``MLA_SHAPES``,
    each read ``rounds`` times L2-warm (graph replay) and L2-cold (each
    launch by its own events after 256 MB are written), the kernels and
    modes in alternating order, the SM clock before and after each round
    (the method of :func:`scan_readings`).  Prints every reading and
    returns {(kernel, label): {mode: (median, spread, readings)}}."""
    from repro_torch.kernels.paged_attention import ops as pa_ops

    g = torch.Generator(device=dev).manual_seed(0)
    scale = 1.0 / (128 + 64) ** 0.5
    rows = {}
    for label, B, H, length, pos in MLA_SHAPES:
        kw = dict(length=length, scale=scale)
        for q8 in (False, True):
            kern = (pa_ops.paged_mla_q8_kernel if q8
                    else pa_ops.paged_mla_kernel)
            qa, qr, pc, pr, sc, bt, pos_t = mla_inputs(dev, g, B, H, length,
                                                       pos, q8)
            rows[(kern.__name__.replace("_kernel", ""), label)] = (
                lambda kern=kern, a=(qa, qr, pc, pr, *sc, bt, pos_t), kw=kw:
                kern(*a, **kw))
    flush = torch.empty(256 * 2**20 // 4, device=dev)
    modes = {"warm": lambda fn: _graph_ms(fn, 50),
             "cold": lambda fn: _events_each_ms(fn, 30, flush)}
    got = {key: {m: [] for m in modes} for key in rows}
    for r in range(rounds):
        order = list(rows) if r % 2 == 0 else list(rows)[::-1]
        before = sm_clock()
        for key in order:
            for m in (modes if r % 2 == 0 else list(modes)[::-1]):
                got[key][m].append(modes[m](rows[key]))
        print(f"mla readings round {r + 1}: SM clock {before} before, "
              f"{sm_clock()} after", flush=True)
    out = {}
    for key in rows:
        out[key] = {}
        for m in modes:
            med, spread = _spread(got[key][m])
            out[key][m] = (med, spread, got[key][m])
            each = ", ".join(f"{v:.5f}" for v in got[key][m])
            print(f"  {key[0]} {key[1]} {m}: median {med:.5f} ms, spread "
                  f"{spread:.1%} ({each})", flush=True)
    del rows, flush
    torch.cuda.empty_cache()
    return out


def mla_kernel_split(dev, iters=50):
    """Device time by kernel of ``paged_mla_kernel`` and
    ``paged_mla_q8_kernel`` at the path shape (``MLA_SHAPES[0]``) under
    the profiler: the tc route's split kernel and its combine apart."""
    from repro_torch.kernels.paged_attention import ops as pa_ops

    g = torch.Generator(device=dev).manual_seed(0)
    _label, B, H, length, pos = MLA_SHAPES[0]
    kw = dict(length=length, scale=1.0 / (128 + 64) ** 0.5)
    for kern in (pa_ops.paged_mla_kernel, pa_ops.paged_mla_q8_kernel):
        a = mla_inputs(dev, g, B, H, length, pos,
                       kern is pa_ops.paged_mla_q8_kernel)
        args = a[:4] + a[4] + a[5:]
        for _ in range(3):
            kern(*args, **kw)
        profile_window(lambda: kern(*args, **kw), iters,
                       f"{kern.__name__.replace('_kernel', '')} path shape")


def mla_f32_error(dev):
    """fp32 queries (the simt route) at the path and odd rows of
    ``MLA_SHAPES`` with chip_smoke's inputs and softmax scale: the kernel
    and the plain version each against the same function evaluated in
    fp64 from the same fp32 operands, and the kernel against the plain
    version; max |error| and the outputs past 2e-6 of each."""
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.paged_attention import quant
    from repro_torch.kernels.paged_attention import ref as pa_ref

    g = torch.Generator(device=dev).manual_seed(0)
    scale = 1.0 / (128 + 64) ** 0.5
    scale32 = float(torch.tensor(scale, dtype=torch.float32))
    for label, B, H, length, pos in MLA_SHAPES[:2]:
        for q8 in (False, True):
            qa, qr, pc, pr, sc, bt, pos_t = mla_inputs(dev, g, B, H, length,
                                                       pos, q8)
            qa, qr = qa.float(), qr.float()
            if q8:
                kern = pa_ops.paged_mla_q8_kernel
                ck = quant.dequantize(pc, sc[0])
                kr = quant.dequantize(pr, sc[1])
            else:
                kern = pa_ops.paged_mla_kernel
                pc, pr = pc.float(), pr.float()
                ck, kr = pc, pr
            kw = dict(length=length, scale=scale)
            sk = dict(zip(("ckv_scale", "krope_scale"), sc))
            got = kern(qa, qr, pc, pr, *sc, bt, pos_t, **kw)
            plain = pa_ref.paged_mla_ref(qa, qr, pc, pr, bt, pos_t, **kw,
                                         **sk)
            c64 = pa_ref.gather_pages(ck, bt, length).double()
            r64 = pa_ref.gather_pages(kr, bt, length).double()
            s = (torch.einsum("bhr,blr->bhl", qa.double(), c64)
                 + torch.einsum("bhk,blk->bhl", qr.double(), r64)) * scale32
            _kp, valid = pa_ref.paged_positions(pos_t, length)
            s = s.masked_fill(~valid[:, None, :], float("-inf"))
            truth = torch.einsum("bhl,blr->bhr", torch.softmax(s, -1), c64)
            parts = []
            for what, a, b in (("kernel - fp64", got.double(), truth),
                               ("plain - fp64", plain.double(), truth),
                               ("kernel - plain", got, plain)):
                e = (a - b).abs()
                parts.append(f"|{what}| max {e.max().item():.4g}, "
                             f"{int((e > 2e-6).sum())} past 2e-6")
            print(f"mla fp32 {'int8' if q8 else 'bf16'} pages {label} (B {B}, "
                  f"H {H}, length {length}; {got.numel()} outputs, max |out| "
                  f"{truth.abs().max().item():.3g}): " + "; ".join(parts),
                  flush=True)


def _mla(dev):
    """The tc route's build info, then :func:`mla_readings`,
    :func:`mla_kernel_split`, :func:`mla_decode_step` and
    :func:`mla_f32_error`."""
    from repro_torch.kernels.paged_attention import ops as pa_ops

    print(f"mla on {_card()}", flush=True)
    for q8 in (False, True):
        print(f"mla tc route build, {'int8' if q8 else 'bf16'} pages: "
              f"{pa_ops.mla_kernel_info(q8)}", flush=True)
    mla_readings(dev)
    mla_kernel_split(dev)
    mla_decode_step(dev)
    mla_f32_error(dev)


def mla_decode_step(dev):
    """One 4-slot ``decode_step_paged`` of full-width deepseek-v3-671b cut
    to its 3 dense MLA layers at position 1055 from bf16 and int8 latent
    pages: eager ms, graph replay (bf16) and one profiler window."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    config = dataclasses.replace(get_config("deepseek-v3-671b"), n_layers=3)
    max_len, ps = 1056, 16
    n_chain = max_len // ps
    for kv_dtype in ("bf16", "int8"):
        model = build_model(dataclasses.replace(config, kv_dtype=kv_dtype),
                            device=dev, generator=torch.Generator(
                                device=dev).manual_seed(0))
        state = model.init_paged_cache(4 * n_chain + 36, ps)
        tok = torch.zeros(4, 1, dtype=torch.int64, device=dev)
        pos = torch.full((4,), max_len - 1, dtype=torch.int32, device=dev)
        bt = torch.arange(4 * n_chain, dtype=torch.int32,
                          device=dev).reshape(4, n_chain)
        act = torch.ones(4, dtype=torch.bool, device=dev)
        rows = torch.arange(4, device=dev)

        def step():
            model.decode_step_paged(tok, state, pos, bt, act, max_len,
                                    rows=rows)
        with torch.inference_mode():
            for _ in range(3):
                step()
            eager = [_sync_ms(step) for _ in range(10)]
            graph = (f"graph replay {_graph_ms(step, 10):.4f} ms"
                     if kv_dtype == "bf16" else "no graph replay")
            print(f"mla decode_step_paged {kv_dtype} pages (4 slots, pos "
                  f"{max_len - 1}): eager ms {[round(t, 2) for t in eager]}, "
                  f"{graph}", flush=True)
            profile_window(step, 5, f"mla {kv_dtype} decode step", top=10)
        del model, state
        torch.cuda.empty_cache()


def _card():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def _imc(dev):
    """imc_mvm (both routes) and minimalist_step alone in graph replay,
    beside their library calls and the launch floor."""
    from repro_torch.kernels.imc_mvm import ops as imc_ops
    from repro_torch.kernels.minimalist_block import ops as mb_ops

    print(f"imc on {_card()}", flush=True)
    one = torch.zeros(1, device=dev)
    print(f"launch floor (one one-element add_, graph replay) "
          f"{_graph_ms(lambda: one.add_(1.0), 500):.5f} ms", flush=True)
    g = torch.Generator(device=dev).manual_seed(0)
    for M, K, N in [(4096, 1024, 1024), (17, 70, 50), (5, 300, 129)]:
        x = (torch.rand(M, K, device=dev, generator=g) > 0.5).float()
        codes = torch.randint(0, 4, (K, N), device=dev, generator=g,
                              dtype=torch.int8)
        scale = torch.rand(N, device=dev, generator=g) * 0.3 + 0.01
        y = torch.empty(M, N, device=dev)
        lib = build.load("imc_mvm")

        def simt():
            build.check(lib.imc_mvm_f32(
                x.data_ptr(), codes.data_ptr(), scale.data_ptr(),
                y.data_ptr(), M, K, N,
                torch.cuda.current_stream().cuda_stream), "imc_mvm")
        ms = _graph_ms(lambda: imc_ops.imc_mvm_kernel(x, codes, scale), 50)
        simt_ms = _graph_ms(simt, 50)
        w = (codes.float() - 1.5) * scale
        wb, xb = w.bfloat16(), x.bfloat16()
        fp32 = _graph_ms(lambda: torch.matmul(x, w), 50)
        bf16 = _graph_ms(lambda: torch.matmul(xb, wb), 50)
        route = imc_ops.route(M, K, N, x.data_ptr(), codes.data_ptr())
        print(f"imc_mvm (M {M}, K {K}, N {N}): route {route} {ms:.5f} ms, "
              f"simt entry {simt_ms:.5f} ms; fp32 matmul {fp32:.5f} ms, "
              f"bf16 matmul {bf16:.5f} ms (graph replay)", flush=True)
    for B, K, N in [(8, 64, 64), (64, 1024, 1024)]:
        x, layer, hp = _step_inputs(dev, g, B, K, N)
        ms = _graph_ms(lambda: mb_ops.minimalist_step_kernel(x, *layer, hp),
                       500)
        ch, cz, scale = layer[:3]
        w = torch.cat([(ch.float() - 1.5) * scale,
                       (cz.float() - 1.5) * scale], dim=1)
        lib_ms = _graph_ms(lambda: torch.matmul(x, w), 500)
        print(f"minimalist_step ({B}, {K}->{N}): {ms:.5f} ms; one fp32 "
              f"matmul {lib_ms:.5f} ms (graph replay)", flush=True)
    # the stream path's chain of layers: dims 1-64-64-64-64-10, 8 slots
    dims = (1, 64, 64, 64, 64, 10)
    chain = [_step_inputs(dev, g, 8, K, N) for K, N in zip(dims[:-1],
                                                           dims[1:])]

    def frame():
        out = chain[0][0]
        for _x, layer, hp in chain:
            out = mb_ops.minimalist_step_kernel(out, *layer, hp)[0]
    print(f"minimalist_step chain (5 layers, 8 slots, one frame): "
          f"{_graph_ms(frame, 100):.5f} ms (graph replay)", flush=True)


def _ssm(dev):
    """The fused selective scan's kernels alone in graph replay at
    chip_smoke's two shapes; the backward's partial sums timed apart."""
    from repro_torch.kernels.fused_ssm import ops as ssm_ops

    print(f"ssm on {_card()}", flush=True)
    g = torch.Generator(device=dev).manual_seed(0)
    for B, T, di, n in [(4, 2048, 8192, 16), (3, 1000, 1000, 16)]:
        dt = torch.nn.functional.softplus(
            torch.randn(B, T, di, device=dev, generator=g)) * 0.2
        x = torch.randn(B, T, di, device=dev, generator=g)
        Bm = torch.randn(B, T, n, device=dev, generator=g) * 0.5
        Cm = torch.randn(B, T, n, device=dev, generator=g) * 0.5
        A = -torch.exp(torch.randn(di, n, device=dev, generator=g) * 0.3)
        dy = torch.randn(B, T, di, device=dev, generator=g)
        ins = (dt, x, Bm, Cm, A)
        _, ent = ssm_ops.fused_ssm_fwd_kernel(*ins)
        f_ms = _graph_ms(lambda: ssm_ops.fused_ssm_fwd_kernel(*ins), 10)
        b_ms = _graph_ms(
            lambda: ssm_ops.fused_ssm_bwd_kernel(*ins, ent, dy), 5)
        rows = ssm_ops.d_blocks(di, n)
        dBp, dCp = (torch.randn(B, rows, T, n, device=dev, generator=g)
                    for _ in range(2))
        dAp = torch.randn(B, di, n, device=dev, generator=g)
        sums_ms = _graph_ms(lambda: (dBp.sum(1), dCp.sum(1), dAp.sum(0)), 5)
        print(f"fused_ssm (B {B}, T {T}, d_inner {di}, d_state {n}) fp32: "
              f"fwd {f_ms:.5f} ms, bwd {b_ms:.5f} ms with its partial "
              f"sums, the sums alone {sums_ms:.5f} ms ({rows} partial rows "
              f"a batch row, {(dBp.numel() + dCp.numel()) * 4 / 1e6:.1f} "
              "MB) (graph replay)", flush=True)
        del dt, x, Bm, Cm, A, dy, ins, ent, dBp, dCp, dAp
        torch.cuda.empty_cache()


#: (B, H, KV, S, D, window) of the flash section: chip_smoke's flash
#: kernel rows at head dims 64 (the attn_train path) and 128 (llava-next-34b,
#: phase vlm), stablelm-12b's training shape (causal) and gemma3-4b's local
#: layers (window 1024), its d160 and d256 rows; then the layers of
#: chip_smoke's wide_head_train at its 4096 tokens (gemma3-4b's global
#: layer too)
FLASH_ROW_SHAPES = [(4, 15, 5, 2048, 64, None),
                    (2, 56, 8, 1088, 128, None),
                    (1, 32, 8, 1024, 160, None),
                    (1, 8, 4, 2048, 256, 1024)]
FLASH_TRAIN_SHAPES = [(1, 32, 8, 4096, 160, None),
                      (1, 8, 4, 4096, 256, 1024),
                      (1, 8, 4, 4096, 256, None)]


def _flash(dev):
    """flash_fwd and flash_bwd alone in graph replay at FLASH_ROW_SHAPES
    (causal, bf16), on the route ``ops.route`` picks, three rounds each;
    then one forward and backward at each of FLASH_TRAIN_SHAPES under the
    profiler, split by kernel.  Calls only the public wrappers, so a copy
    of this file in an older checkout's ``repro_torch/launch/`` times that
    checkout's kernels."""
    from repro_torch.kernels.flash_attention import ops as fa_ops

    print(f"flash on {_card()}", flush=True)
    g = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16
    for B, H, KV, S, D, window in FLASH_ROW_SHAPES + FLASH_TRAIN_SHAPES:
        q = (torch.randn(B, H, S, D, device=dev, generator=g) * 0.5).to(bf)
        k = (torch.randn(B, KV, S, D, device=dev, generator=g) * 0.5).to(bf)
        v = torch.randn(B, KV, S, D, device=dev, generator=g).to(bf)
        do = torch.randn(B, H, S, D, device=dev, generator=g).to(bf)
        out, lse = fa_ops.flash_fwd_kernel(q, k, v, True, window)
        tag = (f"flash (B {B}, H {H}, KV {KV}, S {S}, D {D}, causal, window "
               f"{window}) bf16, {fa_ops.route(bf, D)} route")

        def fwd():
            fa_ops.flash_fwd_kernel(q, k, v, True, window)

        def bwd():
            fa_ops.flash_bwd_kernel(q, k, v, out, lse, do, True, window)
        if (B, H, KV, S, D, window) in FLASH_ROW_SHAPES:
            times = [(_graph_ms(fwd, 20), _graph_ms(bwd, 10))
                     for _ in range(3)]
            print(f"{tag}: fwd {', '.join(f'{f:.5f}' for f, _ in times)} "
                  f"ms, bwd (dq + dkv) "
                  f"{', '.join(f'{b:.5f}' for _, b in times)} ms (graph "
                  "replay)", flush=True)
        else:
            bwd()
            profile_window(lambda: (fwd(), bwd()), 10,
                           f"{tag}, fwd + bwd", top=3)
        del q, k, v, do, out, lse
        torch.cuda.empty_cache()


def sm_clock():
    """The SM clock now, as ``nvidia-smi`` reads it (e.g. "1980 MHz")."""
    return subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def sm_clock_mhz():
    """The SM clock now in MHz, as :func:`sm_clock` reads it."""
    return float(sm_clock().split()[0])


def _events_each_ms(fn, iters, flush=None):
    """Each of ``iters`` launches of ``fn`` timed by its own CUDA events,
    the median in ms.  Before each launch, outside the events, either
    ``flush`` (a tensor larger than the L2) is written or, without one, a
    spin kernel of about 50 us that touches no memory runs: either keeps
    the card busier than the host takes to enqueue the next launch, so no
    host gap falls inside the events."""
    for _ in range(3):
        fn()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    torch.cuda.synchronize()
    for start, end in ev:
        if flush is not None:
            flush.zero_()
        else:
            torch.cuda._sleep(100_000)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    ms = sorted(s.elapsed_time(e) for s, e in ev)
    return ms[len(ms) // 2]


def _spread(xs):
    """The median of ``xs`` and their spread, (max - min) / median."""
    xs = sorted(xs)
    med = xs[len(xs) // 2]
    return med, (xs[-1] - xs[0]) / med


def scan_inputs(dev, g, shape, dtype):
    """a, b, h0, g_out as chip_smoke's scan rows make them."""
    z = torch.sigmoid(torch.randn(shape, device=dev, generator=g))
    a = (1.0 - z).to(dtype)
    b = (z * torch.randn(shape, device=dev, generator=g)).to(dtype)
    h0 = torch.randn(shape[0], shape[2], device=dev, generator=g).to(dtype)
    gout = torch.randn(shape, device=dev, generator=g).to(dtype)
    return a, b, h0, gout


def scan_readings(dev, rounds=5):
    """``linear_scan`` at the LM's prefill chunk (4, 256, 960) bf16 and
    ``linear_scan_bwd`` at the training shape (8, 256, 960) bf16, each
    read ``rounds`` times L2-warm (graph replay), per launch and L2-cold
    (see the module docstring), in alternating order with
    ``minimalist_step`` (8, 64 -> 64); the SM clock before and after each
    round.  Prints every reading and returns {kernel: {mode: (median,
    spread, readings)}} with ``"clocks"`` the SM clock readings."""
    from repro_torch.kernels.linear_scan import ops as scan_ops
    from repro_torch.kernels.minimalist_block import ops as mb_ops

    g = torch.Generator(device=dev).manual_seed(0)
    a, b, h0, _ = scan_inputs(dev, g, (4, 256, 960), torch.bfloat16)
    a2, b2, h02, g2 = scan_inputs(dev, g, (8, 256, 960), torch.bfloat16)
    h2 = scan_ops.linear_scan_kernel(a2, b2, h02)
    x, layer, hp = _step_inputs(dev, g, 8, 64, 64)
    rows = {
        "linear_scan": lambda: scan_ops.linear_scan_kernel(a, b, h0),
        "linear_scan_bwd": lambda: scan_ops.linear_scan_bwd_kernel(
            a2, h2, h02, g2),
        "minimalist_step": lambda: mb_ops.minimalist_step_kernel(
            x, *layer, hp),
    }
    flush = torch.empty(256 * 2**20 // 4, device=dev)
    modes = {"warm": lambda fn: _graph_ms(fn, 200),
             "each": lambda fn: _events_each_ms(fn, 50),
             "cold": lambda fn: _events_each_ms(fn, 50, flush)}
    got = {name: {m: [] for m in modes} for name in rows}
    clocks = []
    for r in range(rounds):
        order = list(rows) if r % 2 == 0 else list(rows)[::-1]
        clocks.append(sm_clock())
        for name in order:
            for m in (modes if r % 2 == 0 else list(modes)[::-1]):
                got[name][m].append(modes[m](rows[name]))
        clocks.append(sm_clock())
        print(f"scan readings round {r + 1} ({' '.join(order)}): SM clock "
              f"{clocks[-2]} before, {clocks[-1]} after", flush=True)
    out = {"clocks": clocks}
    for name in rows:
        out[name] = {}
        for m in modes:
            med, spread = _spread(got[name][m])
            out[name][m] = (med, spread, got[name][m])
            each = ", ".join(f"{v:.5f}" for v in got[name][m])
            print(f"  {name} {m:4s}: median {med:.5f} ms, spread "
                  f"{spread:.1%} ({each})", flush=True)
    del flush, a, b, h0, a2, b2, h02, g2, h2
    # the forward at the training shape and at falcon-mamba's xla shape
    for shape, dtype in [((8, 256, 960), torch.bfloat16),
                         ((1, 2048, 131072), torch.float32)]:
        a, b, h0, _ = scan_inputs(dev, g, shape, dtype)

        def fn():
            scan_ops.linear_scan_kernel(a, b, h0)
        flush = torch.empty(256 * 2**20 // 4, device=dev)
        n = 200 if shape[2] < 10**4 else 20
        warm, cold = _graph_ms(fn, n), _events_each_ms(fn, 20, flush)
        print(f"  linear_scan {shape} {str(dtype)[6:]}: warm {warm:.5f} ms, "
              f"cold {cold:.5f} ms", flush=True)
        out[f"linear_scan {shape}"] = {"warm": warm, "cold": cold}
        del a, b, h0, flush
        torch.cuda.empty_cache()
    return out


# (B, T, K, N) of chip_smoke's minimalist_block rows: the system check's
# layer (32 streams, T 98, 48 -> 48), the paper's widths at 8 and 256
# streams (T 784, 64 -> 64), a small batch, and the system check's first
# layer (K 1) and readout (N 10)
BLOCK_SHAPES = [(32, 98, 48, 48), (8, 784, 64, 64), (256, 784, 64, 64),
                (4, 98, 48, 48), (32, 98, 1, 48), (32, 98, 48, 10)]


def _block_inputs(dev, g, B, T, K, N):
    """Binary x and one layer's codes and biases, h0 zero, as chip_smoke's
    minimalist_block rows make them: (x, codes_h, codes_z, scale, bh, bz,
    h0)."""
    x = (torch.rand(B, T, K, device=dev, generator=g) > 0.5).float()
    ch, cz = (torch.randint(0, 4, (K, N), device=dev, generator=g,
                            dtype=torch.int8) for _ in range(2))
    bh, bz = (torch.randn(N, device=dev, generator=g) * 0.5
              for _ in range(2))
    return x, ch, cz, 0.11, bh, bz, torch.zeros(B, N, device=dev)


def block_readings(dev, rounds=5):
    """``minimalist_block_kernel`` at ``BLOCK_SHAPES`` on binary x, each
    read ``rounds`` times L2-warm (graph replay) and L2-cold (each launch
    by its own events after 256 MB are written), the shapes and modes in
    alternating order, the SM clock before and after each round (the
    method of :func:`scan_readings`).  Calls only the public wrapper, so a
    copy of this file in an older checkout reads that checkout's kernel.
    Prints every reading and returns {shape: {mode: (median, spread,
    readings)}}."""
    from repro_torch.kernels.minimalist_block import ops as mb_ops

    g = torch.Generator(device=dev).manual_seed(0)
    rows = {}
    for B, T, K, N in BLOCK_SHAPES:
        rows[(B, T, K, N)] = (
            lambda a=_block_inputs(dev, g, B, T, K, N):
            mb_ops.minimalist_block_kernel(*a))
    flush = torch.empty(256 * 2**20 // 4, device=dev)
    modes = {"warm": lambda fn: _graph_ms(fn, 50),
             "cold": lambda fn: _events_each_ms(fn, 30, flush)}
    got = {key: {m: [] for m in modes} for key in rows}
    for r in range(rounds):
        order = list(rows) if r % 2 == 0 else list(rows)[::-1]
        before = sm_clock()
        for key in order:
            for m in (modes if r % 2 == 0 else list(modes)[::-1]):
                got[key][m].append(modes[m](rows[key]))
        print(f"block readings round {r + 1}: SM clock {before} before, "
              f"{sm_clock()} after", flush=True)
    out = {}
    for key in rows:
        out[key] = {}
        for m in modes:
            med, spread = _spread(got[key][m])
            out[key][m] = (med, spread, got[key][m])
            each = ", ".join(f"{v:.5f}" for v in got[key][m])
            print(f"  minimalist_block {key} {m}: median {med:.5f} ms, "
                  f"spread {spread:.1%} ({each})", flush=True)
    del rows, flush
    torch.cuda.empty_cache()
    return out


def _step_inputs(dev, g, B, K, N):
    """Binary x (B, K), one layer's (codes_h, codes_z, scale, bh, bz) and
    h_prev (B, N), as chip_smoke's minimalist_step rows make them."""
    x = (torch.rand(B, K, device=dev, generator=g) > 0.5).float()
    ch = torch.randint(0, 4, (K, N), device=dev, generator=g,
                       dtype=torch.int8)
    cz = torch.randint(0, 4, (K, N), device=dev, generator=g,
                       dtype=torch.int8)
    bh = torch.randn(N, device=dev, generator=g) * 0.5
    bz = torch.randn(N, device=dev, generator=g) * 0.5
    hp = torch.randn(B, N, device=dev, generator=g)
    return x, (ch, cz, 0.11 if K == 64 else 0.11 / 16, bh, bz), hp


def _train_step(dev, config, batch_size, seq):
    """A model of ``config`` from seed 0, its AdamW and one batch; returns
    (model, opt, the forward+backward closure over them)."""
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW, param_groups

    model = build_model(config, device=dev, generator=torch.Generator(
        device=dev).manual_seed(0))
    opt = AdamW(param_groups(model), lr=3e-4)
    batch = {k: torch.from_numpy(v).to(dev, torch.int64) for k, v in
             SyntheticLMDataset(vocab=config.vocab, seq_len=seq).sample(
                 batch_size, 0).items()}

    def fwd_bwd():
        opt.zero_grad(set_to_none=True)
        model.loss(batch)[0].backward()
    return model, opt, fwd_bwd


def _lm(parts):
    model, opt, fwd_bwd = parts
    for _ in range(3):
        fwd_bwd()
        opt.step()
    split = [(_sync_ms(fwd_bwd), _sync_ms(opt.step)) for _ in range(5)]
    print("lm train step (host clock): forward+backward ms "
          f"{[round(a, 1) for a, _ in split]}, AdamW.step ms "
          f"{[round(b, 1) for _, b in split]}", flush=True)
    profile_window(fwd_bwd, 2, "lm forward+backward")
    profile_window(opt.step, 2, "lm AdamW.step", top=4)
    del model, opt, fwd_bwd, parts
    torch.cuda.empty_cache()


def _qat(dev):
    from repro_torch.configs import MINIMALIST_SMNIST_DIMS
    from repro_torch.core.mingru import MinimalistNetwork
    from repro_torch.core.quant import QuantConfig
    from repro_torch.optim import AdamW
    from repro_torch.train.qat import qat_loss

    net = MinimalistNetwork(MINIMALIST_SMNIST_DIMS,
                            qcfg=QuantConfig.hardware(), device=dev)
    net.reset_parameters(torch.Generator(device=dev).manual_seed(2))
    qopt = AdamW(net.parameters(), lr=1e-3, weight_decay=0.0)
    g = torch.Generator(device=dev).manual_seed(0)
    xb = torch.rand(64, 784, 1, device=dev, generator=g)
    yb = torch.randint(0, 10, (64,), device=dev, generator=g)

    def qat_step():
        qopt.zero_grad(set_to_none=True)
        qat_loss(net, xb, yb).backward()
        qopt.step()

    for _ in range(3):
        qat_step()
    print(f"qat step (host clock): "
          f"{[round(_sync_ms(qat_step), 1) for _ in range(5)]} ms",
          flush=True)
    profile_window(qat_step, 5, "qat step (paper dims, T 784)")
    del net, qopt
    torch.cuda.empty_cache()


def _big_step(parts, title, tag):
    """A batch 4 x 2048 step: host-clock split, then one profiler window
    each for forward+backward and AdamW.step."""
    model, opt, fwd_bwd = parts
    for _ in range(2):
        fwd_bwd()
        opt.step()
    split = [(_sync_ms(fwd_bwd), _sync_ms(opt.step)) for _ in range(3)]
    print(f"{title} (host clock): forward+backward "
          f"ms {[round(a, 1) for a, _ in split]}, AdamW.step ms "
          f"{[round(b, 1) for _, b in split]}", flush=True)
    profile_window(fwd_bwd, 1, f"{tag} forward+backward", top=12)
    profile_window(opt.step, 1, f"{tag} AdamW.step", top=4)
    del model, opt, fwd_bwd, parts
    torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
