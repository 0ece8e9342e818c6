#!/usr/bin/env python3
"""Start the PyTorch port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:

  1. build   — compile every CUDA kernel of the port from the sources in
               this checkout (one nvcc per source, all at once).
  2. kernels — call each kernel's wrapper on the card at the main path's
               shapes and hold it against its plain PyTorch version;
               time kernel, plain version and (where one exists) one
               PyTorch library call computing the same function.
  3. lm      — serve full-width minimalist-lm-360m (random weights from a
               seed) through ServeEngine: 8 greedy requests, 4 slots,
               prefill through the linear_scan kernel; then the same
               requests with the plain scan, greedy tokens compared.
  4. stream  — stream 8 sMNIST-length frame sequences through the paper's
               hardware network with the fused minimalist_step kernel,
               compared with the unfused network step.

Kernel launch counts are zeroed just before each serving phase and read
just after it.  The second-to-last stdout line is the card's name and
power limit; the last is {"ok": true, "device": {...}}.  Exits non-zero
without a result when CUDA is unavailable or the port is not next to
this script.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM published peaks (dense): HBM3 rate and fp32 non-tensor rate
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def bound(bytes_, flops):
    """(least time in ms, what bounds it) for moving ``bytes_`` once and
    doing ``flops`` fp32 operations on the card."""
    t_mem, t_ops = bytes_ / PEAK_BYTES_PER_S, flops / PEAK_FP32_FLOPS
    return max(t_mem, t_ops) * 1e3, ("bytes" if t_mem >= t_ops
                                     else "operations")


def _events_ms(torch, run, iters):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def eager_ms(torch, fn, iters):
    """Mean time per call of ``fn`` called back to back from Python (CUDA
    events, after warm-up): device time plus whatever the host adds when
    it cannot enqueue as fast as the card runs."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(iters):
            fn()
    return _events_ms(torch, run, iters)


def device_ms(torch, fn, iters):
    """Mean device time per call of ``fn``: ``iters`` calls captured in one
    CUDA graph and replayed, so no host work sits between the kernels."""
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
    torch.cuda.synchronize()
    ms = _events_ms(torch, graph.replay, iters)
    del graph
    return ms


def phase_kernels(torch, dev):
    """Each kernel against its plain version at the main path's shapes."""
    from repro_torch.core import quant
    from repro_torch.kernels.linear_scan import ops as scan_ops
    from repro_torch.kernels.linear_scan import ref as scan_ref
    from repro_torch.kernels.minimalist_block import ops as mb_ops
    from repro_torch.kernels.minimalist_block import ref as mb_ref

    g = torch.Generator(device=dev).manual_seed(0)
    rows = {}

    # -- linear_scan: minGRU prefill chunk (wave 4, chunk 256, d 960) ----
    shapes = [((4, 256, 960), torch.bfloat16, 2e-2),
              ((4, 256, 960), torch.float32, 1e-5),
              ((3, 77, 1000), torch.float32, 1e-5),
              ((3, 77, 1000), torch.bfloat16, 2e-2)]
    for shape, dtype, tol in shapes:
        B, T, D = shape
        z = torch.sigmoid(torch.randn(shape, device=dev, generator=g))
        a = (1.0 - z).to(dtype)
        b = (z * torch.randn(shape, device=dev, generator=g)).to(dtype)
        h0 = torch.randn(B, D, device=dev, generator=g).to(dtype)
        got = scan_ops.linear_scan_kernel(a, b, h0)
        want = scan_ref.linear_scan_associative(a, b, h0)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        tag = f"linear_scan {shape} {str(dtype)[6:]}"
        if not err <= tol:
            fail(f"{tag}: max |kernel - plain| = {err} > {tol}")
        ms = device_ms(torch, lambda: scan_ops.linear_scan_kernel(a, b, h0),
                       200)
        call_ms = eager_ms(
            torch, lambda: scan_ops.linear_scan_kernel(a, b, h0), 200)
        plain_ms = device_ms(
            torch, lambda: scan_ref.linear_scan_associative(a, b, h0), 20)
        elt = a.element_size()
        b_ms, by = bound((3 * B * T * D + B * D) * elt, 2 * B * T * D)
        print(f"kernel {tag}: max_abs_err {err:.3g} (tol {tol}) "
              f"kernel {ms:.4f} ms (eager call {call_ms:.4f} ms), plain "
              f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({by})", flush=True)
        if shape == (4, 256, 960) and dtype == torch.bfloat16:
            rows["linear_scan"] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=by, library_ms=None)

    # -- minimalist_step: paper width (8 slots, 64 -> 64), and wide ------
    for B, K, N in [(8, 64, 64), (64, 1024, 1024)]:
        x = (torch.rand(B, K, device=dev, generator=g) > 0.5).float()
        ch = torch.randint(0, 4, (K, N), device=dev, generator=g,
                           dtype=torch.int8)
        cz = torch.randint(0, 4, (K, N), device=dev, generator=g,
                           dtype=torch.int8)
        bh = torch.randn(N, device=dev, generator=g) * 0.5
        bz = torch.randn(N, device=dev, generator=g) * 0.5
        hp = torch.randn(B, N, device=dev, generator=g)
        scale = 0.11 if K == 64 else 0.11 / 16
        y, h, zc = mb_ops.minimalist_step_kernel(x, ch, cz, scale, bh, bz,
                                                 hp, return_z_codes=True)
        yp, hpl, zcp = mb_ref.minimalist_step_ref(x, ch, cz, scale, bh, bz,
                                                  hp, return_z_codes=True)
        torch.cuda.synchronize()
        # rounding contract: z codes equal wherever the plain gate value
        # (pre_z/6 + 1/2)*63 is more than 1e-3 from an integer
        pre_z = (x @ (cz.float() - 1.5)) * scale + bz
        v = quant.hard_sigmoid(pre_z) * quant.GATE_UNITS
        near = (v - torch.round(v)).abs() <= 1e-3
        bad_z = (zc != zcp) & ~near
        if bad_z.any():
            fail(f"minimalist_step ({B},{K}->{N}): {int(bad_z.sum())} z "
                 "codes differ away from a rounding tie")
        same = zc == zcp
        err = (h - hpl).abs()[same].max().item()
        if not err <= 2e-5:
            fail(f"minimalist_step ({B},{K}->{N}): max |h - plain| = {err}")
        flips = (y != yp) & (hpl.abs() > 1e-4)
        if flips.any():
            fail(f"minimalist_step ({B},{K}->{N}): y flips away from h=0")
        def kernel():
            mb_ops.minimalist_step_kernel(x, ch, cz, scale, bh, bz, hp)
        ms = device_ms(torch, kernel, 200)
        call_ms = eager_ms(torch, kernel, 200)
        plain_ms = device_ms(torch, lambda: mb_ref.minimalist_step_ref(
            x, ch, cz, scale, bh, bz, hp), 50)
        # yardstick the port never calls: both dequantised projections as
        # one fp32 matmul
        w_cat = torch.cat([(ch.float() - 1.5) * scale,
                           (cz.float() - 1.5) * scale], dim=1)
        library_ms = device_ms(torch, lambda: torch.matmul(x, w_cat), 200)
        bytes_ = (B * K * 4 + 2 * K * N + 2 * N * 4 + B * N * 4
                  + 2 * B * N * 4)
        b_ms, by = bound(bytes_, 4 * B * K * N + 8 * B * N)
        print(f"kernel minimalist_step ({B}, {K}->{N}) fp32: "
              f"max_abs_err {err:.3g} (tol 2e-05; {int(near.sum())} gate "
              f"values within 1e-3 of a code step, {int((~same).sum())} z "
              "codes differ there) "
              f"kernel {ms:.4f} ms (eager call {call_ms:.4f} ms), plain "
              f"{plain_ms:.4f} ms, library (one fp32 matmul) "
              f"{library_ms:.4f} ms, "
              f"bound {b_ms:.5f} ms ({by})", flush=True)
        if (B, K, N) == (8, 64, 64):
            rows["minimalist_step"] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=by, library_ms=library_ms)
    return rows


def _serve_lm(torch, model, requests, gen_tokens):
    from repro_torch.serve import DecoderStepModel, ServeEngine, Telemetry
    sm = DecoderStepModel(model, max_len=512, prefill_chunk=256)
    # host-side metrics only (prefill and decode-step wall times, each
    # ending in a device sync); no trace
    eng = ServeEngine(sm, slots=4, telemetry=Telemetry())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = [eng.submit(p, max_new_tokens=gen_tokens) for p in requests]
    eng.run()
    torch.cuda.synchronize()
    return sm, eng, reqs, time.perf_counter() - t0


def phase_lm(torch, dev):
    """Full-width minimalist-lm-360m through the serving engine."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels.linear_scan.ops import linear_scan_kernel
    from repro_torch.models import build_model

    cfg = get_config("minimalist-lm-360m")
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    print(f"lm: {cfg.name} ({sum(p.numel() for p in model.parameters())} "
          f"params, {cfg.n_layers} layers, d {cfg.d_model}) built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    rng = np.random.default_rng(0)
    # the first admission wave is four 192-token prompts (one (4, 256, 960)
    # chunk); the next four admit as singleton waves of mixed lengths
    plens = [192, 192, 192, 192, 64, 96, 128, 160]
    prompts = [rng.integers(0, cfg.vocab, size=p) for p in plens]
    gen_tokens = 32
    _serve_lm(torch, model, prompts, 2)              # warm-up (cuBLAS etc.)

    torch.cuda.reset_peak_memory_stats(dev)
    linear_scan_kernel.launches = 0
    sm, eng, reqs, dt = _serve_lm(torch, model, prompts, gen_tokens)
    launches = linear_scan_kernel.launches
    chunks = sm.n_prefill_chunks
    peak_gb = torch.cuda.max_memory_allocated(dev) / 2**30
    for r in reqs:
        toks = r.tokens
        if not r.finished or len(toks) != gen_tokens:
            fail(f"lm: request {r.uid} finished={r.finished} with "
                 f"{len(toks)} tokens")
        if not ((toks >= 0) & (toks < cfg.vocab)).all():
            fail(f"lm: request {r.uid} emitted a token outside the vocab")
    if launches == 0 or launches != cfg.n_layers * chunks:
        fail(f"lm: linear_scan launches {launches} != {cfg.n_layers} layers "
             f"x {chunks} prefill chunks")
    ttft = sorted((r.first_token_t - r.created_t) * 1e3 for r in reqs)
    n_gen = sum(len(r.tokens) for r in reqs)
    hist = eng.telemetry.registry.histograms
    pre, stp = hist["prefill_ms"], hist["step_ms"].summary()
    print(f"lm: {len(reqs)} requests, {n_gen} tokens in {dt:.3f} s "
          f"({n_gen / dt:.1f} generated tok/s incl. prefill), TTFT p50 "
          f"{ttft[len(ttft) // 2]:.1f} ms max {ttft[-1]:.1f} ms, "
          f"peak memory {peak_gb:.2f} GiB, linear_scan launches {launches} "
          f"= {cfg.n_layers} x {chunks} chunks", flush=True)
    print(f"lm: time split: {pre.n_total} prefill waves {sum(pre.values):.1f}"
          f" ms in all; {stp['count']} decode steps p50 {stp['p50']:.2f} ms "
          f"max {stp['max']:.2f} ms ({stp['count'] * stp['p50']:.1f} ms at "
          "p50)", flush=True)
    # one 4-slot decode step: called eagerly vs its kernels replayed from a
    # CUDA graph; the difference is time the card waits for the host
    tok = torch.zeros(4, 1, dtype=torch.int64, device=dev)
    cache = model.init_cache(4)
    with torch.inference_mode():
        step_eager = eager_ms(torch, lambda: model.decode_step(tok, cache), 10)
        step_dev = device_ms(torch, lambda: model.decode_step(tok, cache), 10)
    print(f"lm: decode_step (4 slots): eager {step_eager:.2f} ms, device "
          f"{step_dev:.2f} ms -> card idle {1 - step_dev / step_eager:.1%} "
          "of an eager step", flush=True)

    # the same requests with the plain scan on the card
    plain = build_model(dataclasses.replace(cfg, scan_backend="assoc"),
                        device=dev)
    plain.load_state_dict(model.state_dict())
    psm, _peng, preqs, _pdt = _serve_lm(torch, plain, prompts, gen_tokens)
    n_div = 0
    for r, pr in zip(reqs, preqs):
        a, b = r.tokens, pr.tokens
        diff = np.flatnonzero(a != b)
        if not len(diff):
            continue
        i = int(diff[0])
        n_div += 1
        # the plain model's top-2 margin where the streams part
        ctx = np.concatenate([r.prompt, a[:i]]).astype(np.int64)
        last, _ = psm.prefill(ctx[None, :])
        top2 = torch.topk(last[0, :cfg.vocab].float(), 2).values
        margin = (top2[0] - top2[1]).item()
        if margin > 0.1:
            fail(f"lm: request {r.uid} diverges from the plain scan at "
                 f"token {i} where the top-2 margin is {margin:.3f} > 0.1")
        print(f"lm: request {r.uid} parts from the plain-scan stream at "
              f"token {i} (plain top-2 margin {margin:.4f} <= 0.1)")
    print(f"lm: greedy tokens match the plain scan's in "
          f"{len(reqs) - n_div}/{len(reqs)} requests end to end", flush=True)
    del plain
    return launches


def phase_stream(torch, dev):
    """The paper's hardware network streaming through the fused kernel."""
    import numpy as np

    from repro_torch.configs import MINIMALIST_SMNIST_DIMS
    from repro_torch.core.mingru import MinimalistNetwork
    from repro_torch.core.quant import QuantConfig
    from repro_torch.kernels.minimalist_block.ops import (
        minimalist_step_kernel)
    from repro_torch.serve import MinimalistStepModel, ServeEngine

    net = MinimalistNetwork(MINIMALIST_SMNIST_DIMS,
                            qcfg=QuantConfig.hardware(), device=dev)
    net.reset_parameters(torch.Generator(device=dev).manual_seed(1))
    rng = np.random.default_rng(1)
    # 8 binarized pixel streams of sMNIST length (784 frames, 1 input)
    streams = [(rng.random((784, 1)) < 0.3).astype(np.float32)
               for _ in range(8)]

    def serve(fused):
        eng = ServeEngine(MinimalistStepModel(net, use_fused_kernel=fused),
                          slots=8)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reqs = [eng.submit(s) for s in streams]
        eng.run()
        torch.cuda.synchronize()
        return reqs, time.perf_counter() - t0

    serve(True)                                      # warm-up
    minimalist_step_kernel.launches = 0
    fused, dt = serve(True)
    launches = minimalist_step_kernel.launches
    if launches == 0:
        fail("stream: the fused path never launched minimalist_step")
    unfused, udt = serve(False)
    worst = 0.0
    for r, u in zip(fused, unfused):
        a, b = r.tokens, u.tokens
        if a.shape != (784, MINIMALIST_SMNIST_DIMS[-1]) or a.shape != b.shape:
            fail(f"stream: request {r.uid} output shape {a.shape} / "
                 f"{b.shape}")
        if not np.isfinite(a).all():
            fail(f"stream: request {r.uid} emitted non-finite outputs")
        worst = max(worst, float(np.abs(a - b).max()))
    if not worst <= 2e-5:
        fail(f"stream: fused outputs differ from the unfused step by "
             f"{worst} > 2e-5")
    frames = 8 * 784
    print(f"stream: 8 x 784 frames, fused {frames / dt:.0f} frames/s "
          f"({dt:.3f} s), unfused {frames / udt:.0f} frames/s "
          f"({udt:.3f} s), max |fused - unfused| {worst:.3g} (tol 2e-05), "
          f"minimalist_step launches {launches}", flush=True)
    return launches


def main():
    if not (SRC / "repro_torch").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run from a checkout")
    sys.path.insert(0, str(SRC))
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    from repro_torch.common import resolve_device
    from repro_torch.kernels import build

    dev = resolve_device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    logs = build.build(build.KERNELS, ptxas_verbose=True)
    print(f"build: {', '.join(build.KERNELS)} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    rows = phase_kernels(torch, dev)
    launches = {"linear_scan": phase_lm(torch, dev),
                "minimalist_step": phase_stream(torch, dev)}

    meta = {
        "linear_scan": ("src/repro_torch/kernels/csrc/linear_scan.cu",
                        "src/repro/kernels/linear_scan/linear_scan.py:54"),
        "minimalist_step": (
            "src/repro_torch/kernels/csrc/minimalist_step.cu",
            "src/repro/kernels/minimalist_block/minimalist_block.py:84"),
    }
    kernels = []
    for name in build.KERNELS:
        source, replaces = meta[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        **rows[name]})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
