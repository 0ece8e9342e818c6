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
  5. train   — train full-width minimalist-lm-360m for 30 steps through
               Trainer (batch 8, seq 256): loss falls, no restores, every
               layer's scan runs the forward and adjoint kernels once per
               step; then 3 steps from the same seed with the plain scan,
               losses and grad norms compared.
  6. system  — the paper's flow of tests/test_system.py on the card: the
               4-phase QAT ladder on the sMNIST surrogate, export to the
               switched-capacitor circuit, circuit agreement with and
               without 1 % mismatch, and the trained network's layers
               replayed through the fused minimalist_block kernel; then
               QAT steps/s at the paper's dims.

Kernel launch counts are zeroed just before each main-path phase and read
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
    # -- linear_scan_bwd: LM training (batch 8, seq 256, d 960) ----------
    for shape, dtype, tol in [((8, 256, 960), torch.bfloat16, 2e-2),
                              ((8, 256, 960), torch.float32, 1e-5),
                              ((3, 77, 1000), torch.float32, 1e-5),
                              ((3, 77, 1000), torch.bfloat16, 2e-2)]:
        B, T, D = shape
        z = torch.sigmoid(torch.randn(shape, device=dev, generator=g))
        a = (1.0 - z).to(dtype)
        b = (z * torch.randn(shape, device=dev, generator=g)).to(dtype)
        h0 = torch.randn(B, D, device=dev, generator=g).to(dtype)
        gout = torch.randn(shape, device=dev, generator=g).to(dtype)
        h = scan_ref.linear_scan_associative(a, b, h0)
        got = scan_ops.linear_scan_bwd_kernel(a, h, h0, gout)
        want = scan_ref.linear_scan_bwd(a, h, h0, gout)
        torch.cuda.synchronize()
        err = max((x.float() - y.float()).abs().max().item()
                  for x, y in zip(got, want))
        tag = f"linear_scan_bwd {shape} {str(dtype)[6:]}"
        if not err <= tol:
            fail(f"{tag}: max |kernel - plain| = {err} > {tol}")

        def kernel():
            scan_ops.linear_scan_bwd_kernel(a, h, h0, gout)
        ms = device_ms(torch, kernel, 200)
        call_ms = eager_ms(torch, kernel, 200)
        plain_ms = device_ms(
            torch, lambda: scan_ref.linear_scan_bwd(a, h, h0, gout), 20)
        elt = a.element_size()
        # reads a, g, h, h0 once, writes da, db, dh0 once; 3 flops/element
        b_ms, by = bound((5 * B * T * D + 2 * B * D) * elt, 3 * B * T * D)
        print(f"kernel {tag}: max_abs_err {err:.3g} (tol {tol}) "
              f"kernel {ms:.4f} ms (eager call {call_ms:.4f} ms), plain "
              f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({by})", flush=True)
        if shape == (8, 256, 960) and dtype == torch.bfloat16:
            rows["linear_scan_bwd"] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=by, library_ms=None)

    # -- minimalist_block: the system check's layer shape (32 streams,
    #    98 frames, 48 -> 48), the paper's (8, 784, 64 -> 64) and a small
    #    batch; bit for bit against the plain version -------------------
    for B, T, K, N in [(32, 98, 48, 48), (8, 784, 64, 64), (4, 98, 48, 48)]:
        x = (torch.rand(B, T, K, device=dev, generator=g) > 0.5).float()
        ch = torch.randint(0, 4, (K, N), device=dev, generator=g,
                           dtype=torch.int8)
        cz = torch.randint(0, 4, (K, N), device=dev, generator=g,
                           dtype=torch.int8)
        bh = torch.randn(N, device=dev, generator=g) * 0.5
        bz = torch.randn(N, device=dev, generator=g) * 0.5
        h0 = torch.zeros(B, N, device=dev)
        scale = 0.11
        y, h = mb_ops.minimalist_block_kernel(x, ch, cz, scale, bh, bz, h0)
        yp, hpl = mb_ref.minimalist_block_ref(x, ch, cz, scale, bh, bz, h0)
        torch.cuda.synchronize()
        err = (h - hpl).abs().max().item()
        if not (torch.equal(h, hpl) and torch.equal(y, yp)):
            fail(f"minimalist_block ({B}, {T}, {K}->{N}): kernel differs "
                 f"from its plain version (max |h - plain| = {err})")

        def kernel():
            mb_ops.minimalist_block_kernel(x, ch, cz, scale, bh, bz, h0)
        ms = device_ms(torch, kernel, 20)
        call_ms = eager_ms(torch, kernel, 20)
        plain_ms = device_ms(torch, lambda: mb_ref.minimalist_block_ref(
            x, ch, cz, scale, bh, bz, h0), 2)
        # yardstick the port never calls: both projections as dequantised
        # fp32 matmuls over all T at once, then the gate and the recurrence
        # as PyTorch elementwise ops
        wh = (ch.float() - 1.5) * scale
        wz = (cz.float() - 1.5) * scale

        def library():
            htl = torch.matmul(x, wh) + bh
            zl = torch.floor(torch.clamp(
                (torch.matmul(x, wz) + bz) / 6.0 + 0.5, 0.0, 1.0) * 63) / 63
            hl = h0
            for t in range(T):
                hl = zl[:, t] * htl[:, t] + (1.0 - zl[:, t]) * hl
            return hl
        library_ms = device_ms(torch, library, 2)
        bytes_ = (B * T * K * 4 + 2 * K * N + 2 * N * 4 + B * N * 4
                  + 2 * B * T * N * 4)
        b_ms, by = bound(bytes_, 4 * B * T * K * N + 8 * B * T * N)
        print(f"kernel minimalist_block ({B}, {T}, {K}->{N}) fp32: "
              f"max_abs_err {err:.3g} (bitwise required) kernel {ms:.4f} ms "
              f"(eager call {call_ms:.4f} ms), plain {plain_ms:.4f} ms, "
              f"library (two fp32 matmuls + elementwise recurrence) "
              f"{library_ms:.4f} ms, bound {b_ms:.5f} ms ({by})", flush=True)
        if (B, T, K, N) == (32, 98, 48, 48):
            rows["minimalist_block"] = dict(
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


def phase_train(torch, dev):
    """Full-width minimalist-lm-360m trained through Trainer on the card."""
    import math
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.data import ShardedLoader, SyntheticLMDataset
    from repro_torch.kernels.linear_scan import ops as scan_ops
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW, cosine_schedule, param_groups
    from repro_torch.train import TrainConfig, Trainer, build_train_step

    cfg = get_config("minimalist-lm-360m")
    steps, batch, seq, seed = 30, 8, 256, 0
    loader = ShardedLoader(SyntheticLMDataset(vocab=cfg.vocab, seq_len=seq),
                           global_batch=batch)

    def make(config):
        model = build_model(config, device=dev, generator=torch.Generator(
            device=dev).manual_seed(seed))
        opt = AdamW(param_groups(model), lr=cosine_schedule(
            3e-4, warmup=steps // 20, total=steps))
        return model, opt

    model, opt = make(cfg)
    with tempfile.TemporaryDirectory() as ckpt_dir:
        trainer = Trainer(model, opt, TrainConfig(
            steps=steps, ckpt_every=steps + 1, ckpt_dir=ckpt_dir,
            log_every=10), loader=loader, seed=seed)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        scan_ops.linear_scan_kernel.launches = 0
        scan_ops.linear_scan_bwd_kernel.launches = 0
        t0 = time.perf_counter()
        _, step = trainer.run()
        wall = time.perf_counter() - t0
        fwd = scan_ops.linear_scan_kernel.launches
        bwd = scan_ops.linear_scan_bwd_kernel.launches
    peak_gb = torch.cuda.max_memory_allocated(dev) / 2**30
    hist = trainer.history
    losses = [h["loss"] for h in hist]
    if step != steps or len(hist) != steps:
        fail(f"train: stopped at step {step} with {len(hist)} steps run")
    if trainer.restores:
        fail(f"train: {trainer.restores} crash-restores (a step raised)")
    if not all(math.isfinite(v) for v in losses):
        fail(f"train: non-finite loss in {losses}")
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    if not last < first:
        fail(f"train: loss did not fall (first-5 mean {first:.4f}, last-5 "
             f"mean {last:.4f})")
    if fwd != cfg.n_layers * steps or bwd != cfg.n_layers * steps:
        fail(f"train: scan launches fwd {fwd}, bwd {bwd} != {cfg.n_layers} "
             f"layers x {steps} steps")
    dts = sorted(h["dt"] for h in hist[3:])
    step_ms = dts[len(dts) // 2] * 1e3
    print(f"train: {cfg.name} {steps} steps (batch {batch}, seq {seq}) in "
          f"{wall:.1f} s incl. the final checkpoint; step p50 "
          f"{step_ms:.1f} ms (first {hist[0]['dt'] * 1e3:.0f} ms) -> "
          f"{batch * seq / (step_ms / 1e3):.0f} tokens/s; peak memory "
          f"{peak_gb:.2f} GiB; loss {losses[0]:.4f} -> {losses[-1]:.4f} "
          f"(first-5 mean {first:.4f}, last-5 mean {last:.4f}); restores 0; "
          f"linear_scan launches {fwd}, linear_scan_bwd launches {bwd} "
          f"= {cfg.n_layers} x {steps}", flush=True)
    del trainer, model, opt

    # the same seed and batches with the plain scan on the card
    plain, popt = make(dataclasses.replace(cfg, scan_backend="assoc"))
    step_fn = build_train_step(plain, popt)
    n_fwd, n_bwd = (scan_ops.linear_scan_kernel.launches,
                    scan_ops.linear_scan_bwd_kernel.launches)
    for i in range(3):
        batch_i = {k: torch.from_numpy(v).to(dev, torch.int64)
                   for k, v in loader.batch_at(i).items()}
        _, met = step_fn({}, batch_i)
        loss, gn = float(met["loss"]), float(met["grad_norm"])
        dl = abs(loss - hist[i]["loss"])
        dg = abs(gn - hist[i]["grad_norm"]) / hist[i]["grad_norm"]
        print(f"train: step {i} kernel loss {hist[i]['loss']:.5f} grad norm "
              f"{hist[i]['grad_norm']:.5f}; plain scan loss {loss:.5f} grad "
              f"norm {gn:.5f} (|dloss| {dl:.2e} tol 2e-2, grad norm "
              f"{dg:.2%} tol 2 %)", flush=True)
        if not (dl <= 2e-2 and dg <= 0.02):
            fail(f"train: step {i} differs from the plain-scan run")
    if (scan_ops.linear_scan_kernel.launches,
            scan_ops.linear_scan_bwd_kernel.launches) != (n_fwd, n_bwd):
        fail("train: the plain-scan run launched a scan kernel")
    del plain, popt
    torch.cuda.empty_cache()
    return bwd


def phase_system(torch, dev):
    """tests/test_system.py's flow on the card, plus the fused kernel."""
    import numpy as np

    from repro_torch.configs import MINIMALIST_SMNIST_DIMS
    from repro_torch.core.analog import (AnalogConfig, analog_forward,
                                         export_layer, make_mismatch)
    from repro_torch.core.mingru import MinimalistNetwork
    from repro_torch.core.quant import QuantConfig
    from repro_torch.data.smnist import load_smnist
    from repro_torch.kernels.linear_scan import ops as scan_ops
    from repro_torch.kernels.minimalist_block import ops as mb_ops
    from repro_torch.optim import AdamW
    from repro_torch.train.qat import QATConfig, qat_loss, train_qat

    (xtr, ytr), (xte, yte) = load_smnist(seed=0, n_train=1024, n_test=256)
    train, test = (xtr[:, ::8], ytr), (xte[:, ::8], yte)
    cfg = QATConfig(dims=(1, 48, 48, 10), phase_epochs=(12, 8, 8, 8),
                    batch=64, lr=5e-3)
    scan_ops.linear_scan_kernel.launches = 0
    scan_ops.linear_scan_bwd_kernel.launches = 0
    t0 = time.perf_counter()
    net, results = train_qat(train, test, cfg, verbose=False, device=dev)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    accs = [r["test_acc"] for r in results]
    n_steps = sum(cfg.phase_epochs) * (1024 // cfg.batch)
    print(f"system: QAT ladder {cfg.dims} T 98, {n_steps} steps in {dt:.1f} "
          f"s; test accuracy by phase {accs}; linear_scan launches "
          f"{scan_ops.linear_scan_kernel.launches}, linear_scan_bwd "
          f"launches {scan_ops.linear_scan_bwd_kernel.launches}", flush=True)
    if not accs[0] > 0.55:
        fail(f"system: fp32 phase failed to learn: {accs}")
    if not accs[-1] > 0.4:
        fail(f"system: hardware phase accuracy {accs[-1]} <= 0.4")
    if scan_ops.linear_scan_bwd_kernel.launches == 0:
        fail("system: QAT never launched linear_scan_bwd")

    # the circuit replays the trained hardware network
    n = 32
    x = torch.from_numpy((xte[:n, ::8] > 0.5).astype(np.float32)).to(dev)
    with torch.no_grad():
        sw_logits, sw = net(x, collect_traces=True)
    sw_pred = sw_logits.argmax(-1)
    acfg = AnalogConfig()
    images = [export_layer(b, acfg) for b in net.blocks]
    readout, _ = analog_forward(images, x, acfg, collect_traces=False)
    agree = (readout.argmax(-1) == sw_pred).float().mean().item()
    mcfg = AnalogConfig(mismatch_sigma=0.01)
    mm = make_mismatch(torch.Generator(device=dev).manual_seed(0), images,
                       mcfg)
    noisy, _ = analog_forward(images, x, mcfg, mismatch=mm,
                              collect_traces=False)
    agree_mm = (noisy.argmax(-1) == readout.argmax(-1)).float().mean().item()
    print(f"system: circuit agrees with the network on {agree:.3f} of {n} "
          f"streams (> 0.9), under 1 % mismatch with the ideal circuit on "
          f"{agree_mm:.3f} (> 0.8)", flush=True)
    if not agree > 0.9:
        fail(f"system: circuit agreement {agree} <= 0.9")
    if not agree_mm > 0.8:
        fail(f"system: agreement under mismatch {agree_mm} <= 0.8")

    # every layer through the fused sequence kernel: teacher-forced, then
    # closed loop
    exported = [mb_ops.from_block_params(b) for b in net.blocks]
    mb_ops.minimalist_block_kernel.launches = 0
    worst = 0.0
    for li, ex in enumerate(exported):
        x_l = x if li == 0 else sw[f"block{li - 1}"]["out"].contiguous()
        y, h = mb_ops.minimalist_block(x_l, *ex)
        h_sw = sw[f"block{li}"]["h"]
        err = (h - h_sw).abs().max().item()
        worst = max(worst, err)
        if not err <= 2e-5:
            fail(f"system: layer {li} kernel h differs from the network's "
                 f"by {err} > 2e-5")
        if li < len(exported) - 1:
            flips = (y != sw[f"block{li}"]["out"]) & (h_sw.abs() >= 1e-4)
            if flips.any():
                fail(f"system: layer {li} Θ flips where |h| >= 1e-4")
    out = x
    for ex in exported:
        out, h = mb_ops.minimalist_block(out, *ex)
    agree_k = (h[:, -1].argmax(-1) == sw_pred).float().mean().item()
    launches = mb_ops.minimalist_block_kernel.launches
    print(f"system: fused minimalist_block per layer (teacher-forced) max "
          f"|h - network| {worst:.3g} (tol 2e-05); closed-loop predictions "
          f"agree with the network on {agree_k:.3f} (> 0.9); "
          f"minimalist_block launches {launches}", flush=True)
    if not agree_k > 0.9:
        fail(f"system: fused closed-loop agreement {agree_k} <= 0.9")
    if launches != 2 * len(exported):
        fail(f"system: minimalist_block launches {launches} != "
             f"{2 * len(exported)}")

    # QAT speed at the paper's dims and sequence length
    pnet = MinimalistNetwork(MINIMALIST_SMNIST_DIMS,
                             qcfg=QuantConfig.hardware(), device=dev)
    pnet.reset_parameters(torch.Generator(device=dev).manual_seed(2))
    popt = AdamW(pnet.parameters(), lr=1e-3, weight_decay=0.0)
    xb = torch.from_numpy(xtr[:64]).to(dev)
    yb = torch.from_numpy(ytr[:64]).to(dev)

    def qat_step():
        popt.zero_grad(set_to_none=True)
        qat_loss(pnet, xb, yb).backward()
        popt.step()
    for _ in range(2):
        qat_step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        qat_step()
    torch.cuda.synchronize()
    sps = 10 / (time.perf_counter() - t0)
    print(f"system: QAT at the paper's dims {MINIMALIST_SMNIST_DIMS}, T 784, "
          f"batch 64 (hardware phase): {sps:.2f} steps/s "
          f"({64 * 784 * sps:.0f} frames/s)", flush=True)
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
                "minimalist_step": phase_stream(torch, dev),
                "linear_scan_bwd": phase_train(torch, dev),
                "minimalist_block": phase_system(torch, dev)}

    meta = {
        "linear_scan": ("src/repro_torch/kernels/csrc/linear_scan.cu",
                        "src/repro/kernels/linear_scan/linear_scan.py:54"),
        "minimalist_step": (
            "src/repro_torch/kernels/csrc/minimalist_step.cu",
            "src/repro/kernels/minimalist_block/minimalist_block.py:84"),
        "linear_scan_bwd": ("src/repro_torch/kernels/csrc/linear_scan_bwd.cu",
                            "src/repro/kernels/linear_scan/ops.py:66"),
        "minimalist_block": (
            "src/repro_torch/kernels/csrc/minimalist_block.cu",
            "src/repro/kernels/minimalist_block/minimalist_block.py:125"),
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
