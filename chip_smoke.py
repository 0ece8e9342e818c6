#!/usr/bin/env python3
"""Start the PyTorch port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:

  1. build   — compile every CUDA kernel of the port from the sources in
               this checkout (one nvcc per source, all at once).
  2. kernels — call each kernel's wrapper on the card at the main path's
               shapes and hold it against its plain PyTorch version;
               time kernel, plain version and (where one exists) one
               PyTorch library call computing the same function; the
               two scan kernels also L2-warm and L2-cold, five rounds
               in alternating order, with the SM clock around each;
               the MLA pair on its tc route and, at the path and odd
               shapes, on its simt route too (unaligned bf16 queries, and
               fp32 queries held to fp64 sums at 2e-6); fused_ssm_fwd
               from a carried state with the final state written out (the
               form mamba_serve's prefill calls) at its chunk shape and an
               odd tail, the chunk shape timed; paged_gqa(_q8) at
               stablelm-12b's and mistral-large-123b's decode shapes and
               flash_fwd/flash_bwd at whisper-small's and llava-next-34b's
               training shapes (PAGED_MODEL_ROWS, FLASH_MODEL_ROWS);
               at a tensor-parallel rank's widths, paged_mla(_q8) at H 64
               and 32 (deepseek-v3-671b at TP 2 and 4) and fused_ssm_fwd
               (carry form) and fused_ssm_bwd at d_inner 4096
               (falcon-mamba-7b at TP 2).
  3. lm     — serve full-width minimalist-lm-360m (random weights from a
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
               replayed through the fused minimalist_block kernel; the
               paper's network at its own widths (1, 64, 64, 64, 64, 10;
               seeded weights) replayed closed loop through the kernel
               over the 256 test streams at T 784, five launches, each
               layer bit for bit against the plain version; then QAT
               steps/s at the paper's dims.
  7. paged   — serve full-width smollm-360m (random weights from a seed)
               from a paged KV cache through build_engine: 8 greedy
               requests, 4 slots, page 16, every decode step through the
               paged_gqa kernel (bf16 pages); the same traffic through the
               gather read (tokens compared under the margin rule), int8
               pages through paged_gqa_q8, the kernel against the gather
               read again on a copy with every layer's output projections
               x32 (whose greedy streams do not just repeat one token), and
               a shared 128-token prefix with and without the prefix cache
               (streams equal).
  8. attn_train — train full-width smollm-360m with attention_impl="flash"
               for 20 steps through Trainer (batch 4, seq 2048): loss
               falls, no restores, every layer runs the flash_fwd kernel
               and both flash_bwd kernels once per step, all three on
               their tensor-core (tc) route; then 3 steps at
               batch 1 x 2048 from the same seed with flash and with the
               naive softmax, losses and grad norms compared.
  9. mamba_train — train full-width falcon-mamba-7b (8 of its 64 layers:
               fp32 AdamW state for all 64 would not fit one card) with
               ssm_impl="fused" for 20 steps through Trainer (batch 4, seq
               2048): loss falls, no restores, every layer runs the
               fused_ssm_fwd and fused_ssm_bwd kernels once per step and
               the linear-scan kernels never; both kernels held to their
               plain versions on layer 0's scan inputs and cotangent at
               the last step; the fp32 w_out products of a layer timed
               alone; then 3 steps at batch 1 x 2048 from the
               same seed with the fused scan and with the materializing
               "xla" path, losses and grad norms compared.
 10. mla_paged — serve full-width deepseek-v3-671b (its 3 dense MLA layers of
               61: one of the other 58, MoE, is 45 GB in fp32; random
               weights from a seed) from paged latent pools through
               build_engine: 8 greedy requests with 256-1024-token prompts,
               4 slots, page 16, every decode step through the paged_mla
               kernel (bf16 pages) on its tensor-core (tc) route; the
               gather read (margin rule), int8 pages through paged_mla_q8
               (tc route too), the kernel against the gather read on a copy
               with the output projections x32, and a shared 512-token
               prefix with and without the prefix cache (streams equal).
 11. sched   — full-width smollm-360m (output projections x32, so greedy
               streams vary) from paged bf16 pages, page 16, 4 slots, every
               decode step through paged_gqa: 6 priority-0 requests
               (prompts 128-256, 64 new tokens), 8 engine steps, then 2
               priority-1 ones, from a pool of three worst-case
               reservations under priority, sjf and edf (deadlines on the
               pair): priority and edf preempt, and every stream equals an
               undisturbed fifo run's with a pool for all, bit for bit; a
               fork of the first request into 2 greedy children (their
               streams equal the parent's; pages copied on write); a
               planted fault (priority again, each victim restored with
               its last page zeroed) must change a victim's stream; the
               static baseline generate() on 4 prompts of 128 against the
               dense engine (margin rule).
 12. spec    — the same target with the minimalist-lm-360m drafter at
               spec_k 4, 8 greedy requests (prompts 64-192, 32 new
               tokens): on the gather read bitwise the target-only
               streams, on the kernel read against the target-only kernel
               streams (margin rule); a drafter double proposing the
               target-only streams (every draft accepted) and one
               corrupting every third draft position (the accepted count
               worked out in advance); the engine's own spec wave
               (ServeEngine.step with the drafter) against its plain
               step, wall time and the profiler's device busy time.
 13. mamba_serve — full-width falcon-mamba-7b (all 64 layers, seeded fp32
               weights) served dense through build_engine: 4 greedy
               requests (prompts 256-1024, 16 new tokens), 2 slots, with
               ssm_impl="fused" (prefill through fused_ssm_fwd, carrying
               the state in and out) and "xla" (through linear_scan),
               tokens compared under the margin rule.
 14. moe_serve — full-width qwen3-moe-30b-a3b (16 of its 48 layers: all
               48 in fp32 would need 122 GB; seeded weights, output
               projections and expert w_down stacks x32) through
               build_engine with dispatch "auto" (per-request prefill,
               gather-GEMM decode): 8 greedy requests (prompts 64-512, 32
               new tokens), 4 slots, chunk 256, page 16: (a) bf16 pages
               through paged_gqa, (b) the gather read, (c) int8 pages
               through paged_gqa_q8, (d) the dense layout; (a) against (b)
               and (d) under the margin rule, (c) against (a) printed; a
               target request alone against it beside 3 others and at
               chunk 64 (margin rule, bitwise printed); one decode step
               eager against graph replay (idle share) and its device time
               split between the MoE MLPs, attention and the rest (one
               profiler window).  Then jamba-1.5-large-398b-smoke (labelled
               smoke: Mamba layers through fused_ssm_fwd beside paged
               attention) dense, paged gather (streams bitwise the dense
               ones) and paged kernel (margin rule).
 15. whisper — full-width whisper-small (12 + 12 layers, seeded weights,
               1500 stub frame embeddings x 0.1): 10 AdamW steps through
               Trainer at batch 4 x 448 decoder tokens with
               attention_impl="flash" (every decoder layer launches the
               flash kernels once a step on the tc route), the first
               step's loss and gradient norm held to "naive" on the same
               weights (|dloss| <= 2e-2, norms within 2 %); then 4 requests
               (output projections x32) encoded once into the cross-K/V
               cache by init_cache(frame_embeds=...) and decoded greedily
               for 64 tokens from a dense self-cache, every choice equal to
               the teacher-forced full forward's where its top-2 margin is
               > 0.1.
 16. vlm     — full-width llava-next-34b cut to 4 of its 60 layers (seeded
               weights; fp32 AdamW state of all 60 would be 550 GB): 5 AdamW
               steps at batch 2, 576 seeded patch embeddings before 512
               tokens, through flash (tc route), the first step held to
               naive as in whisper; peak memory under 70 GiB.
 17. wide_head_train — flash above head dim 128 on its tc route (run at
               160 and 256): full-width stablelm-12b cut to 4 of its 40
               layers (heads of 160) and gemma3-4b cut to one 5:1 pattern
               unit (5 sliding-window layers at window 1024 and 1 global,
               heads of 256), seeded weights, each 5 AdamW steps at batch 1
               x 4096 through flash, the first step held to naive as in
               whisper, every flash launch on the tc route, step p50,
               tokens/s and peak memory (under 70 GiB) printed.
 18. stablelm_serve — full-width stablelm-12b, all 40 layers (48.6 GB of
               fp32 weights, output projections x32) through build_engine:
               8 greedy requests (prompts 64-512, 32 new tokens), 4 slots,
               page 16: (a) bf16 pages through paged_gqa at head dim 160
               (20 16-byte chunks a row, the 4 query rows of a kv head in
               one tile), (b) the gather read, (a) against (b)
               under the margin rule, (c) int8 pages through paged_gqa_q8;
               one bf16 decode step eager against graph replay (idle
               share) and its device time split between attention, the
               MLPs and the rest (one profiler window).
 19. mistral_serve — full-width mistral-large-123b cut to 8 of its 88
               layers (launch.dryrun.depth_variant; 47.5 GB of fp32
               weights, output projections x32): first the dry-run's
               prediction for this cell (lower_cell, decode_32k at batch 4
               x 544 on a 1x1 mesh, meta tensors), then 8 greedy requests
               (prompts 64-512, 32 new tokens), 4 slots, page 16: (a) bf16
               pages through paged_gqa (group 12, vector route), (b) the
               gather read, (a) against (b) under the margin rule, (c)
               int8 pages through paged_gqa_q8; the parameter bytes equal
               the prediction exactly, (a)'s peak lies within
               MISTRAL_PEAK_TOL of the predicted peak, and one 4-slot bf16
               decode step's device time is printed beside the predicted
               memory_s.
 20. dryrun_train — full-width smollm-360m at batch 4 x 2048 through flash,
               one AdamW step with remat "none" and one with "full" from
               the same seed: losses and gradient norms bitwise equal,
               each peak beside the dry-run's prediction, full's below;
               (c) the full step again on a model bound to a world-1 1x1
               mesh: bitwise the unbound one, its peak beside it.
 21. mesh_serve — a world-1 process group (NCCL, through a FileStore
               under build/) and a 1x1 DeviceMesh: (a) full-width
               minimalist-lm-360m dense, phase lm's traffic greedy and
               sampled, (b) full-width smollm-360m (output projections
               x32), phase paged's traffic from bf16 pages through paged_gqa
               and int8 pages through paged_gqa_q8 — every stream bitwise
               the no-mesh engine's, each kernel's launches equal to the
               no-mesh run's, tok/s and decode-step p50 with and without
               the mesh — and (c) two AdamW steps of smollm-360m through
               flash at 1 x 2048 on the mesh, each loss within 1e-6
               relative of the no-mesh run's; (d) TP 2 over two cards with
               spawned NCCL ranks when two are visible, (a) greedy and (b)
               bf16 against the no-mesh streams under the margin rule (else
               a line says it did not run).
 22. tp_serve — TP 2 on two spawned ranks: NCCL with a card each where
               two are visible, else gloo with both ranks on card 0 (the
               transport is printed).  With mistral_serve's traffic (8
               requests, prompts 64-512, 32 new): falcon-mamba-7b fused,
               dense slots (all 64 layers on two cards, 16 on one: each
               rank first builds the whole fp32 model); deepseek-v3-671b's
               3 dense MLA layers from bf16 and int8 latent pages (64
               heads a rank reach paged_mla(_q8)); whisper-small (x32)
               decoded greedily after the encoder; one AdamW step of
               falcon-mamba-7b (8 layers, 1 x 2048) with gradients under
               remat none and full (losses bitwise).  The parent runs the
               same with no mesh: streams under the margin rule, the TP
               loss within TP_LOSS_TOL, decode-step p50 with and without
               the mesh, launches of fused_ssm_* and paged_mla*.
 23. mixed   — a stack mixing minGRU and attention at minimalist-lm-360m's
               widths (x32) from bf16 pages with phase lm's traffic: the
               paged_gqa read against the gather read (margin rule).
 24. examples — repro_torch.examples.quickstart and .serve_batch on the
               card as subprocesses; a non-zero exit fails the script.
 25. imc     — the paper's IMC projection (Eq. 6) through its entry point
               imc_mvm on the card at the kernel rows' shapes with leading
               dimensions (the 4096 x 1024 x 1024 one on the tc route),
               against its plain version, and Eq. 6's all-ones and
               all-zeros properties.

Kernel launch counts are zeroed just before each main-path run and read
just after it; a kernel's count in the last line sums its phases.  The second-to-last stdout line is the card's name and
power limit; the last is {"ok": true, "device": {...}}.  Exits non-zero
without a result when CUDA is unavailable or the port is not next to
this script.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM published peaks (dense): HBM3 rate, fp32 non-tensor rate, and
# the bf16 tensor-core rate (the flash rows: a bf16 x bf16 product is exact
# in fp32, so the card could do their work on the tensor cores)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_TENSOR_FLOPS = 989e12


# falcon-mamba-7b's ssm_impl="xla" scan at batch 1 x 2048: d_inner 8192 x
# d_state 16 channels (models/mamba.py), one fp32 linear_scan a layer
MAMBA_XLA_SCAN = (1, 2048, 131072)


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def bound(bytes_, flops, peak_flops=PEAK_FP32_FLOPS):
    """(least time in ms, what bounds it) for moving ``bytes_`` once and
    doing ``flops`` operations at ``peak_flops`` (fp32 unless given) on the
    card."""
    t_mem, t_ops = bytes_ / PEAK_BYTES_PER_S, flops / peak_flops
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

    # -- linear_scan: minGRU prefill chunk (wave 4, chunk 256, d 960), the
    #    training step's forward (batch 8) and falcon-mamba's ssm_impl="xla"
    #    scan (batch 1, seq 2048, d_inner 8192 x d_state 16) -------------
    shapes = [((4, 256, 960), torch.bfloat16, 2e-2),
              ((4, 256, 960), torch.float32, 1e-5),
              ((3, 77, 1000), torch.float32, 1e-5),
              ((3, 77, 1000), torch.bfloat16, 2e-2),
              ((8, 256, 960), torch.bfloat16, 2e-2),
              (MAMBA_XLA_SCAN, torch.float32, 1e-5)]
    for shape, dtype, tol in shapes:
        B, T, D = shape
        big = shape == MAMBA_XLA_SCAN
        z = torch.sigmoid(torch.randn(shape, device=dev, generator=g))
        a = (1.0 - z).to(dtype)
        b = (z * torch.randn(shape, device=dev, generator=g)).to(dtype)
        del z
        h0 = torch.randn(B, D, device=dev, generator=g).to(dtype)
        got = scan_ops.linear_scan_kernel(a, b, h0)
        want = scan_ref.linear_scan_associative(a, b, h0)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        del got, want
        tag = f"linear_scan {shape} {str(dtype)[6:]}"
        if not err <= tol:
            fail(f"{tag}: max |kernel - plain| = {err} > {tol}")
        n = 20 if big else 200
        ms = device_ms(torch, lambda: scan_ops.linear_scan_kernel(a, b, h0),
                       n)
        call_ms = eager_ms(
            torch, lambda: scan_ops.linear_scan_kernel(a, b, h0), n)
        plain_ms = device_ms(
            torch, lambda: scan_ref.linear_scan_associative(a, b, h0),
            2 if big else 20)
        elt = a.element_size()
        b_ms, by = bound((3 * B * T * D + B * D) * elt, 2 * B * T * D)
        print(f"kernel {tag}: max_abs_err {err:.3g} (tol {tol}) "
              f"kernel {ms:.5f} ms (eager call {call_ms:.4f} ms), plain "
              f"{plain_ms:.4f} ms, bound {b_ms:.5f} ms ({by}; "
              f"{b_ms / ms:.1%} of it)", flush=True)
        if shape == (4, 256, 960) and dtype == torch.bfloat16:
            rows["linear_scan"] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=by, library_ms=None)
        elif shape == (8, 256, 960):
            rows["linear_scan"].update(
                train_max_abs_err=err, train_ms=ms, train_plain_ms=plain_ms,
                train_bound_ms=b_ms)
        elif big:
            rows["linear_scan"].update(
                mamba_xla_max_abs_err=err, mamba_xla_ms=ms,
                mamba_xla_plain_ms=plain_ms, mamba_xla_bound_ms=b_ms)
        del a, b, h0
        torch.cuda.empty_cache()

    # the launch floor: one one-element PyTorch op in the same harness, the
    # least a kernel launch costs in graph replay
    one = torch.zeros(1, device=dev)
    floor_ms = device_ms(torch, lambda: one.add_(1.0), 500)
    print(f"launch floor (one one-element add_, graph replay): "
          f"{floor_ms:.5f} ms", flush=True)

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
              f"kernel {ms:.5f} ms (eager call {call_ms:.4f} ms), plain {plain_ms:.4f} ms, library (one "
              f"fp32 matmul) {library_ms:.5f} ms, launch floor "
              f"{floor_ms:.5f} ms, bound {b_ms:.5f} ms ({by})", flush=True)
        if (B, K, N) == (8, 64, 64):
            rows["minimalist_step"] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=by, library_ms=library_ms,
                launch_floor_ms=floor_ms)
        else:
            rows["minimalist_step"].update(
                wide_max_abs_err=err, wide_ms=ms, wide_plain_ms=plain_ms, wide_bound_ms=b_ms,
                wide_library_ms=library_ms)
    # -- linear_scan_bwd: LM training (batch 8, seq 256, d 960), and the
    #    falcon-mamba xla scan's backward ---------------------------------
    for shape, dtype, tol in [((8, 256, 960), torch.bfloat16, 2e-2),
                              ((8, 256, 960), torch.float32, 1e-5),
                              ((3, 77, 1000), torch.float32, 1e-5),
                              ((3, 77, 1000), torch.bfloat16, 2e-2),
                              (MAMBA_XLA_SCAN, torch.float32, 1e-5)]:
        B, T, D = shape
        big = shape == MAMBA_XLA_SCAN
        z = torch.sigmoid(torch.randn(shape, device=dev, generator=g))
        a = (1.0 - z).to(dtype)
        b = (z * torch.randn(shape, device=dev, generator=g)).to(dtype)
        del z
        h0 = torch.randn(B, D, device=dev, generator=g).to(dtype)
        gout = torch.randn(shape, device=dev, generator=g).to(dtype)
        h = scan_ref.linear_scan_associative(a, b, h0)
        del b
        got = scan_ops.linear_scan_bwd_kernel(a, h, h0, gout)
        want = scan_ref.linear_scan_bwd(a, h, h0, gout)
        torch.cuda.synchronize()
        err = max((x.float() - y.float()).abs().max().item()
                  for x, y in zip(got, want))
        del got, want
        tag = f"linear_scan_bwd {shape} {str(dtype)[6:]}"
        if not err <= tol:
            fail(f"{tag}: max |kernel - plain| = {err} > {tol}")

        def kernel():
            scan_ops.linear_scan_bwd_kernel(a, h, h0, gout)
        n = 20 if big else 200
        ms = device_ms(torch, kernel, n)
        call_ms = eager_ms(torch, kernel, n)
        plain_ms = device_ms(
            torch, lambda: scan_ref.linear_scan_bwd(a, h, h0, gout),
            2 if big else 20)
        elt = a.element_size()
        # reads a, g, h, h0 once, writes da, db, dh0 once; 3 flops/element
        b_ms, by = bound((5 * B * T * D + 2 * B * D) * elt, 3 * B * T * D)
        print(f"kernel {tag}: max_abs_err {err:.3g} (tol {tol}) "
              f"kernel {ms:.5f} ms (eager call {call_ms:.4f} ms), plain "
              f"{plain_ms:.4f} ms, bound {b_ms:.5f} ms ({by}; "
              f"{b_ms / ms:.1%} of it)", flush=True)
        if shape == (8, 256, 960) and dtype == torch.bfloat16:
            rows["linear_scan_bwd"] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=by, library_ms=None)
        elif big:
            rows["linear_scan_bwd"].update(
                mamba_xla_max_abs_err=err, mamba_xla_ms=ms,
                mamba_xla_plain_ms=plain_ms, mamba_xla_bound_ms=b_ms)
        del a, h, h0, gout
        torch.cuda.empty_cache()

    # -- the two scan rows in both L2 states: five rounds in alternating
    #    order with minimalist_step, the SM clock around each round -----
    from repro_torch.launch.profile import scan_readings
    print(f"scan readings on {torch.cuda.get_device_name(0)}: L2-warm = "
          "graph replay of 200 launches on the same inputs, each = each "
          "launch by its own events after a spin kernel, cold = each "
          "launch by its own events after 256 MB are written", flush=True)
    got = scan_readings(dev)
    for name in ("linear_scan", "linear_scan_bwd"):
        for mode, key in (("warm", "l2_warm"), ("cold", "l2_cold"),
                          ("each", "each_launch")):
            med, spread, _ = got[name][mode]
            rows[name][f"{key}_ms"] = med
            rows[name][f"{key}_spread"] = spread
    rows["linear_scan"]["sm_clocks"] = got["clocks"]

    # -- minimalist_block: the system check's layer shape (32 streams,
    #    98 frames, 48 -> 48), its first layer and readout, the paper's
    #    (8, 784, 64 -> 64) and (256, 784, 64 -> 64) and a small batch;
    #    bit for bit against the plain version ---------------------------
    from repro_torch.launch.profile import (BLOCK_SHAPES, _block_inputs,
                                            sm_clock_mhz)
    for B, T, K, N in BLOCK_SHAPES:
        x, ch, cz, scale, bh, bz, h0 = _block_inputs(dev, g, B, T, K, N)
        y, h = mb_ops.minimalist_block_kernel(x, ch, cz, scale, bh, bz, h0)
        yp, hpl = mb_ref.minimalist_block_ref(x, ch, cz, scale, bh, bz, h0)
        torch.cuda.synchronize()
        err = (h - hpl).abs().max().item()
        if not (torch.equal(h, hpl) and torch.equal(y, yp)):
            fail(f"minimalist_block ({B}, {T}, {K}->{N}): kernel differs "
                 f"from its plain version (max |h - plain| = {err})")
        del y, h, yp, hpl

        def kernel():
            mb_ops.minimalist_block_kernel(x, ch, cz, scale, bh, bz, h0)
        ms = device_ms(torch, kernel, 50)
        mhz = sm_clock_mhz()
        call_ms = eager_ms(torch, kernel, 50)
        plain_ms = device_ms(torch, lambda: mb_ref.minimalist_block_ref(
            x, ch, cz, scale, bh, bz, h0), 2)
        # a loop of PyTorch calls the port never makes (no single call
        # computes a gated recurrence): both projections as dequantised
        # fp32 matmuls over all T at once, then the gate and the
        # recurrence as elementwise ops
        wh = (ch.float() - 1.5) * scale
        wz = (cz.float() - 1.5) * scale

        def loop():
            htl = torch.matmul(x, wh) + bh
            zl = torch.floor(torch.clamp(
                (torch.matmul(x, wz) + bz) / 6.0 + 0.5, 0.0, 1.0) * 63) / 63
            hl = h0
            for t in range(T):
                hl = zl[:, t] * htl[:, t] + (1.0 - zl[:, t]) * hl
            return hl
        loop_ms = device_ms(torch, loop, 2)
        bytes_ = (B * T * K * 4 + 2 * K * N + 2 * N * 4 + B * N * 4
                  + 2 * B * T * N * 4)
        b_ms, by = bound(bytes_, 4 * B * T * K * N + 8 * B * T * N,
                         PEAK_BF16_TENSOR_FLOPS)
        # the state update's dependent chain: two fp32 operations (about
        # 8 cycles) a frame, at the SM clock read after the timing
        chain_ms = T * 8 / (mhz * 1e3)
        slab, ctas = mb_ops.block_plan(
            B, N, torch.cuda.get_device_properties(dev).multi_processor_count)
        print(f"kernel minimalist_block ({B}, {T}, {K}->{N}) fp32: "
              f"max_abs_err {err:.3g} (bitwise required; slab {slab}, "
              f"{ctas} CTAs) kernel {ms:.5f} ms "
              f"(eager call {call_ms:.4f} ms), plain {plain_ms:.4f} ms, "
              f"loop (not one call) {loop_ms:.4f} ms, bound {b_ms:.5f} ms "
              f"({by}, bf16 tensor peak; {b_ms / ms:.1%} of it), chain "
              f"floor {chain_ms:.5f} ms (T x 8 cycles at {mhz:.0f} MHz)",
              flush=True)
        key = {(32, 98, 48, 48): "", (8, 784, 64, 64): "paper_b8_",
               (256, 784, 64, 64): "paper_b256_"}.get((B, T, K, N))
        if key == "":
            rows["minimalist_block"] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=by, library_ms=None, loop_ms=loop_ms,
                chain_floor_ms=chain_ms)
        elif key:
            rows["minimalist_block"].update({
                f"{key}ms": ms, f"{key}plain_ms": plain_ms,
                f"{key}bound_ms": b_ms, f"{key}bound_by": by,
                f"{key}chain_floor_ms": chain_ms})
        del x, ch, cz, bh, bz, h0
        torch.cuda.empty_cache()
    rows.update(_kernel_rows_paged(torch, dev, g))
    rows.update(_kernel_rows_flash(torch, dev, g))
    rows.update(_kernel_rows_ssm(torch, dev, g))
    rows.update(_kernel_rows_mla(torch, dev, g))
    rows.update(_kernel_rows_imc(torch, dev, g))
    rows["fused_ssm_fwd"].update(_ssm_carry_against_plain(torch, dev, g))
    _kernel_rows_model_shapes(torch, dev, rows)
    _kernel_rows_tp(torch, dev, rows)
    return rows


def _past_bf16_ulp(torch, got, want):
    """(number of elements where |got - want| exceeds one bf16 ulp of the
    larger magnitude plus 2e-6, max |got - want|)."""
    a, w = got.float(), want.float()
    mag = torch.maximum(a.abs(), w.abs()).clamp(min=2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    err = (a - w).abs()
    return int((err > ulp + 2e-6).sum()), err.max().item()


def _paged_case(torch, dev, g, *, B, H, KV, hd, ps, length, pos, window,
                num_pages, q8):
    """Inputs of one paged decode read: random disjoint chains in a pool
    twice the chains' size (the rest holds other tenants' pages)."""
    n = -(-length // ps)
    perm = torch.randperm(num_pages, device=dev, generator=g)
    bt = perm[:B * n].reshape(B, n).to(torch.int32).contiguous()
    q = torch.randn(B, H, hd, device=dev, generator=g).to(torch.bfloat16)
    pk = torch.randn(num_pages, ps, KV, hd, device=dev, generator=g)
    pv = torch.randn(num_pages, ps, KV, hd, device=dev, generator=g)
    pos = torch.as_tensor(pos, dtype=torch.int32, device=dev)
    if not q8:
        return q, pk.to(torch.bfloat16), pv.to(torch.bfloat16), (), bt, pos
    from repro_torch.kernels.paged_attention import quant as kvq
    ks, vs = kvq.page_abs_scale(pk), kvq.page_abs_scale(pv)
    return q, kvq.quantize(pk, ks), kvq.quantize(pv, vs), (ks, vs), bt, pos


# (label, B, H, KV, hd, length, window, pos) of the paged GQA kernel rows:
# the paged phase's decode shape (4 slots, smollm-360m's 15/5 heads of 64,
# page 16, cache 256; the JSON row) and its 128-entry window ring, a long
# context (64 slots x 2048 positions, all full: the pages exceed the 50 MB
# L2, so bytes decide), gemma3-4b's local layers (8/4 heads of 256 on
# 1024-entry rings, three of four wrapped) and qwen3-moe-30b-a3b's decode
# in phase moe_serve (32/4 heads of 128, cache 512; rows 5d/6d)
PAGED_ROWS = [
    ("path", 4, 15, 5, 64, 256, None, [255, 255, 255, 255]),
    ("ring", 4, 15, 5, 64, 128, 128, [255, 200, 130, 64]),
    ("long", 64, 15, 5, 64, 2048, None, [2047] * 64),
    ("gemma", 4, 8, 4, 256, 1024, 1024, [4095, 3000, 1500, 1023]),
    ("qwen3", 4, 32, 4, 128, 512, None, [511, 511, 511, 511]),
]


def _layout_tag(pa_ops, hd, itemsize, group, aligned=True):
    """The layout the built ``paged_gqa.cuh`` chooses
    (``ops.gqa_device_layout``), in words; fails unless the wrapper's
    mirror of the rule (``ops.gqa_layout``) gives the same."""
    lay = pa_ops.gqa_device_layout(hd, itemsize, group, aligned)
    mirror = pa_ops.gqa_layout(hd, itemsize, group, aligned)
    if lay != mirror:
        fail(f"paged_gqa layout at hd {hd}, {itemsize}-byte pools, group "
             f"{group}, aligned {aligned}: the library chooses {lay}, "
             f"ops.gqa_layout says {mirror}")
    if lay["route"] == "scalar":
        return "scalar route (one element a lane, one query row a tile)"
    return (f"vector route ({hd * itemsize // 16} 16-byte chunks over "
            f"{lay['lanes']} lanes, {lay['chunks']} a lane; "
            f"{lay['tile']} query rows a tile)")


def _paged_row(torch, dev, g, q8, label, B, H, KV, hd, length, window,
               pos, scalar=False):
    """paged_gqa (or paged_gqa_q8) at one shape against the plain version;
    kernel (graph replay and eager), plain and SDPA times and the byte
    bound; with ``scalar``, also the kernel on the same pools one element
    past a 16-byte boundary (the one-element layout, checked against the
    plain version too) timed in the same call.  Returns the row's
    numbers."""
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.paged_attention import ref as pa_ref

    ps = 16
    name = "paged_gqa_q8" if q8 else "paged_gqa"
    kern = pa_ops.paged_gqa_q8_kernel if q8 else pa_ops.paged_gqa_kernel
    q, pk, pv, sc, bt, pos_t = _paged_case(
        torch, dev, g, B=B, H=H, KV=KV, hd=hd, ps=ps, length=length,
        pos=pos, window=window, num_pages=2 * B * (-(-length // ps)),
        q8=q8)
    kw = dict(length=length, window=window)
    got = kern(q, pk, pv, *sc, bt, pos_t, **kw)
    sk = dict(zip(("k_scale", "v_scale"), sc))
    want = pa_ref.paged_gqa_ref(q, pk, pv, bt, pos_t, **kw, **sk)
    torch.cuda.synchronize()
    # one bf16 ulp of the output (of the larger magnitude), plus the fp32
    # bound 2e-6 where cancellation leaves it near zero: both round fp32
    # results within 2e-6 of each other to bf16
    n_bad, err = _past_bf16_ulp(torch, got, want)
    itemsize = pk.element_size()
    tag = (f"{name} {label} (B {B}, H {H}, KV {KV}, hd {hd}, page {ps}, "
           f"length {length}, window {window}) bf16 q, "
           f"{_layout_tag(pa_ops, hd, itemsize, H // KV)}")
    if n_bad:
        fail(f"{tag}: |kernel - plain| exceeds one bf16 ulp + 2e-6 "
             f"(max {err})")

    def kernel():
        kern(q, pk, pv, *sc, bt, pos_t, **kw)
    ms = device_ms(torch, kernel, 200)
    call_ms = eager_ms(torch, kernel, 200)
    plain_ms = device_ms(torch, lambda: pa_ref.paged_gqa_ref(
        q, pk, pv, bt, pos_t, **kw, **sk), 20)
    # yardstick the port never calls: SDPA over the dense (dequantized)
    # view of the same chains, gathered and expanded to H heads outside
    # the timed region
    L = length
    if q8:
        kd = pa_ref.gather_dequant(pk, sc[0], bt, L, torch.bfloat16)
        vd = pa_ref.gather_dequant(pv, sc[1], bt, L, torch.bfloat16)
    else:
        kd = pa_ref.gather_pages(pk, bt, L)
        vd = pa_ref.gather_pages(pv, bt, L)
    kd = kd.permute(0, 2, 1, 3).repeat_interleave(H // KV, 1)
    vd = vd.permute(0, 2, 1, 3).repeat_interleave(H // KV, 1)
    _kp, valid = pa_ref.paged_positions(pos_t, L, window)
    mask = valid[:, None, None, :]
    qd = q[:, :, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = device_ms(
        torch, lambda: sdpa(qd, kd, vd, attn_mask=mask), 200)
    del kd, vd
    # bytes and flops that this run's positions need: each row's live
    # pages (the window caps them), q and out, the block table
    flops = bytes_ = 0
    for p in pos:
        f, b = pa_ops.cost_model(
            1, H, KV, hd, live_tokens=p + 1, page_size=ps,
            dtype_bytes=1 if q8 else 2, window=window,
            scale_bytes=4 if q8 else 0)
        flops, bytes_ = flops + f, bytes_ + b
    b_ms, by = bound(bytes_, flops)
    print(f"kernel {tag}: max_abs_err {err:.3g} (tol one bf16 ulp + 2e-6) "
          f"kernel {ms:.5f} ms (eager call {call_ms:.5f} ms), plain "
          f"{plain_ms:.4f} ms, library (SDPA on the dense view) "
          f"{library_ms:.5f} ms, bound {b_ms:.5f} ms ({by}, "
          f"{bytes_ / 1e6:.1f} MB; {b_ms / ms:.1%} of it)", flush=True)
    scalar_ms = None
    if scalar:
        mk, mv = pa_ops.misaligned(pk), pa_ops.misaligned(pv)
        n_bad, s_err = _past_bf16_ulp(
            torch, kern(q, mk, mv, *sc, bt, pos_t, **kw), want)
        if n_bad:
            fail(f"{name} {label} on misaligned pools (scalar route): "
                 f"|kernel - plain| exceeds one bf16 ulp + 2e-6 (max "
                 f"{s_err})")
        scalar_ms = device_ms(
            torch, lambda: kern(q, mk, mv, *sc, bt, pos_t, **kw), 200)
        ms2 = device_ms(torch, kernel, 200)
        print(f"kernel {name} {label}: "
              f"{_layout_tag(pa_ops, hd, itemsize, H // KV, False)} on "
              f"pools one element past 16 bytes: max_abs_err "
              f"{s_err:.3g}, {scalar_ms:.5f} ms = "
              f"{scalar_ms / max(ms, ms2):.2f}x the aligned pools' "
              f"{ms:.5f} / {ms2:.5f} ms (before / after it)", flush=True)
        del mk, mv
    row = dict(max_abs_err=err, ms=ms, eager_ms=call_ms, plain_ms=plain_ms,
               bound_ms=b_ms, bound_by=by, library_ms=library_ms)
    if scalar_ms is not None:
        row["scalar_ms"] = scalar_ms
    return row


def _prefixed(label, row):
    """A shape's row numbers as extra keys of a kernel's JSON row."""
    return {f"{label}_{k}": row[k] for k in (
        "ms", "eager_ms", "plain_ms", "bound_ms", "library_ms",
        "max_abs_err", "scalar_ms") if k in row}


def _kernel_rows_paged(torch, dev, g):
    """paged_gqa and paged_gqa_q8 at PAGED_ROWS against the plain version
    (_paged_row)."""
    rows = {}
    for q8 in (False, True):
        name = "paged_gqa_q8" if q8 else "paged_gqa"
        for label, *shape in PAGED_ROWS:
            row = _paged_row(torch, dev, g, q8, label, *shape)
            if label == "path":
                row.pop("eager_ms")
                rows[name] = row
            elif label != "ring":
                rows[name].update(_prefixed(label, row))
    return rows


def _flash_flops(B, H, S, D, window):
    """flops of the causal flash forward and backward at (B, H, S, D):
    q.k^T and p.V (4 D each) over the (query, key) pairs the mask admits,
    min(i + 1, window) keys in row i; the backward 2.5 times the forward,
    the reference cost model's ratio (its 3.5 for a training call less the
    forward).  The reference's cost model counts S^2 / 2 pairs under a
    causal mask and S x window under a window: at S 2048, window 1024, a
    third more than the mask admits."""
    w = S if window is None else min(window, S)
    pairs = w * (w + 1) // 2 + (S - w) * w
    fwd = 4 * B * H * pairs * D
    return fwd, 2.5 * fwd


def _sdpa_bwd_ms(torch, sdpa, qkv, do, kw, rounds=3):
    """SDPA's backward alone, timed as the kernels are (graph replay):
    its forward and backward (inputs that need grad) less that forward,
    ``rounds`` times.  Returns (median, the rounds)."""
    ql, kl, vl = (t.detach().requires_grad_() for t in qkv)

    def fwd():
        return sdpa(ql, kl, vl, **kw)

    def fwd_bwd():
        torch.autograd.grad(fwd(), (ql, kl, vl), do)
    xs = [device_ms(torch, fwd_bwd, 10) - device_ms(torch, fwd, 10)
          for _ in range(rounds)]
    return sorted(xs)[len(xs) // 2], xs


def _flash_row(torch, dev, g, B, H, KV, S, D, window):
    """flash_fwd and flash_bwd at one shape (causal, bf16) against their
    plain versions (the bounds of _kernel_rows_flash), with kernel, plain
    and SDPA times and the bounds.  Returns (forward row, backward
    row)."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref

    sdpa = torch.nn.functional.scaled_dot_product_attention
    bf = torch.bfloat16
    q = (torch.randn(B, H, S, D, device=dev, generator=g) * 0.5).to(bf)
    k = (torch.randn(B, KV, S, D, device=dev, generator=g) * 0.5).to(bf)
    v = torch.randn(B, KV, S, D, device=dev, generator=g).to(bf)
    do = torch.randn(B, H, S, D, device=dev, generator=g).to(bf)
    tag = (f"(B {B}, H {H}, KV {KV}, S {S}, D {D}, causal, window "
           f"{window}) bf16, {fa_ops.route(bf, D)} route")
    out, lse = fa_ops.flash_fwd_kernel(q, k, v, True, window)
    want, want_lse = fa_ref.flash_attention_ref(q, k, v, True, window)
    torch.cuda.synchronize()
    n_bad, err = _past_bf16_ulp(torch, out, want)
    lse_diff = (lse - want_lse).abs()
    lse_err = lse_diff.max().item()
    if n_bad or not (lse_diff <= 2e-5 + 2e-5 * want_lse.abs()).all():
        fail(f"flash_fwd {tag}: {n_bad} outputs past one bf16 ulp + "
             f"2e-6 (max {err}), max |lse - plain| {lse_err}")
    grads = fa_ops.flash_bwd_kernel(q, k, v, out, lse, do, True, window)
    wgrads = fa_ref.flash_attention_bwd_ref(q, k, v, out, lse, do, True,
                                            window, acc=torch.float64)
    torch.cuda.synchronize()
    gerr = 0.0
    for name, a, w in zip(("dq", "dk", "dv"), grads, wgrads):
        n_bad, e = _past_bf16_ulp(torch, a, w)
        if n_bad:
            fail(f"flash_bwd {tag}: {n_bad} {name} entries past one bf16 "
                 f"ulp + 2e-6 (max |diff| {e})")
        gerr = max(gerr, e)

    def fwd():
        fa_ops.flash_fwd_kernel(q, k, v, True, window)

    def bwd():
        fa_ops.flash_bwd_kernel(q, k, v, out, lse, do, True, window)
    f_ms, f_call = device_ms(torch, fwd, 20), eager_ms(torch, fwd, 20)
    b_ms, b_call = device_ms(torch, bwd, 10), eager_ms(torch, bwd, 10)
    f_plain = device_ms(torch, lambda: fa_ref.flash_attention_ref(
        q, k, v, True, window), 2)
    b_plain = device_ms(torch, lambda: fa_ref.flash_attention_bwd_ref(
        q, k, v, out, lse, do, True, window), 2)
    # yardstick the port never calls: SDPA (GQA), causal, or with a
    # boolean window mask; its backward alone, timed on a retained
    # autograd graph
    if window is None:
        kw = dict(is_causal=True, enable_gqa=True)
    else:
        kw = dict(attn_mask=fa_ref.attend_mask(S, True, window, dev),
                  enable_gqa=True)
    f_lib = device_ms(torch, lambda: sdpa(q, k, v, **kw), 20)
    b_lib, b_libs = _sdpa_bwd_ms(torch, sdpa, (q, k, v), do, kw)
    # the forward's bytes from the reference's cost model (the inference
    # call); the backward's each input (q, k, v, out, do, lse) read and
    # each gradient written once; the flops of both over the (query, key)
    # pairs the mask admits (_flash_flops)
    f_flops, b_flops = _flash_flops(B, H, S, D, window)
    _, fb = fa_ops.cost_model(B, H, KV, S, D, window=window, train=False)
    el = q.element_size()
    bb = 2 * B * (H + 2 * KV) * S * D * el + 2 * B * H * S * D * el \
        + B * H * S * 4
    fb_ms, f_by = bound(fb, f_flops, PEAK_BF16_TENSOR_FLOPS)
    bb_ms, b_by = bound(bb, b_flops, PEAK_BF16_TENSOR_FLOPS)
    print(f"kernel flash_fwd {tag}: max_abs_err {err:.3g} (tol one bf16 "
          f"ulp + 2e-6; lse {lse_err:.3g}) kernel {f_ms:.4f} ms (eager "
          f"call {f_call:.4f} ms), plain {f_plain:.4f} ms, library (SDPA) "
          f"{f_lib:.4f} ms, bound {fb_ms:.5f} ms ({f_by}, bf16 tensor "
          f"peak; {f_flops / 1e9:.1f} GFLOP, {fb / 1e6:.1f} MB)", flush=True)
    print(f"kernel flash_bwd {tag}: max_abs_err {gerr:.3g} (tol one bf16 "
          f"ulp + 2e-6) kernels dq+dkv {b_ms:.4f} ms (eager call "
          f"{b_call:.4f} ms), plain {b_plain:.4f} ms, library (SDPA's "
          f"backward: forward and backward less the forward, graph replay) "
          f"{b_lib:.4f} ms (rounds {', '.join(f'{x:.4f}' for x in b_libs)})"
          f", bound {bb_ms:.5f} ms ({b_by}, bf16 tensor peak; "
          f"{b_flops / 1e9:.1f} GFLOP, {bb / 1e6:.1f} MB)", flush=True)
    del q, k, v, do, out, lse, want, want_lse, grads, wgrads
    torch.cuda.empty_cache()
    return (dict(max_abs_err=err, ms=f_ms, eager_ms=f_call,
                 plain_ms=f_plain, bound_ms=fb_ms, bound_by=f_by,
                 library_ms=f_lib),
            dict(max_abs_err=gerr, ms=b_ms, eager_ms=b_call,
                 plain_ms=b_plain, bound_ms=bb_ms, bound_by=b_by,
                 library_ms=b_lib))


def _kernel_rows_flash(torch, dev, g):
    """flash_fwd and flash_bwd at the attn_train phase's shape (smollm-360m:
    batch 4, 15/5 heads of 64, seq 2048, causal, bf16), at gemma3-4b's
    local layers (8/4 heads of 256, window 1024: keys d256_*) and at
    stablelm-12b's 32/8 heads of 160 (seq 1024, causal: d160_*), all on
    the tc route, against their plain versions.  Every bf16 output (out, dq,
    dk, dv) within one bf16 ulp of the larger magnitude plus 2e-6; lse
    (fp32) within 2e-5 + 2e-5 |plain|.  out is held to the fp32 plain
    version (both round to bf16 fp32 sums of the same terms, which sum to
    at most max |v| in magnitude).  The gradients are held to the plain
    version's sums taken in fp64: over thousands of rows the fp32 plain
    version is itself off by up to about 1e-7 of the terms' summed
    magnitude, so where a key's terms sum to 20 (the first keys, which
    every query sees) two fp32 orders can part by more than 2e-6 while
    each is within it of the exact sum."""
    rows = {}
    # the path shape; gemma3-4b's local layers; stablelm-12b's 32/8 heads
    # of 160 (run as three 64-column panels)
    for B, H, KV, S, D, window in [(4, 15, 5, 2048, 64, None),
                                   (1, 8, 4, 2048, 256, 1024),
                                   (1, 32, 8, 1024, 160, None)]:
        fwd, bwd = _flash_row(torch, dev, g, B, H, KV, S, D, window)
        if (B, H, D) == (4, 15, 64):
            for r in (fwd, bwd):
                r.pop("eager_ms")
            rows["flash_fwd"], rows["flash_bwd"] = fwd, bwd
        else:
            for name, r in (("flash_fwd", fwd), ("flash_bwd", bwd)):
                rows[name].update({f"d{D}_{k}": r[k] for k in (
                    "max_abs_err", "ms", "plain_ms", "bound_ms",
                    "library_ms")})
    return rows


# the paged and flash calls of the archs the port added last, at the
# shapes their phases give them: (label, B, H, KV, hd, length, window, pos)
# of stablelm-12b's decode in phase stablelm_serve (32/8 heads of 160: 20
# bf16 or 10 int8 16-byte chunks a row, timed also on misaligned pools,
# the one-element layout; 4 slots, cache 544 = 512 + 32, page 16)
# and of mistral-large-123b's heads (96/8 of 128, group 12, the same
# cache; phase mistral_serve); (label, B, H, KV, S, D, window) of the decoder's
# causal self-attention in phase whisper (batch 4, 12/12 heads of 64, 448
# tokens), of phase vlm (llava-next-34b: batch 2, 56/8 heads of 128 over
# 576 patches + 512 tokens) and of phase wide_head_train (batch 1 x
# WIDE_SEQ: stablelm-12b's 32/8 heads of 160, gemma3-4b's 8/4 heads of 256
# in its local layers, window 1024, and in its global one), all on the tc
# route
PAGED_MODEL_ROWS = [
    ("stablelm", 4, 32, 8, 160, 544, None, [543] * 4),
    ("mistral", 4, 96, 8, 128, 544, None, [543] * 4),
]
FLASH_MODEL_ROWS = [("whisper", 4, 12, 12, 448, 64, None),
                    ("llava", 2, 56, 8, 1088, 128, None),
                    ("stablelm_train", 1, 32, 8, 4096, 160, None),
                    ("gemma3_local", 1, 8, 4, 4096, 256, 1024),
                    ("gemma3_global", 1, 8, 4, 4096, 256, None)]


def _kernel_rows_model_shapes(torch, dev, rows):
    """PAGED_MODEL_ROWS and FLASH_MODEL_ROWS against the plain versions
    (_paged_row, _flash_row), added to ``rows`` under their labels; a
    generator of their own leaves the other rows' inputs as they were."""
    g = torch.Generator(device=dev).manual_seed(16)
    for q8 in (False, True):
        name = "paged_gqa_q8" if q8 else "paged_gqa"
        for label, *shape in PAGED_MODEL_ROWS:
            rows[name].update(_prefixed(label, _paged_row(
                torch, dev, g, q8, label, *shape,
                scalar=label == "stablelm")))
    for label, B, H, KV, S, D, window in FLASH_MODEL_ROWS:
        fwd, bwd = _flash_row(torch, dev, g, B, H, KV, S, D, window)
        rows["flash_fwd"].update(_prefixed(label, fwd))
        rows["flash_bwd"].update(_prefixed(label, bwd))


def _kernel_rows_tp(torch, dev, rows):
    """The kernels at a tensor-parallel rank's widths (phase tp_serve):
    paged_mla(_q8) at MLA_TP_ROWS (:func:`_mla_row`), fused_ssm_fwd in
    carry form at SSM_TP_CARRY (:func:`_ssm_carry_against_plain`) and
    both SSM kernels at SSM_TP_TRAIN (:func:`_ssm_rows`), added to
    ``rows`` under their labels; a generator of their own leaves the
    other rows' inputs as they were."""
    g = torch.Generator(device=dev).manual_seed(31)
    for q8 in (False, True):
        name = "paged_mla_q8" if q8 else "paged_mla"
        for label, H in MLA_TP_ROWS:
            rows[name].update(_prefixed(label, _mla_row(
                torch, dev, g, q8, label, 4, H, 1056, [1055] * 4,
                simt=False)))
    rows["fused_ssm_fwd"].update(_ssm_carry_against_plain(
        torch, dev, g, [SSM_TP_CARRY], "tp2_carry_"))
    fwd, bwd = _ssm_rows(torch, dev, g, *SSM_TP_TRAIN)
    rows["fused_ssm_fwd"].update(_prefixed("tp2", fwd))
    rows["fused_ssm_bwd"].update(_prefixed("tp2", bwd))


def _ssm_err_within(name, got, want, atol, rtol):
    """max |got - want|; fails past atol x max|want| + rtol x |want|."""
    err = (got - want).abs()
    if not bool((err <= atol * want.abs().max() + rtol * want.abs()).all()):
        fail(f"{name}: max |kernel - plain| {err.max().item()} past atol "
             f"{atol} x max|plain| {want.abs().max().item()} + rtol {rtol}")
    return err.max().item()


#: fused_ssm_fwd's carry form (mamba_serve's prefill): the path's chunk
#: (timed) and an odd tail
SSM_CARRY_SHAPES = [(1, 256, 8192, 16), (1, 77, 8192, 16)]
#: falcon-mamba-7b at TP 2 (d_inner 8192 / 2): the carry form's chunk and
#: the training shape of both kernels
SSM_TP_CARRY, SSM_TP_TRAIN = (1, 256, 4096, 16), (4, 2048, 4096, 16)


def _ssm_carry_against_plain(torch, dev, g, shapes=SSM_CARRY_SHAPES,
                             prefix="carry_"):
    """fused_ssm_fwd in the form mamba_serve's prefill calls it (from a
    carried state h0, the final state written to h_last) at ``shapes``:
    y, the entry states and h_last against the plain version from the
    same h0 at the forward's atol 2e-5 x max|plain| / rtol 2e-5; the first
    shape timed too.  Returns its numbers under ``prefix`` for
    fused_ssm_fwd's JSON row."""
    from repro_torch.kernels.fused_ssm import ops as ssm_ops
    from repro_torch.kernels.fused_ssm import ref as ssm_ref

    for k, (B, T, di, n) in enumerate(shapes):
        dt = torch.nn.functional.softplus(
            torch.randn(B, T, di, device=dev, generator=g)) * 0.2
        x = torch.randn(B, T, di, device=dev, generator=g)
        Bm = torch.randn(B, T, n, device=dev, generator=g) * 0.5
        Cm = torch.randn(B, T, n, device=dev, generator=g) * 0.5
        A = -torch.exp(torch.randn(di, n, device=dev, generator=g) * 0.3)
        h0 = torch.randn(B, di, n, device=dev, generator=g)
        h_last, want_last = torch.empty_like(h0), torch.empty_like(h0)
        y, ent = ssm_ops.fused_ssm_fwd_kernel(dt, x, Bm, Cm, A, h0=h0,
                                              h_last=h_last)
        yp, entp = ssm_ref.fused_ssm_fwd_ref(dt, x, Bm, Cm, A, ssm_ops.CHUNK,
                                             h0=h0, h_last=want_last)
        torch.cuda.synchronize()
        tag = f"fused_ssm_fwd carry (B {B}, T {T}, d_inner {di}, d_state {n})"
        errs = {k: _ssm_err_within(f"{tag} {k}", a, w, 2e-5, 2e-5)
                for k, a, w in (("y", y, yp), ("h_entries", ent, entp),
                                ("h_last", h_last, want_last))}
        print(f"kernel {tag} fp32 from a random h0: max_abs_err "
              + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
              + " (tol 2e-5 x max|plain| "
              + " / ".join(f"{w.abs().max().item():.3g}"
                           for w in (yp, entp, want_last))
              + " + 2e-5 rel)", flush=True)
        if k == 0:
            ins = (dt, x, Bm, Cm, A)

            def kernel():
                ssm_ops.fused_ssm_fwd_kernel(*ins, h0=h0, h_last=h_last)
            ms = device_ms(torch, kernel, 50)
            call_ms = eager_ms(torch, kernel, 50)
            plain_ms = device_ms(torch, lambda: ssm_ref.fused_ssm_fwd_ref(
                *ins, ssm_ops.CHUNK, h0=h0, h_last=want_last), 2)
            # the reference's forward cost at 4 bytes an element, plus h0
            # read and h_last written once
            flops, bytes_ = ssm_ops.cost_model(B, T, di, n, train=False,
                                               dtype_bytes=4)
            bytes_ += 2 * B * di * n * 4
            b_ms, by = bound(bytes_, flops)
            print(f"kernel {tag} fp32 carry form: kernel {ms:.4f} ms (eager "
                  f"call {call_ms:.4f} ms), plain {plain_ms:.4f} ms, "
                  f"library none, bound {b_ms:.5f} ms ({by}; "
                  f"{flops / 1e9:.3f} GFLOP, {bytes_ / 1e6:.1f} MB; "
                  f"{b_ms / ms:.1%} of it)", flush=True)
            row = {f"{prefix}{key}": v for key, v in dict(
                ms=ms, eager_ms=call_ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=by, library_ms=None,
                max_abs_err=max(errs.values())).items()}
        del dt, x, Bm, Cm, A, h0, h_last, want_last, y, ent, yp, entp
    return row


def _ssm_against_plain(torch, ins, dy, what):
    """fused_ssm_fwd and fused_ssm_bwd on ``ins`` = (dt, x, Bm, Cm, A) and
    dy against their plain versions on the same inputs: y and the entry
    states at the reference's atol 2e-5 / rtol 2e-5, the gradients at
    5e-5 / 5e-4, atol scaled by the largest magnitude of the plain result
    (the gradients sum over thousands of steps and channels).  Returns
    ({output: max |kernel - plain|}, {output: max |plain|}, the kernel's
    entry states)."""
    from repro_torch.kernels.fused_ssm import ops as ssm_ops
    from repro_torch.kernels.fused_ssm import ref as ssm_ref

    y, ent = ssm_ops.fused_ssm_fwd_kernel(*ins)
    yp, entp = ssm_ref.fused_ssm_fwd_ref(*ins, ssm_ops.CHUNK)
    grads = ssm_ops.fused_ssm_bwd_kernel(*ins, ent, dy)
    wgrads = ssm_ref.fused_ssm_bwd_ref(*ins, entp, dy, ssm_ops.CHUNK)
    torch.cuda.synchronize()
    errs = {"y": _ssm_err_within(f"fused_ssm_fwd {what} y", y, yp, 2e-5,
                                 2e-5),
            "h_entries": _ssm_err_within(f"fused_ssm_fwd {what} h_entries",
                                         ent, entp, 2e-5, 2e-5)}
    for name, a, w in zip(("ddt", "dx", "dB", "dC", "dA"), grads, wgrads):
        errs[name] = _ssm_err_within(f"fused_ssm_bwd {what} {name}", a, w,
                                     5e-5, 5e-4)
    scale = {k: v.abs().max().item() for k, v in zip(
        ("y", "h_entries", "ddt", "dx", "dB", "dC", "dA"),
        (yp, entp) + tuple(wgrads))}
    return errs, scale, ent


def _ssm_errs_line(errs, scale):
    return (f"max_abs_err y {errs['y']:.3g}, h_entries "
            f"{errs['h_entries']:.3g} (tol 2e-5 x max|plain| {scale['y']:.3g}"
            f" / {scale['h_entries']:.3g} + 2e-5 rel); "
            + ", ".join(f"{k} {errs[k]:.3g} (max|plain| {scale[k]:.3g})"
                        for k in ("ddt", "dx", "dB", "dC", "dA"))
            + " (tol 5e-5 x max|plain| + 5e-4 rel)")


def _ssm_rows(torch, dev, g, B, T, di, n):
    """fused_ssm_fwd and fused_ssm_bwd at (B, T, d_inner, d_state), fp32,
    against their plain versions on the same inputs
    (_ssm_against_plain), timed beside them and their bounds, with what
    the build made of each kernel (registers, local bytes, resident blocks
    an SM) and the dB/dC partial bytes a backward call writes -> (the
    forward's row, the backward's)."""
    from repro_torch.kernels.fused_ssm import ops as ssm_ops
    from repro_torch.kernels.fused_ssm import ref as ssm_ref

    dt = torch.nn.functional.softplus(
        torch.randn(B, T, di, device=dev, generator=g)) * 0.2
    x = torch.randn(B, T, di, device=dev, generator=g)
    Bm = torch.randn(B, T, n, device=dev, generator=g) * 0.5
    Cm = torch.randn(B, T, n, device=dev, generator=g) * 0.5
    A = -torch.exp(torch.randn(di, n, device=dev, generator=g) * 0.3)
    dy = torch.randn(B, T, di, device=dev, generator=g)
    ins = (dt, x, Bm, Cm, A)
    tag = f"(B {B}, T {T}, d_inner {di}, d_state {n}) fp32"
    errs, scale, ent = _ssm_against_plain(torch, ins, dy, tag)

    def fwd():
        ssm_ops.fused_ssm_fwd_kernel(*ins)

    def bwd():
        ssm_ops.fused_ssm_bwd_kernel(*ins, ent, dy)
    f_ms, f_call = device_ms(torch, fwd, 10), eager_ms(torch, fwd, 10)
    b_ms, b_call = device_ms(torch, bwd, 5), eager_ms(torch, bwd, 5)
    f_plain = device_ms(torch, lambda: ssm_ref.fused_ssm_fwd_ref(
        *ins, ssm_ops.CHUNK), 1)
    b_plain = device_ms(torch, lambda: ssm_ref.fused_ssm_bwd_ref(
        *ins, ent, dy, ssm_ops.CHUNK), 1)
    # bounds from the reference's cost model at 4 bytes an element: each
    # input read and each output written once, the residual states at the
    # reference's 256-step spacing (not this kernel's CHUNK, a design
    # choice); the backward is the training totals less the forward's.
    # Flops 6 per (t, d, n) forward, 15 backward
    ff, f_bytes = ssm_ops.cost_model(B, T, di, n, train=False,
                                     dtype_bytes=4)
    tf, t_bytes = ssm_ops.cost_model(B, T, di, n, train=True,
                                     dtype_bytes=4)
    b_bytes = t_bytes - f_bytes
    fb_ms, f_by = bound(f_bytes, ff)
    bb_ms, b_by = bound(b_bytes, tf - ff)
    built = {}
    for which in ("fwd", "bwd"):
        i = ssm_ops.kernel_info(which, n)
        built[which] = (f"{i['registers']} registers, {i['local_bytes']} "
                        f"local bytes a thread, {i['blocks_per_sm']} "
                        f"resident block(s) an SM of {i['threads']} "
                        f"threads, {i['smem_bytes']} B shared")
    p_mb = ssm_ops.partial_bytes(B, T, di, n) / 1e6
    print(f"kernel fused_ssm_fwd {tag}: kernel {f_ms:.4f} ms (eager "
          f"call {f_call:.4f} ms), plain {f_plain:.4f} ms, library none, "
          f"bound {fb_ms:.5f} ms ({f_by}; {ff / 1e9:.2f} GFLOP, "
          f"{f_bytes / 1e6:.1f} MB; {fb_ms / f_ms:.1%} of it); build: "
          f"{built['fwd']}", flush=True)
    print(f"kernel fused_ssm_bwd {tag}: kernel {b_ms:.4f} ms (eager "
          f"call {b_call:.4f} ms, partial sums included), plain "
          f"{b_plain:.4f} ms, library none, bound {bb_ms:.5f} ms "
          f"({b_by}; {(tf - ff) / 1e9:.2f} GFLOP, {b_bytes / 1e6:.1f} "
          f"MB; {bb_ms / b_ms:.1%} of it); dB/dC partials {p_mb:.1f} MB "
          f"a call ({ssm_ops.d_blocks(di, n)} rows a batch row); build: "
          f"{built['bwd']}", flush=True)
    print(f"kernel fused_ssm {tag}: {_ssm_errs_line(errs, scale)}",
          flush=True)
    del dt, x, Bm, Cm, A, dy, ins, ent
    torch.cuda.empty_cache()
    # no single PyTorch call computes a selective scan: library none
    return (dict(max_abs_err=max(errs["y"], errs["h_entries"]), ms=f_ms,
                 eager_ms=f_call, plain_ms=f_plain, bound_ms=fb_ms,
                 bound_by=f_by, library_ms=None),
            dict(max_abs_err=max(errs[k] for k in ("ddt", "dx", "dB", "dC",
                                                   "dA")),
                 ms=b_ms, eager_ms=b_call, plain_ms=b_plain, bound_ms=bb_ms,
                 bound_by=b_by, library_ms=None))


def _kernel_rows_ssm(torch, dev, g):
    """fused_ssm_fwd and fused_ssm_bwd (:func:`_ssm_rows`) at the
    mamba_train phase's shape (falcon-mamba-7b: batch 4, seq 2048,
    d_inner 8192, d_state 16, fp32), the JSON rows, and at an odd one (T
    and d_inner off the kernels' 32-step chunks and 256-channel
    blocks)."""
    rows = {}
    for shape in [(4, 2048, 8192, 16), (3, 1000, 1000, 16)]:
        fwd, bwd = _ssm_rows(torch, dev, g, *shape)
        if shape[0] == 4:
            for row in (fwd, bwd):
                row.pop("eager_ms")
            rows["fused_ssm_fwd"], rows["fused_ssm_bwd"] = fwd, bwd
    return rows


def _mla_simt(torch, kern, tag, inputs, kw, sk):
    """The simt route (paged_mla.cuh) of one MLA wrapper on the same bf16
    inputs, reached through the route rule: q_abs one element off 16-byte
    alignment.  Held against the plain version at one bf16 ulp + 2e-6; it
    must count in launches and not in launches_tc -> (max |kernel -
    plain|, a call of it)."""
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.paged_attention import ref as pa_ref

    qa, qr, pc, pr, sc, bt, pos_t = inputs
    buf = torch.empty(qa.numel() + 1, dtype=qa.dtype, device=qa.device)
    qa = buf[1:].view(qa.shape).copy_(qa)
    route = pa_ops.mla_route(
        qa.dtype, pc.dtype, qa.shape[2], qr.shape[2], pc.shape[1],
        all(t.data_ptr() % 16 == 0 for t in (qa, qr, pc, pr)))
    n0, tc0 = kern.launches, kern.launches_tc
    got = kern(qa, qr, pc, pr, *sc, bt, pos_t, **kw)
    moved = (kern.launches - n0, kern.launches_tc - tc0)
    tag = f"{tag} unaligned bf16 q, simt route"
    if route != "simt" or moved != (1, 0):
        fail(f"{tag}: route {route}, (launches, launches_tc) moved by "
             f"{moved}, not (1, 0)")
    want = pa_ref.paged_mla_ref(qa, qr, pc, pr, bt, pos_t, **kw, **sk)
    torch.cuda.synchronize()
    n_bad, err = _past_bf16_ulp(torch, got, want)
    if n_bad:
        fail(f"{tag}: |kernel - plain| exceeds one bf16 ulp + 2e-6 at "
             f"{n_bad} outputs (max {err})")
    print(f"kernel {tag}: max_abs_err {err:.3g} (tol one bf16 ulp + 2e-6)",
          flush=True)
    return err, lambda: kern(qa, qr, pc, pr, *sc, bt, pos_t, **kw)


def _mla_simt_f32(torch, kern, tag, inputs, kw, sk, q8):
    """The simt route on fp32 queries (bf16 pages widened to fp32; int8
    pages as they are), held to the function evaluated in fp64 from the
    same operands (``paged_mla_ref(acc=torch.float64)``) at the contract's
    2e-6: the fp32 plain version's cuBLAS sums are farther from it than
    the kernel is -> max |kernel - fp64|."""
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.paged_attention import ref as pa_ref

    qa, qr, pc, pr, sc, bt, pos_t = inputs
    qa, qr = qa.float(), qr.float()
    if not q8:
        pc, pr = pc.float(), pr.float()
    n0, tc0 = kern.launches, kern.launches_tc
    got = kern(qa, qr, pc, pr, *sc, bt, pos_t, **kw)
    moved = (kern.launches - n0, kern.launches_tc - tc0)
    tag = f"{tag} fp32 q, simt route"
    if moved != (1, 0) or pa_ops.mla_route(
            qa.dtype, pc.dtype, qa.shape[2], qr.shape[2], pc.shape[1],
            True) != "simt":
        fail(f"{tag}: (launches, launches_tc) moved by {moved}, not (1, 0)")
    want = pa_ref.paged_mla_ref(qa, qr, pc, pr, bt, pos_t, **kw, **sk,
                                acc=torch.float64)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    if not err <= 2e-6:
        fail(f"{tag}: |kernel - fp64| max {err:.3g} > 2e-6")
    print(f"kernel {tag}: max |kernel - fp64 sums| {err:.3g} (tol 2e-6)",
          flush=True)
    return err


def _mla_row(torch, dev, g, q8, label, B, H, length, pos, simt):
    """One paged MLA kernel row (kv_lora 512, rope 64, page 16, bf16
    queries: the tc route) against the plain version at one bf16 ulp of
    the output plus 2e-6, timed beside the plain version, one SDPA call
    over the dense latent view and the bound; with ``simt`` the simt
    route too, on bf16 queries (:func:`_mla_simt`) and on fp32 queries
    against fp64 sums (:func:`_mla_simt_f32`)."""
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.paged_attention import ref as pa_ref
    from repro_torch.launch.mla_shapes import mla_inputs

    sdpa = torch.nn.functional.scaled_dot_product_attention
    r, dr, ps = 512, 64, 16
    scale = 1.0 / (128 + 64) ** 0.5      # 1 / sqrt(nope + rope)
    name = "paged_mla_q8" if q8 else "paged_mla"
    kern = pa_ops.paged_mla_q8_kernel if q8 else pa_ops.paged_mla_kernel
    qa, qr, pc, pr, sc, bt, pos_t = mla_inputs(
        dev, g, B, H, length, pos, q8, ps=ps, r=r, dr=dr)
    route = pa_ops.mla_route(
        qa.dtype, pc.dtype, r, dr, ps,
        all(t.data_ptr() % 16 == 0 for t in (qa, qr, pc, pr)))
    kw = dict(length=length, scale=scale)
    sk = dict(zip(("ckv_scale", "krope_scale"), sc))
    tc0 = kern.launches_tc
    got = kern(qa, qr, pc, pr, *sc, bt, pos_t, **kw)
    if route != "tc" or kern.launches_tc - tc0 != 1:
        fail(f"{name} {label}: not on the tc route ({route}; "
             f"launches_tc moved by {kern.launches_tc - tc0})")
    want = pa_ref.paged_mla_ref(qa, qr, pc, pr, bt, pos_t, **kw, **sk)
    torch.cuda.synchronize()
    n_bad, err = _past_bf16_ulp(torch, got, want)
    del got, want
    tag = (f"{name} {label} (B {B}, H {H}, r {r}, dr {dr}, page {ps}, "
           f"length {length}, pos {pos if B < 8 else pos[0]}) bf16 "
           f"q, {route} route")
    if n_bad:
        fail(f"{tag}: |kernel - plain| exceeds one bf16 ulp + 2e-6 "
             f"at {n_bad} outputs (max {err})")
    row = {}
    if simt:
        inputs = (qa, qr, pc, pr, sc, bt, pos_t)
        simt_err, simt_call = _mla_simt(torch, kern, f"{name} {label}",
                                        inputs, kw, sk)
        row["simt_max_abs_err"] = simt_err
        row["simt_f32_max_abs_err_fp64"] = _mla_simt_f32(
            torch, kern, f"{name} {label}", inputs, kw, sk, q8)
        row["simt_ms"] = device_ms(torch, simt_call, 50)
        print(f"kernel {name} {label} simt route (unaligned bf16 q): "
              f"{row['simt_ms']:.4f} ms", flush=True)
        del simt_call

    def kernel():
        kern(qa, qr, pc, pr, *sc, bt, pos_t, **kw)
    ms = device_ms(torch, kernel, 100)
    call_ms = eager_ms(torch, kernel, 100)
    plain_ms = device_ms(torch, lambda: pa_ref.paged_mla_ref(
        qa, qr, pc, pr, bt, pos_t, **kw, **sk), 10)
    # yardstick the port never calls: one SDPA call over the gathered
    # dense (dequantized) latent view, q = [q_abs, q_rope], k = [ckv,
    # krope], v = ckv: one head, the H query heads (which share the
    # latent) along the query axis
    if q8:
        cd = pa_ref.gather_dequant(pc, sc[0], bt, length, torch.bfloat16)
        rd = pa_ref.gather_dequant(pr, sc[1], bt, length, torch.bfloat16)
    else:
        cd = pa_ref.gather_pages(pc, bt, length)
        rd = pa_ref.gather_pages(pr, bt, length)
    qd = torch.cat([qa, qr], dim=-1)[:, None]
    kd = torch.cat([cd, rd], dim=-1)[:, None]
    vd = cd[:, None]
    _kp, valid = pa_ref.paged_positions(pos_t, length)
    mask = valid[:, None, None, :]
    library_ms = device_ms(torch, lambda: sdpa(
        qd, kd, vd, attn_mask=mask, scale=scale), 100 if B < 8 else 20)
    # bytes and flops that this run's positions need: each row's live
    # latent pages, q and out, the block table
    flops = bytes_ = 0
    for p in pos:
        f, b = pa_ops.cost_model_mla(
            1, H, r, dr, live_tokens=p + 1, page_size=ps,
            dtype_bytes=1 if q8 else 2, scale_bytes=4 if q8 else 0)
        flops, bytes_ = flops + f, bytes_ + b
    b_ms, by = bound(bytes_, flops, PEAK_BF16_TENSOR_FLOPS)
    print(f"kernel {tag}: max_abs_err {err:.3g} (tol one bf16 ulp "
          f"+ 2e-6) kernel {ms:.4f} ms (eager call {call_ms:.4f} "
          f"ms), plain {plain_ms:.4f} ms, library (SDPA on the "
          f"dense latent view) {library_ms:.4f} ms, bound "
          f"{b_ms:.5f} ms ({by}, bf16 tensor peak; "
          f"{flops / 1e9:.2f} GFLOP, {bytes_ / 1e6:.2f} MB; "
          f"{b_ms / ms:.1%} of it)", flush=True)
    del qa, qr, pc, pr, sc, bt, pos_t, cd, rd, qd, kd, vd, mask
    torch.cuda.empty_cache()
    return dict(max_abs_err=err, ms=ms, eager_ms=call_ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=by, library_ms=library_ms,
                mla_route=route, **row)


#: the paged MLA rows at a tensor-parallel rank's heads: deepseek-v3-671b
#: at TP 2 and TP 4 (128 heads / 2, / 4) at the path's B 4, cache 1056
MLA_TP_ROWS = [("tp2", 64), ("tp4", 32)]


def _kernel_rows_mla(torch, dev, g):
    """paged_mla and paged_mla_q8 at mla_shapes.MLA_SHAPES
    (:func:`_mla_row`; the simt route at the path and odd shapes), the
    build's registers, spills and resident CTAs of each tc
    instantiation first."""
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.launch.mla_shapes import MLA_SHAPES

    rows = {}
    for q8 in (False, True):
        name = "paged_mla_q8" if q8 else "paged_mla"
        info = pa_ops.mla_kernel_info(q8)
        print(f"kernel {name} tc route build: {info['registers']} registers, "
              f"{info['local_bytes']} local (spill) bytes a thread, "
              f"{info['smem_bytes']} B dynamic shared memory, "
              f"{info['blocks_per_sm']} CTA(s) of {info['threads']} threads "
              "resident an SM", flush=True)
        if info["local_bytes"]:
            fail(f"{name}: the tc route spills ({info})")
    for q8 in (False, True):
        name = "paged_mla_q8" if q8 else "paged_mla"
        for label, B, H, length, pos in MLA_SHAPES:
            row = _mla_row(torch, dev, g, q8, label, B, H, length, pos,
                           simt=label != "long")
            if label == "path":
                row.pop("eager_ms")
                rows[name] = row
            elif label == "long":
                rows[name].update(long_ms=row["ms"],
                                  long_bound_ms=row["bound_ms"],
                                  long_library_ms=row["library_ms"])
    return rows


#: (M, K, N) of the IMC rows: the largest shape of
#: benchmarks/imc_throughput.py, and two ragged ones
IMC_SHAPES = [(4096, 1024, 1024), (17, 70, 50), (5, 300, 129)]


def _imc_inputs(torch, dev, g, M, K, N):
    x = (torch.rand(M, K, device=dev, generator=g) > 0.5).float()
    codes = torch.randint(0, 4, (K, N), device=dev, generator=g,
                          dtype=torch.int8)
    scale = torch.rand(N, device=dev, generator=g) * 0.3 + 0.01
    return x, codes, scale


def _imc_close(torch, got, want):
    """(within the reference's 1e-5 atol and rtol, max |got - want|)."""
    err = (got - want).abs()
    return bool((err <= 1e-5 + 1e-5 * want.abs()).all()), err.max().item()


def _kernel_rows_imc(torch, dev, g):
    """imc_mvm at the imc phase's shapes against the plain version (the
    reference's 1e-5), and bitwise against the simt entry point."""
    from repro_torch.kernels import build
    from repro_torch.kernels.imc_mvm import ops as imc_ops
    from repro_torch.kernels.imc_mvm import ref as imc_ref

    rows = {}
    for M, K, N in IMC_SHAPES:
        x, codes, scale = _imc_inputs(torch, dev, g, M, K, N)
        route = imc_ops.route(M, K, N, x.data_ptr(), codes.data_ptr())
        got = imc_ops.imc_mvm_kernel(x, codes, scale)
        simt = torch.empty_like(got)
        lib = build.load("imc_mvm")

        def simt_call():
            build.check(lib.imc_mvm_f32(
                x.data_ptr(), codes.data_ptr(), scale.data_ptr(),
                simt.data_ptr(), M, K, N,
                torch.cuda.current_stream().cuda_stream), "imc_mvm")
        simt_call()
        want = imc_ref.imc_mvm_ref(x, codes, scale)
        torch.cuda.synchronize()
        ok, err = _imc_close(torch, got, want)
        tag = f"imc_mvm (M {M}, K {K}, N {N}) fp32, {route} route"
        if not ok:
            fail(f"{tag}: max |kernel - plain| = {err} past 1e-5 + 1e-5 rel")
        # binary x: the tc route's bf16 product is exact, so both routes
        # agree bit for bit
        if not torch.equal(got.view(torch.int32), simt.view(torch.int32)):
            fail(f"{tag}: differs from the simt route")

        def kernel():
            imc_ops.imc_mvm_kernel(x, codes, scale)
        ms = device_ms(torch, kernel, 50)
        simt_ms = device_ms(torch, simt_call, 50)
        call_ms = eager_ms(torch, kernel, 50)
        plain_ms = device_ms(torch, lambda: imc_ref.imc_mvm_ref(
            x, codes, scale), 20)
        # yardstick the port never calls: one fp32 matmul with the weight
        # dequantized (scale included) outside the timed region, then 1/K
        w = imc_ref.dequantize_codes(codes, scale)
        library_ms = device_ms(torch, lambda: torch.matmul(x, w) * (1.0 / K),
                               50)
        # a reference point only (its output is bf16, not the function's
        # fp32): the same product as one bf16 matmul
        xb, wb = x.bfloat16(), w.bfloat16()
        bf16_ms = device_ms(torch, lambda: torch.matmul(xb, wb), 50)
        # x and y in fp32, the int8 codes and the scales, each once; the
        # product is exact in bf16, so its operations count at that peak
        bytes_ = M * K * 4 + K * N + N * 4 + M * N * 4
        flops = 2 * M * K * N
        b_ms, by = bound(bytes_, flops, PEAK_BF16_TENSOR_FLOPS)
        print(f"kernel {tag}: max_abs_err {err:.3g} (tol 1e-5 + 1e-5 rel; "
              f"bitwise the simt route's) kernel {ms:.5f} ms (simt route "
              f"{simt_ms:.5f} ms; eager call {call_ms:.4f} ms), plain "
              f"{plain_ms:.4f} ms, library (one fp32 matmul with the "
              f"dequantized weight) {library_ms:.5f} ms (bf16 matmul, "
              f"reference point only: {bf16_ms:.5f} ms), bound {b_ms:.5f} "
              f"ms ({by}, bf16 tensor peak; {flops / 1e9:.2f} GFLOP, "
              f"{bytes_ / 1e6:.2f} MB)", flush=True)
        if (M, K, N) == IMC_SHAPES[0]:
            rows["imc_mvm"] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=by, library_ms=library_ms, imc_route=route,
                simt_ms=simt_ms, bf16_matmul_ms=bf16_ms)
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
    layers = len(MINIMALIST_SMNIST_DIMS) - 1
    if launches != 784 * layers:
        fail(f"stream: minimalist_step launches {launches} != 784 frames x "
             f"{layers} layers")
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
    from repro_torch.kernels.minimalist_block import ref as mb_ref
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

    # the paper's network at its own widths (seeded weights) exported and
    # replayed closed loop through the fused kernel over the 256 test
    # streams at T 784, binarised as above: each layer bit for bit
    # against the plain version on the same inputs
    pnet = MinimalistNetwork(MINIMALIST_SMNIST_DIMS,
                             qcfg=QuantConfig.hardware(), device=dev)
    pnet.reset_parameters(torch.Generator(device=dev).manual_seed(2))
    paper = [mb_ops.from_block_params(b) for b in pnet.blocks]
    xs = torch.from_numpy((xte > 0.5).astype(np.float32)).to(dev)

    def replay():
        outs, out = [], xs
        for ex in paper:
            out, h = mb_ops.minimalist_block(out, *ex)
            outs.append((out, h))
        return outs
    mb_ops.minimalist_block_kernel.launches = 0
    outs = replay()
    paper_launches = mb_ops.minimalist_block_kernel.launches
    if paper_launches != len(paper):
        fail(f"system: paper replay launched minimalist_block "
             f"{paper_launches} times, not {len(paper)}")
    layer_in = xs
    for li, (ex, (y, h)) in enumerate(zip(paper, outs)):
        yp, hp = mb_ref.minimalist_block_ref(
            layer_in, *ex, torch.zeros(xs.shape[0], ex[0].shape[1],
                                       device=dev))
        if not (torch.equal(h, hp) and torch.equal(y, yp)):
            fail(f"system: paper replay layer {li} differs from the plain "
                 f"version (max |h - plain| "
                 f"{(h - hp).abs().max().item():.3g})")
        layer_in = y
    del outs, yp, hp, y, h, layer_in
    replay_ms = device_ms(torch, replay, 5)
    replay_eager_ms = eager_ms(torch, replay, 5)
    print(f"system: paper replay {MINIMALIST_SMNIST_DIMS} over "
          f"{xs.shape[0]} streams x T {xs.shape[1]}: {paper_launches} "
          f"minimalist_block launches, every layer bitwise equal to the "
          f"plain version; five launches {replay_ms:.4f} ms in graph "
          f"replay ({replay_eager_ms:.4f} ms eager)", flush=True)
    torch.cuda.empty_cache()

    # QAT speed at the paper's dims and sequence length
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
    return launches + paper_launches


def _serve_paged(torch, model, prompts, gen_tokens, *, prefix_cache=False,
                 prefill_chunk=256, mesh=None):
    """One run of the paged serving path through the entry points a user
    calls (build_engine with a paged ServeConfig; on ``mesh`` when one is
    given)."""
    from repro_torch.configs import ServeConfig
    from repro_torch.launch.serve import build_engine
    from repro_torch.serve import Telemetry

    eng = build_engine(model, ServeConfig(
        slots=4, max_len=256, prefill_chunk=prefill_chunk, kv_layout="paged",
        page_size=16, prefix_cache=prefix_cache), telemetry=Telemetry(),
        mesh=mesh)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = [eng.submit(p, max_new_tokens=gen_tokens) for p in prompts]
    eng.run()
    torch.cuda.synchronize()
    return eng, reqs, time.perf_counter() - t0


def _check_drained(eng, what):
    if eng.prefix_cache is not None:
        eng.prefix_cache.clear()
    pool = eng.pool
    if pool.pages_in_use or pool.reserved_total or len(pool._free) \
            != pool.num_pages:
        fail(f"paged: {what}: pool not drained ({pool.pages_in_use} pages "
             f"in use, {pool.reserved_total} reserved)")


def _first_divergence(a, b):
    import numpy as np
    diff = np.flatnonzero(np.asarray(a) != np.asarray(b))
    return int(diff[0]) if len(diff) else None


def phase_paged(torch, dev):
    """Full-width smollm-360m served from a paged KV cache."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.models import build_model

    cfg = get_config("smollm-360m")
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(0))

    def variant(**kw):
        other = build_model(dataclasses.replace(cfg, **kw), device=dev)
        other.load_state_dict(model.state_dict())
        return other
    torch.cuda.synchronize()
    print(f"paged: {cfg.name} ({sum(p.numel() for p in model.parameters())} "
          f"params, {cfg.n_layers} layers, d {cfg.d_model}, heads "
          f"{cfg.n_heads}/{cfg.n_kv_heads}) built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    rng = np.random.default_rng(0)
    plens = [71, 97, 130, 150, 165, 181, 190, 75]     # not page-aligned
    prompts = [rng.integers(0, cfg.vocab, size=p) for p in plens]
    gen_tokens = 32
    _serve_paged(torch, model, prompts[:4], 2)       # warm-up (cuBLAS etc.)

    def measured(m, tag, kernel):
        torch.cuda.reset_peak_memory_stats(dev)
        pa_ops.paged_gqa_kernel.launches = 0
        pa_ops.paged_gqa_q8_kernel.launches = 0
        eng, reqs, dt = _serve_paged(torch, m, prompts, gen_tokens)
        launches = kernel.launches if kernel is not None else (
            pa_ops.paged_gqa_kernel.launches
            + pa_ops.paged_gqa_q8_kernel.launches)
        peak_gb = torch.cuda.max_memory_allocated(dev) / 2**30
        for r in reqs:
            toks = r.tokens
            if not r.finished or len(toks) != gen_tokens:
                fail(f"paged {tag}: request {r.uid} finished={r.finished} "
                     f"with {len(toks)} tokens")
            if not ((toks >= 0) & (toks < cfg.vocab)).all():
                fail(f"paged {tag}: request {r.uid} emitted a token outside "
                     "the vocab")
        pool_b = sum(t.numel() * t.element_size() for layer in eng.state
                     for t in layer.values())
        ttft = sorted((r.first_token_t - r.created_t) * 1e3 for r in reqs)
        stp = eng.telemetry.registry.histograms["step_ms"].summary()
        n_gen = sum(len(r.tokens) for r in reqs)
        print(f"paged {tag}: {len(reqs)} requests, {n_gen} tokens in "
              f"{dt:.3f} s ({n_gen / dt:.1f} generated tok/s incl. prefill),"
              f" TTFT p50 {ttft[len(ttft) // 2]:.1f} ms max {ttft[-1]:.1f} "
              f"ms, {eng.n_steps} decode steps p50 {stp['p50']:.2f} ms, peak "
              f"memory {peak_gb:.2f} GiB, pool {eng.pool.num_pages} pages = "
              f"{pool_b / 2**20:.2f} MiB, kernel launches {launches}; "
              f"distinct tokens per stream "
              f"{[len(set(r.tokens.tolist())) for r in reqs]}", flush=True)
        _check_drained(eng, tag)
        return eng, reqs, launches

    # (a) bf16 pages through the paged_gqa kernel
    eng, reqs, launches = measured(model, "bf16 kernel",
                                   pa_ops.paged_gqa_kernel)
    if pa_ops.paged_gqa_q8_kernel.launches:
        fail("paged bf16: the int8 kernel was launched")
    if launches == 0 or launches != cfg.n_layers * eng.n_steps:
        fail(f"paged bf16: paged_gqa launches {launches} != {cfg.n_layers} "
             f"layers x {eng.n_steps} decode steps")
    print(f"paged: paged_gqa launches {launches} = {cfg.n_layers} layers x "
          f"{eng.n_steps} decode steps", flush=True)
    # one 4-slot decode step at position 200: called eagerly vs its kernels
    # replayed from a CUDA graph; the difference is time the card waits
    # for the host
    n_pages = eng.pool.num_pages
    state = model.init_paged_cache(n_pages, 16)
    tok = torch.zeros(4, 1, dtype=torch.int64, device=dev)
    pos = torch.full((4,), 200, dtype=torch.int32, device=dev)
    bt = torch.arange(n_pages, dtype=torch.int32, device=dev).reshape(4, -1)
    act = torch.ones(4, dtype=torch.bool, device=dev)
    rows = torch.arange(4, device=dev)

    def step():
        model.decode_step_paged(tok, state, pos, bt, act, 256, rows=rows)
    with torch.inference_mode():
        step_eager = eager_ms(torch, step, 10)
        step_dev = device_ms(torch, step, 10)
    print(f"paged: decode_step_paged (4 slots, pos 200): eager "
          f"{step_eager:.2f} ms, device {step_dev:.2f} ms -> card idle "
          f"{1 - step_dev / step_eager:.1%} of an eager step", flush=True)
    del state

    def against_gather(tag, reqs, gm):
        """Serve the same traffic through the gather read of ``gm``; the
        kernel streams ``reqs`` must equal its streams up to the first
        token where the gather model's top-2 margin is <= 0.1."""
        geng, greqs, glaunch = measured(gm, f"{tag} gather", None)
        if glaunch:
            fail(f"paged {tag} gather: {glaunch} paged kernel launches")
        n_div = 0
        for r, gr in zip(reqs, greqs):
            i = _first_divergence(r.tokens, gr.tokens)
            if i is None:
                continue
            n_div += 1
            ctx = np.concatenate([r.prompt, r.tokens[:i]]).astype(np.int64)
            last, _ = geng.sm.prefill(ctx[None, :])
            top2 = torch.topk(last[0, :cfg.vocab].float(), 2).values
            margin = (top2[0] - top2[1]).item()
            if margin > 0.1:
                fail(f"paged {tag}: request {r.uid} diverges from the gather "
                     f"read at token {i} where the top-2 margin is "
                     f"{margin:.3f} > 0.1")
            print(f"paged {tag}: request {r.uid} parts from the gather "
                  f"stream at token {i} (gather top-2 margin {margin:.4f} "
                  "<= 0.1)")
        print(f"paged {tag}: kernel greedy tokens match the gather read's in "
              f"{len(reqs) - n_div}/{len(reqs)} requests end to end",
              flush=True)

    # (b) the same traffic through the dense-gather read
    against_gather("bf16", reqs, variant(paged_impl="gather"))

    # (c) int8 pages through the paged_gqa_q8 kernel
    qmodel = variant(kv_dtype="int8")
    qeng, qreqs, q8_launches = measured(qmodel, "int8 kernel",
                                        pa_ops.paged_gqa_q8_kernel)
    if pa_ops.paged_gqa_kernel.launches:
        fail("paged int8: the bf16 kernel was launched")
    if q8_launches == 0 or q8_launches != cfg.n_layers * qeng.n_steps:
        fail(f"paged int8: paged_gqa_q8 launches {q8_launches} != "
             f"{cfg.n_layers} layers x {qeng.n_steps} decode steps")
    same = sum(int(np.sum(np.asarray(a.tokens) == np.asarray(b.tokens)))
               for a, b in zip(reqs, qreqs))
    firsts = [_first_divergence(a.tokens, b.tokens) for a, b in
              zip(reqs, qreqs)]
    print(f"paged: int8 greedy tokens equal bf16's at {same}/"
          f"{len(reqs) * gen_tokens} positions; first divergence per request "
          f"{firsts}", flush=True)
    del qmodel, qeng

    # (b') random weights give one-token greedy streams (the tied head
    # reads each input's own embedding off the residual), so the kernel
    # is also compared with the gather read on a sharpened copy: every
    # layer's output projections x32 (the CPU tests' smoke models need x4;
    # at d 960 the streams vary from about x16 on)
    sharp = variant()
    with torch.no_grad():
        for layer in sharp.layers:
            layer.mixer.wo.mul_(32.0)
            layer.mlp.w_down.mul_(32.0)
    _seng, sreqs, _ = measured(sharp, "sharpened bf16 kernel",
                               pa_ops.paged_gqa_kernel)
    sgather = variant(paged_impl="gather")
    sgather.load_state_dict(sharp.state_dict())
    against_gather("sharpened", sreqs, sgather)
    del sharp, sgather

    # (d) a shared 128-token prefix, with and without the prefix cache
    prefix = rng.integers(0, cfg.vocab, size=128)
    shared = [np.concatenate([prefix, rng.integers(0, cfg.vocab, size=t)])
              for t in (9, 21, 40, 57)]
    streams = []
    for cache in (False, True):
        peng, preqs, pdt = _serve_paged(torch, model, shared, gen_tokens,
                                        prefix_cache=cache,
                                        prefill_chunk=64)
        ttft = sorted((r.first_token_t - r.created_t) * 1e3 for r in preqs)
        print(f"paged prefix_cache={cache}: 4 requests sharing 128 tokens in "
              f"{pdt:.3f} s, TTFT p50 {ttft[len(ttft) // 2]:.1f} ms, prefix "
              f"hits {peng.n_prefix_hits}, prompt tokens skipped "
              f"{peng.n_prefix_tokens}", flush=True)
        streams.append([list(r.tokens) for r in preqs])
        _check_drained(peng, f"prefix_cache={cache}")
    if streams[0] != streams[1]:
        fail("paged: streams with the prefix cache differ from the same "
             "traffic without it")
    if peng.n_prefix_hits == 0:
        fail("paged: the prefix cache never hit")
    del model
    torch.cuda.empty_cache()
    return {"paged_gqa": launches, "paged_gqa_q8": q8_launches}


def phase_attn_train(torch, dev):
    """Full-width smollm-360m trained through Trainer with flash
    attention on the card, then flash against the naive softmax."""
    import math
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.data import ShardedLoader, SyntheticLMDataset
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW, cosine_schedule, param_groups
    from repro_torch.train import TrainConfig, Trainer, build_train_step

    cfg = dataclasses.replace(get_config("smollm-360m"),
                              attention_impl="flash")
    steps, batch, seq, seed = 20, 4, 2048, 0

    def make(config):
        model = build_model(config, device=dev, generator=torch.Generator(
            device=dev).manual_seed(seed))
        opt = AdamW(param_groups(model), lr=cosine_schedule(
            3e-4, warmup=steps // 20, total=steps))
        return model, opt

    loader = ShardedLoader(SyntheticLMDataset(vocab=cfg.vocab, seq_len=seq),
                           global_batch=batch)
    model, opt = make(cfg)
    with tempfile.TemporaryDirectory() as ckpt_dir:
        trainer = Trainer(model, opt, TrainConfig(
            steps=steps, ckpt_every=steps + 1, ckpt_dir=ckpt_dir,
            log_every=10), loader=loader, seed=seed)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        _zero_flash_counts()
        t0 = time.perf_counter()
        _, step = trainer.run()
        wall = time.perf_counter() - t0
        n_fwd, n_dq, n_dkv, *n_tc = _flash_counts()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 2**30
    hist = trainer.history
    losses = [h["loss"] for h in hist]
    if step != steps or len(hist) != steps:
        fail(f"attn_train: stopped at step {step} with {len(hist)} steps run")
    if trainer.restores:
        fail(f"attn_train: {trainer.restores} crash-restores (a step raised)")
    if not all(math.isfinite(v) for v in losses):
        fail(f"attn_train: non-finite loss in {losses}")
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    if not last < first:
        fail(f"attn_train: loss did not fall (first-5 mean {first:.4f}, "
             f"last-5 mean {last:.4f})")
    want = cfg.n_layers * steps
    if (n_fwd, n_dq, n_dkv) != (want,) * 3:
        fail(f"attn_train: flash launches fwd {n_fwd}, bwd dq {n_dq}, bwd "
             f"dkv {n_dkv} != {cfg.n_layers} layers x {steps} steps")
    if tuple(n_tc) != (want,) * 3:
        fail(f"attn_train: tc-route launches fwd, dq, dkv {tuple(n_tc)} != "
             f"{cfg.n_layers} layers x {steps} steps")
    dts = sorted(h["dt"] for h in hist[3:])
    step_ms = dts[len(dts) // 2] * 1e3
    print(f"attn_train: {cfg.name} attention_impl=flash {steps} steps "
          f"(batch {batch}, seq {seq}) in {wall:.1f} s incl. the final "
          f"checkpoint; step p50 {step_ms:.1f} ms (first "
          f"{hist[0]['dt'] * 1e3:.0f} ms) -> "
          f"{batch * seq / (step_ms / 1e3):.0f} tokens/s; peak memory "
          f"{peak_gb:.2f} GiB; loss {losses[0]:.4f} -> {losses[-1]:.4f} "
          f"(first-5 mean {first:.4f}, last-5 mean {last:.4f}); restores 0; "
          f"flash_fwd launches {n_fwd}, flash_bwd launches dq {n_dq} dkv "
          f"{n_dkv} = {cfg.n_layers} x {steps}, all on the tc route "
          f"(fwd, dq, dkv {tuple(n_tc)})", flush=True)
    del trainer, model, opt
    torch.cuda.empty_cache()

    # batch 1 x 2048, the same seed and batches: flash, then the naive
    # softmax (whose (B, H, S, S) scores do not fit at batch 4)
    one = ShardedLoader(SyntheticLMDataset(vocab=cfg.vocab, seq_len=seq),
                        global_batch=1)
    runs = {}
    for impl in ("flash", "naive"):
        model, opt = make(dataclasses.replace(cfg, attention_impl=impl))
        step_fn = build_train_step(model, opt)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        n0 = _flash_counts()
        mets = []
        for i in range(3):
            b = {k: torch.from_numpy(v).to(dev, torch.int64)
                 for k, v in one.batch_at(i).items()}
            _, met = step_fn({}, b)
            mets.append((float(met["loss"]), float(met["grad_norm"])))
        ran = tuple(a - b for a, b in zip(_flash_counts(), n0))
        runs[impl] = (mets, torch.cuda.max_memory_allocated(dev) / 2**30,
                      ran)
        del model, opt, step_fn
        torch.cuda.empty_cache()
    (fm, f_gb, f_ran), (nm, n_gb, n_ran) = runs["flash"], runs["naive"]
    if f_ran != (3 * cfg.n_layers,) * 6:
        fail(f"attn_train: the batch-1 flash run launched (fwd, dq, dkv, "
             f"and the same on the tc route) {f_ran}")
    if any(n_ran):
        fail(f"attn_train: the naive run launched flash kernels {n_ran}")
    for i, ((fl, fg), (nl, ng)) in enumerate(zip(fm, nm)):
        dl, dg = abs(fl - nl), abs(fg - ng) / ng
        print(f"attn_train: batch 1 step {i} flash loss {fl:.5f} grad norm "
              f"{fg:.5f}; naive loss {nl:.5f} grad norm {ng:.5f} (|dloss| "
              f"{dl:.2e} tol 2e-2, grad norm {dg:.2%} tol 2 %)", flush=True)
        if not (dl <= 2e-2 and dg <= 0.02):
            fail(f"attn_train: batch-1 step {i}: flash differs from naive")
    print(f"attn_train: batch 1 x {seq} peak memory flash {f_gb:.2f} GiB, "
          f"naive {n_gb:.2f} GiB", flush=True)
    return {"flash_fwd": n_fwd, "flash_bwd": n_dkv}


#: Layers of falcon-mamba-7b's 64 that the mamba_train phase keeps: the
#: port's AdamW holds fp32 params, grads and two moments, 16 B a parameter;
#: 64 layers (7.27 B parameters) would need 116 GB, 8 need 22 GB.
MAMBA_LAYERS = 8


def phase_mamba_train(torch, dev):
    """Full-width falcon-mamba-7b (8 of 64 layers) trained through Trainer
    with the fused selective scan on the card, then fused against the
    materializing path (the linear-scan kernels) at batch 1."""
    import math
    import os
    import shutil
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.data import ShardedLoader, SyntheticLMDataset
    from repro_torch.kernels.fused_ssm import ops as ssm_ops
    from repro_torch.kernels.linear_scan import ops as scan_ops
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW, cosine_schedule, param_groups
    from repro_torch.train import TrainConfig, Trainer, build_train_step

    cfg = dataclasses.replace(get_config("falcon-mamba-7b"),
                              n_layers=MAMBA_LAYERS, ssm_impl="fused")
    steps, batch, seq, seed = 20, 4, 2048, 0
    counters = (ssm_ops.fused_ssm_fwd_kernel, ssm_ops.fused_ssm_bwd_kernel,
                scan_ops.linear_scan_kernel, scan_ops.linear_scan_bwd_kernel)

    def make(config):
        model = build_model(config, device=dev, generator=torch.Generator(
            device=dev).manual_seed(seed))
        opt = AdamW(param_groups(model), lr=cosine_schedule(
            3e-4, warmup=steps // 20, total=steps))
        return model, opt

    def launches():
        return tuple(k.launches for k in counters)

    loader = ShardedLoader(SyntheticLMDataset(vocab=cfg.vocab, seq_len=seq),
                           global_batch=batch)
    model, opt = make(cfg)
    n_params = sum(p.numel() for p in model.parameters())
    with tempfile.TemporaryDirectory() as ckpt_dir:
        free_gb = shutil.disk_usage(ckpt_dir).free / 1e9
        trainer = Trainer(model, opt, TrainConfig(
            steps=steps, ckpt_every=steps + 1, ckpt_dir=ckpt_dir,
            log_every=10), loader=loader, seed=seed)
        saves = []
        real_save = trainer.ckpt.save

        def timed_save(*a, **kw):
            t = time.perf_counter()
            real_save(*a, **kw)
            saves.append(time.perf_counter() - t)
        # on the checkpointer, not the trainer: a closure over the trainer
        # would keep it, and the model, alive after `del trainer`
        trainer.ckpt.save = timed_save
        # layer 0's scan inputs at the last step, copied to the host: its
        # forward is the step's first scan launch, its backward the last
        scan = ssm_ops.SelectiveScan
        real_fwd, real_bwd = scan.forward, scan.backward
        last = (steps - 1) * cfg.n_layers
        caught = {}

        def catch_fwd(ctx, *ins):
            if counters[0].launches == last:
                caught["ins"] = [t.float().cpu() for t in ins]
            return real_fwd(ctx, *ins)

        def catch_bwd(ctx, dy):
            if counters[1].launches == last + cfg.n_layers - 1:
                caught["dy"] = dy.float().cpu()
            return real_bwd(ctx, dy)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        for k in counters:
            k.launches = 0
        scan.forward, scan.backward = (staticmethod(catch_fwd),
                                       staticmethod(catch_bwd))
        try:
            t0 = time.perf_counter()
            _, step = trainer.run()
            wall = time.perf_counter() - t0
        finally:
            scan.forward, scan.backward = (staticmethod(real_fwd),
                                           staticmethod(real_bwd))
        n_fwd, n_bwd, n_scan, n_scan_bwd = launches()
        ckpt_gb = sum(os.path.getsize(os.path.join(d, f))
                      for d, _, fs in os.walk(ckpt_dir) for f in fs) / 1e9
    peak_gb = torch.cuda.max_memory_allocated(dev) / 2**30
    hist = trainer.history
    losses = [h["loss"] for h in hist]
    if step != steps or len(hist) != steps:
        fail(f"mamba_train: stopped at step {step} with {len(hist)} steps "
             "run")
    if trainer.restores:
        fail(f"mamba_train: {trainer.restores} crash-restores (a step "
             "raised)")
    if not all(math.isfinite(v) for v in losses):
        fail(f"mamba_train: non-finite loss in {losses}")
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    if not last < first:
        fail(f"mamba_train: loss did not fall (first-5 mean {first:.4f}, "
             f"last-5 mean {last:.4f})")
    want = cfg.n_layers * steps
    if (n_fwd, n_bwd) != (want, want) or n_scan or n_scan_bwd:
        fail(f"mamba_train: launches fused_ssm_fwd {n_fwd}, fused_ssm_bwd "
             f"{n_bwd} (want {cfg.n_layers} layers x {steps} steps each), "
             f"linear_scan {n_scan}, linear_scan_bwd {n_scan_bwd} (want 0)")
    dts = sorted(h["dt"] for h in hist[3:])
    step_ms = dts[len(dts) // 2] * 1e3
    print(f"mamba_train: {cfg.name} ({cfg.n_layers} of 64 layers, "
          f"{n_params / 1e9:.3f} B params) ssm_impl=fused {steps} steps "
          f"(batch {batch}, seq {seq}) in {wall:.1f} s incl. the final "
          f"checkpoint; step p50 {step_ms:.1f} ms (first "
          f"{hist[0]['dt'] * 1e3:.0f} ms) -> "
          f"{batch * seq / (step_ms / 1e3):.0f} tokens/s; peak memory "
          f"{peak_gb:.2f} GiB; loss {losses[0]:.4f} -> {losses[-1]:.4f} "
          f"(first-5 mean {first:.4f}, last-5 mean {last:.4f}); restores 0; "
          f"fused_ssm_fwd launches {n_fwd}, fused_ssm_bwd launches {n_bwd} "
          f"= {cfg.n_layers} x {steps}, linear_scan 0, linear_scan_bwd 0; "
          f"final checkpoint {ckpt_gb:.2f} GB in {saves[-1]:.1f} s "
          f"({free_gb:.0f} GB were free there)", flush=True)
    del trainer, model, opt
    torch.cuda.empty_cache()

    # both kernels against their plain versions on trained inputs: layer
    # 0's (dt, x, B, C, A) and output cotangent at the last step
    if "ins" not in caught or "dy" not in caught or \
            caught["dy"].shape != caught["ins"][1].shape:
        fail("mamba_train: layer 0's scan inputs at the last step were not "
             "caught")
    ins = [t.to(dev) for t in caught.pop("ins")]
    dy = caught.pop("dy").to(dev)
    errs, scale, _ = _ssm_against_plain(
        torch, ins, dy, "mamba_train layer 0 at the last step")
    print(f"mamba_train: layer 0's scan at step {steps} (inputs "
          f"{tuple(ins[1].shape)}, d_state {ins[4].shape[1]}), kernels "
          f"against plain: {_ssm_errs_line(errs, scale)}", flush=True)
    del ins, dy
    torch.cuda.empty_cache()

    # one layer's fp32 w_out products a step, timed alone: the reference's
    # promoted product of the fp32 tail with the bf16-rounded w_out, its
    # forward and its two backward products
    di, d, rows = cfg.mamba.d_inner(cfg.d_model), cfg.d_model, batch * seq
    y = torch.randn(rows, di, device=dev)
    w = torch.randn(di, d, device=dev).bfloat16().float()
    gy = torch.randn(rows, d, device=dev)
    gemm_ms = device_ms(torch, lambda: (y @ w, gy @ w.T, y.T @ gy), 5)
    del y, w, gy
    torch.cuda.empty_cache()
    print(f"mamba_train: one layer's fp32 w_out products (forward and both "
          f"backward, {6 * rows * di * d / 1e12:.2f} TFLOP) {gemm_ms:.2f} "
          f"ms; x {cfg.n_layers} layers = {gemm_ms * cfg.n_layers:.1f} ms, "
          f"{gemm_ms * cfg.n_layers / step_ms:.0%} of the step p50",
          flush=True)

    # batch 1 x 2048, the same seed and batches: fused, then the
    # materializing path (prefill from a blank carry through the linear
    # scan kernels), whose (B, T, d_inner, d_state) terms do not fit at 4
    one = ShardedLoader(SyntheticLMDataset(vocab=cfg.vocab, seq_len=seq),
                        global_batch=1)
    runs = {}
    for impl in ("fused", "xla"):
        model, opt = make(dataclasses.replace(cfg, ssm_impl=impl))
        step_fn = build_train_step(model, opt)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        n0 = launches()
        mets = []
        for i in range(3):
            b = {k: torch.from_numpy(v).to(dev, torch.int64)
                 for k, v in one.batch_at(i).items()}
            _, met = step_fn({}, b)
            mets.append((float(met["loss"]), float(met["grad_norm"])))
        ran = tuple(a - b for a, b in zip(launches(), n0))
        runs[impl] = (mets, torch.cuda.max_memory_allocated(dev) / 2**30,
                      ran)
        del model, opt, step_fn
        torch.cuda.empty_cache()
    (fm, f_gb, f_ran), (xm, x_gb, x_ran) = runs["fused"], runs["xla"]
    k = 3 * cfg.n_layers
    if f_ran != (k, k, 0, 0):
        fail(f"mamba_train: the batch-1 fused run launched (fused_ssm_fwd, "
             f"fused_ssm_bwd, linear_scan, linear_scan_bwd) = {f_ran}")
    if x_ran != (0, 0, k, k):
        fail(f"mamba_train: the batch-1 xla run launched (fused_ssm_fwd, "
             f"fused_ssm_bwd, linear_scan, linear_scan_bwd) = {x_ran}")
    for i, ((fl, fg), (xl, xg)) in enumerate(zip(fm, xm)):
        dl, dg = abs(fl - xl), abs(fg - xg) / xg
        print(f"mamba_train: batch 1 step {i} fused loss {fl:.5f} grad norm "
              f"{fg:.5f}; xla loss {xl:.5f} grad norm {xg:.5f} (|dloss| "
              f"{dl:.2e} tol 2e-2, grad norm {dg:.2%} tol 2 %)", flush=True)
        if not (dl <= 2e-2 and dg <= 0.02):
            fail(f"mamba_train: batch-1 step {i}: fused differs from xla")
    print(f"mamba_train: batch 1 x {seq}, {cfg.n_layers} layers, peak "
          f"memory fused {f_gb:.2f} GiB, xla {x_gb:.2f} GiB", flush=True)
    return {"fused_ssm_fwd": n_fwd, "fused_ssm_bwd": n_bwd}


#: deepseek-v3-671b's first three layers are dense MLA layers (d_ff 18432);
#: the other 58 are MoE (256 routed experts plus 1 shared, 11.3 B parameters
#: a layer), which the port does not have yet.  The mla_paged phase serves
#: the depth cut to the dense layers at the published widths.
MLA_ARCH, MLA_LAYERS = "deepseek-v3-671b", 3


def _serve_mla(torch, model, prompts, gen_tokens, *, max_len, num_pages,
               prefix_cache=False):
    """One run of the paged MLA serving path through build_engine."""
    from repro_torch.configs import ServeConfig
    from repro_torch.launch.serve import build_engine
    from repro_torch.serve import Telemetry

    eng = build_engine(model, ServeConfig(
        slots=4, max_len=max_len, prefill_chunk=256, kv_layout="paged",
        page_size=16, num_pages=num_pages, prefix_cache=prefix_cache),
        telemetry=Telemetry())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = [eng.submit(p, max_new_tokens=gen_tokens) for p in prompts]
    eng.run()
    torch.cuda.synchronize()
    return eng, reqs, time.perf_counter() - t0


def phase_mla_paged(torch, dev):
    """Full-width deepseek-v3-671b (its 3 dense MLA layers) served from
    paged latent pools."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.launch.profile import profile_window
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_config(MLA_ARCH), n_layers=MLA_LAYERS)
    specs = cfg.layer_specs()
    if any(s.moe for s in specs):
        fail(f"mla_paged: the depth cut kept MoE layers {specs}")
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(0))
    kernels = (pa_ops.paged_mla_kernel, pa_ops.paged_mla_q8_kernel)
    tc_launches = {}

    def variant(**kw):
        other = build_model(dataclasses.replace(cfg, **kw), device=dev)
        other.load_state_dict(model.state_dict())
        return other
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    m = cfg.mla
    print(f"mla_paged: {cfg.name} ({cfg.n_layers} dense MLA layers of 61, "
          f"{n_params / 1e9:.3f} B params, d {cfg.d_model}, {cfg.n_heads} "
          f"heads, q_lora {m.q_lora_rank}, kv_lora {m.kv_lora_rank}, rope "
          f"{m.qk_rope_head_dim}, d_ff {specs[0].d_ff}, vocab {cfg.vocab}) "
          f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    rng = np.random.default_rng(0)
    plens = [1024, 1024, 700, 700, 512, 300, 900, 256]
    prompts = [rng.integers(0, cfg.vocab, size=p) for p in plens]
    gen_tokens = 32
    max_len = max(plens) + gen_tokens           # 1056: 66 pages of 16
    num_pages = 4 * (max_len // 16) + 36        # 4 full chains + headroom
    kw = dict(max_len=max_len, num_pages=num_pages)
    _serve_mla(torch, model, prompts[:2], 2, **kw)   # warm-up (cuBLAS etc.)

    def measured(mdl, tag, kernel):
        torch.cuda.reset_peak_memory_stats(dev)
        for k in kernels:
            k.launches = 0
            k.launches_tc = 0
        eng, reqs, dt = _serve_mla(torch, mdl, prompts, gen_tokens, **kw)
        launches = kernel.launches if kernel is not None else sum(
            k.launches for k in kernels)
        if kernel is not None:
            tc_launches[tag] = kernel.launches_tc
        peak_gb = torch.cuda.max_memory_allocated(dev) / 2**30
        for r in reqs:
            toks = r.tokens
            if not r.finished or len(toks) != gen_tokens:
                fail(f"mla_paged {tag}: request {r.uid} finished="
                     f"{r.finished} with {len(toks)} tokens")
            if not ((toks >= 0) & (toks < cfg.vocab)).all():
                fail(f"mla_paged {tag}: request {r.uid} emitted a token "
                     "outside the vocab")
        pool_b = sum(t.numel() * t.element_size() for layer in eng.state
                     for t in layer.values())
        ttft = sorted((r.first_token_t - r.created_t) * 1e3 for r in reqs)
        stp = eng.telemetry.registry.histograms["step_ms"].summary()
        n_gen = sum(len(r.tokens) for r in reqs)
        print(f"mla_paged {tag}: {len(reqs)} requests, {n_gen} tokens in "
              f"{dt:.3f} s ({n_gen / dt:.1f} generated tok/s incl. "
              f"prefill), TTFT p50 {ttft[len(ttft) // 2]:.1f} ms max "
              f"{ttft[-1]:.1f} ms, {eng.n_steps} decode steps p50 "
              f"{stp['p50']:.2f} ms, peak memory {peak_gb:.2f} GiB, pool "
              f"{eng.pool.num_pages} pages = {pool_b / 2**20:.2f} MiB, "
              f"kernel launches {launches}; distinct tokens per stream "
              f"{[len(set(r.tokens.tolist())) for r in reqs]}", flush=True)
        _check_drained(eng, f"mla_paged {tag}")
        return eng, reqs, launches, pool_b

    # (a) bf16 latent pages through the paged_mla kernel
    eng, reqs, launches, pool_bf16 = measured(model, "bf16 kernel",
                                              pa_ops.paged_mla_kernel)
    if pa_ops.paged_mla_q8_kernel.launches:
        fail("mla_paged bf16: the int8 kernel was launched")
    if launches == 0 or launches != cfg.n_layers * eng.n_steps:
        fail(f"mla_paged bf16: paged_mla launches {launches} != "
             f"{cfg.n_layers} layers x {eng.n_steps} decode steps")
    if tc_launches["bf16 kernel"] != launches:
        fail(f"mla_paged bf16: {tc_launches['bf16 kernel']} of {launches} "
             "paged_mla launches on the tc route")
    print(f"mla_paged: paged_mla launches {launches} = {cfg.n_layers} layers "
          f"x {eng.n_steps} decode steps, all on the tc route", flush=True)

    # one 4-slot decode step at position 1055 (the longest chains): called
    # eagerly vs its kernels replayed from a CUDA graph; the difference is
    # time the card waits for the host; then the kernels with the most
    # device time in it
    state = model.init_paged_cache(num_pages, 16)
    tok = torch.zeros(4, 1, dtype=torch.int64, device=dev)
    pos = torch.full((4,), max_len - 1, dtype=torch.int32, device=dev)
    n_chain = max_len // 16
    bt = torch.arange(4 * n_chain, dtype=torch.int32,
                      device=dev).reshape(4, n_chain)
    act = torch.ones(4, dtype=torch.bool, device=dev)
    rows = torch.arange(4, device=dev)

    def step():
        model.decode_step_paged(tok, state, pos, bt, act, max_len, rows=rows)
    with torch.inference_mode():
        step_eager = eager_ms(torch, step, 10)
        step_dev = device_ms(torch, step, 10)
        print(f"mla_paged: decode_step_paged (4 slots, pos {max_len - 1}): "
              f"eager {step_eager:.2f} ms, device {step_dev:.2f} ms -> card "
              f"idle {1 - step_dev / step_eager:.1%} of an eager step",
              flush=True)
        profile_window(step, 5, "mla_paged: decode_step_paged profile")
    del state

    def against_gather(tag, reqs, gm):
        """The kernel streams ``reqs`` equal the gather read's up to the
        first token where the gather model's top-2 margin is <= 0.1."""
        geng, greqs, glaunch, _ = measured(gm, f"{tag} gather", None)
        if glaunch:
            fail(f"mla_paged {tag} gather: {glaunch} paged kernel launches")
        n_div = 0
        for r, gr in zip(reqs, greqs):
            i = _first_divergence(r.tokens, gr.tokens)
            if i is None:
                continue
            n_div += 1
            ctx = np.concatenate([r.prompt, r.tokens[:i]]).astype(np.int64)
            last, _ = geng.sm.prefill(ctx[None, :])
            top2 = torch.topk(last[0, :cfg.vocab].float(), 2).values
            margin = (top2[0] - top2[1]).item()
            if margin > 0.1:
                fail(f"mla_paged {tag}: request {r.uid} diverges from the "
                     f"gather read at token {i} where the top-2 margin is "
                     f"{margin:.3f} > 0.1")
            print(f"mla_paged {tag}: request {r.uid} parts from the gather "
                  f"stream at token {i} (gather top-2 margin {margin:.4f} "
                  "<= 0.1)")
        print(f"mla_paged {tag}: kernel greedy tokens match the gather "
              f"read's in {len(reqs) - n_div}/{len(reqs)} requests end to "
              "end", flush=True)

    # (b) the same traffic through the dense-gather read
    gm = variant(paged_impl="gather")
    against_gather("bf16", reqs, gm)
    del gm

    # (c) int8 latent pages through the paged_mla_q8 kernel
    qmodel = variant(kv_dtype="int8")
    qeng, qreqs, q8_launches, pool_int8 = measured(
        qmodel, "int8 kernel", pa_ops.paged_mla_q8_kernel)
    if pa_ops.paged_mla_kernel.launches:
        fail("mla_paged int8: the bf16 kernel was launched")
    if q8_launches == 0 or q8_launches != cfg.n_layers * qeng.n_steps:
        fail(f"mla_paged int8: paged_mla_q8 launches {q8_launches} != "
             f"{cfg.n_layers} layers x {qeng.n_steps} decode steps")
    if tc_launches["int8 kernel"] != q8_launches:
        fail(f"mla_paged int8: {tc_launches['int8 kernel']} of {q8_launches} "
             "paged_mla_q8 launches on the tc route")
    same = sum(int(np.sum(np.asarray(a.tokens) == np.asarray(b.tokens)))
               for a, b in zip(reqs, qreqs))
    firsts = [_first_divergence(a.tokens, b.tokens) for a, b in
              zip(reqs, qreqs)]
    print(f"mla_paged: pool bytes bf16 {pool_bf16 / 2**20:.2f} MiB, int8 "
          f"{pool_int8 / 2**20:.2f} MiB ({pool_int8 / pool_bf16:.3f}x); "
          f"int8 greedy tokens equal bf16's at {same}/"
          f"{len(reqs) * gen_tokens} positions; first divergence per "
          f"request {firsts}; paged_mla_q8 launches {q8_launches}, all on "
          "the tc route", flush=True)
    del qmodel, qeng

    # (b') random weights give few-token greedy streams, so the kernel is
    # also compared with the gather read on a sharpened copy: every
    # layer's output projections x32 (as in phase paged)
    sharp = variant()
    with torch.no_grad():
        for layer in sharp.layers:
            layer.mixer.wo.mul_(32.0)
            layer.mlp.w_down.mul_(32.0)
    _seng, sreqs, _, _ = measured(sharp, "sharpened bf16 kernel",
                                  pa_ops.paged_mla_kernel)
    sgather = variant(paged_impl="gather")
    sgather.load_state_dict(sharp.state_dict())
    against_gather("sharpened", sreqs, sgather)
    del sharp, sgather

    # (d) 4 requests sharing a 512-token prefix, with and without the
    # prefix cache
    prefix = rng.integers(0, cfg.vocab, size=512)
    shared = [np.concatenate([prefix, rng.integers(0, cfg.vocab, size=t)])
              for t in (9, 100, 257, 300)]
    streams = []
    for cache in (False, True):
        peng, preqs, pdt = _serve_mla(torch, model, shared, gen_tokens,
                                      prefix_cache=cache, **kw)
        ttft = sorted((r.first_token_t - r.created_t) * 1e3 for r in preqs)
        print(f"mla_paged prefix_cache={cache}: 4 requests sharing 512 "
              f"tokens in {pdt:.3f} s, TTFT p50 {ttft[len(ttft) // 2]:.1f} "
              f"ms max {ttft[-1]:.1f} ms, prefix hits {peng.n_prefix_hits}, "
              f"prompt tokens skipped {peng.n_prefix_tokens}", flush=True)
        streams.append([list(r.tokens) for r in preqs])
        _check_drained(peng, f"mla_paged prefix_cache={cache}")
    if streams[0] != streams[1]:
        fail("mla_paged: streams with the prefix cache differ from the same "
             "traffic without it")
    if peng.n_prefix_hits == 0:
        fail("mla_paged: the prefix cache never hit")
    del model
    torch.cuda.empty_cache()
    return {"paged_mla": launches, "paged_mla_q8": q8_launches}


def _margin_rule(torch, tag, sm, vocab, prompts, got, want):
    """``got`` equals ``want`` per stream up to the first token where the
    top-2 margin of ``sm`` (the side ``want`` came from; a fresh prefill
    of the prompt and ``want``'s tokens so far) is <= 0.1."""
    import numpy as np

    n_same = 0
    for prompt, a, b in zip(prompts, got, want):
        i = _first_divergence(a, b)
        if i is None:
            n_same += 1
            continue
        ctx = np.concatenate([prompt, b[:i]]).astype(np.int64)
        last, _ = sm.prefill(ctx[None, :])
        top2 = torch.topk(last[0, :vocab].float(), 2).values
        margin = (top2[0] - top2[1]).item()
        if margin > 0.1:
            fail(f"{tag}: a stream diverges at token {i} where the top-2 "
                 f"margin is {margin:.3f} > 0.1")
        print(f"{tag}: a stream parts at token {i} (top-2 margin "
              f"{margin:.4f} <= 0.1)", flush=True)
    print(f"{tag}: {n_same}/{len(got)} streams equal end to end", flush=True)


def _sharpen(torch, model, factor=32.0):
    """Every layer's output projections x ``factor``, in place: random
    weights give one-token greedy streams (the tied head reads each
    input's own embedding off the residual); x32 makes them vary at
    smollm-360m's width (phase_paged).  An attention layer's ``wo``, a
    Mamba layer's ``w_out``, a dense MLP's ``w_down``, an MoE MLP's
    expert ``w_down`` stack and its shared expert's ``w_down``; of an
    encoder-decoder (whisper), the decoder layers' self- and
    cross-attention ``wo`` and MLP ``w_down``."""
    with torch.no_grad():
        for layer in getattr(model, "dec", ()):
            for w in (layer.self_attn.wo, layer.cross.wo, layer.mlp.w_down):
                w.mul_(factor)
        for layer in getattr(model, "layers", ()):
            for name in ("wo", "w_out"):
                if hasattr(layer.mixer, name):
                    getattr(layer.mixer, name).mul_(factor)
            if layer.mlp is not None:
                layer.mlp.w_down.mul_(factor)
                if getattr(layer.mlp, "shared", None) is not None:
                    layer.mlp.shared.w_down.mul_(factor)
    return model


SCHED_GEN = 64


def _sched_run(torch, model, policy, low, high, *, num_pages, deadlines=None,
               fault=None):
    """The sched traffic through build_engine: the priority-0 prompts
    ``low``, 8 engine steps, then the priority-1 pair ``high``; ``fault``,
    if given, is applied to the new engine first.  Returns (engine,
    requests in submission order, seconds)."""
    from repro_torch.configs import ServeConfig
    from repro_torch.launch.serve import build_engine
    from repro_torch.serve import Telemetry

    eng = build_engine(model, ServeConfig(
        slots=4, max_len=256 + SCHED_GEN, kv_layout="paged", page_size=16,
        num_pages=num_pages, policy=policy), telemetry=Telemetry())
    if fault is not None:
        fault(eng)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = [eng.submit(p, max_new_tokens=SCHED_GEN) for p in low]
    for _ in range(8):
        eng.step()
    reqs += [eng.submit(p, max_new_tokens=SCHED_GEN, priority=1,
                        deadline=None if deadlines is None else deadlines[i])
             for i, p in enumerate(high)]
    eng.run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    for r in reqs:
        if not r.finished or len(r.tokens) != SCHED_GEN:
            fail(f"sched {policy}: request {r.uid} finished={r.finished} "
                 f"with {len(r.tokens)} tokens")
    _check_drained(eng, f"sched {policy}")
    return eng, reqs, dt


def _zero_last_restored_page(torch, eng):
    """A planted fault: every restore of a preempted request zeroes the
    last page of its fresh chain (its newest positions) in every layer's
    pool, as a restore that lost one page would."""
    restore = eng.sm.restore_slot

    def faulty(state, snap, slot, pages):
        state = restore(state, snap, slot, pages)
        with torch.inference_mode():
            for sub in state:
                for v in sub.values():
                    v[int(pages[-1])] = 0
        return state
    eng.sm.restore_slot = faulty


def _victims(reqs, streams):
    """(uid, preemptions, distinct tokens) of each preempted request."""
    return [(r.uid, r.n_preemptions, len(set(map(int, t))))
            for r, t in zip(reqs, streams) if r.n_preemptions]


def phase_sched(torch, dev):
    """Full-width smollm-360m from paged bf16 pages through the paged_gqa
    kernel under the priority, sjf and edf policies, preemption and fork;
    then the static baseline against the engine."""
    import numpy as np

    from repro_torch.configs import ServeConfig, get_config
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.launch.serve import build_engine, generate
    from repro_torch.models import build_model

    cfg = get_config("smollm-360m")
    model = _sharpen(torch, build_model(
        cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0)))
    rng = np.random.default_rng(1)
    low = [rng.integers(0, cfg.vocab, size=p)
           for p in (128, 160, 192, 224, 256, 144)]
    high = [rng.integers(0, cfg.vocab, size=p) for p in (176, 208)]
    worst = -(-(256 + SCHED_GEN) // 16)            # pages of the longest
    tight = 3 * worst

    # the undisturbed run: FIFO, a pool big enough for every slot
    ref_eng, ref, ref_dt = _sched_run(torch, model, "fifo", low, high,
                                      num_pages=0)
    if ref_eng.n_preemptions:
        fail("sched: the fifo run preempted")
    want = [list(r.tokens) for r in ref]
    n_gen = len(ref) * SCHED_GEN
    print(f"sched: {cfg.name} x32-sharpened, 6 priority-0 + 2 priority-1 "
          f"requests (prompts 128-256, {SCHED_GEN} new tokens), 4 slots, page "
          f"16; fifo with {ref_eng.pool.num_pages} pages: {ref_dt:.3f} s "
          f"({n_gen / ref_dt:.1f} generated tok/s incl. prefill); distinct "
          f"tokens per stream {[len(set(w)) for w in want]}", flush=True)

    out = {}
    for policy, dls in (("priority", None), ("sjf", None),
                        ("edf", (30.0, 31.0))):
        pa_ops.paged_gqa_kernel.launches = 0
        eng, reqs, dt = _sched_run(torch, model, policy, low, high,
                                   num_pages=tight, deadlines=dls)
        launches = pa_ops.paged_gqa_kernel.launches
        got = [list(r.tokens) for r in reqs]
        if got != want:
            bad = [r.uid for r, g, w in zip(reqs, got, want) if g != w]
            fail(f"sched {policy}: streams of requests {bad} differ from the "
                 "undisturbed fifo run's")
        tel = eng.telemetry.registry.counters
        print(f"sched {policy} ({tight} pages = 3 worst-case reservations): "
              f"{dt:.3f} s ({n_gen / dt:.1f} generated tok/s incl. prefill), "
              f"preemptions {eng.n_preemptions}, resumes "
              f"{tel.get('resumes', 0)}, host bytes snapshotted "
              f"{eng.n_snapshot_bytes} ({eng.n_snapshot_bytes / 2**20:.2f} "
              f"MiB), paged_gqa launches {launches}; every stream bitwise the "
              "fifo run's; (uid, preemptions, distinct tokens) of the "
              f"preempted: {_victims(reqs, got)}", flush=True)
        if policy != "sjf" and not eng.n_preemptions:
            fail(f"sched {policy}: the urgent pair preempted nothing")
        if launches == 0 or pa_ops.paged_gqa_q8_kernel.launches:
            fail(f"sched {policy}: paged_gqa launches {launches}")
        out[policy] = launches

    # the control: the priority run again with each victim restored with
    # its last page zeroed; the bitwise check must see the fault
    eng, reqs, _dt = _sched_run(
        torch, model, "priority", low, high, num_pages=tight,
        fault=lambda e: _zero_last_restored_page(torch, e))
    got = [list(r.tokens) for r in reqs]
    changed = [r.uid for r, g, w in zip(reqs, got, want)
               if r.n_preemptions and g != w]
    print(f"sched planted fault (each restore zeroes the chain's last page): "
          f"preempted {_victims(reqs, got)}, streams changed {changed}",
          flush=True)
    if not changed:
        fail("sched: a restore that zeroes a page left every preempted "
             "stream bitwise the fifo run's (the check cannot see it)")

    # fork: the first request into 2 greedy children, copy-on-write
    eng = build_engine(model, ServeConfig(slots=4, max_len=256 + SCHED_GEN,
                                          kv_layout="paged", page_size=16))
    parent = eng.submit(low[0], max_new_tokens=SCHED_GEN)
    eng.submit(low[1], max_new_tokens=SCHED_GEN)
    for _ in range(3):
        eng.step()
    kids = eng.fork(parent, 2)
    eng.run()
    if any(list(k.tokens) != list(parent.tokens) for k in kids) or \
            list(parent.tokens) != want[0]:
        fail("sched fork: a child's stream differs from its parent's")
    if eng.n_cow_copies < 1:
        fail("sched fork: no page was copied on write")
    _check_drained(eng, "fork")
    print(f"sched fork: 2 greedy children of request 0 bitwise its stream, "
          f"{eng.n_cow_copies} COW page copies", flush=True)

    # the static baseline (per-token prefill, lock-step decode, dense)
    # against the engine's dense greedy streams
    prompts = [rng.integers(0, cfg.vocab, size=128) for _ in range(4)]
    gen = 32
    generate(model, np.stack(prompts)[:, :8], max_len=160, gen_tokens=2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    base = generate(model, np.stack(prompts), max_len=160, gen_tokens=gen)
    torch.cuda.synchronize()
    base_dt = time.perf_counter() - t0
    eng = build_engine(model, ServeConfig(slots=4, max_len=160))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = [eng.submit(p, max_new_tokens=gen) for p in prompts]
    eng.run()
    torch.cuda.synchronize()
    eng_dt = time.perf_counter() - t0
    print(f"sched baseline: static batch 4 x (128 + {gen}) in {base_dt:.3f} s "
          f"({4 * gen / base_dt:.1f} generated tok/s, "
          f"{4 * (128 + gen) / base_dt:.1f} incl. prompt), engine (dense, 4 "
          f"slots, chunked prefill) {eng_dt:.3f} s ({4 * gen / eng_dt:.1f} "
          f"generated tok/s)", flush=True)
    _margin_rule(torch, "sched baseline vs engine", eng.sm, cfg.vocab,
                 prompts, base.cpu().numpy(), [r.tokens for r in reqs])
    del model
    torch.cuda.empty_cache()
    return {"paged_gqa": out["priority"]}


class OracleDrafter:
    """A drafter double with DraftStepModel's interface that proposes the
    next tokens of known target-only streams (``streams[uid]``), so every
    draft is accepted; ``corrupt(position)`` picks drafts to replace with
    another token.  Lives here, not in the package: with random weights the
    real drafter is almost never accepted, and this drives the verifier's
    accept and reject paths on the card (here and in
    tests/test_torch_cuda.py).  Set ``.eng`` to the engine it serves."""

    def __init__(self, torch, k, vocab, streams, corrupt=None):
        self.torch, self.k, self.vocab = torch, k, vocab
        self.streams, self.corrupt = streams, corrupt
        self.eng = None
        self.telemetry = None

    def init_store(self, slots):
        return None

    def propose(self, store, sel, tok, active):
        import numpy as np
        st = self.eng.st
        toks = np.zeros((len(tok), self.k), np.int64)
        toks[:, 0] = tok
        for s in np.flatnonzero(active):
            req, p = st.slot_req[s], int(st.pos[s])
            stream = self.streams[req.uid]
            for m in range(1, self.k):
                j = p + m - len(req.prompt)      # output j sits at plen + j
                t = int(stream[j]) if j < len(stream) else 0
                if self.corrupt is not None and self.corrupt(p + m):
                    t = (t + 1) % self.vocab
                toks[s, m] = t
        return self.torch.as_tensor(toks, device=self.eng.sm.device), store

    def prefill(self, xs):
        return None

    def install(self, store, carry, slots):
        return store

    def snapshot_slot(self, store, slot):
        return None

    def restore_slot(self, store, snap, slot):
        return store

    def copy_slot(self, store, src, dst):
        return store


def _expected_accepts(plens, gen, k, corrupt):
    """Drafts a greedy engine accepts when every draft is the true token
    except at positions where ``corrupt`` holds (the wave arithmetic of
    ServeEngine._spec_step with heterogeneous_k)."""
    total = 0
    for plen in plens:
        pos, remaining = plen, gen - 1
        while remaining > 0:
            kk = min(k, remaining)
            a = 0
            while a < kk - 1 and not corrupt(pos + a + 1):
                a += 1
            total += a
            pos += a + 1
            remaining -= a + 1
    return total


SPEC_K, SPEC_GEN = 4, 32


def _engine_step_ms(torch, eng, prompts, gen, n=5):
    """ServeEngine.step once every request runs: admit ``prompts`` with
    ``gen`` new tokens each, warm up 2 steps, then time ``n``
    steps by the host clock and ``n`` more under the profiler (device
    time of kernels and copies).  Returns (wall ms a step, device busy ms
    a step, tokens a slot a step, the 5 kernels with the most device time
    as (ms a step, name)); drains the engine."""
    import collections

    from torch.profiler import DeviceType, ProfilerActivity, profile

    for p in prompts:
        eng.submit(p, max_new_tokens=gen)
    while eng.waiting:
        eng.step()
    for _ in range(2):
        eng.step()
    torch.cuda.synchronize()
    d0 = eng.n_emitted
    t0 = time.perf_counter()
    for _ in range(n):
        eng.step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / n
    toks = (eng.n_emitted - d0) / n / len(prompts)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            eng.step()
        torch.cuda.synchronize()
    by_name = collections.Counter()
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not getattr(
                e, "is_user_annotation", False):
            by_name[e.name] += e.device_time_total / 1e3 / n
    busy = sum(by_name.values())
    if busy <= 0:
        fail("engine step: the profiler saw no device time")
    eng.run()
    _check_drained(eng, "engine step timing")
    return wall, busy, toks, [(ms, name) for name, ms in
                              by_name.most_common(5)]


def phase_spec(torch, dev):
    """Full-width smollm-360m target from paged bf16 pages with the
    minimalist-lm-360m drafter at spec_k 4, plus drafter doubles."""
    import numpy as np

    from repro_torch.configs import ServeConfig, get_config
    from repro_torch.kernels.linear_scan import ops as scan_ops
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.launch.serve import build_engine
    from repro_torch.models import build_model
    from repro_torch.serve import ServeEngine, Telemetry

    cfg = get_config("smollm-360m")
    model = _sharpen(torch, build_model(
        cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0)))
    gmodel = build_model(dataclasses.replace(cfg, paged_impl="gather"),
                         device=dev)
    gmodel.load_state_dict(model.state_dict())
    rng = np.random.default_rng(2)
    plens = [64, 96, 128, 160, 192, 80, 112, 176]
    prompts = [rng.integers(0, cfg.vocab, size=p) for p in plens]

    def serve(m, drafter=None, double=None, tag=""):
        kw = dict(drafter="minimalist-lm-360m", spec_k=SPEC_K) if drafter \
            else {}
        conf = ServeConfig(slots=4, max_len=192 + SPEC_GEN + SPEC_K,
                           kv_layout="paged", page_size=16, **kw)
        if double is not None:
            sm = build_engine(m, conf).sm
            eng = ServeEngine(sm, slots=4, drafter=double, spec_k=SPEC_K,
                              telemetry=Telemetry())
            double.eng = eng
        else:
            eng = build_engine(m, conf, telemetry=Telemetry())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reqs = [eng.submit(p, max_new_tokens=SPEC_GEN) for p in prompts]
        eng.run()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        for r in reqs:
            if not r.finished or len(r.tokens) != SPEC_GEN:
                fail(f"spec {tag}: request {r.uid} finished={r.finished} with "
                     f"{len(r.tokens)} tokens")
        _check_drained(eng, f"spec {tag}")
        n = len(reqs) * SPEC_GEN
        print(f"spec {tag}: {dt:.3f} s ({n / dt:.1f} generated tok/s incl. "
              f"prefill), {eng.n_steps} waves, drafts accepted "
              f"{eng.n_drafts_accepted}/{eng.n_drafts_proposed} (accept rate "
              f"{eng.stats().accept_rate:.3f})", flush=True)
        return eng, [list(r.tokens) for r in reqs]

    serve(gmodel, tag="warm-up")
    # (a) the gather read: spec bitwise target-only
    _e, plain_g = serve(gmodel, tag="target-only gather")
    _e, spec_g = serve(gmodel, drafter=True, tag="minimalist-lm-360m gather")
    if spec_g != plain_g:
        fail("spec (a): greedy spec streams differ from the target-only "
             "gather streams")
    # (b) the kernel read, target-only, against the spec streams (whose
    # verify reads through the gather view) under the margin rule
    scan_ops.linear_scan_kernel.launches = 0
    pa_ops.paged_gqa_kernel.launches = 0
    plain_eng, plain_k = serve(model, tag="target-only kernel")
    spec_eng, spec_k = serve(model, drafter=True, tag="minimalist-lm-360m "
                             "kernel")
    draft_scans = scan_ops.linear_scan_kernel.launches
    gqa = pa_ops.paged_gqa_kernel.launches
    if draft_scans == 0 or gqa == 0:
        fail(f"spec (b): drafter linear_scan launches {draft_scans}, target "
             f"paged_gqa launches {gqa}")
    print(f"spec (b): drafter prefill linear_scan launches {draft_scans}, "
          f"target paged_gqa launches {gqa} (target-only run)", flush=True)
    if spec_k != spec_g:
        fail("spec (b): spec streams under the kernel read differ from the "
             "gather read's (every spec wave verifies through the gather "
             "view)")
    _margin_rule(torch, "spec (b) spec vs target-only kernel", plain_eng.sm,
                 cfg.vocab, prompts, spec_k, plain_k)
    # (c) a double proposing the target-only stream: all accepted
    streams = dict(enumerate(plain_g))
    eng_c, got_c = serve(gmodel, double=OracleDrafter(
        torch, SPEC_K, cfg.vocab, streams), tag="all-accepting double")
    if eng_c.n_drafts_accepted != eng_c.n_drafts_proposed or got_c != plain_g:
        fail(f"spec (c): accepted {eng_c.n_drafts_accepted} of "
             f"{eng_c.n_drafts_proposed}, streams equal {got_c == plain_g}")
    # (d) every third draft position corrupted
    def corrupt(p):
        return p % 3 == 0
    eng_d, got_d = serve(gmodel, double=OracleDrafter(
        torch, SPEC_K, cfg.vocab, streams, corrupt), tag="corrupting double")
    want_d = _expected_accepts(plens, SPEC_GEN, SPEC_K, corrupt)
    if eng_d.n_drafts_accepted != want_d or got_d != plain_g:
        fail(f"spec (d): accepted {eng_d.n_drafts_accepted}, expected "
             f"{want_d}; streams equal {got_d == plain_g}")
    print(f"spec (c)/(d): all {eng_c.n_drafts_proposed} drafts accepted; "
          f"corrupting every third position: {eng_d.n_drafts_accepted} "
          f"accepted = the count worked out; streams bitwise", flush=True)

    # the engine's own waves, 4 slots at prompt 160: ServeEngine.step with
    # the drafter (propose, verify, commit, the host's bookkeeping)
    # against its plain step, both on the kernel read
    long = [rng.integers(0, cfg.vocab, size=160) for _ in range(4)]
    for name, kw in (("plain step", {}), ("spec wave", dict(
            drafter="minimalist-lm-360m", spec_k=SPEC_K))):
        eng = build_engine(model, ServeConfig(
            slots=4, max_len=160 + 64 + SPEC_K, kv_layout="paged",
            page_size=16, **kw))
        wall, busy, toks, top = _engine_step_ms(torch, eng, long, 64)
        print(f"spec: engine {name} (4 slots, prompt 160): wall {wall:.3f} "
              f"ms, device busy {busy:.3f} ms -> card idle "
              f"{1 - busy / wall:.1%}; {toks:.2f} tokens a slot a step, "
              f"{wall / toks:.3f} ms a token a slot; most device time: "
              + "; ".join(f"{ms:.3f} ms {nm[:60]}" for ms, nm in top),
              flush=True)
    del model, gmodel, spec_eng, plain_eng, eng
    torch.cuda.empty_cache()
    return {"linear_scan": draft_scans, "paged_gqa": gqa}


MAMBA_SERVE_LAYERS = 64


def phase_mamba_serve(torch, dev):
    """Full-width falcon-mamba-7b (all 64 layers, fp32 weights) served
    dense through build_engine, ssm_impl fused then xla."""
    import numpy as np

    from repro_torch.configs import ServeConfig, get_config
    from repro_torch.kernels.fused_ssm import ops as ssm_ops
    from repro_torch.kernels.linear_scan import ops as scan_ops
    from repro_torch.launch.serve import build_engine
    from repro_torch.models import build_model

    gc.collect()                   # engines of earlier phases (see below)
    base = dataclasses.replace(get_config("falcon-mamba-7b"),
                               n_layers=MAMBA_SERVE_LAYERS)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, base.vocab, size=p)
               for p in (256, 512, 768, 1024)]
    gen = 16
    runs = {}
    for impl in ("fused", "xla"):
        cfg = dataclasses.replace(base, ssm_impl=impl)
        t0 = time.perf_counter()
        model = build_model(cfg, device=dev, generator=torch.Generator(
            device=dev).manual_seed(0))
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in model.parameters())
        print(f"mamba_serve: {cfg.name} ssm_impl={impl} ({cfg.n_layers} "
              f"layers, {n_params / 1e9:.2f} B fp32 params, d "
              f"{cfg.d_model}) built in {time.perf_counter() - t0:.1f} s",
              flush=True)
        conf = ServeConfig(slots=2, max_len=1024 + gen)
        eng = build_engine(model, conf)            # warm-up
        eng.submit(prompts[0][:64], max_new_tokens=2)
        eng.run()
        ssm_ops.fused_ssm_fwd_kernel.launches = 0
        scan_ops.linear_scan_kernel.launches = 0
        torch.cuda.reset_peak_memory_stats(dev)
        eng = build_engine(model, conf)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reqs = [eng.submit(p, max_new_tokens=gen) for p in prompts]
        eng.run()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        fused, scans = (ssm_ops.fused_ssm_fwd_kernel.launches,
                        scan_ops.linear_scan_kernel.launches)
        for r in reqs:
            toks = r.tokens
            if not r.finished or len(toks) != gen or not (
                    (toks >= 0) & (toks < cfg.vocab)).all():
                fail(f"mamba_serve {impl}: request {r.uid} finished="
                     f"{r.finished}, tokens {toks}")
        chunks = eng.sm.n_prefill_chunks
        want = (chunks * cfg.n_layers, 0) if impl == "fused" else \
            (0, chunks * cfg.n_layers)
        if (fused, scans) != want:
            fail(f"mamba_serve {impl}: (fused_ssm_fwd, linear_scan) launches "
                 f"{(fused, scans)} != {want} ({chunks} prefill chunks x "
                 f"{cfg.n_layers} layers)")
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        print(f"mamba_serve {impl}: 4 requests (prompts 256-1024, {gen} new "
              f"tokens), 2 slots, {dt:.3f} s ({4 * gen / dt:.1f} generated "
              f"tok/s incl. prefill, {sum(len(p) for p in prompts) / dt:.0f} "
              f"prompt tok/s), {chunks} prefill chunks, fused_ssm_fwd "
              f"launches {fused}, linear_scan launches {scans}, peak memory "
              f"{peak:.1f} GiB; distinct tokens per stream "
              f"{[len(set(r.tokens.tolist())) for r in reqs]}", flush=True)
        # keep the xla engine's step model for the margin rule; drop the
        # fused model first (two 29 GB models do not fit beside the xla
        # prefill's activations).  An engine sits in a reference cycle
        # (its slot table holds a bound method of it), so only the cycle
        # collector frees the model it holds
        runs[impl] = (eng.sm if impl == "xla" else None,
                      [r.tokens for r in reqs], fused, scans)
        del model, eng
        gc.collect()
        torch.cuda.empty_cache()
    _margin_rule(torch, "mamba_serve fused vs xla", runs["xla"][0],
                 base.vocab, prompts, runs["fused"][1], runs["xla"][1])
    launches = {"fused_ssm_fwd": runs["fused"][2],
                "linear_scan": runs["xla"][3]}
    runs.clear()
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# full-width qwen3-moe-30b-a3b cut in depth: 16 of its 48 layers (one fp32
# layer is 623 M parameters, 2.49 GB; 48 would need 122 GB with the 2.49 GB
# untied embedding and head), and the hybrid smoke stack
MOE_ARCH, MOE_LAYERS = "qwen3-moe-30b-a3b", 16
MOE_HYBRID = "jamba-1.5-large-398b-smoke"


def _serve_engine(torch, model, prompts, gen_tokens, *, max_len,
                  kv_layout="paged", prefill_chunk=256, num_pages=0,
                  mesh=None):
    """One greedy run of ``prompts`` through build_engine (4 slots, page
    16; an MoE model's dispatch as configured; on ``mesh`` when one is
    given)."""
    from repro_torch.configs import ServeConfig
    from repro_torch.launch.serve import build_engine
    from repro_torch.serve import Telemetry

    eng = build_engine(model, ServeConfig(
        slots=4, max_len=max_len, prefill_chunk=prefill_chunk,
        kv_layout=kv_layout, page_size=16, num_pages=num_pages),
        telemetry=Telemetry(), mesh=mesh)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = [eng.submit(p, max_new_tokens=gen_tokens) for p in prompts]
    eng.run()
    torch.cuda.synchronize()
    return eng, reqs, time.perf_counter() - t0


def _reconfigure(model, **kw):
    """The same weights read under another ``paged_impl`` / ``kv_dtype``,
    in place: every module that holds the config gets the new one (a
    second copy of a 42 GB model would not fit beside the first)."""
    cfg = dataclasses.replace(model.cfg, **kw)
    for module in model.modules():
        if hasattr(module, "cfg"):
            module.cfg = cfg
    return model


def _device_split(torch, fn, iters, ranges, by_name=None):
    """Run ``fn`` ``iters`` times under the profiler with each method in
    ``ranges`` ({tag: (class, method name)}) wrapped in a
    ``record_function(tag)`` range; each kernel's device time goes to the
    innermost tagged range of the op that launched it.  Device time the
    profiler links to no op (the port's own kernels, launched through
    ctypes) goes to the tag of the first ``by_name`` entry ({substring of
    the kernel's name: tag}) the kernel's name holds; the rest of it is
    left out, since it also holds the ranges' own spans on the device's
    timeline.  Returns ({tag or "other": device ms an iteration}, profiled wall ms an
    iteration)."""
    import collections

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    saved = {}
    for tag, (cls, name) in ranges.items():
        orig = getattr(cls, name)
        saved[tag] = (cls, name, orig)

        def wrapped(self, *a, _orig=orig, _tag=tag, **k):
            with record_function(_tag):
                return _orig(self, *a, **k)
        setattr(cls, name, wrapped)
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / iters
    finally:
        for cls, name, orig in saved.values():
            setattr(cls, name, orig)
    split = collections.Counter()
    linked, device = collections.Counter(), collections.Counter()
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            device[e.name] += e.time_range.elapsed_us()
        kernels = getattr(e, "kernels", None) or []
        if not kernels:
            continue
        tag, node = "other", e
        while node is not None:
            if node.name in ranges:
                tag = node.name
                break
            node = node.cpu_parent
        split[tag] += sum(k.duration for k in kernels) / 1e3 / iters
        for k in kernels:
            linked[k.name] += k.duration
    for name, us in device.items():
        tag = next((t for sub, t in (by_name or {}).items() if sub in name),
                   None)
        if tag is not None and us > linked[name]:
            split[tag] += (us - linked[name]) / 1e3 / iters
    return dict(split), wall


def _routing_replay(torch, model, prompt, toks, *, max_len, kv_layout,
                    prefill_chunk=256, **cfg_kw):
    """Teacher-forced replay of one request through a one-slot step model
    of ``model`` read under ``cfg_kw`` (``paged_impl``, ``kv_dtype``) and
    ``kv_layout``: the prompt's prefill, then one decode step for each of
    ``toks``.  Returns (each decode-step MoE routing in execution order
    as (step, call, expert ids (k,), router logits (E,) fp32), the real-
    vocab logits that decide each token: the prefill's, then each
    step's)."""
    import numpy as np

    from repro_torch.models.moe import MoEMLP
    from repro_torch.serve import DecoderStepModel, PagedConfig

    _reconfigure(model, **cfg_kw)
    paged = dict(kv_layout="paged", paged=PagedConfig(page_size=16)) \
        if kv_layout == "paged" else {}
    sm = DecoderStepModel(model, max_len=max_len,
                          prefill_chunk=prefill_chunk, **paged)
    state = sm.init_state(1)
    last, carry = sm.prefill(np.asarray(prompt)[None, :])
    decided = [last[0, :sm.vocab].float().cpu()]
    bt = None
    if kv_layout == "paged":
        bt = np.arange(sm.max_pages, dtype=np.int32)[None, :]
        state = sm.write_slots(state, carry, np.zeros(1, np.int64), pages=bt,
                               plen=len(prompt))
    else:
        state = sm.write_slots(state, carry, np.zeros(1, np.int64))
    record, step = [], [0]
    route, sample = MoEMLP._route, sm._sample

    def recording(self, xt, par=None):
        out = route(self, xt, par)
        logits = (xt @ self.router.to(xt.dtype)).float()
        record.append((step[0], len(record), out[1][0].cpu(),
                       logits[0].cpu()))
        return out

    def keeping(logits, samp, pos):
        decided.append(logits[0, :sm.vocab].float().cpu())
        return sample(logits, samp, pos)
    MoEMLP._route, sm._sample = recording, keeping
    try:
        for t, tok in enumerate(toks):
            step[0] = t
            _out, state = sm.step(np.asarray([tok]), state,
                                  np.asarray([len(prompt) + t]),
                                  np.ones(1, bool), bt=bt)
    finally:
        MoEMLP._route = route
    return record, decided


def _moe_margin_rule(torch, tag, model, vocab, prompts, got, want, *,
                     got_cfg, want_cfg, max_len, prefill_chunk=256):
    """The margin rule for MoE stacks, from a teacher-forced replay of
    ``want``'s tokens through both configurations (``*_cfg``: kv_layout,
    paged_impl, kv_dtype; one slot, the decode path).  ``got`` equals
    ``want`` per stream up to the first token i where either (1) the want
    side's top-2 margin in the logits that decide token i (its prefill's
    for i = 0, else its decode step i - 1's) is <= 0.1, or (2) a routing
    decision parts the two sides: the first MoE routing whose expert ids
    differ comes at or before decode step i - 1, the want side's
    router-logit margin at it (the k-th largest logit minus the (k+1)-th)
    is <= 0.1, and the two sides' router logits differ by at most 0.1 at
    it and at every routing before it.  A rounding difference in the
    attention read moves the router's input a little, and a near-tie
    among the experts then flips, which changes the token stream by more
    than any token margin; a wrong read moves the router's logits by much
    more than 0.1."""
    n_same = 0
    for prompt, a, b in zip(prompts, got, want):
        i = _first_divergence(a, b)
        if i is None:
            n_same += 1
            continue
        (rec_w, dec_w), (rec_g, _dec_g) = [
            _routing_replay(torch, model, prompt, b[:i], max_len=max_len,
                            prefill_chunk=prefill_chunk, **cfg)
            for cfg in (want_cfg, got_cfg)]
        top2 = torch.topk(dec_w[i], 2).values
        margin = (top2[0] - top2[1]).item()
        if margin <= 0.1:
            print(f"{tag}: a stream parts at token {i} (top-2 margin "
                  f"{margin:.4f} <= 0.1)", flush=True)
            continue
        drift, flip = 0.0, None
        for (s, c, ids_w, lg_w), (_s, _c, ids_g, lg_g) in zip(rec_w, rec_g):
            drift = max(drift, (lg_w - lg_g).abs().max().item())
            if set(ids_w.tolist()) != set(ids_g.tolist()):
                k = len(ids_w)
                srt = torch.sort(lg_w, descending=True).values
                flip = (s, c, (srt[k - 1] - srt[k]).item())
                break
        if flip is None or flip[2] > 0.1 or drift > 0.1:
            found = "no expert flip" if flip is None else (
                f"a flip at decode step {flip[0]} with router margin "
                f"{flip[2]:.4f}")
            fail(f"{tag}: a stream diverges at token {i} where the top-2 "
                 f"margin is {margin:.3f} > 0.1, and the routing replay "
                 f"finds {found} (router logits apart by up to "
                 f"{drift:.4f})")
        print(f"{tag}: a stream parts at token {i} (top-2 margin "
              f"{margin:.4f}) after an expert flip at decode step {flip[0]}, "
              f"routing {flip[1]}: router margin {flip[2]:.4f} <= 0.1, router "
              f"logits apart by up to {drift:.4f} <= 0.1", flush=True)
    print(f"{tag}: {n_same}/{len(got)} streams equal end to end", flush=True)


def phase_moe_serve(torch, dev):
    """Full-width qwen3-moe-30b-a3b (16 of 48 layers) served from bf16 and
    int8 KV pages through the paged_gqa kernels, the gather read and the
    dense layout; then the hybrid jamba smoke stack, paged against
    dense."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels.fused_ssm import ops as ssm_ops
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.models import build_model
    from repro_torch.models.attention import GQAAttention
    from repro_torch.models.moe import MoEMLP

    gc.collect()                   # engines of earlier phases
    torch.cuda.empty_cache()
    full = get_config(MOE_ARCH)
    cfg = dataclasses.replace(full, n_layers=MOE_LAYERS)
    e = cfg.moe
    t0 = time.perf_counter()
    model = _sharpen(torch, build_model(
        cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0)))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"moe_serve: {cfg.name} at full width, depth cut to {cfg.n_layers} "
          f"of its {full.n_layers} layers (fp32 weights of all "
          f"{full.n_layers}: {full.param_count() * 4 / 1e9:.1f} GB), "
          f"{n_params / 1e9:.2f} B fp32 params = {n_params * 4 / 1e9:.1f} "
          f"GB, d {cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads} of "
          f"{cfg.head_dim}, {e.n_experts} experts top-{e.top_k} of width "
          f"{e.d_ff_expert}, vocab {cfg.vocab}, dispatch {e.dispatch}; "
          f"output projections x32; built in {time.perf_counter() - t0:.1f} "
          "s", flush=True)
    rng = np.random.default_rng(4)
    plens = [512, 448, 384, 320, 256, 192, 128, 64]
    prompts = [rng.integers(0, cfg.vocab, size=p) for p in plens]
    gen = 32
    max_len = max(plens) + gen                   # 544: 34 pages of 16
    kernels = (pa_ops.paged_gqa_kernel, pa_ops.paged_gqa_q8_kernel)
    _serve_engine(torch, model, [p[:40] for p in prompts[:4]], 2,
               max_len=max_len)                  # warm-up (cuBLAS etc.)

    def measured(tag, kv_layout="paged", the_prompts=prompts, **kw):
        torch.cuda.reset_peak_memory_stats(dev)
        for k in kernels:
            k.launches = 0
        eng, reqs, dt = _serve_engine(torch, model, the_prompts, gen,
                                   max_len=max_len, kv_layout=kv_layout,
                                   **kw)
        launches = tuple(k.launches for k in kernels)
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        for r in reqs:
            toks = r.tokens
            if not r.finished or len(toks) != gen or not (
                    (toks >= 0) & (toks < cfg.vocab)).all():
                fail(f"moe_serve {tag}: request {r.uid} finished="
                     f"{r.finished}, {len(toks)} tokens {toks}")
        if eng.pool is not None:
            _check_drained(eng, f"moe_serve {tag}")
        ttft = sorted((r.first_token_t - r.created_t) * 1e3 for r in reqs)
        stp = eng.telemetry.registry.histograms["step_ms"].summary()
        n_gen = sum(len(r.tokens) for r in reqs)
        print(f"moe_serve {tag}: {len(reqs)} requests, {n_gen} tokens in "
              f"{dt:.3f} s ({n_gen / dt:.1f} generated tok/s incl. "
              f"prefill), TTFT p50 {ttft[len(ttft) // 2]:.1f} ms max "
              f"{ttft[-1]:.1f} ms, {eng.n_steps} decode steps p50 "
              f"{stp['p50']:.2f} ms, peak memory {peak:.2f} GiB, "
              f"(paged_gqa, paged_gqa_q8) launches {launches}; distinct "
              f"tokens per stream "
              f"{[len(set(r.tokens.tolist())) for r in reqs]}", flush=True)
        return eng, [list(r.tokens) for r in reqs], launches

    # (a) bf16 pages through the paged_gqa kernel
    eng_a, streams_a, (n_a, q_a) = measured("(a) bf16 kernel")
    if q_a or n_a == 0 or n_a != cfg.n_layers * eng_a.n_steps:
        fail(f"moe_serve (a): (paged_gqa, paged_gqa_q8) launches "
             f"{(n_a, q_a)} != ({cfg.n_layers} layers x {eng_a.n_steps} "
             "decode steps, 0)")
    print(f"moe_serve: paged_gqa launches {n_a} = {cfg.n_layers} layers x "
          f"{eng_a.n_steps} decode steps", flush=True)
    del eng_a

    # (b) the same traffic through the gather read
    _reconfigure(model, paged_impl="gather")
    eng_b, streams_b, launched = measured("(b) bf16 gather")
    if any(launched):
        fail(f"moe_serve (b): paged kernel launches {launched}")
    kernel_bf16 = dict(kv_layout="paged", paged_impl="kernel",
                       kv_dtype="bf16")
    _moe_margin_rule(torch, "moe_serve (a) kernel vs (b) gather", model,
                     cfg.vocab, prompts, streams_a, streams_b,
                     got_cfg=kernel_bf16,
                     want_cfg=dict(kernel_bf16, paged_impl="gather"),
                     max_len=max_len)
    del eng_b

    # (c) int8 pages through paged_gqa_q8
    _reconfigure(model, paged_impl="kernel", kv_dtype="int8")
    eng_c, streams_c, (n_c, q_c) = measured("(c) int8 kernel")
    if n_c or q_c == 0 or q_c != cfg.n_layers * eng_c.n_steps:
        fail(f"moe_serve (c): (paged_gqa, paged_gqa_q8) launches "
             f"{(n_c, q_c)} != (0, {cfg.n_layers} layers x "
             f"{eng_c.n_steps} decode steps)")
    same = sum(int(np.sum(np.asarray(a) == np.asarray(b)))
               for a, b in zip(streams_a, streams_c))
    print(f"moe_serve: int8 greedy tokens equal bf16's (a) at {same}/"
          f"{len(prompts) * gen} positions; first divergence per request "
          f"{[_first_divergence(a, b) for a, b in zip(streams_a, streams_c)]}"
          f"; paged_gqa_q8 launches {q_c}", flush=True)
    del eng_c

    # (d) the dense layout
    _reconfigure(model, kv_dtype="bf16")
    eng_d, streams_d, launched = measured("(d) dense", kv_layout="dense")
    if any(launched):
        fail(f"moe_serve (d): paged kernel launches {launched}")
    _moe_margin_rule(torch, "moe_serve (a) kernel vs (d) dense", model,
                     cfg.vocab, prompts, streams_a, streams_d,
                     got_cfg=kernel_bf16,
                     want_cfg=dict(kernel_bf16, kv_layout="dense"),
                     max_len=max_len)
    del eng_d
    _reconfigure(model, paged_impl="kernel", kv_dtype="bf16")

    # batch invariance on the card: the target alone against the same
    # request beside 3 others, and at chunk 64 against chunk 256
    target = prompts[1]
    alone_eng, alone, _ = measured("target alone", the_prompts=[target])
    _e, mixed, _ = measured("target with 3 others",
                            the_prompts=[target] + prompts[5:8])
    _e, chunked, _ = measured("target at chunk 64", the_prompts=[target],
                              prefill_chunk=64)
    del _e
    for tag, other in (("co-batched", mixed[0]), ("chunk 64", chunked[0])):
        _margin_rule(torch, f"moe_serve target {tag} vs alone",
                     alone_eng.sm, cfg.vocab, [target], [other], alone)
        print(f"moe_serve: target {tag} bitwise the lone run's: "
              f"{other == alone[0]}", flush=True)
    del alone_eng

    # one 4-slot decode step at position 543 (the longest chains): eager
    # against its kernels replayed from a CUDA graph, then the device time
    # split between the MoE MLPs (routing, gather, expert GEMMs, combine),
    # the attention layers (projections, rope, pool write, paged_gqa) and
    # everything else (norms, residuals, embedding, head)
    n_chain = max_len // 16
    num_pages = 4 * n_chain
    state = model.init_paged_cache(num_pages, 16, batch=4)
    tok = torch.zeros(4, 1, dtype=torch.int64, device=dev)
    pos = torch.full((4,), max_len - 1, dtype=torch.int32, device=dev)
    bt = torch.arange(num_pages, dtype=torch.int32,
                      device=dev).reshape(4, n_chain)
    act = torch.ones(4, dtype=torch.bool, device=dev)
    rows = torch.arange(4, device=dev)

    def step():
        model.decode_step_paged(tok, state, pos, bt, act, max_len, rows=rows)
    with torch.inference_mode():
        step_eager = eager_ms(torch, step, 10)
        step_dev = device_ms(torch, step, 10)
        print(f"moe_serve: decode_step_paged (4 slots, pos {max_len - 1}): "
              f"eager {step_eager:.2f} ms, device {step_dev:.2f} ms -> card "
              f"idle {1 - step_dev / step_eager:.1%} of an eager step",
              flush=True)
        split, wall = _device_split(torch, step, 5, {
            "moe": (MoEMLP, "forward"),
            "attention": (GQAAttention, "decode_paged")},
            {"paged_gqa::": "attention"})
    busy = sum(split.values())
    if busy <= 0:
        print("moe_serve: decode step device split: not measured (the "
              "profiler saw no device time)", flush=True)
    else:
        print(f"moe_serve: decode step device split (profiler, 5 steps): "
              f"busy {busy:.3f} ms of {wall:.2f} ms wall a step; "
              + ", ".join(f"{k} {v:.3f} ms ({v / busy:.1%})" for k, v in
                          sorted(split.items())), flush=True)
    del state, model
    gc.collect()
    torch.cuda.empty_cache()

    # the hybrid path at smoke size: Mamba layers (fused_ssm_fwd prefill
    # from the carried state) beside paged attention layers
    hcfg = dataclasses.replace(get_config(MOE_HYBRID), ssm_impl="fused")
    hmodel = _sharpen(torch, build_model(
        hcfg, device=dev, generator=torch.Generator(device=dev)
        .manual_seed(0)), 4.0)
    hprompts = [rng.integers(0, hcfg.vocab, size=p)
                for p in (40, 17, 64, 9, 33, 50)]
    n_attn = len(hmodel.paged_layer_names())
    n_mamba = hcfg.n_layers - n_attn
    hruns = {}
    for tag, layout, impl in (("dense", "dense", "kernel"),
                              ("paged gather", "paged", "gather"),
                              ("paged kernel", "paged", "kernel")):
        _reconfigure(hmodel, paged_impl=impl)
        pa_ops.paged_gqa_kernel.launches = 0
        ssm_ops.fused_ssm_fwd_kernel.launches = 0
        heng, hreqs, hdt = _serve_engine(torch, hmodel, hprompts, 16,
                                      max_len=96, kv_layout=layout,
                                      prefill_chunk=32)
        fused, paged = (ssm_ops.fused_ssm_fwd_kernel.launches,
                        pa_ops.paged_gqa_kernel.launches)
        want_fused = heng.sm.n_prefill_chunks * n_mamba
        want_paged = n_attn * heng.n_steps if tag == "paged kernel" else 0
        if (fused, paged) != (want_fused, want_paged):
            fail(f"moe_serve {MOE_HYBRID} {tag}: (fused_ssm_fwd, paged_gqa) "
                 f"launches {(fused, paged)} != {(want_fused, want_paged)}")
        if heng.pool is not None:
            _check_drained(heng, f"moe_serve {MOE_HYBRID} {tag}")
        hruns[tag] = (heng.sm, [list(r.tokens) for r in hreqs], fused, paged)
        print(f"moe_serve {MOE_HYBRID} (smoke) {tag}: {len(hreqs)} requests "
              f"in {hdt:.3f} s, fused_ssm_fwd launches {fused}, paged_gqa "
              f"launches {paged}; distinct tokens per stream "
              f"{[len(set(r.tokens.tolist())) for r in hreqs]}", flush=True)
    if hruns["paged gather"][1] != hruns["dense"][1]:
        fail(f"moe_serve {MOE_HYBRID}: paged gather streams differ from the "
             "dense layout's")
    print(f"moe_serve {MOE_HYBRID}: paged gather streams bitwise the dense "
          "layout's", flush=True)
    _moe_margin_rule(torch, f"moe_serve {MOE_HYBRID} paged kernel vs dense",
                     hmodel, hcfg.vocab, hprompts, hruns["paged kernel"][1],
                     hruns["dense"][1],
                     got_cfg=dict(kv_layout="paged", paged_impl="kernel"),
                     want_cfg=dict(kv_layout="dense", paged_impl="kernel"),
                     max_len=96, prefill_chunk=32)
    launches = {"paged_gqa": n_a + hruns["paged kernel"][3],
                "paged_gqa_q8": q_c,
                "fused_ssm_fwd": sum(r[2] for r in hruns.values())}
    del hmodel, hruns
    gc.collect()
    torch.cuda.empty_cache()
    return launches


#: The whisper phase: Whisper's 448-token text context, 64 decode tokens.
WHISPER_SEQ, WHISPER_GEN = 448, 64
#: Layers of llava-next-34b's 60 that the vlm phase trains: the port's
#: AdamW holds fp32 params, grads and two moments, 16 B a parameter; 4
#: layers (2.23 B parameters) and the untied embedding and head (0.92 B)
#: need 50.4 GB, all 60 would need 550 GB.
VLM_LAYERS = 4


class _WithEmbeds:
    """``loader``'s batches for steps 0..steps-1 with stub frontend
    embeddings added: ``embeds`` (B, n, d) fp32, 0.1 x a normal seeded
    by the step, made in bulk before the run (set-up, not step time)."""

    def __init__(self, loader, n, d, steps, seed=0):
        import numpy as np

        self.loader = loader
        self.embeds = [
            0.1 * np.random.default_rng((seed, step)).standard_normal(
                (loader.global_batch, n, d), dtype=np.float32)
            for step in range(steps)]

    def batch_at(self, step):
        return dict(self.loader.batch_at(step), embeds=self.embeds[step])


def _on_card(batch, dev):
    """A loader's numpy batch on the card: float arrays in their dtype,
    the rest as int64 (as Trainer moves them)."""
    import torch
    return {k: torch.from_numpy(v).to(dev, None if v.dtype.kind == "f"
                                      else torch.int64)
            for k, v in batch.items()}


def _flash_counts():
    """The flash kernels' launch counters: (fwd, dq, dkv) and the same on
    the tc route."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    fwd_k, bwd_k = fa_ops.flash_fwd_kernel, fa_ops.flash_bwd_kernel
    return (fwd_k.launches, bwd_k.launches_dq, bwd_k.launches_dkv,
            fwd_k.launches_tc, bwd_k.launches_dq_tc, bwd_k.launches_dkv_tc)


def _zero_flash_counts():
    from repro_torch.kernels.flash_attention import ops as fa_ops
    fwd_k, bwd_k = fa_ops.flash_fwd_kernel, fa_ops.flash_bwd_kernel
    fwd_k.launches = bwd_k.launches_dq = bwd_k.launches_dkv = 0
    fwd_k.launches_tc = bwd_k.launches_dq_tc = bwd_k.launches_dkv_tc = 0


def _flash_against_naive(torch, tag, model, batch):
    """The first step's loss and gradients of ``model`` on ``batch`` with
    attention_impl "flash", then "naive" on the same weights (no optimizer
    step): |dloss| <= 2e-2 and the gradient norms within 2 % (the standing
    flash-against-naive bound of phase attn_train); the smallest
    per-tensor cosine printed.  Returns the flash loss; leaves the model
    on flash with no gradients."""
    runs = {}
    for impl in ("flash", "naive"):
        _reconfigure(model, attention_impl=impl)
        model.zero_grad(set_to_none=True)
        n0 = _flash_counts()
        loss, _ = model.loss(batch)
        loss.backward()
        ran = tuple(a - b for a, b in zip(_flash_counts(), n0))
        grads = {n: p.grad for n, p in model.named_parameters()}
        norm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                              for g in grads.values())).item()
        runs[impl] = (loss.item(), norm, grads, ran)
        model.zero_grad(set_to_none=True)
    _reconfigure(model, attention_impl="flash")
    (fl, fg, fgrads, f_ran), (nl, ng, ngrads, n_ran) = (runs["flash"],
                                                        runs["naive"])
    if not all(f_ran[:3]) or any(n_ran):
        fail(f"{tag}: flash launches (fwd, dq, dkv, tc...) {f_ran} in the "
             f"flash step, {n_ran} in the naive one")
    cos = min((torch.sum(a.double() * b.double())
               / (a.double().norm() * b.double().norm())).item()
              for a, b in zip(fgrads.values(), ngrads.values())
              if b.abs().max() > 0)
    dl, dg = abs(fl - nl), abs(fg - ng) / ng
    print(f"{tag}: first step flash loss {fl:.5f} grad norm {fg:.5f}; naive "
          f"loss {nl:.5f} grad norm {ng:.5f} (|dloss| {dl:.2e} tol 2e-2, "
          f"grad norm {dg:.2%} tol 2 %); smallest per-tensor gradient "
          f"cosine {cos:.5f}", flush=True)
    if not (dl <= 2e-2 and dg <= 0.02):
        fail(f"{tag}: the first step with flash differs from naive")
    del fgrads, ngrads, runs
    return fl


def _check_training(tag, losses, steps, cfg, want_launches):
    """Every step ran with a finite loss (a few steps from random weights
    on fresh batches need not lower it: the step-to-step spread is larger
    than the fall), and the flash kernels launched as ``want_launches``
    says, all on the tc route."""
    import math

    launches, want = want_launches
    if len(losses) != steps or not all(math.isfinite(v) for v in losses):
        fail(f"{tag}: {len(losses)} of {steps} steps, losses {losses}")
    if launches != (want,) * 6:
        fail(f"{tag}: flash launches (fwd, dq, dkv, then on the tc route) "
             f"{launches} != {cfg.n_layers} decoder layers x {steps} steps")


def _train_through_flash(torch, dev, tag, model, loader, steps):
    """``steps`` AdamW steps of ``model`` through build_train_step on
    ``loader``'s batches, the first step held to naive first
    (:func:`_flash_against_naive`): every step's loss finite, the flash
    kernels launched once a layer a step, all on the tc route, and the
    peak memory at most 70 GiB.  Returns (the checked first loss, losses,
    step seconds, flash launches, peak GiB, the step function)."""
    from repro_torch.optim import AdamW, cosine_schedule, param_groups
    from repro_torch.train import build_train_step

    cfg = model.cfg
    first = _flash_against_naive(torch, tag, model,
                                 _on_card(loader.batch_at(0), dev))
    opt = AdamW(param_groups(model), lr=cosine_schedule(3e-4, warmup=0,
                                                        total=steps))
    step_fn = build_train_step(model, opt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _zero_flash_counts()
    losses, dts = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        _, met = step_fn({}, _on_card(loader.batch_at(i), dev))
        losses.append(float(met["loss"]))
        dts.append(time.perf_counter() - t0)
    launches = _flash_counts()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 2**30
    _check_training(tag, losses, steps, cfg, (launches,
                                              cfg.n_layers * steps))
    if peak_gb > 70:
        fail(f"{tag}: peak memory {peak_gb:.2f} GiB > 70 GiB at "
             f"{cfg.n_layers} layers")
    return first, losses, dts, launches, peak_gb, step_fn


def phase_whisper(torch, dev):
    """Full-width whisper-small trained through Trainer with flash in the
    decoder, the first step held to naive; then 4 requests encoded once
    and decoded greedily from the cross-K/V cache, held to the full
    forward teacher-forced."""
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.data import ShardedLoader, SyntheticLMDataset
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW, cosine_schedule, param_groups
    from repro_torch.train import TrainConfig, Trainer

    gc.collect()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_config("whisper-small"),
                              attention_impl="flash")
    steps, batch, seed = 10, 4, 0
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev, generator=torch.Generator(
        device=dev).manual_seed(seed))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"whisper: {cfg.name} at full width, {cfg.n_enc_layers} + "
          f"{cfg.n_layers} layers, d {cfg.d_model}, {cfg.n_heads} heads of "
          f"{cfg.head_dim}, vocab {cfg.vocab}, {cfg.frontend_seq} stub frame "
          f"embeddings; {n_params / 1e6:.1f} M fp32 params; built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    loader = _WithEmbeds(ShardedLoader(SyntheticLMDataset(
        vocab=cfg.vocab, seq_len=WHISPER_SEQ), global_batch=batch),
        cfg.frontend_seq, cfg.d_model, steps)
    first = _flash_against_naive(torch, "whisper (a)", model,
                                 _on_card(loader.batch_at(0), dev))
    opt = AdamW(param_groups(model), lr=cosine_schedule(3e-4, warmup=0,
                                                        total=steps))
    with tempfile.TemporaryDirectory() as ckpt_dir:
        trainer = Trainer(model, opt, TrainConfig(
            steps=steps, ckpt_every=steps + 1, ckpt_dir=ckpt_dir,
            log_every=steps), loader=loader, seed=seed)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        _zero_flash_counts()
        t0 = time.perf_counter()
        _, step = trainer.run()
        wall = time.perf_counter() - t0
        launches = _flash_counts()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 2**30
    hist = trainer.history
    losses = [h["loss"] for h in hist]
    if trainer.restores:
        fail(f"whisper (a): {trainer.restores} crash-restores")
    _check_training("whisper (a)", losses, steps, cfg,
                    (launches, cfg.n_layers * steps))
    dts = sorted(h["dt"] for h in hist[2:])
    step_ms = dts[len(dts) // 2] * 1e3
    print(f"whisper (a): {steps} AdamW steps (batch {batch} x {WHISPER_SEQ} "
          f"tokens, {cfg.frontend_seq} frames) in {wall:.1f} s incl. the "
          f"final checkpoint; step p50 {step_ms:.1f} ms (first "
          f"{hist[0]['dt'] * 1e3:.0f} ms) -> "
          f"{batch * WHISPER_SEQ / (step_ms / 1e3):.0f} decoder tokens/s; "
          f"peak memory {peak_gb:.2f} GiB; loss {losses[0]:.4f} (the "
          f"checked first step's {first:.4f}) -> {losses[-1]:.4f}; flash "
          f"launches fwd, dq, dkv {launches[:3]} = {cfg.n_layers} decoder "
          f"layers x {steps} steps, all on the tc route", flush=True)
    del trainer, model, opt
    gc.collect()
    torch.cuda.empty_cache()

    # (b) 4 requests: encode once into the cross-K/V cache, then greedy
    # decode_step from a dense self-cache; output projections x32 so the
    # greedy streams vary (the tied head otherwise reads each input back)
    model = _sharpen(torch, build_model(cfg, device=dev, generator=torch
                                        .Generator(device=dev).manual_seed(1)))
    g = torch.Generator(device=dev).manual_seed(2)
    frames = 0.1 * torch.randn(batch, cfg.frontend_seq, cfg.d_model,
                               device=dev, generator=g)
    start = torch.randint(0, cfg.vocab, (batch, 1), device=dev, generator=g)
    with torch.inference_mode():
        model.encode(frames)                                 # warm-up
        enc_ms = eager_ms(torch, lambda: model.encode(frames), 5)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cache = model.init_cache(batch, WHISPER_GEN, frame_embeds=frames)
        torch.cuda.synchronize()
        fill_ms = (time.perf_counter() - t0) * 1e3
        tok, toks, logits, dts = start, [], [], []
        t0 = time.perf_counter()
        for t in range(WHISPER_GEN):
            ts = time.perf_counter()
            lg, cache = model.decode_step(tok, cache, t)
            tok = lg[:, :, :cfg.vocab].argmax(-1)
            toks.append(tok)
            logits.append(lg[:, 0])
            torch.cuda.synchronize()
            dts.append(time.perf_counter() - ts)
        dec_s = time.perf_counter() - t0
        stream = torch.cat(toks, 1)                          # (B, GEN)
        dec = torch.stack(logits, 1)
        # the full forward over the same tokens, teacher-forced
        full = model(torch.cat([start, stream[:, :-1]], 1), embeds=frames)
    top2 = torch.topk(full[..., :cfg.vocab], 2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]
    differ = full[..., :cfg.vocab].argmax(-1) != stream
    worst = margin[differ].max().item() if differ.any() else None
    err = (dec - full).abs().max().item()
    distinct = [len(set(r.tolist())) for r in stream]
    dts = sorted(dts[1:])
    print(f"whisper (b): {batch} requests encoded once ({cfg.frontend_seq} "
          f"frames: encoder {enc_ms:.2f} ms eager), cross-K/V cache filled "
          f"in {fill_ms:.1f} ms, {WHISPER_GEN} greedy decode steps in "
          f"{dec_s:.3f} s: step p50 {dts[len(dts) // 2] * 1e3:.2f} ms, "
          f"{batch * WHISPER_GEN / dec_s:.1f} generated tok/s; decode vs the "
          f"teacher-forced forward: max |logits diff| {err:.3g}, "
          f"{int(differ.sum())} greedy choices differ (largest top-2 margin "
          f"there {worst}, rule <= 0.1); distinct tokens per stream "
          f"{distinct}", flush=True)
    if worst is not None and worst > 0.1:
        fail(f"whisper (b): a decode choice differs from the full forward "
             f"where its top-2 margin is {worst:.3f} > 0.1")
    if max(distinct) < 2:
        fail("whisper (b): every stream repeats one token")
    del model, cache, full, dec, frames
    gc.collect()
    torch.cuda.empty_cache()
    return {"flash_fwd": launches[0], "flash_bwd": launches[2]}


def phase_vlm(torch, dev):
    """Full-width llava-next-34b cut to VLM_LAYERS layers trained with 576
    patch embeddings before 512 tokens, flash attention, the first step
    held to naive."""
    from repro_torch.configs import get_config
    from repro_torch.data import ShardedLoader, SyntheticLMDataset
    from repro_torch.models import build_model

    gc.collect()
    torch.cuda.empty_cache()
    full = get_config("llava-next-34b")
    cfg = dataclasses.replace(full, n_layers=VLM_LAYERS,
                              attention_impl="flash")
    steps, batch, seq, seed = 5, 2, 512, 0
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev, generator=torch.Generator(
        device=dev).manual_seed(seed))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"vlm: {cfg.name} at full width, depth cut to {cfg.n_layers} of "
          f"its {full.n_layers} layers (AdamW state of all "
          f"{full.n_layers}: {full.param_count() * 16 / 1e9:.0f} GB), "
          f"{n_params / 1e9:.2f} B fp32 params, d {cfg.d_model}, heads "
          f"{cfg.n_heads}/{cfg.n_kv_heads} of {cfg.head_dim}, vocab "
          f"{cfg.vocab}, {cfg.frontend_seq} patch embeddings + {seq} "
          f"tokens; built in {time.perf_counter() - t0:.1f} s", flush=True)
    loader = _WithEmbeds(ShardedLoader(SyntheticLMDataset(
        vocab=cfg.vocab, seq_len=seq), global_batch=batch),
        cfg.frontend_seq, cfg.d_model, steps)
    first, losses, dts, launches, peak_gb, step_fn = _train_through_flash(
        torch, dev, "vlm", model, loader, steps)
    p50 = sorted(dts[1:])[(steps - 1) // 2] * 1e3
    tokens = batch * (cfg.frontend_seq + seq)
    print(f"vlm: {steps} AdamW steps (batch {batch} x ({cfg.frontend_seq} "
          f"patches + {seq} tokens)): step p50 {p50:.1f} ms (first "
          f"{dts[0] * 1e3:.0f} ms) -> {tokens / (p50 / 1e3):.0f} positions/s; "
          f"peak memory {peak_gb:.2f} GiB; loss {losses[0]:.4f} (the checked "
          f"first step's {first:.4f}) -> {losses[-1]:.4f}; flash launches "
          f"fwd, dq, dkv {launches[:3]} = {cfg.n_layers} layers x {steps} "
          f"steps, all on the tc route", flush=True)
    del model, step_fn
    gc.collect()
    torch.cuda.empty_cache()
    return {"flash_fwd": launches[0], "flash_bwd": launches[2]}


#: The wide_head_train phase: batch 1 x 4096 tokens, 5 AdamW steps, and
#: stablelm-12b cut to 4 of its 40 layers (278 M parameters each, with the
#: untied embedding and head 1.03 B: 2.14 B fp32 parameters, 34 GB with
#: gradients and AdamW's two moments; all 40 would need 197 GB).  gemma3-4b
#: is cut to one pattern unit of 6 layers (94 M each and 671 M of tied
#: embedding: 1.24 B, 20 GB with state).
WIDE_SEQ, WIDE_STEPS = 4096, 5
WIDE_CUTS = [("stablelm-12b", dict(n_layers=4)),
             ("gemma3-4b", dict(n_layers=6, tail_layers=()))]


def _flash_device_share(torch, fn):
    """One call of ``fn`` under the profiler: (device ms of the flash
    kernels, device ms of every kernel, wall ms)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    flash = busy = 0.0
    for e in prof.events():
        for k in getattr(e, "kernels", None) or []:
            busy += k.duration / 1e3
            flash += k.duration / 1e3 if "flash::" in k.name else 0.0
    return flash, busy, wall


def _train_wide(torch, dev, arch, cut):
    """``arch`` cut by ``cut`` at full width, trained WIDE_STEPS AdamW
    steps at batch 1 x WIDE_SEQ through flash (first step held to naive,
    every launch on the tc route, peak under 70 GiB).  Returns the flash
    launches (fwd, dq, dkv)."""
    from repro_torch.configs import get_config
    from repro_torch.data import ShardedLoader, SyntheticLMDataset
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import build_model

    gc.collect()
    torch.cuda.empty_cache()
    full = get_config(arch)
    cfg = dataclasses.replace(full, attention_impl="flash", **cut)
    kinds = [spec.kind for spec in cfg.layer_specs()]
    steps, batch, seed = WIDE_STEPS, 1, 0
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev, generator=torch.Generator(
        device=dev).manual_seed(seed))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    route = fa_ops.route(torch.bfloat16, cfg.head_dim)
    local = kinds.count("attn_local")
    local = (f", {local} of them sliding-window at {cfg.sliding_window}"
             if local else "")
    print(f"wide_head_train: {arch} at full width, depth cut to "
          f"{cfg.n_layers} of its {full.n_layers} layers{local}, d "
          f"{cfg.d_model}, heads "
          f"{cfg.n_heads}/{cfg.n_kv_heads} of {cfg.head_dim} (flash {route} "
          f"route), vocab {cfg.vocab}; {n_params / 1e9:.2f} B fp32 params; "
          f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    if route != "tc":
        fail(f"wide_head_train {arch}: head dim {cfg.head_dim} on the "
             f"{route} route")
    loader = ShardedLoader(SyntheticLMDataset(vocab=cfg.vocab,
                                              seq_len=WIDE_SEQ),
                           global_batch=batch)
    tag = f"wide_head_train {arch}"
    first, losses, dts, launches, peak_gb, step_fn = _train_through_flash(
        torch, dev, tag, model, loader, steps)
    p50 = sorted(dts[1:])[(steps - 1) // 2] * 1e3
    print(f"{tag}: {steps} AdamW steps (batch {batch} x {WIDE_SEQ} tokens): "
          f"step p50 {p50:.1f} ms (first {dts[0] * 1e3:.0f} ms) -> "
          f"{batch * WIDE_SEQ / (p50 / 1e3):.0f} tokens/s; peak memory "
          f"{peak_gb:.2f} GiB; loss {losses[0]:.4f} (the checked first "
          f"step's {first:.4f}) -> {losses[-1]:.4f}; flash launches fwd, dq, "
          f"dkv {launches[:3]} = {cfg.n_layers} layers x {steps} steps, all "
          f"on the tc route", flush=True)
    # where a step's time goes: one more step under the profiler, after
    # the counted run
    extra = _on_card(loader.batch_at(steps), dev)
    flash_ms, busy_ms, wall_ms = _flash_device_share(
        torch, lambda: step_fn({}, extra))
    print(f"{tag}: one profiled step: device busy {busy_ms:.1f} ms of "
          f"{wall_ms:.1f} ms wall (idle {1 - busy_ms / wall_ms:.1%}); the "
          f"flash kernels {flash_ms:.2f} ms ({flash_ms / busy_ms:.1%} of "
          f"the busy time)", flush=True)
    del model, step_fn
    gc.collect()
    torch.cuda.empty_cache()
    return launches[:3]


def phase_wide_head_train(torch, dev):
    """Flash above head dim 128 on the tc route, end to end: WIDE_CUTS
    trained at full width (:func:`_train_wide`)."""
    launches = {"flash_fwd": 0, "flash_bwd": 0}
    for arch, cut in WIDE_CUTS:
        fwd, _, dkv = _train_wide(torch, dev, arch, cut)
        launches["flash_fwd"] += fwd
        launches["flash_bwd"] += dkv
    return launches


def phase_stablelm_serve(torch, dev):
    """Full-width stablelm-12b, all 40 layers, served from bf16 pages
    through paged_gqa at head dim 160 (20 16-byte chunks a row, the 4
    query rows of a kv head in one tile), against the gather read, then
    from int8 pages through paged_gqa_q8."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.models import build_model
    from repro_torch.models.attention import GQAAttention
    from repro_torch.models.moe import DenseMLP

    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config("stablelm-12b")
    group = cfg.n_heads // cfg.n_kv_heads
    t0 = time.perf_counter()
    model = _sharpen(torch, build_model(
        cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0)))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"stablelm_serve: {cfg.name} at full width, all {cfg.n_layers} "
          f"layers, {n_params / 1e9:.2f} B fp32 params = "
          f"{n_params * 4 / 1e9:.1f} GB, d {cfg.d_model}, heads "
          f"{cfg.n_heads}/{cfg.n_kv_heads} of {cfg.head_dim} (paged_gqa: "
          f"{_layout_tag(pa_ops, cfg.head_dim, 2, group)} for bf16 pages, "
          f"{_layout_tag(pa_ops, cfg.head_dim, 1, group)} for int8), vocab "
          f"{cfg.vocab}; output projections x32; built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    rng = np.random.default_rng(5)
    plens = [512, 448, 384, 320, 256, 192, 128, 64]
    prompts = [rng.integers(0, cfg.vocab, size=p) for p in plens]
    gen = 32
    max_len = max(plens) + gen                   # 544: 34 pages of 16
    kernels = (pa_ops.paged_gqa_kernel, pa_ops.paged_gqa_q8_kernel)
    _serve_engine(torch, model, [p[:40] for p in prompts[:4]], 2,
                  max_len=max_len)               # warm-up (cuBLAS etc.)

    def measured(tag):
        torch.cuda.reset_peak_memory_stats(dev)
        for k in kernels:
            k.launches = 0
        eng, reqs, dt = _serve_engine(torch, model, prompts, gen,
                                      max_len=max_len)
        launches = tuple(k.launches for k in kernels)
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        for r in reqs:
            toks = r.tokens
            if not r.finished or len(toks) != gen or not (
                    (toks >= 0) & (toks < cfg.vocab)).all():
                fail(f"stablelm_serve {tag}: request {r.uid} finished="
                     f"{r.finished}, {len(toks)} tokens {toks}")
        _check_drained(eng, f"stablelm_serve {tag}")
        ttft = sorted((r.first_token_t - r.created_t) * 1e3 for r in reqs)
        stp = eng.telemetry.registry.histograms["step_ms"].summary()
        n_gen = sum(len(r.tokens) for r in reqs)
        print(f"stablelm_serve {tag}: {len(reqs)} requests, {n_gen} tokens "
              f"in {dt:.3f} s ({n_gen / dt:.1f} generated tok/s incl. "
              f"prefill), TTFT p50 {ttft[len(ttft) // 2]:.1f} ms max "
              f"{ttft[-1]:.1f} ms, {eng.n_steps} decode steps p50 "
              f"{stp['p50']:.2f} ms, peak memory {peak:.2f} GiB, "
              f"(paged_gqa, paged_gqa_q8) launches {launches}; distinct "
              f"tokens per stream "
              f"{[len(set(r.tokens.tolist())) for r in reqs]}", flush=True)
        return eng, [list(r.tokens) for r in reqs], launches

    # (a) bf16 pages through paged_gqa
    eng_a, streams_a, (n_a, q_a) = measured("(a) bf16 kernel")
    if q_a or n_a == 0 or n_a != cfg.n_layers * eng_a.n_steps:
        fail(f"stablelm_serve (a): (paged_gqa, paged_gqa_q8) launches "
             f"{(n_a, q_a)} != ({cfg.n_layers} layers x {eng_a.n_steps} "
             "decode steps, 0)")
    del eng_a
    # (b) the same traffic through the gather read
    _reconfigure(model, paged_impl="gather")
    eng_b, streams_b, launched = measured("(b) bf16 gather")
    if any(launched):
        fail(f"stablelm_serve (b): paged kernel launches {launched}")
    _margin_rule(torch, "stablelm_serve (a) kernel vs (b) gather", eng_b.sm,
                 cfg.vocab, prompts, streams_a, streams_b)
    del eng_b
    # (c) int8 pages through paged_gqa_q8
    _reconfigure(model, paged_impl="kernel", kv_dtype="int8")
    eng_c, streams_c, (n_c, q_c) = measured("(c) int8 kernel")
    if n_c or q_c == 0 or q_c != cfg.n_layers * eng_c.n_steps:
        fail(f"stablelm_serve (c): (paged_gqa, paged_gqa_q8) launches "
             f"{(n_c, q_c)} != (0, {cfg.n_layers} layers x "
             f"{eng_c.n_steps} decode steps)")
    same = sum(int(np.sum(np.asarray(a) == np.asarray(b)))
               for a, b in zip(streams_a, streams_c))
    print(f"stablelm_serve: int8 greedy tokens equal bf16's (a) at {same}/"
          f"{len(prompts) * gen} positions; first divergence per request "
          f"{[_first_divergence(a, b) for a, b in zip(streams_a, streams_c)]}"
          f"; launches paged_gqa {n_a} (a), paged_gqa_q8 {q_c} (c)",
          flush=True)
    del eng_c

    # one 4-slot bf16 decode step at position 543 (the longest chains):
    # eager against its kernels replayed from a CUDA graph, then the device
    # time split between the attention layers (projections, rope, pool
    # write, paged_gqa), the MLPs and the rest (norms, embedding, head)
    _reconfigure(model, kv_dtype="bf16")
    n_chain = max_len // 16
    state = model.init_paged_cache(4 * n_chain, 16)
    tok = torch.zeros(4, 1, dtype=torch.int64, device=dev)
    pos = torch.full((4,), max_len - 1, dtype=torch.int32, device=dev)
    bt = torch.arange(4 * n_chain, dtype=torch.int32,
                      device=dev).reshape(4, n_chain)
    act = torch.ones(4, dtype=torch.bool, device=dev)
    rows = torch.arange(4, device=dev)

    def step():
        model.decode_step_paged(tok, state, pos, bt, act, max_len, rows=rows)
    with torch.inference_mode():
        step_eager = eager_ms(torch, step, 5)
        step_dev = device_ms(torch, step, 5)
        split, wall = _device_split(torch, step, 3, {
            "attention": (GQAAttention, "decode_paged"),
            "mlp": (DenseMLP, "forward")}, {"paged_gqa::": "attention"})
    busy = sum(split.values())
    print(f"stablelm_serve: decode_step_paged (4 slots, pos {max_len - 1}, "
          f"bf16 pages): eager {step_eager:.2f} ms, device {step_dev:.2f} ms "
          f"-> card idle {1 - step_dev / step_eager:.1%} of an eager step; "
          + ("device split: not measured (the profiler saw no device time)"
             if busy <= 0 else
             f"device split (profiler, 3 steps): busy {busy:.3f} ms of "
             f"{wall:.2f} ms wall a step; " + ", ".join(
                 f"{k} {v:.3f} ms ({v / busy:.1%})"
                 for k, v in sorted(split.items()))), flush=True)
    del state, model
    gc.collect()
    torch.cuda.empty_cache()
    return {"paged_gqa": n_a, "paged_gqa_q8": q_c}


#: Layers of mistral-large-123b's 88 that mistral_serve keeps (full width:
#: 11.9 B parameters, 47.5 GB in fp32; 12 would be 69.7 GB and leave too
#: little room for the per-call bf16 weight casts, ~2.8 GB a layer)
MISTRAL_LAYERS = 8
#: mistral_serve's measured peak (max_memory_allocated over serving run
#: (a), less what was allocated before the model was built) must lie
#: within this fraction of the dry-run's predicted peak (arguments +
#: temp of the decode cell); fixed before the first card run (PERF.md)
MISTRAL_PEAK_TOL = 0.05


def phase_mistral_serve(torch, dev):
    """Full-width mistral-large-123b cut to MISTRAL_LAYERS layers with the
    dry-run's ``depth_variant``: the dry-run's prediction for its decode
    cell first, then 8 requests from bf16 pages through paged_gqa (group
    12, vector route) against the gather read (margin rule), and from int8
    pages through paged_gqa_q8; the parameter bytes equal the prediction,
    the peak lies within MISTRAL_PEAK_TOL of it, and one decode step's
    device time is printed beside the predicted memory_s."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import ShapeMesh
    from repro_torch.models import build_model

    gc.collect()
    torch.cuda.empty_cache()
    cfg = dryrun.depth_variant(get_config("mistral-large-123b"),
                               MISTRAL_LAYERS)
    plens = [512, 448, 384, 320, 256, 192, 128, 64]
    gen = 32
    max_len = max(plens) + gen                   # 544: 34 pages of 16
    # (1) the prediction for this cell, before anything is built
    t0 = time.perf_counter()
    pred = dryrun.lower_cell(cfg.name, "decode_32k",
                             ShapeMesh(("data", "model"), (1, 1)), cfg=cfg,
                             batch_override=4, seq_override=max_len)
    mem, roof = pred["memory_analysis"], pred["roofline"]
    want_params = mem["argument_parts"]["params"]
    want_peak = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
    print(f"mistral_serve: dry-run prediction (lower_cell, decode_32k at "
          f"batch 4 x {max_len}, {cfg.n_layers} of 88 layers, 1x1 mesh; "
          f"{time.perf_counter() - t0:.1f} s on meta tensors): arguments "
          f"{mem['argument_size_in_bytes']} B ({mem['argument_parts']}), "
          f"temp {mem['temp_size_in_bytes']} B, peak {want_peak} B = "
          f"{want_peak / 2**30:.2f} GiB; flops "
          f"{pred['cost_analysis']['flops']:.4g}, bytes accessed "
          f"{pred['cost_analysis']['bytes accessed']:.4g} -> memory_s "
          f"{roof['memory_s'] * 1e3:.3f} ms, compute_s "
          f"{roof['compute_s'] * 1e3:.4f} ms (H100 SXM data-sheet peaks)",
          flush=True)

    base = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    model = _sharpen(torch, build_model(
        cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0)))
    torch.cuda.synchronize()
    n_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    print(f"mistral_serve: {cfg.name} at full width, {cfg.n_layers} of 88 "
          f"layers, {n_bytes / 4e9:.2f} B fp32 params = {n_bytes / 1e9:.1f} "
          f"GB, d {cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads} of "
          f"{cfg.head_dim} (paged_gqa route "
          f"{pa_ops.gqa_route(cfg.head_dim, 2)}), d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab}; output projections x32; built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if n_bytes != want_params:
        fail(f"mistral_serve: parameter bytes {n_bytes} != the dry-run's "
             f"{want_params}")
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg.vocab, size=p) for p in plens]
    kernels = (pa_ops.paged_gqa_kernel, pa_ops.paged_gqa_q8_kernel)
    _serve_engine(torch, model, [p[:40] for p in prompts[:4]], 2,
                  max_len=max_len)               # warm-up (cuBLAS etc.)
    gc.collect()

    def measured(tag):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        for k in kernels:
            k.launches = 0
        eng, reqs, dt = _serve_engine(torch, model, prompts, gen,
                                      max_len=max_len)
        launches = tuple(k.launches for k in kernels)
        peak = torch.cuda.max_memory_allocated(dev) - base
        for r in reqs:
            toks = r.tokens
            if not r.finished or len(toks) != gen or not (
                    (toks >= 0) & (toks < cfg.vocab)).all():
                fail(f"mistral_serve {tag}: request {r.uid} finished="
                     f"{r.finished}, {len(toks)} tokens {toks}")
        _check_drained(eng, f"mistral_serve {tag}")
        ttft = sorted((r.first_token_t - r.created_t) * 1e3 for r in reqs)
        stp = eng.telemetry.registry.histograms["step_ms"].summary()
        n_gen = sum(len(r.tokens) for r in reqs)
        print(f"mistral_serve {tag}: {len(reqs)} requests, {n_gen} tokens "
              f"in {dt:.3f} s ({n_gen / dt:.1f} generated tok/s incl. "
              f"prefill), TTFT p50 {ttft[len(ttft) // 2]:.1f} ms max "
              f"{ttft[-1]:.1f} ms, {eng.n_steps} decode steps p50 "
              f"{stp['p50']:.2f} ms, peak {peak} B = {peak / 2**30:.2f} GiB "
              f"above the phase's start, (paged_gqa, paged_gqa_q8) "
              f"launches {launches}", flush=True)
        return eng, [list(r.tokens) for r in reqs], launches, peak

    # (2) bf16 pages through paged_gqa, the peak against the prediction
    eng_a, streams_a, (n_a, q_a), peak = measured("(a) bf16 kernel")
    if q_a or n_a == 0 or n_a != cfg.n_layers * eng_a.n_steps:
        fail(f"mistral_serve (a): (paged_gqa, paged_gqa_q8) launches "
             f"{(n_a, q_a)} != ({cfg.n_layers} layers x {eng_a.n_steps} "
             "decode steps, 0)")
    rel = peak / want_peak - 1.0
    print(f"mistral_serve: peak predicted {want_peak} B "
          f"({want_peak / 2**30:.2f} GiB), measured {peak} B "
          f"({peak / 2**30:.2f} GiB): {rel:+.2%} (tol "
          f"{MISTRAL_PEAK_TOL:.0%}); parameter bytes {n_bytes} = the "
          "prediction exactly", flush=True)
    if abs(rel) > MISTRAL_PEAK_TOL:
        fail(f"mistral_serve: measured peak {peak} B is {rel:+.2%} off the "
             f"dry-run's {want_peak} B (tol {MISTRAL_PEAK_TOL:.0%})")
    del eng_a
    # the same traffic through the gather read
    _reconfigure(model, paged_impl="gather")
    eng_b, streams_b, launched, _ = measured("(b) bf16 gather")
    if any(launched):
        fail(f"mistral_serve (b): paged kernel launches {launched}")
    _margin_rule(torch, "mistral_serve (a) kernel vs (b) gather", eng_b.sm,
                 cfg.vocab, prompts, streams_a, streams_b)
    del eng_b
    # (c) int8 pages through paged_gqa_q8, against the gather read
    _reconfigure(model, paged_impl="kernel", kv_dtype="int8")
    eng_c, streams_c, (n_c, q_c), _ = measured("(c) int8 kernel")
    if n_c or q_c == 0 or q_c != cfg.n_layers * eng_c.n_steps:
        fail(f"mistral_serve (c): (paged_gqa, paged_gqa_q8) launches "
             f"{(n_c, q_c)} != (0, {cfg.n_layers} layers x "
             f"{eng_c.n_steps} decode steps)")
    same = sum(int(np.sum(np.asarray(a) == np.asarray(b)))
               for a, b in zip(streams_a, streams_c))
    print(f"mistral_serve: int8 greedy tokens equal bf16's (a) at {same}/"
          f"{len(prompts) * gen} positions; first divergence per request "
          f"{[_first_divergence(a, b) for a, b in zip(streams_a, streams_c)]}"
          , flush=True)
    del eng_c

    # (3) one 4-slot bf16 decode step at position 543, its device time
    # beside the dry-run's memory_s (the decode cell's eager bytes over
    # the data-sheet HBM rate)
    _reconfigure(model, kv_dtype="bf16")
    n_chain = max_len // 16
    state = model.init_paged_cache(4 * n_chain, 16)
    tok = torch.zeros(4, 1, dtype=torch.int64, device=dev)
    pos = torch.full((4,), max_len - 1, dtype=torch.int32, device=dev)
    bt = torch.arange(4 * n_chain, dtype=torch.int32,
                      device=dev).reshape(4, n_chain)
    act = torch.ones(4, dtype=torch.bool, device=dev)
    rows = torch.arange(4, device=dev)

    def step():
        model.decode_step_paged(tok, state, pos, bt, act, max_len, rows=rows)
    with torch.inference_mode():
        step_eager = eager_ms(torch, step, 3)
        step_dev = device_ms(torch, step, 3)
    print(f"mistral_serve: decode_step_paged (4 slots, pos {max_len - 1}, "
          f"bf16 pages): device {step_dev:.3f} ms against the dry-run's "
          f"memory_s {roof['memory_s'] * 1e3:.3f} ms (measured / predicted "
          f"{step_dev / (roof['memory_s'] * 1e3):.3f}); eager "
          f"{step_eager:.3f} ms -> card idle "
          f"{1 - step_dev / step_eager:.1%} of an eager step", flush=True)
    del state, model
    gc.collect()
    torch.cuda.empty_cache()
    return {"paged_gqa": n_a, "paged_gqa_q8": q_c}


def phase_dryrun_train(torch, dev):
    """Full-width smollm-360m at batch 4 x 2048 through flash, one AdamW
    step with remat="none" and one with remat="full" from the same seed:
    the two first-step losses and gradient norms equal bit for bit, each
    measured peak printed beside the dry-run's prediction (its meta pass
    runs the flash stand-in, ``impl="optimized"``: flash itself never
    sees a meta tensor), and full's peak below none's; (c) the full step
    on a model bound to a world-1 1x1 mesh, bitwise the unbound one."""
    from repro_torch.configs import get_config
    from repro_torch.data import ShardedLoader, SyntheticLMDataset
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import ShapeMesh
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW, param_groups
    from repro_torch.train import build_train_step

    cfg = dataclasses.replace(get_config("smollm-360m"),
                              attention_impl="flash")
    B, S = 4, 2048
    one = ShardedLoader(SyntheticLMDataset(vocab=cfg.vocab, seq_len=S),
                        global_batch=B)
    out, counts = {}, [0, 0]
    for remat in ("none", "full"):
        pred = dryrun.lower_cell(cfg.name, "train_4k",
                                 ShapeMesh(("data", "model"), (1, 1)),
                                 remat=remat, impl="optimized",
                                 batch_override=B, seq_override=S)
        mem = pred["memory_analysis"]
        want = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated(dev)
        model = build_model(cfg, device=dev, remat=remat,
                            generator=torch.Generator(device=dev)
                            .manual_seed(0))
        opt = AdamW(param_groups(model), lr=3e-4)
        step_fn = build_train_step(model, opt)
        b = {k: torch.from_numpy(v).to(dev, torch.int64)
             for k, v in one.batch_at(0).items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        _zero_flash_counts()
        t0 = time.perf_counter()
        _, met = step_fn({}, b)
        loss, gn = met["loss"].item(), met["grad_norm"].item()
        dt = time.perf_counter() - t0
        ran = _flash_counts()
        peak = torch.cuda.max_memory_allocated(dev) - base
        counts[0] += ran[0]
        counts[1] += ran[2]
        out[remat] = (loss, gn, peak)
        print(f"dryrun_train: remat={remat} first step {dt * 1e3:.0f} ms, "
              f"loss {loss!r}, grad norm {gn!r}; peak measured {peak} B = "
              f"{peak / 2**30:.2f} GiB, predicted {want} B = "
              f"{want / 2**30:.2f} GiB (arguments "
              f"{mem['argument_size_in_bytes']} + temp "
              f"{mem['temp_size_in_bytes']}; measured / predicted "
              f"{peak / want:.3f}); flash launches (fwd, dq, dkv) "
              f"{tuple(ran[:3])}", flush=True)
        want_fwd = cfg.n_layers * (2 if remat == "full" else 1)
        if tuple(ran[:3]) != (want_fwd, cfg.n_layers, cfg.n_layers):
            fail(f"dryrun_train: remat={remat} flash launches {ran[:3]}")
        del model, opt, step_fn, b
    (l0, g0, p0), (l1, g1, p1) = out["none"], out["full"]
    if (l0, g0) != (l1, g1):
        fail(f"dryrun_train: remat full's first step (loss {l1!r}, grad "
             f"norm {g1!r}) differs from none's ({l0!r}, {g0!r}); bitwise "
             "equality is expected")
    if not p1 < p0:
        fail(f"dryrun_train: remat full's peak {p1} B is not below none's "
             f"{p0} B")
    print(f"dryrun_train: loss and grad norm bitwise equal under none and "
          f"full; peak full / none {p1 / p0:.3f}", flush=True)

    # (c) remat="full" on a model bound to a world-1 1x1 mesh: the unit's
    # recomputation replays the local view, so the step is the unbound
    # full step's bit for bit
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.parallel import spmd

    gc.collect()
    torch.cuda.empty_cache()
    _mesh_group(torch, dev, name="dryrun_train_store")
    try:
        mesh = make_local_mesh(model=1, data=1, device=dev.type)
        base = torch.cuda.memory_allocated(dev)
        model = build_model(cfg, device=dev, remat="full",
                            generator=torch.Generator(device=dev)
                            .manual_seed(0))
        spmd.bind(model, mesh)
        opt = AdamW(param_groups(model), lr=3e-4)
        step_fn = build_train_step(model, opt)
        b = {k: torch.from_numpy(v).to(dev, torch.int64)
             for k, v in one.batch_at(0).items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        _zero_flash_counts()
        _, met = step_fn({}, b)
        l2, g2 = met["loss"].item(), met["grad_norm"].item()
        ran = _flash_counts()
        p2 = torch.cuda.max_memory_allocated(dev) - base
        del model, opt, step_fn, b
    finally:
        dist.destroy_process_group()
    counts[0] += ran[0]
    counts[1] += ran[2]
    print(f"dryrun_train (c): remat=full bound to a world-1 1x1 mesh "
          f"({dist.Backend.NCCL if dev.type == 'cuda' else 'gloo'}): loss "
          f"{l2!r}, grad norm {g2!r}; peak {p2} B = {p2 / 2**30:.2f} GiB "
          f"bound, {p1} B = {p1 / 2**30:.2f} GiB unbound; flash launches "
          f"(fwd, dq, dkv) {tuple(ran[:3])}", flush=True)
    if (l2, g2) != (l1, g1):
        fail(f"dryrun_train (c): the bound full step (loss {l2!r}, grad norm "
             f"{g2!r}) differs from the unbound one ({l1!r}, {g1!r})")
    if tuple(ran[:3]) != (2 * cfg.n_layers, cfg.n_layers, cfg.n_layers):
        fail(f"dryrun_train (c): flash launches {ran[:3]}")
    gc.collect()
    torch.cuda.empty_cache()
    return {"flash_fwd": counts[0], "flash_bwd": counts[1]}


def phase_examples(torch, dev):
    """The quickstart and serving examples on the card, each as a
    subprocess (``python -m repro_torch.examples.<name>``): a non-zero
    exit fails the script."""
    import os

    del dev
    gc.collect()
    torch.cuda.empty_cache()
    env = dict(os.environ, PYTHONPATH=str(SRC))
    for name in ("quickstart", "serve_batch"):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m",
                               f"repro_torch.examples.{name}"], cwd=ROOT,
                              env=env, capture_output=True, text=True,
                              timeout=600)
        lines = proc.stdout.strip().splitlines()
        for line in lines[-4:]:
            print(f"  examples {name}: {line}")
        if proc.returncode:
            fail(f"examples: {name} exited {proc.returncode}: "
                 f"{proc.stderr[-2000:]}")
        print(f"examples: {name} exited 0 in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    return {}


# phase mesh_serve: the archs it serves (a rehearsal on the CPU maps them
# to their smoke variants) and the flash training shape of its part (c)
MESH_LM, MESH_GQA = "minimalist-lm-360m", "smollm-360m"
MESH_TRAIN_SEQ = 2048


def _mesh_group(torch, dev, rank=0, world=1, name="mesh_serve_store"):
    """Open this rank's process group (NCCL on the card, gloo on the CPU)
    through a FileStore under build/."""
    import torch.distributed as dist

    store = ROOT / "build" / name
    store.parent.mkdir(parents=True, exist_ok=True)
    if rank == 0 and store.exists():
        store.unlink()
    if dev.type == "cuda":      # the card the group's communicator uses
        torch.cuda.set_device(dev.index or 0)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            store=dist.FileStore(str(store), world),
                            rank=rank, world_size=world)


def _mesh_lm_prompts(cfg):
    import numpy as np
    rng = np.random.default_rng(0)
    return [rng.integers(0, cfg.vocab, size=p)
            for p in [192, 192, 192, 192, 64, 96, 128, 160]]


def _mesh_gqa_prompts(cfg):
    import numpy as np
    rng = np.random.default_rng(0)
    return [rng.integers(0, cfg.vocab, size=p)
            for p in [71, 97, 130, 150, 165, 181, 190, 75]]


def _mesh_lm_run(torch, model, prompts, *, sampled, mesh=None):
    """Phase lm's traffic (32 new tokens; odd requests sampled when
    ``sampled``) through ServeEngine, dense slots: (streams, linear_scan
    launches, engine, seconds)."""
    from repro_torch.configs import SamplingParams
    from repro_torch.kernels.linear_scan.ops import linear_scan_kernel
    from repro_torch.serve import DecoderStepModel, ServeEngine, Telemetry

    eng = ServeEngine(DecoderStepModel(model, max_len=512,
                                       prefill_chunk=256),
                      slots=4, telemetry=Telemetry(), mesh=mesh)
    linear_scan_kernel.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = [eng.submit(p, max_new_tokens=32, sampling=SamplingParams(
        temperature=0.8, top_k=40, seed=11 + i)
        if sampled and i % 2 else None) for i, p in enumerate(prompts)]
    eng.run()
    torch.cuda.synchronize()
    return ([r.tokens.tolist() for r in reqs], linear_scan_kernel.launches,
            eng, time.perf_counter() - t0)


def _mesh_gqa_model(torch, dev):
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    return _sharpen(torch, build_model(
        get_config(MESH_GQA), device=dev,
        generator=torch.Generator(device=dev).manual_seed(0)))


def _mesh_tp2_rank(rank, world, out_path):
    """One rank of part (d): TP 2 over two cards, phase (a)'s greedy and
    phase (b)'s bf16 traffic; rank 0 writes the streams to ``out_path``."""
    sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as dist

    from repro_torch.common import resolve_device
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import build_model

    dev = resolve_device(f"cuda:{rank}")
    torch.cuda.set_device(dev)
    _mesh_group(torch, dev, rank, world, "mesh_serve_tp2_store")
    try:
        mesh = make_local_mesh(model=world, data=1, device="cuda")
        cfg = get_config(MESH_LM)
        model = build_model(cfg, device=dev, generator=torch.Generator(
            device=dev).manual_seed(0))
        lm, *_ = _mesh_lm_run(torch, model, _mesh_lm_prompts(cfg),
                              sampled=False, mesh=mesh)
        del model
        model = _mesh_gqa_model(torch, dev)
        _eng, reqs, _dt = _serve_paged(
            torch, model, _mesh_gqa_prompts(model.cfg), 32, mesh=mesh)
        if rank == 0:
            Path(out_path).write_text(json.dumps({
                "lm": lm, "gqa": [r.tokens.tolist() for r in reqs]}))
    finally:
        dist.destroy_process_group()


def phase_mesh_serve(torch, dev):
    """Serving and training on a 1x1 DeviceMesh (world-1 group) at full
    width, bitwise the no-mesh runs: (a) minimalist-lm-360m dense through
    linear_scan, greedy and sampled; (b) smollm-360m (output projections
    x32) from bf16 and int8 pages through paged_gqa(_q8), with generated
    tok/s and decode-step p50 with and without the mesh; (c) two AdamW
    steps of smollm-360m through flash at 1 x MESH_TRAIN_SEQ; (d) TP 2
    over two cards when more than one is visible."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_local_mesh, mesh_info

    _mesh_group(torch, dev)
    try:
        mesh = make_local_mesh(model=1, data=1, device=dev.type)
        print(f"mesh_serve: {dist.get_backend()} world-1 group, mesh "
              f"{mesh_info(mesh)}", flush=True)
        launches = _mesh_serve_parts(torch, dev, mesh)
    finally:
        dist.destroy_process_group()
    _mesh_tp2(torch, dev)
    return launches


def _mesh_serve_parts(torch, dev, mesh):
    from repro_torch.common.pytree import module_tree
    from repro_torch.configs import get_config
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.models import build_model
    from repro_torch.optim.adamw import AdamW, param_groups
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel import spmd

    # (a) minimalist-lm-360m, dense slots: no mesh first, then the same
    # model bound to the mesh in place
    cfg = get_config(MESH_LM)
    model = build_model(cfg, device=dev, generator=torch.Generator(
        device=dev).manual_seed(0))
    prompts = _mesh_lm_prompts(cfg)
    ref = {s: _mesh_lm_run(torch, model, prompts, sampled=s)
           for s in (False, True)}
    got = {s: _mesh_lm_run(torch, model, prompts, sampled=s, mesh=mesh)
           for s in (False, True)}
    n_scan = 0
    for s in (False, True):
        tag = "sampled" if s else "greedy"
        (rs, rn, _re, rdt), (gs, gn, _ge, gdt) = ref[s], got[s]
        if gs != rs:
            fail(f"mesh_serve (a) {tag}: 1x1 mesh streams differ from the "
                 f"no-mesh engine's (request {_first_divergence_req(rs, gs)})")
        if gn == 0 or gn != rn:
            fail(f"mesh_serve (a) {tag}: linear_scan launches {gn} on the "
                 f"mesh, {rn} without")
        n_scan += gn
        print(f"mesh_serve (a): {cfg.name} dense {tag}: 8 streams bitwise "
              f"the no-mesh engine's, linear_scan launches {gn} (no mesh "
              f"{rn}); {rdt:.3f} s without the mesh, {gdt:.3f} s on it",
              flush=True)
    del model, ref, got
    gc.collect()
    torch.cuda.empty_cache()

    # (b) smollm-360m x32 from bf16 and int8 pages
    model = _mesh_gqa_model(torch, dev)
    cfg = model.cfg
    prompts = _mesh_gqa_prompts(cfg)
    counts = {"paged_gqa": 0, "paged_gqa_q8": 0}

    def run(kv, mesh=None):
        _reconfigure(model, kv_dtype=kv)
        if kv == "bf16":     # warm-up of each side (the int8 run follows)
            _serve_paged(torch, model, prompts[:4], 2, mesh=mesh)
        pa_ops.paged_gqa_kernel.launches = 0
        pa_ops.paged_gqa_q8_kernel.launches = 0
        eng, reqs, dt = _serve_paged(torch, model, prompts, 32, mesh=mesh)
        n = (pa_ops.paged_gqa_kernel.launches,
             pa_ops.paged_gqa_q8_kernel.launches)
        stp = eng.telemetry.registry.histograms["step_ms"].summary()
        toks = [r.tokens.tolist() for r in reqs]
        return toks, n, sum(map(len, toks)) / dt, stp["p50"], eng.n_steps
    ref = {kv: run(kv) for kv in ("bf16", "int8")}
    got = {kv: run(kv, mesh) for kv in ("bf16", "int8")}
    for kv, name, i in (("bf16", "paged_gqa", 0), ("int8", "paged_gqa_q8",
                                                    1)):
        (rs, rn, rtps, rp50, rsteps), (gs, gn, gtps, gp50, gsteps) = \
            ref[kv], got[kv]
        if gs != rs:
            fail(f"mesh_serve (b) {kv}: 1x1 mesh streams differ from the "
                 f"no-mesh engine's (request {_first_divergence_req(rs, gs)})")
        if gn[i] == 0 or gn != rn or gn[1 - i]:
            fail(f"mesh_serve (b) {kv}: (paged_gqa, paged_gqa_q8) launches "
                 f"{gn} on the mesh, {rn} without")
        counts[name] += gn[i]
        print(f"mesh_serve (b): {cfg.name} x32 {kv} pages: 8 greedy streams "
              f"bitwise the no-mesh engine's (distinct tokens per stream "
              f"{[len(set(t)) for t in gs]}), {name} launches {gn[i]} (no "
              f"mesh {rn[i]}); generated tok/s incl. prefill {gtps:.1f} on "
              f"the mesh, {rtps:.1f} without; decode step p50 {gp50:.2f} ms "
              f"on the mesh, {rp50:.2f} ms without ({gsteps} / {rsteps} "
              f"steps)", flush=True)
    _reconfigure(model, kv_dtype="bf16")
    del model, ref, got
    gc.collect()
    torch.cuda.empty_cache()

    # (c) two AdamW steps through flash at 1 x MESH_TRAIN_SEQ
    import numpy as np
    tcfg = dataclasses.replace(get_config(MESH_GQA), attention_impl="flash")
    toks = np.random.default_rng(5).integers(0, tcfg.vocab,
                                             (1, MESH_TRAIN_SEQ + 1))
    batch = {"tokens": torch.as_tensor(toks[:, :-1], device=dev),
             "labels": torch.as_tensor(toks[:, 1:], device=dev)}

    def two_steps(mesh=None):
        model = build_model(tcfg, device=dev, generator=torch.Generator(
            device=dev).manual_seed(0))
        b = batch
        if mesh is not None:
            bind = spmd.bind(model, mesh)
            b = shd.distribute_tree(batch, shd.batch_specs(batch, mesh), mesh)
            specs = shd.opt_state_specs(bind.specs, module_tree(model), mesh,
                                        zero1=True)
        opt = AdamW(param_groups(model), lr=3e-4)
        if mesh is not None:
            from repro_torch.common.pytree import flatten_dict
            opt.place_moments(dict(model.named_parameters()), {
                ".".join(k): v for k, v in flatten_dict(specs["m"]).items()})
        losses = []
        _zero_flash_counts()
        for _ in range(2):
            opt.zero_grad(set_to_none=True)
            loss, _ = model.loss(b)
            loss.backward()
            spmd.sync_grads(model)
            opt.step()
            losses.append(loss.item())
        torch.cuda.synchronize()
        ran = _flash_counts()
        del model, opt
        gc.collect()
        torch.cuda.empty_cache()
        return losses, ran
    ref_l, _ = two_steps()
    got_l, ran = two_steps(mesh)
    rel = [abs(g - r) / abs(r) for g, r in zip(got_l, ref_l)]
    print(f"mesh_serve (c): {tcfg.name} through flash at 1 x "
          f"{MESH_TRAIN_SEQ}, 2 AdamW steps: losses {got_l} on the mesh, "
          f"{ref_l} without (relative differences {rel}, tol 1e-6); flash "
          f"launches (fwd, dq, dkv, then on the tc route) {ran}",
          flush=True)
    if max(rel) > 1e-6:
        fail("mesh_serve (c): the mesh losses differ from the no-mesh ones")
    want = tcfg.n_layers * 2
    if ran != (want,) * 6:
        fail(f"mesh_serve (c): flash launches {ran} != {tcfg.n_layers} "
             "layers x 2 steps, all on the tc route")
    return {"linear_scan": n_scan, **counts, "flash_fwd": ran[0],
            "flash_bwd": ran[2]}


def _first_divergence_req(a, b):
    return next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)


def _mesh_tp2(torch, dev):
    """Part (d): TP 2 over two cards, spawned NCCL ranks, against the
    no-mesh streams of (a) greedy and (b) bf16 under the margin rule —
    or a line saying it did not run."""
    n = torch.cuda.device_count() if dev.type == "cuda" else 0
    if n < 2:
        print(f"mesh_serve (d): TP 2 not run: {n} card(s) visible (it "
              "needs two)", flush=True)
        return
    import torch.multiprocessing as mp

    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    out = ROOT / "build" / "mesh_serve_tp2.json"
    out.unlink(missing_ok=True)
    mp.start_processes(_mesh_tp2_rank, args=(2, str(out)), nprocs=2,
                       start_method="spawn")
    got = json.loads(out.read_text())
    # the no-mesh streams; where TP 2's part from them, the parting must
    # sit at a near-tie of the no-mesh model (the row-parallel sums
    # reassociate in fp32)
    cfg = get_config(MESH_LM)
    model = build_model(cfg, device=dev, generator=torch.Generator(
        device=dev).manual_seed(0))
    prompts = _mesh_lm_prompts(cfg)
    lm, _n, eng, _dt = _mesh_lm_run(torch, model, prompts, sampled=False)
    _margin_rule(torch, "mesh_serve (d) lm", eng.sm, cfg.vocab, prompts,
                 got["lm"], lm)
    del model, eng
    model = _mesh_gqa_model(torch, dev)
    prompts = _mesh_gqa_prompts(model.cfg)
    eng, reqs, _dt = _serve_paged(torch, model, prompts, 32)
    _margin_rule(torch, "mesh_serve (d) paged bf16", eng.sm, model.cfg.vocab,
                 prompts, got["gqa"], [r.tokens.tolist() for r in reqs])
    del model, eng, reqs
    gc.collect()
    torch.cuda.empty_cache()
    print("mesh_serve (d): TP 2 over two cards against no mesh: streams "
          "above", flush=True)


# phase tp_serve: falcon-mamba-7b's depth by the cards the ranks have (a
# gloo rank sharing the one card first builds the whole fp32 model: 16
# layers are 8.7 GB), the depth of its train step, whisper's decode length
TP_MAMBA_LAYERS = {1: 16, 2: 64}
TP_TRAIN_LAYERS, TP_TRAIN_SEQ = 8, 2048
TP_WHISPER_GEN = 32
# the train step's loss on the TP 2 mesh against no mesh, relative: the
# row-parallel sums reassociate in fp32 and the bf16 compute rounds them;
# one bf16 flip of a label's logit moves the mean NLL over 2048 tokens by
# about 1.3e-6 (falcon-mamba-7b's 8-layer step on an H100 read 1.58e-6;
# the CPU smoke stacks agree to 1e-6, tests/test_torch_tp_layers.py)
TP_LOSS_TOL = 1e-5


def _tp_traffic(vocab):
    """mistral_serve's traffic: 8 prompts of 512 down to 64 tokens, 32 new
    tokens each."""
    import numpy as np
    rng = np.random.default_rng(7)
    return [rng.integers(0, vocab, size=p)
            for p in [512, 448, 384, 320, 256, 192, 128, 64]], 32


def _tp_serve_rank(rank, world, transport, layers, out_path):
    """One rank of phase tp_serve: TP ``world`` over "model" on
    ``transport`` (NCCL, a card a rank; gloo, every rank on card 0),
    :func:`_tp_parts` on the mesh; rank 0 writes its results."""
    sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as dist

    from repro_torch.common import resolve_device
    from repro_torch.launch.mesh import make_local_mesh

    dev = resolve_device(f"cuda:{rank if transport == 'nccl' else 0}")
    torch.cuda.set_device(dev)
    dist.init_process_group(transport, store=dist.FileStore(
        str(ROOT / "build" / "tp_serve_store"), world), rank=rank,
        world_size=world)
    try:
        mesh = make_local_mesh(model=world, data=1, device="cuda")
        out = _tp_parts(torch, dev, mesh, layers, verbose=rank == 0)
        if rank == 0:
            Path(out_path).write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()


def _tp_parts(torch, dev, mesh, layers, got=None, verbose=True):
    """Phase tp_serve's work, on ``mesh`` (the ranks) or with no mesh (the
    parent, ``got`` = rank 0's results, each part checked against them
    while its no-mesh model is at hand): (a) falcon-mamba-7b cut to
    ``layers`` layers, ssm_impl fused, dense slots; (b) deepseek-v3-671b's
    3 dense MLA layers from bf16 and int8 latent pages; (c) whisper-small
    (output projections x32) greedy from the encoder's cross-K/V cache;
    (d) falcon-mamba-7b cut to TP_TRAIN_LAYERS layers, one AdamW step at
    1 x TP_TRAIN_SEQ, its gradients taken under remat none and full.
    Returns streams, launch counts, decode-step p50s and losses; prints
    when ``verbose``."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels.fused_ssm import ops as ssm_ops
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW, param_groups
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel import spmd

    tag = "tp_serve " + ("TP 2" if mesh is not None else "no mesh")
    res = {}
    say = print if verbose else (lambda *a, **k: None)

    def seeded(cfg, seed=0):
        return build_model(cfg, device=dev, generator=torch.Generator(
            device=dev).manual_seed(seed))

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    def served(eng, reqs, dt, **extra):
        stp = eng.telemetry.registry.histograms["step_ms"].summary()
        return dict(streams=[r.tokens.tolist() for r in reqs],
                    p50=stp["p50"], steps=eng.n_steps, s=dt, **extra)

    # (a) falcon-mamba-7b, fused, dense slots
    cfg = dataclasses.replace(get_config("falcon-mamba-7b"), n_layers=layers,
                              ssm_impl="fused")
    model = seeded(cfg)
    prompts, gen = _tp_traffic(cfg.vocab)
    kw = dict(max_len=512 + gen, kv_layout="dense", mesh=mesh)
    _serve_engine(torch, model, prompts[:2], 2, **kw)       # warm-up
    ssm_ops.fused_ssm_fwd_kernel.launches = 0
    eng, reqs, dt = _serve_engine(torch, model, prompts, gen, **kw)
    res["mamba"] = served(eng, reqs, dt,
                          fused_ssm_fwd=ssm_ops.fused_ssm_fwd_kernel.launches,
                          chunks=eng.sm.n_prefill_chunks)
    say(f"{tag} (a): {cfg.name} {layers} of 64 layers, fused, dense: 8 "
        f"requests in {dt:.2f} s, decode step p50 {res['mamba']['p50']:.2f}"
        f" ms ({eng.n_steps} steps), fused_ssm_fwd launches "
        f"{res['mamba']['fused_ssm_fwd']} ({eng.sm.n_prefill_chunks} "
        f"prefill chunks x {layers} layers); distinct tokens per stream "
        f"{[len(set(t)) for t in res['mamba']['streams']]}", flush=True)
    if got is not None:
        _margin_rule(torch, f"{tag} (a) vs TP 2", eng.sm, cfg.vocab, prompts,
                     got["mamba"]["streams"], res["mamba"]["streams"])
    del model, eng, reqs
    free()

    # (b) deepseek-v3-671b's dense MLA layers, bf16 and int8 latent pages
    cfg = dataclasses.replace(get_config(MLA_ARCH), n_layers=MLA_LAYERS)
    model = seeded(cfg)
    kw = dict(max_len=512 + gen, num_pages=4 * 34 + 36, mesh=mesh)
    _serve_engine(torch, model, prompts[:2], 2, **kw)       # warm-up
    for kv, kern in (("bf16", pa_ops.paged_mla_kernel),
                     ("int8", pa_ops.paged_mla_q8_kernel)):
        _reconfigure(model, kv_dtype=kv)
        for k in (pa_ops.paged_mla_kernel, pa_ops.paged_mla_q8_kernel):
            k.launches = k.launches_tc = 0
        eng, reqs, dt = _serve_engine(torch, model, prompts, gen, **kw)
        r = res[f"mla_{kv}"] = served(eng, reqs, dt, launches=kern.launches,
                                      tc=kern.launches_tc)
        say(f"{tag} (b): {cfg.name} {MLA_LAYERS} dense MLA layers, {kv} "
            f"latent pages: 8 requests in {dt:.2f} s, decode step p50 "
            f"{r['p50']:.2f} ms ({eng.n_steps} steps), {kern.__name__} "
            f"launches {kern.launches} ({kern.launches_tc} on the tc "
            f"route) with {spmd.local(model.layers[0].mixer.w_uq).shape[1]}"
            f" heads a rank; distinct tokens per stream "
            f"{[len(set(t)) for t in r['streams']]}", flush=True)
        if got is not None:
            _margin_rule(torch, f"{tag} (b) {kv} vs TP 2", eng.sm, cfg.vocab,
                         prompts, got[f"mla_{kv}"]["streams"], r["streams"])
        del eng, reqs
    del model
    free()

    # (c) whisper-small: encode once, greedy decode from the cross cache
    cfg = get_config("whisper-small")
    model = _sharpen(torch, seeded(cfg, 1))
    if mesh is not None:
        spmd.bind(model, mesh)
    g = torch.Generator(device=dev).manual_seed(2)
    frames = 0.1 * torch.randn(4, cfg.frontend_seq, cfg.d_model, device=dev,
                               generator=g)
    start = torch.randint(0, cfg.vocab, (4, 1), device=dev, generator=g)
    with torch.inference_mode():
        cache = model.init_cache(4, TP_WHISPER_GEN, frame_embeds=frames)
        tok, toks, dts = start, [], []
        for t in range(TP_WHISPER_GEN):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg, cache = model.decode_step(tok, cache, t)
            tok = lg[:, :, :cfg.vocab].argmax(-1)
            toks.append(tok)
            torch.cuda.synchronize()
            dts.append((time.perf_counter() - t0) * 1e3)
        stream = torch.cat(toks, 1)
    dts = sorted(dts[1:])
    res["whisper"] = dict(streams=stream.tolist(), p50=dts[len(dts) // 2])
    say(f"{tag} (c): {cfg.name} x32, 4 requests encoded once, "
        f"{TP_WHISPER_GEN} greedy decode steps p50 "
        f"{res['whisper']['p50']:.2f} ms; distinct tokens per stream "
        f"{[len(set(t)) for t in res['whisper']['streams']]}", flush=True)
    if got is not None:
        # where TP 2's stream parts from this one, the teacher-forced
        # forward's top-2 margin there must be <= 0.1
        other = torch.as_tensor(got["whisper"]["streams"], device=dev)
        with torch.inference_mode():
            full = model(torch.cat([start, stream[:, :-1]], 1), embeds=frames)
        top2 = torch.topk(full[..., :cfg.vocab], 2, dim=-1).values
        margin = (top2[..., 0] - top2[..., 1])
        for i in range(4):
            j = _first_divergence(other[i].tolist(), stream[i].tolist())
            if j is not None and margin[i, j].item() > 0.1:
                fail(f"{tag} (c) vs TP 2: request {i} parts at token {j} "
                     f"where the top-2 margin is {margin[i, j].item():.3f}")
        say(f"{tag} (c) vs TP 2: "
            f"{sum(a == b for a, b in zip(other.tolist(), stream.tolist()))}"
            "/4 streams equal end to end, the rest part at a top-2 margin "
            "<= 0.1", flush=True)
    del model, cache
    free()

    # (d) one AdamW step, gradients under remat none and full
    cfg = dataclasses.replace(get_config("falcon-mamba-7b"),
                              n_layers=TP_TRAIN_LAYERS, ssm_impl="fused")
    model = seeded(cfg)
    toks = np.random.default_rng(5).integers(0, cfg.vocab,
                                             (1, TP_TRAIN_SEQ + 1))
    batch = {"tokens": torch.as_tensor(toks[:, :-1], device=dev),
             "labels": torch.as_tensor(toks[:, 1:], device=dev)}
    if mesh is not None:
        spmd.bind(model, mesh)
        batch = shd.distribute_tree(batch, shd.batch_specs(batch, mesh), mesh)
    opt = AdamW(param_groups(model), lr=3e-4)
    train = {}
    for remat in ("none", "full"):
        model.remat = remat
        opt.zero_grad(set_to_none=True)
        for k in (ssm_ops.fused_ssm_fwd_kernel, ssm_ops.fused_ssm_bwd_kernel):
            k.launches = 0
        loss, _ = model.loss(batch)
        loss.backward()
        spmd.sync_grads(model)
        torch.cuda.synchronize()
        train[remat] = (loss.item(), ssm_ops.fused_ssm_fwd_kernel.launches,
                        ssm_ops.fused_ssm_bwd_kernel.launches)
    gn = float(opt.step()["grad_norm"])
    res["train"] = dict(train, grad_norm=gn)
    say(f"{tag} (d): {cfg.name} {TP_TRAIN_LAYERS} of 64 layers at 1 x "
        f"{TP_TRAIN_SEQ}, one AdamW step (grad norm {gn!r}): loss, "
        f"fused_ssm_fwd and fused_ssm_bwd launches under remat none "
        f"{train['none']} and full {train['full']}", flush=True)
    if train["none"][0] != train["full"][0]:
        fail(f"{tag} (d): remat full's loss {train['full'][0]!r} is not "
             f"none's {train['none'][0]!r}")
    if got is not None:
        a, b = got["train"]["none"][0], train["none"][0]
        rel = abs(a - b) / abs(b)
        ga = got["train"]["grad_norm"]
        say(f"{tag} (d) vs TP 2: loss {a!r} on the mesh, {b!r} without "
            f"(relative difference {rel:.3g}, tol {TP_LOSS_TOL}); grad norm "
            f"{ga!r} / {gn!r} (relative difference {abs(ga - gn) / gn:.3g})",
            flush=True)
        if rel > TP_LOSS_TOL:
            fail(f"{tag} (d): the TP loss is {rel:.3g} off the no-mesh one")
    del model, opt, batch
    free()
    return res


def phase_tp_serve(torch, dev):
    """TP 2 on two ranks: spawned NCCL ranks with a card each when two are
    visible, else two spawned gloo ranks sharing card 0 (gloo carries the
    CUDA tensors through the host).  The ranks run :func:`_tp_parts` on a
    1x2 mesh (Mamba on its d_inner slice, the fused scan at d_inner / 2;
    MLA on half the heads, the paged MLA kernels at H 64; whisper's
    attention on half its heads); the parent runs it with no mesh and
    holds each part's streams to the TP ones under the margin rule, the
    train step's loss to 1e-6 relative.  Returns rank 0's launches."""
    import torch.multiprocessing as mp

    n = torch.cuda.device_count()
    transport = "nccl" if n >= 2 else "gloo"
    layers = TP_MAMBA_LAYERS[min(n, 2)]
    print(f"tp_serve: TP 2 over {transport} ({n} card(s) visible: "
          + ("one a rank" if transport == "nccl" else
             "both ranks on card 0") + f"), falcon-mamba-7b at {layers} "
          "layers", flush=True)
    out = ROOT / "build" / "tp_serve.json"
    out.unlink(missing_ok=True)
    (ROOT / "build" / "tp_serve_store").unlink(missing_ok=True)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mp.start_processes(_tp_serve_rank, args=(2, transport, layers, str(out)),
                       nprocs=2, start_method="spawn")
    print(f"tp_serve: the two ranks ran in {time.perf_counter() - t0:.1f} s",
          flush=True)
    got = json.loads(out.read_text())
    ref = _tp_parts(torch, dev, None, layers, got=got)
    for part, what in (("mamba", "(a) falcon-mamba"),
                       ("mla_bf16", "(b) MLA bf16"),
                       ("mla_int8", "(b) MLA int8"),
                       ("whisper", "(c) whisper")):
        print(f"tp_serve {what}: decode step p50 {got[part]['p50']:.2f} ms "
              f"on the TP 2 mesh ({transport}), {ref[part]['p50']:.2f} ms "
              "with no mesh", flush=True)
    chunks, want = got["mamba"]["chunks"], got["mamba"]["chunks"] * layers
    if got["mamba"]["fused_ssm_fwd"] != want:
        fail(f"tp_serve (a): fused_ssm_fwd launches "
             f"{got['mamba']['fused_ssm_fwd']} != {chunks} chunks x {layers}")
    for kv in ("bf16", "int8"):
        r = got[f"mla_{kv}"]
        if r["launches"] == 0 or r["tc"] != r["launches"] \
                or r["launches"] != MLA_LAYERS * r["steps"]:
            fail(f"tp_serve (b) {kv}: paged MLA launches {r['launches']} "
                 f"({r['tc']} tc) != {MLA_LAYERS} layers x {r['steps']} "
                 "steps, all on the tc route")
    tr = got["train"]
    want = {"none": (TP_TRAIN_LAYERS, TP_TRAIN_LAYERS),
            "full": (2 * TP_TRAIN_LAYERS, TP_TRAIN_LAYERS)}
    for remat, (nf, nb) in want.items():
        if tuple(tr[remat][1:]) != (nf, nb):
            fail(f"tp_serve (d) remat {remat}: (fused_ssm_fwd, "
                 f"fused_ssm_bwd) launches {tr[remat][1:]} != {(nf, nb)}")
    print(f"tp_serve: TP 2 ({transport}) launches on rank 0: fused_ssm_fwd "
          f"{got['mamba']['fused_ssm_fwd']} serving + "
          f"{tr['none'][1] + tr['full'][1]} training, fused_ssm_bwd "
          f"{tr['none'][2] + tr['full'][2]}, paged_mla "
          f"{got['mla_bf16']['launches']}, paged_mla_q8 "
          f"{got['mla_int8']['launches']}", flush=True)
    return {"fused_ssm_fwd": got["mamba"]["fused_ssm_fwd"] + tr["none"][1]
            + tr["full"][1],
            "fused_ssm_bwd": tr["none"][2] + tr["full"][2],
            "paged_mla": got["mla_bf16"]["launches"],
            "paged_mla_q8": got["mla_int8"]["launches"]}


def phase_mixed(torch, dev):
    """A stack mixing minGRU and attention at minimalist-lm-360m's widths
    (pattern (minGRU, attention) x 16, seeded weights, output projections
    x32) served from bf16 pages with phase lm's traffic: the paged_gqa
    kernel read against the gather read under the margin rule, the
    minGRU layers' prefill through linear_scan."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ATTN, MINGRU, LayerSpec
    from repro_torch.kernels.linear_scan.ops import linear_scan_kernel
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_config("minimalist-lm-360m"), pattern=(
        LayerSpec(MINGRU), LayerSpec(ATTN)))
    model = _sharpen(torch, build_model(cfg, device=dev, generator=torch
                                        .Generator(device=dev).manual_seed(0)))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=p)
               for p in [192, 192, 192, 192, 64, 96, 128, 160]]
    kw = dict(max_len=512, kv_layout="paged")
    _serve_engine(torch, model, prompts[:2], 2, **kw)        # warm-up
    runs = {}
    for impl in ("kernel", "gather"):
        _reconfigure(model, paged_impl=impl)
        linear_scan_kernel.launches = pa_ops.paged_gqa_kernel.launches = 0
        eng, reqs, dt = _serve_engine(torch, model, prompts, 32, **kw)
        runs[impl] = (eng.sm, [r.tokens.tolist() for r in reqs],
                      linear_scan_kernel.launches,
                      pa_ops.paged_gqa_kernel.launches)
        stp = eng.telemetry.registry.histograms["step_ms"].summary()
        print(f"mixed: {cfg.name} pattern (minGRU, attention) x "
              f"{cfg.n_repeats}, bf16 pages, {impl} read: 8 requests in "
              f"{dt:.2f} s, decode step p50 {stp['p50']:.2f} ms, "
              f"linear_scan launches {runs[impl][2]} "
              f"({eng.sm.n_prefill_chunks} chunks x {cfg.n_layers // 2} "
              f"minGRU layers), paged_gqa launches {runs[impl][3]}; distinct "
              f"tokens per stream {[len(set(t)) for t in runs[impl][1]]}",
              flush=True)
        want = (eng.sm.n_prefill_chunks * cfg.n_layers // 2,
                cfg.n_layers // 2 * eng.n_steps if impl == "kernel" else 0)
        if runs[impl][2:] != want:
            fail(f"mixed {impl}: (linear_scan, paged_gqa) launches "
                 f"{runs[impl][2:]} != {want}")
        del eng, reqs
    _margin_rule(torch, "mixed kernel vs gather", runs["gather"][0],
                 cfg.vocab, prompts, runs["kernel"][1], runs["gather"][1])
    launches = {"linear_scan": runs["kernel"][2] + runs["gather"][2],
                "paged_gqa": runs["kernel"][3]}
    runs.clear()
    _reconfigure(model, paged_impl="kernel")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_imc(torch, dev):
    """The paper's IMC projection through its entry point on the card, at
    the kernel rows' shapes and with leading dimensions, and Eq. 6's
    properties."""
    from repro_torch.kernels.imc_mvm import ops as imc_ops
    from repro_torch.kernels.imc_mvm import ref as imc_ref

    g = torch.Generator(device=dev).manual_seed(7)
    imc_ops.imc_mvm_kernel.launches = 0
    imc_ops.imc_mvm_kernel.launches_tc = 0
    worst = 0.0
    for M, K, N in IMC_SHAPES:
        x, codes, scale = _imc_inputs(torch, dev, g, M, K, N)
        # the entry point takes any leading dims: (M, K) as (2, M/2, K)
        lead = (2, M // 2) if M % 2 == 0 else (M,)
        got = imc_ops.imc_mvm(x.reshape(*lead, K), codes, scale)
        want = imc_ref.imc_mvm_ref(x, codes, scale)
        ok, err = _imc_close(torch, got.reshape(M, N), want)
        if got.shape != (*lead, N) or not ok:
            fail(f"imc: imc_mvm {(M, K, N)} as {lead}: shape "
                 f"{tuple(got.shape)}, max |kernel - plain| {err}")
        worst = max(worst, err)
        # Eq. 6: all-ones x settles at the column mean of the selected
        # levels times Δ; x = 0 at exactly V0 (0 in weight units)
        ones = imc_ops.imc_mvm(torch.ones_like(x), codes, scale)
        mean = ((codes.float() - 1.5) * scale).mean(0)
        mean_err = (ones - mean).abs().max().item()
        zero = imc_ops.imc_mvm(torch.zeros_like(x), codes, scale)
        zmax = zero.abs().max().item()
        if not mean_err <= 1e-6 or zmax != 0.0:
            fail(f"imc: Eq. 6 at {(M, K, N)}: all-ones vs column mean "
                 f"{mean_err} (tol 1e-6), |y(0)| max {zmax} (want 0)")
        print(f"imc: imc_mvm {(M, K, N)} as {lead + (K,)}: max |kernel - "
              f"plain| {err:.3g} (tol 1e-5 + 1e-5 rel); Eq. 6: all-ones vs "
              f"the column mean {mean_err:.3g} (tol 1e-6), y(0) = 0 "
              "exactly", flush=True)
    launches = imc_ops.imc_mvm_kernel.launches
    tc = imc_ops.imc_mvm_kernel.launches_tc
    if launches != 3 * len(IMC_SHAPES):
        fail(f"imc: imc_mvm launches {launches} != {3 * len(IMC_SHAPES)}")
    if tc != 3:     # the (4096, 1024, 1024) shape's three calls
        fail(f"imc: {tc} imc_mvm launches on the tc route, want 3")
    print(f"imc: {len(IMC_SHAPES)} shapes, max |kernel - plain| {worst:.3g}; "
          f"imc_mvm launches {launches} ({tc} on the tc route)", flush=True)
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
            if "registers" in line or "spill" in line or "entry" in line:
                print(f"  ptxas {name}: {line.strip()}")

    def timed(phase):
        t = time.perf_counter()
        out = phase(torch, dev)
        print(f"{phase.__name__}: {time.perf_counter() - t:.1f} s (script "
              f"at {time.perf_counter() - t0:.1f} s)", flush=True)
        return out

    rows = timed(phase_kernels)
    launches = {"linear_scan": timed(phase_lm),
                "minimalist_step": timed(phase_stream),
                "linear_scan_bwd": timed(phase_train),
                "minimalist_block": timed(phase_system)}
    launches.update(timed(phase_paged))
    launches.update(timed(phase_attn_train))
    launches.update(timed(phase_mamba_train))
    launches.update(timed(phase_mla_paged))
    # the serving phases drive kernels of earlier phases: counts add up
    for phase in (phase_sched, phase_spec, phase_mamba_serve,
                  phase_moe_serve, phase_whisper, phase_vlm,
                  phase_wide_head_train, phase_stablelm_serve, phase_mistral_serve,
                  phase_dryrun_train, phase_mesh_serve, phase_tp_serve,
                  phase_mixed, phase_examples):
        for name, n in timed(phase).items():
            launches[name] += n
    launches["imc_mvm"] = timed(phase_imc)

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
        "paged_gqa": (
            "src/repro_torch/kernels/csrc/paged_gqa.cu",
            "src/repro/kernels/paged_attention/paged_attention.py:107"),
        "paged_gqa_q8": (
            "src/repro_torch/kernels/csrc/paged_gqa_q8.cu",
            "src/repro/kernels/paged_attention/paged_attention.py:179"),
        "flash_fwd": (
            "src/repro_torch/kernels/csrc/flash_fwd.cu",
            "src/repro/kernels/flash_attention/flash_attention.py:102"),
        "flash_bwd": (
            "src/repro_torch/kernels/csrc/flash_bwd.cu",
            "src/repro/kernels/flash_attention/flash_attention.py:232"),
        "fused_ssm_fwd": (
            "src/repro_torch/kernels/csrc/fused_ssm_fwd.cu",
            "src/repro/kernels/fused_ssm/fused_ssm.py:113"),
        "fused_ssm_bwd": (
            "src/repro_torch/kernels/csrc/fused_ssm_bwd.cu",
            "src/repro/kernels/fused_ssm/fused_ssm.py:147"),
        "paged_mla": (
            "src/repro_torch/kernels/csrc/paged_mla.cu",
            "src/repro/kernels/paged_attention/paged_attention.py:259"),
        "paged_mla_q8": (
            "src/repro_torch/kernels/csrc/paged_mla_q8.cu",
            "src/repro/kernels/paged_attention/paged_attention.py:332"),
        "imc_mvm": (
            "src/repro_torch/kernels/csrc/imc_mvm.cu",
            "src/repro/kernels/imc_mvm/imc_mvm.py:58"),
    }
    # how a kernel was redesigned after its first port
    design = {name: "wgmma+TMA, split-bf16 P/dS"
              for name in ("flash_fwd", "flash_bwd")}
    design.update({name: "cluster page ranges merged in DSMEM, warps on "
                   "pages, 16-byte cp.async ring, one launch"
                   for name in ("paged_gqa", "paged_gqa_q8")})
    design["imc_mvm"] = ("tc route: bf16 wgmma m64n256k16 fed by a 4-stage "
                         "TMA ring, codes widened in shared memory, TMA "
                         "store; simt route for unaligned shapes")
    design["minimalist_block"] = ("both projections off the time loop on "
                                  "bf16 wgmma, A from registers (x in three "
                                  "bf16 parts), one CTA a batch row and "
                                  "column slab (8-64 by ops.block_plan), "
                                  "64-frame chunks double-buffered between "
                                  "a projection warpgroup and chain threads "
                                  "that hold only the state update")
    design["minimalist_step"] = ("all slots of a column slab in one CTA, "
                                 "16-byte staging, split-K over 8 lanes, "
                                 "codes and biases loaded first")
    design.update({name: "tc route: 64 heads of a request a CTA over a "
                   "range of its live pages (cut on the card from pos), TMA "
                   "page ring (int8 widened to bf16 in shared memory), bf16 "
                   "wgmma for the scores and for the latent sum with P in "
                   "three bf16 parts, fp32 range partials and a second pass"
                   for name in ("paged_mla", "paged_mla_q8")})
    design.update({name: "chunked scan across T: a thread's L steps all "
                   "loaded before its first FMA, chunk summaries combined "
                   "in shared memory, re-walk from registers; tiles carry "
                   "in registers with the next tile's loads in flight"
                   for name in ("linear_scan", "linear_scan_bwd")})
    kernels = []
    for name in build.KERNELS:
        source, replaces = meta[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        **rows[name]})
        if name in design:
            kernels[-1]["design"] = design[name]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
