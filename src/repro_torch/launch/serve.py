"""Serving entry point: continuous-batching decode on the port (port of
``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \
        --requests 16 --slots 4 --prompt-len 32 --gen 32

    # smollm-360m from a paged int8 KV cache with prefix caching
    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \
        --smoke --device cpu --kv-layout paged --kv-dtype int8 --prefix-cache

    # an MoE arch (qwen3-moe-30b-a3b, deepseek-v3-671b, jamba-1.5-large-398b)
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch qwen3-moe-30b-a3b --smoke --device cpu --kv-layout paged \
        --moe-dispatch auto

Prompts are consumed by the grid-padded chunked prefill (one linear scan
per chunk and minGRU layer — the CUDA kernel on the card; one masked
softmax per chunk and attention layer), decode is one slot-batch step per
token, and finished sequences retire the step they complete.
``--kv-layout paged`` keeps attention caches in a shared page pool read
through the paged GQA or MLA decode kernels (``--paged-impl kernel``,
default)
or the dense-gather oracle (``--paged-impl gather``); ``--kv-dtype int8``
stores the pages as int8 codes with per-page scales; ``--prefix-cache``
lets requests sharing a prompt prefix attach to its pages.
``--temperature/--top-k/--top-p`` turn on per-request sampling.
``--policy priority|sjf|edf`` reorders admission (priority and edf may
preempt under the paged layout); ``--fork N`` forks the first request
into N copy-on-write streams after one step; ``--drafter ARCH --spec-k K``
turns on speculative decoding with a pure-recurrent drafter (paged
layout); ``--baseline`` runs the static-batch loop (:func:`generate`)
instead of the engine.  ``--moe-dispatch pooled|per_request|auto`` sets
an MoE arch's dispatch (``auto``, the default, is batch-invariant; an
arch without MoE layers refuses it).

``--mesh DxM`` serves on a (data=D, model=M) mesh: parameters TP-shard
over "model" by the rule tables, slots DP-shard over "data".  Run
plainly, the launcher starts the D x M ranks itself and waits for them —
gloo ranks with ``--device cpu``, NCCL ranks with one card each on
``cuda`` (D x M must not exceed the visible cards); under ``torchrun``
(``RANK``/``WORLD_SIZE`` set) it joins that group instead.  Rank 0 alone
prints.

    PYTHONPATH=src python -m repro_torch.launch.serve --smoke \
        --device cpu --mesh 2x2
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from repro_torch.common import resolve_device
from repro_torch.configs import SamplingParams, ServeConfig, get_config
from repro_torch.configs.base import (ATTN, ATTN_LOCAL, MLA, PAGED_IMPLS,
                                      SCAN_BACKENDS)
from repro_torch.models import build_model
from repro_torch.serve.scheduler import POLICIES
from repro_torch.serve import (DecoderStepModel, DraftStepModel, PagedConfig,
                               ServeEngine, Telemetry)


def generate(model, prompts, *, max_len, gen_tokens):
    """Static-batch baseline: per-token prefill, then lock-step greedy
    decode through ``DecoderLM.decode_step`` (dense cache).  prompts: (B,
    P) ints.  Returns (B, gen_tokens) int64 on the model's device.  Every
    sequence holds its batch row for all P + gen_tokens steps — the
    reference the continuous-batching engine is measured against."""
    dev = model.device
    prompts = torch.as_tensor(np.asarray(prompts), dtype=torch.int64,
                              device=dev)
    B, P = prompts.shape
    vocab = model.cfg.vocab
    with torch.inference_mode():
        cache = model.init_cache(B, max_len)

        def step(tok, cache, t):
            logits, cache = model.decode_step(tok, cache, t)
            return torch.argmax(logits[:, -1, :vocab], -1), cache
        tok = None
        for t in range(P):
            tok, cache = step(prompts[:, t:t + 1], cache, t)
        out = []
        for t in range(gen_tokens):
            out.append(tok)
            tok, cache = step(tok[:, None], cache, P + t)
        return torch.stack(out, 1)


def build_engine(model, serve: ServeConfig = ServeConfig(), telemetry=None,
                 mesh=None):
    """ServeEngine over ``model`` as ``serve`` configures it (dense or
    paged KV layout, prefix cache, policy, and the drafter
    ``serve.drafter`` on the target's device, weights from seed 1 as the
    reference's), bound to ``mesh`` when one is given."""
    kw = {}
    if serve.drafter:
        dev = model.device
        dmodel = build_model(get_config(serve.drafter), device=dev,
                             generator=torch.Generator(device=dev)
                             .manual_seed(1))
        kw = dict(drafter=DraftStepModel(dmodel, spec_k=serve.spec_k,
                                         prefill_chunk=serve.prefill_chunk),
                  spec_k=serve.spec_k)
    paged = None
    if serve.kv_layout == "paged":
        paged = PagedConfig(page_size=serve.page_size,
                            num_pages=serve.num_pages)
    sm = DecoderStepModel(model, max_len=serve.max_len,
                          prefill_chunk=serve.prefill_chunk,
                          kv_layout=serve.kv_layout, paged=paged)
    return ServeEngine(sm, slots=serve.slots, policy=serve.policy,
                       prefix_cache=serve.prefix_cache, telemetry=telemetry,
                       mesh=mesh, **kw)


def parse_mesh(spec: str):
    """'DxM' -> (data=D, model=M); '' -> None (no mesh)."""
    if not spec:
        return None
    try:
        d, m = (int(v) for v in spec.lower().split("x"))
    except ValueError:
        raise ValueError(f"--mesh expects DxM (e.g. 2x2), got {spec!r}")
    if m < 1 or d < 1:
        raise ValueError(f"mesh axes must be >= 1, got data={d} model={m}")
    return d, m


def _spawn_ranks(argv, world: int) -> int:
    """Start ``world`` ranks of this command, meeting through a FileStore
    in a fresh temporary directory; rank 0's output is this process's.
    Returns the first non-zero exit code (the others are then stopped),
    else 0."""
    import repro_torch

    src = os.path.dirname(os.path.dirname(repro_torch.__file__))
    with tempfile.TemporaryDirectory(prefix="repro_torch_mesh_") as tmp:
        env = dict(os.environ, REPRO_TORCH_MESH_STORE=os.path.join(
            tmp, "store"), REPRO_TORCH_MESH_WORLD=str(world),
            PYTHONPATH=os.pathsep.join(
                [src] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
        procs = [subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.serve", *argv],
            env=dict(env, REPRO_TORCH_MESH_RANK=str(r)),
            stdout=None if r == 0 else subprocess.DEVNULL)
            for r in range(world)]
        try:
            while True:
                codes = [p.poll() for p in procs]
                failed = [c for c in codes if c]
                if failed or all(c == 0 for c in codes):
                    rc = failed[0] if failed else 0
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        return rc


def _join_ranks(device):
    """Open this rank's process group (a rank this launcher started, or
    one of ``torchrun``'s); returns (rank, world, device)."""
    import torch.distributed as dist

    if "REPRO_TORCH_MESH_STORE" in os.environ:
        rank = int(os.environ["REPRO_TORCH_MESH_RANK"])
        world = int(os.environ["REPRO_TORCH_MESH_WORLD"])
        local = rank
    else:
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        local = int(os.environ.get("LOCAL_RANK", rank))
    if device.type == "cuda":
        device = torch.device("cuda", local)
        torch.cuda.set_device(device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    if "REPRO_TORCH_MESH_STORE" in os.environ:
        store = dist.FileStore(os.environ["REPRO_TORCH_MESH_STORE"], world)
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=world)
    else:
        dist.init_process_group(backend, init_method="env://", rank=rank,
                                world_size=world)
    return rank, world, device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="minimalist-lm-360m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda; the CPU "
                         "only when asked, e.g. --device cpu)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and the per-request "
                         "sampling seed base (request i uses seed+i)")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32,
                    help="mean prompt length; actual lengths vary ±50%%")
    ap.add_argument("--gen", type=int, default=32,
                    help="mean generation budget; actual budgets vary ±50%%")
    ap.add_argument("--prefill-chunk", type=int, default=256)
    ap.add_argument("--max-len", type=int, default=0,
                    help="cache length (unused by minGRU stacks; default: "
                         "the longest request)")
    ap.add_argument("--scan-backend", default=None,
                    choices=[None, *SCAN_BACKENDS],
                    help="linear-scan backend for recurrent prefill")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--verbose", action="store_true",
                    help="print a per-step stats line")
    ap.add_argument("--trace", default="", metavar="OUT.json",
                    help="save request-lifecycle + wave spans as Chrome "
                         "trace_event JSON")
    ap.add_argument("--metrics", action="store_true",
                    help="print engine.metrics() as JSON after the run")
    ap.add_argument("--kv-layout", default="dense",
                    choices=["dense", "paged"])
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--num-pages", type=int, default=0,
                    help="page pool size (0 = dense-equivalent)")
    ap.add_argument("--kv-dtype", default=None, choices=["bf16", "int8"],
                    help="KV page dtype (paged layout)")
    ap.add_argument("--paged-impl", default=None, choices=PAGED_IMPLS,
                    help="paged decode read (default: the arch's, kernel)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="attach requests to cached prompt-prefix pages")
    ap.add_argument("--policy", default="fifo", choices=POLICIES,
                    help="admission policy: fifo, priority (may preempt "
                         "under the paged layout), sjf (shortest prefill "
                         "first with aging) or edf (earliest deadline; may "
                         "preempt)")
    ap.add_argument("--drafter", default="",
                    help="speculative decoding: arch of a pure O(1)-state "
                         "draft model (e.g. minimalist-lm-360m); needs "
                         "--kv-layout paged and the target's vocab")
    ap.add_argument("--spec-k", type=int, default=1,
                    help="tokens decided per wave per slot (1 = off)")
    ap.add_argument("--fork", type=int, default=0,
                    help="fork the first admitted request into N more "
                         "copy-on-write streams after one step (paged)")
    ap.add_argument("--baseline", action="store_true",
                    help="run the static-batch loop instead of the engine")
    ap.add_argument("--moe-dispatch", default=None,
                    choices=[None, "pooled", "per_request", "auto"],
                    help="MoE routing mode (default: the arch's, auto)")
    ap.add_argument("--mesh", default="",
                    help="serve under a DxM mesh (e.g. 2x2 = data 2 x "
                         "model 2): params and caches TP-shard over "
                         "'model' via the logical-axis rules, slots "
                         "DP-shard over 'data'; starts D*M ranks (gloo on "
                         "the CPU, NCCL with one card a rank) unless run "
                         "under torchrun")
    argv = list(sys.argv[1:] if argv is None else argv)
    args = ap.parse_args(argv)
    if min(args.requests, args.gen, args.prompt_len, args.slots) < 1:
        ap.error("--requests, --gen, --prompt-len and --slots must all "
                 "be >= 1")
    try:
        mesh_dm = parse_mesh(args.mesh)
    except ValueError as e:
        ap.error(str(e))

    cfg, drafter = _config(args, ap)
    device = resolve_device(args.device)
    if mesh_dm is None:
        return _serve(args, cfg, drafter, device)
    d, m = mesh_dm
    if args.baseline:
        ap.error("--baseline is the single-device static loop; drop --mesh")
    if device.type == "cuda" and d * m > torch.cuda.device_count():
        ap.error(f"mesh data={d} x model={m} needs {d * m} devices but only "
                 f"{torch.cuda.device_count()} are available (one card a "
                 "rank)")
    if not ("REPRO_TORCH_MESH_STORE" in os.environ
            or "WORLD_SIZE" in os.environ):
        rc = _spawn_ranks(argv, d * m)
        if rc:
            raise SystemExit(rc)
        return None
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_local_mesh

    rank, world, device = _join_ranks(device)
    try:
        mesh = make_local_mesh(model=m, data=d, device=device.type)
        quiet = contextlib.redirect_stdout(io.StringIO()) if rank \
            else contextlib.nullcontext()
        with quiet:
            print(f"mesh data={d} x model={m} ({world} "
                  f"{dist.get_backend()} ranks)")
            return _serve(args, cfg, drafter, device, mesh)
    finally:
        dist.destroy_process_group()


def _config(args, ap):
    """The config ``args`` ask for and the drafter's arch (flag errors
    exit through ``ap``)."""
    cfg = get_config(args.arch + ("-smoke" if args.smoke else ""))
    if args.scan_backend:
        cfg = dataclasses.replace(cfg, scan_backend=args.scan_backend)
    if args.kv_layout == "paged" and not any(
            s.kind in (ATTN, ATTN_LOCAL, MLA) for s in cfg.layer_specs()):
        ap.error(f"--kv-layout paged needs an attention-bearing arch; "
                 f"{cfg.name} keeps O(1) state per slot (serve it dense)")
    if args.prefix_cache and args.kv_layout != "paged":
        ap.error("--prefix-cache needs --kv-layout paged")
    if args.fork and args.kv_layout != "paged":
        ap.error("--fork needs --kv-layout paged")
    drafter = args.drafter and (
        args.drafter + ("-smoke" if args.smoke
                        and not args.drafter.endswith("-smoke") else ""))
    if drafter and args.kv_layout != "paged":
        ap.error("--drafter needs --kv-layout paged")
    if args.spec_k > 1 and not drafter:
        ap.error("--spec-k > 1 needs --drafter")
    if args.kv_dtype:
        cfg = dataclasses.replace(cfg, kv_dtype=args.kv_dtype)
    if args.paged_impl:
        cfg = dataclasses.replace(cfg, paged_impl=args.paged_impl)
    if args.moe_dispatch:
        if cfg.moe is None:
            ap.error(f"--moe-dispatch given but {cfg.name} has no MoE "
                     "layers")
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, dispatch=args.moe_dispatch))
    return cfg, drafter


def _serve(args, cfg, drafter, device, mesh=None):
    """Build the model and serve the run ``args`` describe (on ``mesh``
    when one is given)."""
    gen = torch.Generator(device=device).manual_seed(args.seed)
    model = build_model(cfg, device=device, generator=gen)

    rng = np.random.default_rng(1)
    lo = max(1, args.prompt_len // 2)
    plens = rng.integers(lo, args.prompt_len * 3 // 2 + 1, args.requests)
    glens = rng.integers(max(1, args.gen // 2),
                         args.gen * 3 // 2 + 1, args.requests)
    prompts = [rng.integers(0, cfg.vocab, size=p, dtype=np.int64)
               for p in plens]
    max_len = args.max_len or int(plens.max() + glens.max() + 1)

    if args.baseline:
        # static batch: every prompt resized to the longest, the worst case
        P, G = int(plens.max()), int(glens.max())
        batch = np.stack([np.resize(p, P) for p in prompts])
        t0 = time.time()
        out = generate(model, batch, max_len=max(max_len, P + G),
                       gen_tokens=G)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.time() - t0
        print(f"baseline ({device}): {tuple(out.shape)} in {dt:.2f}s "
              f"({args.requests * (P + G) / dt:.1f} tok/s incl. prefill)")
        return out

    telemetry = None
    if args.trace or args.metrics:
        telemetry = Telemetry(trace=bool(args.trace))
    eng = build_engine(model, ServeConfig(
        slots=args.slots, max_len=max_len, prefill_chunk=args.prefill_chunk,
        kv_layout=args.kv_layout, page_size=args.page_size,
        num_pages=args.num_pages, prefix_cache=args.prefix_cache,
        policy=args.policy, spec_k=args.spec_k, drafter=drafter),
        telemetry=telemetry, mesh=mesh)
    if eng.drafter is not None:
        print(f"speculative decoding: drafter {drafter}, k={args.spec_k}")
    t0 = time.time()
    first = None
    for i, (p, g) in enumerate(zip(prompts, glens)):
        sampling = None
        if args.temperature > 0:
            sampling = SamplingParams(temperature=args.temperature,
                                      top_k=args.top_k, top_p=args.top_p,
                                      seed=args.seed + i)
        r = eng.submit(p, max_new_tokens=int(g), sampling=sampling)
        first = first or r
    if args.fork:
        eng.step()                       # admit + one decode step
        room = int(args.slots - eng.active.sum())
        if first.finished or not room:
            print(f"fork skipped: request uid={first.uid} "
                  + ("already finished" if first.finished
                     else "no free slot (raise --slots above the request "
                          "count to fork)"))
        else:
            kids = eng.fork(first, min(args.fork, room))
            print(f"forked request uid={first.uid} into {len(kids)} COW "
                  "streams")
    done = eng.run(verbose=args.verbose)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    total = int(plens.sum() + glens.sum())
    stats = eng.stats()
    print(f"engine ({device}): {len(done)} requests, {eng.n_emitted} tokens "
          f"in {dt:.2f}s ({total/dt:.1f} tok/s incl. prefill), slot "
          f"utilization {stats.utilization:.2f}, policy {stats.policy}, "
          f"{stats.n_preemptions} preemption(s)")
    if eng.drafter is not None:
        print(f"spec decode: accept rate {stats.accept_rate:.2f}, "
              f"{eng._n_decoded / max(eng.n_steps, 1):.2f} tokens/wave")
    if eng.n_forks or eng.n_cow_copies:
        print(f"forks: {eng.n_forks}, COW page copies: {eng.n_cow_copies}")
    if args.trace:
        eng.telemetry.save_trace(args.trace)
        print(f"trace: {len(eng.telemetry.trace)} events -> {args.trace}")
    if args.metrics:
        print("metrics:", json.dumps(eng.metrics(), indent=2,
                                     sort_keys=True))
    print("sample:", done[0].tokens[:16])
    return done


if __name__ == "__main__":
    main()
