"""Serving entry point: continuous-batching decode on the port (port of
``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \
        --requests 16 --slots 4 --prompt-len 32 --gen 32

Prompts are consumed by the grid-padded chunked prefill (one linear scan
per chunk and minGRU layer — the CUDA kernel on the card), decode is one
slot-batch step per token, and finished sequences retire the step they
complete.  ``--temperature/--top-k/--top-p`` turn on per-request
sampling.  The flags of features the port does not have yet (mesh,
paged KV, prefix cache, preemptive policies, speculative decoding,
forking, the static-batch baseline) are accepted by the parser and
refused with an error naming them.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from repro_torch.common import resolve_device
from repro_torch.configs import SamplingParams, ServeConfig, get_config
from repro_torch.configs.base import SCAN_BACKENDS
from repro_torch.models import build_model
from repro_torch.serve import DecoderStepModel, ServeEngine, Telemetry


def build_engine(model, serve: ServeConfig = ServeConfig(), telemetry=None):
    if serve.kv_layout != "dense" or serve.drafter or serve.prefix_cache:
        raise NotImplementedError("paged KV, prefix caching and speculative "
                                  "decoding are not ported yet")
    sm = DecoderStepModel(model, max_len=serve.max_len,
                          prefill_chunk=serve.prefill_chunk)
    return ServeEngine(sm, slots=serve.slots, policy=serve.policy,
                       telemetry=telemetry)


def _not_ported(args, ap):
    """Refuse every flag of a feature the port does not have yet."""
    refused = {
        "--mesh": bool(args.mesh),
        "--kv-layout paged": args.kv_layout != "dense",
        "--kv-dtype": args.kv_dtype is not None,
        "--paged-impl": args.paged_impl is not None,
        "--num-pages": args.num_pages != 0,
        "--prefix-cache": args.prefix_cache,
        f"--policy {args.policy}": args.policy != "fifo",
        "--drafter": bool(args.drafter),
        "--spec-k": args.spec_k != 1,
        "--fork": args.fork != 0,
        "--moe-dispatch": args.moe_dispatch is not None,
        "--baseline": args.baseline,
    }
    bad = [flag for flag, used in refused.items() if used]
    if bad:
        ap.error(f"not ported to the PyTorch package yet: {', '.join(bad)}")


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
                    help="cache length (unused by minGRU stacks)")
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
    # features of the reference not ported yet (refused by _not_ported)
    ap.add_argument("--mesh", default="")
    ap.add_argument("--kv-layout", default="dense",
                    choices=["dense", "paged"])
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--kv-dtype", default=None, choices=["bf16", "int8"])
    ap.add_argument("--paged-impl", default=None,
                    choices=["gather", "pallas", "pallas_tpu"])
    ap.add_argument("--num-pages", type=int, default=0)
    ap.add_argument("--prefix-cache", action="store_true")
    ap.add_argument("--policy", default="fifo",
                    choices=["fifo", "priority", "sjf", "edf"])
    ap.add_argument("--drafter", default="")
    ap.add_argument("--spec-k", type=int, default=1)
    ap.add_argument("--fork", type=int, default=0)
    ap.add_argument("--moe-dispatch", default=None,
                    choices=[None, "pooled", "per_request", "auto"])
    ap.add_argument("--baseline", action="store_true")
    args = ap.parse_args(argv)
    if min(args.requests, args.gen, args.prompt_len, args.slots) < 1:
        ap.error("--requests, --gen, --prompt-len and --slots must all "
                 "be >= 1")
    _not_ported(args, ap)

    device = resolve_device(args.device)
    cfg = get_config(args.arch + ("-smoke" if args.smoke else ""))
    if args.scan_backend:
        cfg = dataclasses.replace(cfg, scan_backend=args.scan_backend)
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
    telemetry = None
    if args.trace or args.metrics:
        telemetry = Telemetry(trace=bool(args.trace))
    eng = build_engine(model, ServeConfig(slots=args.slots, max_len=max_len,
                                          prefill_chunk=args.prefill_chunk),
                       telemetry=telemetry)
    t0 = time.time()
    for i, (p, g) in enumerate(zip(prompts, glens)):
        sampling = None
        if args.temperature > 0:
            sampling = SamplingParams(temperature=args.temperature,
                                      top_k=args.top_k, top_p=args.top_p,
                                      seed=args.seed + i)
        eng.submit(p, max_new_tokens=int(g), sampling=sampling)
    done = eng.run(verbose=args.verbose)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    total = int(plens.sum() + glens.sum())
    stats = eng.stats()
    print(f"engine ({device}): {len(done)} requests, {eng.n_emitted} tokens "
          f"in {dt:.2f}s ({total/dt:.1f} tok/s incl. prefill), slot "
          f"utilization {stats.utilization:.2f}, policy {stats.policy}")
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
