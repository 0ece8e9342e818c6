"""Where a training step's time goes on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile [--sass]

Builds the kernels, then for a full-width ``minimalist-lm-360m`` step
(batch 8, seq 256) and a QAT step of the paper's network (dims
1-64-64-64-64-10, T 784, batch 64, hardware phase):

  * the host-clock split of the step into forward + backward and
    ``AdamW.step``, each ending in ``torch.cuda.synchronize()``;
  * one ``torch.profiler`` window: device time summed over the CUDA
    kernels and copies alone, their count per step, the card's idle share
    of the profiled wall time, and the kernels with the most device time.

With ``--sass``, also the order of global loads (LDG), stores (STG) and
FMAs in each scan kernel's SASS (``cuobjdump`` from the CUDA toolkit):
how many loads a thread keeps in flight per step.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import collections
import re
import subprocess
import time
from pathlib import Path

import torch

from repro_torch.common import resolve_device
from repro_torch.kernels import build


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
        print(f"  {ms:8.3f} ms/step  {name[:90]}")


def sass_order(name):
    """The sequence of LDG/STG/FFMA opcodes of each function in kernel
    ``name``'s library, as cuobjdump disassembles it."""
    tool = str(Path(build.nvcc()).parent / "cuobjdump")
    out = subprocess.run([tool, "-sass", str(build.library_path(name))],
                         capture_output=True, text=True, check=True).stdout
    for func in re.split(r"\n\s*Function : ", out)[1:]:
        ops = re.findall(r"\*/\s+(?:@!?U?P\d+\s+)?(LDG|STG|FFMA)\S*", func)
        print(f"{name} {func.splitlines()[0][:70]}:\n  {' '.join(ops[:64])}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--sass", action="store_true")
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    build.build()
    if args.sass:
        for name in ("linear_scan", "linear_scan_bwd"):
            sass_order(name)

    from repro_torch.configs import MINIMALIST_SMNIST_DIMS, get_config
    from repro_torch.core.mingru import MinimalistNetwork
    from repro_torch.core.quant import QuantConfig
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW, param_groups
    from repro_torch.train.qat import qat_loss

    cfg = get_config("minimalist-lm-360m")
    model = build_model(cfg, device=dev, generator=torch.Generator(
        device=dev).manual_seed(0))
    opt = AdamW(param_groups(model), lr=3e-4)
    batch = {k: torch.from_numpy(v).to(dev, torch.int64) for k, v in
             SyntheticLMDataset(vocab=cfg.vocab, seq_len=256).sample(
                 8, 0).items()}

    def fwd_bwd():
        opt.zero_grad(set_to_none=True)
        model.loss(batch)[0].backward()

    for _ in range(3):
        fwd_bwd()
        opt.step()
    split = [(_sync_ms(fwd_bwd), _sync_ms(opt.step)) for _ in range(5)]
    print("lm train step (host clock): forward+backward ms "
          f"{[round(a, 1) for a, _ in split]}, AdamW.step ms "
          f"{[round(b, 1) for _, b in split]}", flush=True)
    profile_window(fwd_bwd, 2, "lm forward+backward")
    profile_window(opt.step, 2, "lm AdamW.step", top=4)
    del model, opt
    torch.cuda.empty_cache()

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


if __name__ == "__main__":
    main()
