"""Paper Fig. 4 demo: overlay software-model and circuit-simulation traces
(port of ``examples/mixed_signal_demo.py``).

Prints ASCII trace overlays of z, h̃ and h for one unit over time — the
software (hardware-constrained) model vs the behavioral switched-capacitor
simulation — plus agreement statistics, with and without component
non-idealities.

    PYTHONPATH=src python -m repro_torch.examples.mixed_signal_demo
    PYTHONPATH=src python -m repro_torch.examples.mixed_signal_demo \\
        --device cpu
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.common import resolve_device
from repro_torch.core import quant
from repro_torch.core.analog import (AnalogConfig, analog_forward, export_layer,
                                     make_mismatch)
from repro_torch.core.mingru import MinimalistNetwork


def ascii_trace(name, sw, an, lo, hi, width=64):
    """Two-row ASCII overlay: '·' software, 'x' analog, '*' overlap."""
    def level(v):
        return np.clip(((v - lo) / (hi - lo + 1e-9) * 7).astype(int), 0, 7)

    qs, qa = level(np.asarray(sw)), level(np.asarray(an))
    print(f"--- {name} (·=software x=circuit *=both) ---")
    for lv in range(7, -1, -1):
        line = []
        for t in range(min(len(qs), width)):
            s, a = qs[t] == lv, qa[t] == lv
            line.append("*" if s and a else "·" if s else "x" if a else " ")
        print("|" + "".join(line) + "|")


def _z_agreement(sw, an, n_blocks):
    return float(np.mean([
        (sw[f"block{i}"]["z"] == an[i]["z"]).float().mean().item()
        for i in range(n_blocks)]))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--steps", type=int, default=64)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    dims = (6, 16, 16, 5)
    net = MinimalistNetwork(dims, qcfg=quant.QuantConfig.hardware(),
                            device=dev)
    g = torch.Generator(device=dev).manual_seed(7)
    net.reset_parameters(g)
    B, T = 1, args.steps
    x = (torch.rand(B, T, dims[0], generator=g, device=dev) > 0.6).float()

    with torch.no_grad():
        _logits, sw = net(x, collect_traces=True)
    acfg = AnalogConfig()
    images = [export_layer(b, acfg) for b in net.blocks]
    _, an = analog_forward(images, x, acfg)

    unit, li = 3, 1
    for sig, (lo, hi) in (("z", (0, 1)), ("htilde", (-3, 3)), ("h", (-3, 3))):
        ascii_trace(f"block{li}.{sig}[unit {unit}]",
                    sw[f"block{li}"][sig][0, :, unit].cpu().numpy(),
                    an[li][sig][0, :, unit].cpu().numpy(), lo, hi)

    z_match = _z_agreement(sw, an, len(images))
    print(f"\nz-code agreement (ideal circuit): {z_match:.4f}")

    acfg_mm = AnalogConfig(mismatch_sigma=0.01, comparator_noise_v=0.002)
    mm = make_mismatch(torch.Generator(device=dev).manual_seed(2), images,
                       acfg_mm)
    _, an_mm = analog_forward(images, x, acfg_mm, mismatch=mm,
                              generator=torch.Generator(
                                  device=dev).manual_seed(3))
    z_match_mm = _z_agreement(sw, an_mm, len(images))
    print(f"z-code agreement (1% mismatch + comparator noise): "
          f"{z_match_mm:.4f}")
    return {"z_match": z_match, "z_match_mismatch": z_match_mm}


if __name__ == "__main__":
    main()
