"""Quickstart: the paper's full pipeline in one run (port of
``examples/quickstart.py``).

1. Build a MINIMALIST network under full hardware constraints (2 b weights,
   6 b biases, binary activations, hard-σ 6 b gate — paper §2).
2. Train it briefly on the sequential-pattern task (a float warm-up, then
   the hardware constraints; the minGRU scans through ``linear_scan``).
3. Export the trained weights to switched-capacitor circuit quantities
   (capacitor codes, bias-row voltages, ADC presets — paper §3).
4. Replay the circuit simulation and verify it reproduces the software
   model (paper Fig. 4 verification flow).
5. Replay the trained network closed loop through the fused sequence
   kernel (``minimalist_block``) and verify it agrees as well.

    PYTHONPATH=src python -m repro_torch.examples.quickstart
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.common import resolve_device
from repro_torch.core import quant
from repro_torch.core.analog import AnalogConfig, analog_forward, export_layer
from repro_torch.core.mingru import MinimalistNetwork
from repro_torch.data.smnist import load_smnist
from repro_torch.kernels.minimalist_block import ops as mb_ops
from repro_torch.optim import AdamW
from repro_torch.train.qat import qat_loss


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--n-train", type=int, default=1024)
    ap.add_argument("--epochs", default="8,6",
                    help="float,hardware epochs")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    print("== 1. hardware-constrained MINIMALIST network ==")
    dims = (1, 32, 32, 10)
    net = MinimalistNetwork(dims, qcfg=quant.QuantConfig.hardware(),
                            device=dev)
    net.reset_parameters(torch.Generator(device=dev).manual_seed(0))
    print(f"dims {dims}, quantization: 2b W / 6b b / Θ outputs / hard-σ 6b z")

    print("== 2. short QAT run (float warm-up -> hardware constraints) ==")
    (xtr, ytr), (xte, yte) = load_smnist(n_train=args.n_train, n_test=256)
    xtr, xte = xtr[:, ::8], xte[:, ::8]  # subsample time for speed
    x_all = torch.from_numpy(np.ascontiguousarray(xtr)).to(dev)
    y_all = torch.from_numpy(ytr).to(dev)
    # the float warm-up and the hardware phase train the same latent
    # weights with one optimizer (the reference passes one params tree
    # through both networks)
    float_net = MinimalistNetwork(
        dims, qcfg=quant.QuantConfig.float_baseline(), device=dev)
    for bf, bh in zip(float_net.blocks, net.blocks):
        for name in ("wh", "bh", "wz", "bz"):
            setattr(bf, name, getattr(bh, name))
    opt = AdamW(net.parameters(), lr=5e-3, weight_decay=0.0)
    epochs = [int(e) for e in args.epochs.split(",")]
    loss = torch.zeros(())
    for phase, n, n_ep in (("float", float_net, epochs[0]),
                           ("hardware", net, epochs[1])):
        for _ in range(n_ep):
            for i in range(0, len(xtr), 64):
                opt.zero_grad(set_to_none=True)
                loss = qat_loss(n, x_all[i:i + 64], y_all[i:i + 64])
                loss.backward()
                opt.step()
        print(f"phase {phase}: final loss {loss.item():.3f}")

    x_te = torch.from_numpy(np.ascontiguousarray(xte)).to(dev)
    with torch.no_grad():
        acc = (net(x_te).argmax(-1).cpu().numpy() == yte).mean()
    print(f"test accuracy (software, hardware-constrained): {acc:.3f}")

    print("== 3. export to switched-capacitor circuit ==")
    acfg = AnalogConfig()
    images = [export_layer(b, acfg) for b in net.blocks]
    for li, img in enumerate(images):
        print(f"layer {li}: codes {tuple(img.codes_h.shape)} (2b), "
              f"alpha {img.alpha*1e3:.2f} mV/unit, "
              f"ADC offsets {img.adc_offset_code[:4].tolist()}...")

    print("== 4. mixed-signal verification (Fig. 4 flow) ==")
    xb = torch.from_numpy((xte[:64] > 0.5).astype(np.float32)).to(dev)
    with torch.no_grad():
        sw_pred = net(xb).argmax(-1)
    readout, _ = analog_forward(images, xb, acfg, collect_traces=False)
    agree = (sw_pred == readout.argmax(-1)).float().mean().item()
    print(f"software vs circuit prediction agreement: {agree:.3f}")
    assert agree > 0.9, agree

    print("== 5. closed-loop replay through the fused kernel ==")
    out = xb
    for b in net.blocks:
        out, h = mb_ops.minimalist_block(out, *mb_ops.from_block_params(b))
    agree_k = (sw_pred == h[:, -1].argmax(-1)).float().mean().item()
    print(f"software vs fused minimalist_block agreement: {agree_k:.3f}")
    assert agree_k > 0.9, agree_k
    print("OK — the circuit reproduces the trained model.")
    return {"accuracy": float(acc), "agree": agree, "agree_kernel": agree_k}


if __name__ == "__main__":
    main()
