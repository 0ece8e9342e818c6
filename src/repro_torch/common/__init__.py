"""Host-side helpers shared across the port (``repro.common``'s
``pow2ceil``) plus the device rule every entry point follows."""
from __future__ import annotations

import torch


def pow2ceil(n: int) -> int:
    """Smallest power of two >= n (n >= 1; pow2ceil(0) == 1) — the one
    bucket-rounding rule shared by admission waves and prefill chunk
    capping (``repro.common.pow2ceil``)."""
    return 1 << max(0, int(n) - 1).bit_length()


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller
    names another.  With no CUDA device and no explicit choice this
    raises — the port never falls back to the CPU on its own."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run on the CPU")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device} requested but CUDA is "
                               "not available")
        # mirror the reference's full-fp32 matmuls (hopper-kernels §6)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device
