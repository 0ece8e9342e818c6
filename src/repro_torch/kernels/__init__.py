"""The port's hand-written CUDA kernels, their wrappers and their plain
PyTorch versions, one subpackage per TPU kernel family of the reference.

Every wrapper follows one device rule: it takes its plain version only
when every tensor input lies on the CPU (:func:`on_cpu`); otherwise it
runs :func:`check_devices` (and its own shape and dtype checks) and
launches the kernel or raises.  A CPU tensor mixed with CUDA tensors is
refused by the wrapper, never handed to torch."""
from __future__ import annotations


def on_cpu(*tensors) -> bool:
    """Whether a wrapper takes its plain version: every input on the
    CPU."""
    return all(t.device.type == "cpu" for t in tensors)


def check_devices(what, *tensors):
    """Raise unless every tensor lies on one CUDA device."""
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{what}: inputs on different devices")
    if dev.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dev}")
