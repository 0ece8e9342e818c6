"""The IMC projection's CUDA kernel wrapper and its entry point (port of
``repro.kernels.imc_mvm.ops``).

``imc_mvm_kernel`` runs ``csrc/imc_mvm.cu`` (which replaces the TPU
kernel ``imc_mvm_pallas``) on CUDA tensors and its plain version,
:func:`ref.imc_mvm_ref`, when every input lies on the CPU; it counts its
launches in ``imc_mvm_kernel.launches``.  The reference's wrapper pads
every axis to whole tiles and rescales by Kp/K because its TPU kernel
needs whole tiles; the CUDA kernel masks its ragged edges and divides by
the true K, so the port's wrapper neither pads nor rescales.

Inference only (the hardware path): the weights are frozen 2 b codes, so
no autograd here.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, check_devices, on_cpu
from repro_torch.kernels.imc_mvm import ref

#: Legal ``backend`` values of :func:`imc_mvm`: the kernel wrapper (its
#: plain version on CPU tensors) or the plain version on any device.
BACKENDS = ("kernel", "plain")


def imc_mvm_kernel(x, codes, scale):
    """x: (M, K) fp32 in {0, 1}; codes: (K, N) int8 in [0, 4); scale:
    (N,) fp32 -> (M, N) fp32 = (x @ (codes - 1.5)) · scale / K."""
    if on_cpu(x, codes, scale):
        return ref.imc_mvm_ref(x, codes, scale)
    what = "imc_mvm_kernel"
    check_devices(what, x, codes, scale)
    if x.dtype != torch.float32 or codes.dtype != torch.int8 or \
            scale.dtype != torch.float32:
        raise ValueError(f"{what}: x and scale must be float32 and codes "
                         f"int8, got {x.dtype}/{codes.dtype}/{scale.dtype}")
    if x.dim() != 2 or codes.dim() != 2 or codes.shape[0] != x.shape[1] \
            or scale.shape != (codes.shape[1],):
        raise ValueError(f"{what}: shapes x {tuple(x.shape)}, codes "
                         f"{tuple(codes.shape)}, scale {tuple(scale.shape)}")
    if not all(t.is_contiguous() for t in (x, codes, scale)):
        raise ValueError(f"{what}: inputs must be contiguous")
    M, K = x.shape
    N = codes.shape[1]
    if max(M, K, N) >= 2**31 or -(-M // 64) > 65535:
        raise ValueError(f"{what}: shape ({M}, {K}, {N}) too large for one "
                         "launch")
    out = torch.empty(M, N, dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    if K == 0:
        return out.zero_()
    lib = build.load("imc_mvm")
    err = lib.imc_mvm_f32(x.data_ptr(), codes.data_ptr(), scale.data_ptr(),
                          out.data_ptr(), M, K, N,
                          torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "imc_mvm")
    imc_mvm_kernel.launches += 1
    return out


imc_mvm_kernel.launches = 0


def imc_mvm(x, codes, scale, *, backend="kernel"):
    """Charge-sharing MVM (x @ deq(codes)) / K.  x: (..., K) in {0, 1};
    codes: (K, N) int; scale: a float or (N,) -> (..., N) fp32; leading
    dimensions are kept."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r} (one of {BACKENDS})")
    N = codes.shape[1]
    if not torch.is_tensor(scale):
        scale = torch.tensor(scale, device=codes.device)
    scale = scale.to(torch.float32).expand(N).contiguous()
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if backend == "plain":
        out = ref.imc_mvm_ref(x2, codes, scale)
    else:
        out = imc_mvm_kernel(x2.float().contiguous(),
                             codes.to(torch.int8).contiguous(), scale)
    return out.reshape(*lead, N)

