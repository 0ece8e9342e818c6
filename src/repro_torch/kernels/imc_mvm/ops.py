"""The IMC projection's CUDA kernel wrapper and its entry point (port of
``repro.kernels.imc_mvm.ops``).

``imc_mvm_kernel`` runs ``csrc/imc_mvm.cu`` (which replaces the TPU
kernel ``imc_mvm_pallas``) on CUDA tensors and its plain version,
:func:`ref.imc_mvm_ref`, when every input lies on the CPU.  The source
has two routes, picked by :func:`route` from the shape and the operands'
alignment, never from their values: ``tc`` (a bf16 wgmma tile fed by a
TMA ring) where TMA can address every operand, else ``simt`` (fp32 on
the CUDA cores).  A launch that fails raises; it is never retried on the
other route.  ``imc_mvm_kernel.launches`` counts launches and
``.launches_tc`` those on the tc route.  The reference's wrapper pads
every axis to whole tiles and rescales by Kp/K because its TPU kernel
needs whole tiles; the CUDA kernels mask or zero-fill their ragged edges
and divide by the true K, so the port's wrapper neither pads nor
rescales.

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


def route(M, K, N, *data_ptrs):
    """The kernel's route for x (M, K) fp32, codes (K, N) int8 and y
    (M, N) fp32 at ``data_ptrs``: ``"tc"`` where TMA can address every
    operand (16-byte row strides, so K % 4 == 0 and N % 16 == 0, and
    16-byte-aligned data pointers), else ``"simt"``."""
    aligned = all(p % 16 == 0 for p in data_ptrs)
    return "tc" if M > 0 and K > 0 and K % 4 == 0 and N % 16 == 0 \
        and aligned else "simt"


def imc_mvm_kernel(x, codes, scale):
    """x: (M, K) fp32 in {0, 1}; codes: (K, N) int8 in [0, 4); scale:
    (N,) fp32 -> (M, N) fp32 = (x @ (codes - 1.5)) · scale / K.

    The route is :func:`route`'s.  The tc route multiplies in bf16: binary
    x and the 2 b levels are exact there, and it equals the simt route bit
    for bit; x outside {0, 1} (outside the op's domain) is rounded to bf16
    first, and a code's low two bits select its level."""
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
    tc = route(M, K, N, x.data_ptr(), codes.data_ptr(),
               out.data_ptr()) == "tc"
    lib = build.load("imc_mvm")
    fn = lib.imc_mvm_f32_tc if tc else lib.imc_mvm_f32
    err = fn(x.data_ptr(), codes.data_ptr(), scale.data_ptr(),
             out.data_ptr(), M, K, N,
             torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "imc_mvm")
    imc_mvm_kernel.launches += 1
    imc_mvm_kernel.launches_tc += tc
    return out


imc_mvm_kernel.launches = 0
imc_mvm_kernel.launches_tc = 0


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

