"""The fused MINIMALIST kernels' wrappers, the hardware export and the
cost model (port of ``repro.kernels.minimalist_block.ops``).

``minimalist_step_kernel`` runs the hand-written CUDA kernel
(``csrc/minimalist_step.cu``, which replaces the TPU kernel
``minimalist_step_pallas``) on CUDA tensors and its plain version,
:func:`ref.minimalist_step_ref`, on CPU tensors.
``minimalist_block_kernel`` does the same for a whole sequence
(``csrc/minimalist_block.cu``, replacing ``minimalist_block_pallas``;
plain version :func:`ref.minimalist_block_ref`).  Each counts its
launches in ``<wrapper>.launches``.

Inference only — the deployment path of the paper's edge accelerator,
and the digital twin that a trained network is verified against.
"""
from __future__ import annotations

import torch

from repro_torch.core import quant
from repro_torch.kernels import build, check_devices, on_cpu
from repro_torch.kernels.minimalist_block import ref

#: Legal ``backend`` values of :func:`minimalist_step` and
#: :func:`minimalist_block`.
BACKENDS = ("kernel", "plain")


def from_block_params(block):
    """A trained hardware-mode ``MinGRUBlock`` -> (codes_h, codes_z,
    scale, bh, bz): int8 2 b codes (K, N) on one scale shared by both
    matrices, the 6 b h-bias and the ADC-grid z-bias — exactly
    ``repro.kernels.minimalist_block.ops.from_block_params``."""
    with torch.no_grad():
        scale = float(torch.maximum(quant.weight_scale(block.wh),
                                    quant.weight_scale(block.wz)))
        ch = quant.quantize_weights_2b(block.wh, scale)[1].to(torch.int8)
        cz = quant.quantize_weights_2b(block.wz, scale)[1].to(torch.int8)
        bh = quant.quantize_bias_6b(block.bh).float()
        bz = quant.quantize_gate_bias_adc(block.bz).float()
    return ch.contiguous(), cz.contiguous(), scale, bh, bz


def _check_args(what, x, codes_h, codes_z, bh, bz, h, x_shape):
    """Shape, dtype, device and contiguity checks of both CUDA wrappers."""
    check_devices(what, x, codes_h, codes_z, bh, bz, h)
    B, K = x_shape[0], x_shape[-1]
    N = codes_h.shape[1]
    expect = {"x": (x, x_shape, torch.float32),
              "codes_h": (codes_h, (K, N), torch.int8),
              "codes_z": (codes_z, (K, N), torch.int8),
              "bh": (bh, (N,), torch.float32),
              "bz": (bz, (N,), torch.float32),
              "h": (h, (B, N), torch.float32)}
    for name, (t, shape, dtype) in expect.items():
        if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
            raise ValueError(f"{what}: {name} must be {dtype} "
                             f"{tuple(shape)}, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    if B > 65535 or max(x_shape + (N,)) >= 2**31:
        raise ValueError(f"{what}: shape {tuple(x_shape)} -> {N} too large "
                         "for one launch")


def minimalist_step_kernel(x, codes_h, codes_z, scale, bh, bz, h_prev, *,
                           return_z_codes=False):
    """ONE decode step of the fused core: x (B, K) fp32, codes (K, N) int8,
    scale float, bh/bz (N,) fp32, h_prev (B, N) fp32 -> (y, h) each (B, N)
    fp32, plus the int8 gate codes when ``return_z_codes``."""
    if on_cpu(x, codes_h, codes_z, bh, bz, h_prev):
        return ref.minimalist_step_ref(x, codes_h, codes_z, scale, bh, bz,
                                       h_prev, return_z_codes=return_z_codes)
    _check_args("minimalist_step_kernel", x, codes_h, codes_z, bh, bz,
                h_prev, tuple(x.shape))
    B, K = x.shape
    N = codes_h.shape[1]
    y = torch.empty((B, N), dtype=torch.float32, device=x.device)
    h = torch.empty_like(y)
    zc = (torch.empty((B, N), dtype=torch.int8, device=x.device)
          if return_z_codes else None)
    if y.numel():
        lib = build.load("minimalist_step")
        err = lib.minimalist_step_f32(
            x.data_ptr(), codes_h.data_ptr(), codes_z.data_ptr(),
            float(scale), bh.data_ptr(), bz.data_ptr(), h_prev.data_ptr(),
            y.data_ptr(), h.data_ptr(), 0 if zc is None else zc.data_ptr(),
            B, K, N, torch.cuda.current_stream(x.device).cuda_stream)
        build.check(err, "minimalist_step")
        minimalist_step_kernel.launches += 1
    return (y, h, zc) if return_z_codes else (y, h)


minimalist_step_kernel.launches = 0


#: Column slabs the sequence kernel is compiled for, widest first.
BLOCK_SLABS = (64, 32, 16, 8)


def block_plan(B, N, sms):
    """The sequence kernel's grid for B batch rows and N columns on a card
    of ``sms`` SMs: ``(slab, ctas)``, one CTA a batch row and ``slab``
    columns.  The slab is the widest of :data:`BLOCK_SLABS` no wider than
    N needs that still gives each SM a CTA; where none does, the
    narrowest: a small batch spreads its columns over the most SMs, and
    each SM's projection work then slows its state-update chain the
    least."""
    cap = BLOCK_SLABS[-1]
    while cap < min(N, BLOCK_SLABS[0]):
        cap *= 2
    slab = BLOCK_SLABS[-1]
    for cand in BLOCK_SLABS:
        if cand <= cap and B * -(-N // cand) >= sms:
            slab = cand
            break
    return slab, B * -(-N // slab)


def minimalist_block_kernel(x, codes_h, codes_z, scale, bh, bz, h0):
    """The fused core over a sequence: x (B, T, K) fp32 (binary on the
    deployment path), codes (K, N) int8, scale float, bh/bz (N,) fp32,
    h0 (B, N) fp32 -> (y = Θ(h), h) each (B, T, N) fp32.  On the card:
    one launch tiled by :func:`block_plan`, bit for bit the plain
    version's on binary x and within fp32 rounding of it on analog x."""
    if on_cpu(x, codes_h, codes_z, bh, bz, h0):
        return ref.minimalist_block_ref(x, codes_h, codes_z, scale, bh, bz,
                                        h0)
    if x.dim() != 3:
        raise ValueError(f"minimalist_block_kernel: x must be (B, T, K), "
                         f"got {tuple(x.shape)}")
    _check_args("minimalist_block_kernel", x, codes_h, codes_z, bh, bz, h0,
                tuple(x.shape))
    B, T, K = x.shape
    N = codes_h.shape[1]
    y = torch.empty((B, T, N), dtype=torch.float32, device=x.device)
    h = torch.empty_like(y)
    if y.numel():
        slab, _ = block_plan(B, N, torch.cuda.get_device_properties(
            x.device).multi_processor_count)
        lib = build.load("minimalist_block")
        err = lib.minimalist_block_f32(
            x.data_ptr(), codes_h.data_ptr(), codes_z.data_ptr(),
            float(scale), bh.data_ptr(), bz.data_ptr(), h0.data_ptr(),
            y.data_ptr(), h.data_ptr(), B, T, K, N, slab,
            torch.cuda.current_stream(x.device).cuda_stream)
        build.check(err, "minimalist_block")
        minimalist_block_kernel.launches += 1
    return y, h


minimalist_block_kernel.launches = 0


def minimalist_block(x, codes_h, codes_z, scale, bh, bz, h0=None, *,
                     backend="kernel"):
    """Fused hardware-mode block inference over a sequence.  x: (B, T, K)
    in {0, 1}; h0: (B, N) or None (zeros) -> (y = Θ(h), h) each
    (B, T, N)."""
    if h0 is None:
        h0 = torch.zeros(x.shape[0], codes_h.shape[1], dtype=torch.float32,
                         device=x.device)
    if backend == "kernel":
        return minimalist_block_kernel(x, codes_h, codes_z, scale, bh, bz,
                                       h0)
    if backend == "plain":
        return ref.minimalist_block_ref(x, codes_h, codes_z, scale, bh, bz,
                                        h0)
    raise ValueError(f"unknown backend {backend!r} (one of {BACKENDS})")


def minimalist_step(x, codes_h, codes_z, scale, bh, bz, h_prev, *,
                    backend="kernel"):
    """Fused single-step hardware-mode decode: projection + gate + state
    update + comparator.  x: (B, K); h_prev: (B, N) -> (y=Θ(h), h) each
    (B, N).  The serving engine's frame-streaming hot path."""
    if backend == "kernel":
        return minimalist_step_kernel(x, codes_h, codes_z, scale, bh, bz,
                                      h_prev)
    if backend == "plain":
        return ref.minimalist_step_ref(x, codes_h, codes_z, scale, bh, bz,
                                       h_prev)
    raise ValueError(f"unknown backend {backend!r} (one of {BACKENDS})")


def cost_model(B, T, K, N, *, dtype_bytes=2):
    """Analytic (flops, bytes) per fused block call: two MVMs + O(BTN)
    elementwise work; memory sees x once, int8 codes once, y/h out."""
    flops = 2 * 2 * B * T * K * N + 8 * B * T * N
    bytes_ = (B * T * K * dtype_bytes        # x (binary, stored bf16)
              + 2 * K * N                    # int8 code matrices
              + B * T * N * (dtype_bytes + 4))  # y + h out
    return flops, bytes_
