"""Quantizers and the QAT schedule of the MINIMALIST architecture (port
of ``repro.core.quant``, paper §2).

  * 2 b weights   — four equidistant levels {-3/2, -1/2, +1/2, +3/2}·Δ
  * 6 b biases    — uniform symmetric fixed point, codes [-31, 31]
  * binary output activations σ_h = Θ(·) (Heaviside)
  * hard-sigmoid gate σ_z(x) = clip(x/6 + 1/2, 0, 1), quantized to the
    6 b SAR-ADC grid {k/63}; its bias on the ADC preset grid, codes
    [-32, 31] (two's complement)

Every quantizer is straight-through: forward = the quantized value,
backward = identity.  The forward values are bitwise the reference's.
"""
from __future__ import annotations

import dataclasses

import torch

# Relative 2 b weight levels (units of the level spacing Δ).
_W2B_LEVELS = (-1.5, -0.5, 0.5, 1.5)


def _div(x, c):
    """``x / c`` as a true IEEE division on every device.  A Python
    scalar divisor would let CUDA multiply by its reciprocal instead,
    which moves results by an ulp and can flip a 6 b gate code."""
    if not torch.is_tensor(c):
        c = torch.full((), c, dtype=x.dtype, device=x.device)
    return x / c


def _ste(x_quant, x):
    """Straight-through: forward ``x_quant``, gradient of identity wrt x.

    Written as x − sg(x) + sg(x_quant) (``repro.core.quant._ste``): the
    x − sg(x) term is an exact IEEE zero, so the forward value is
    bit-exactly ``x_quant``; ``x + sg(x_quant − x)`` is not."""
    return x - x.detach() + x_quant.detach()


# ---------------------------------------------------------------------------
# Weight / bias quantizers
# ---------------------------------------------------------------------------

def weight_scale(w, *, axis=None):
    """Per-tensor (or per-axis) Δ so that ±1.5Δ covers ~|w|_max."""
    if axis is None:
        m = w.abs().max()
    else:
        m = w.abs().amax(dim=axis, keepdim=True)
    return _div(torch.clamp(m, min=1e-8), 1.5)


def quantize_weights_2b(w, scale=None):
    """Project w onto {±0.5, ±1.5}·Δ with STE. Returns (w_q, codes ∈ [0,4))."""
    if scale is None:
        scale = weight_scale(w).detach()
    wn = _div(w, scale)
    # nearest of the four levels; decision boundaries at -1, 0, +1
    codes = ((wn > -1.0).to(torch.int32) + (wn > 0.0).to(torch.int32)
             + (wn > 1.0).to(torch.int32))
    levels = torch.tensor(_W2B_LEVELS, dtype=torch.float32, device=w.device)
    wq = levels[codes] * scale
    return _ste(wq, w), codes


def quantize_levels_2b(w, scale):
    """The 2 b weights in units of Δ: levels {±0.5, ±1.5} with STE, so
    that ``(x @ levels) * scale`` has the gradient of ``x @ w``.  With
    binary x every partial sum of ``x @ levels`` is a small multiple of
    1/2, exact in fp32 in any summation order."""
    wn = _div(w, scale)
    _, codes = quantize_weights_2b(w, scale)
    levels = torch.tensor(_W2B_LEVELS, dtype=torch.float32, device=w.device)
    return _ste(levels[codes], wn)


def weight_codes_2b(w, scale=None):
    """Non-differentiable export path: 2 b codes + Δ for the hardware map."""
    if scale is None:
        scale = weight_scale(w)
    _, codes = quantize_weights_2b(w, scale)
    return codes, scale


def quantize_bias_6b(b, scale=None):
    """Uniform symmetric 6 b fixed point: levels {-31..31}·δ.

    SYMMETRIC grid (the weight/bias DAC): code -32 is never emitted and
    quantize(-x) == -quantize(x) exactly.  The gate bias uses the other,
    two's-complement grid — see :func:`quantize_gate_bias_adc`."""
    if scale is None:
        scale = _div(torch.clamp(b.abs().max(), min=1e-8), 31.0).detach()
    q = torch.clamp(torch.round(_div(b, scale)), -31, 31) * scale
    return _ste(q, b)


# ---------------------------------------------------------------------------
# Activation functions (paper Eq. 4, 5)
# ---------------------------------------------------------------------------

def sigmoid(x):
    """Logistic σ(x) = 1 / (1 + exp(−x)), one op at a time in x.dtype —
    the expansion XLA gives ``jax.nn.sigmoid`` (neg, exp, add, divide,
    each rounded to the array's dtype).  ``torch.sigmoid`` rounds once
    from fp32 instead, which differs from the reference in a third of
    bf16 results."""
    return 1.0 / (1.0 + torch.exp(-x))


def hard_sigmoid(x):
    """σ_z(x) = 0 for x ≤ −3, 1 for x ≥ +3, x/6 + 1/2 in between."""
    return torch.clamp(_div(x, 6.0) + 0.5, 0.0, 1.0)


# 6 binary-scaled capacitor groups = 63 unit capacitors (paper §3.1.2)
GATE_UNITS = 63


def quantize_unit_6b(z):
    """Quantize z ∈ [0,1] to the capacitor-swap grid {k/63}: mid-rise
    floor, the SAR ADC's own transfer."""
    zq = _div(torch.floor(z * GATE_UNITS), float(GATE_UNITS))
    return _ste(zq, z)


# One input-referred ADC LSB is 6/63 model units (paper §3.1.2).
ADC_GATE_BIAS_LSB = 6.0 / GATE_UNITS


def quantize_gate_bias_adc(b):
    """Quantize the gate bias onto the ADC-offset grid: full TWO'S-
    COMPLEMENT codes -32..31 (the ADC preset is a signed 6 b register)."""
    q = torch.clamp(torch.round(_div(b, ADC_GATE_BIAS_LSB)), -32, 31) \
        * ADC_GATE_BIAS_LSB
    return _ste(q, b)


def hard_sigmoid_q6(x):
    """Hardware gate: hard sigmoid followed by the 6 b ADC quantization."""
    return quantize_unit_6b(hard_sigmoid(x))


class _Heaviside(torch.autograd.Function):
    """Θ(x) with a boxcar surrogate gradient 1/(2w) on |x| < w."""

    @staticmethod
    def forward(ctx, x, width):
        ctx.save_for_backward(x)
        ctx.width = width
        return (x > 0.0).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        w = ctx.width
        mask = (x.abs() < w).to(g.dtype) / (2.0 * w)
        return g * mask, None


def heaviside_ste(x, *, surrogate_width=3.0):
    """Binary output activation Θ(x) with a boxcar STE surrogate
    (``repro.core.quant.heaviside_ste``); forward is exactly {0, 1}."""
    return _Heaviside.apply(x, float(surrogate_width))


# ---------------------------------------------------------------------------
# QAT configuration & the 4-phase schedule (paper §4.1)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Which hardware constraints are active."""
    quantize_weights: bool = False    # 2 b weights
    quantize_biases: bool = False     # 6 b biases
    binary_output: bool = False       # σ_h = Θ (else identity)
    hard_sigmoid_gate: bool = False   # σ_z = hard sigmoid (else logistic)
    quantize_gate_6b: bool = False    # 6 b z (ADC resolution)
    surrogate_width: float = 3.0

    @staticmethod
    def float_baseline():
        return QuantConfig()

    @staticmethod
    def quantized():
        """2 b W / 6 b b / binary σ_h, original gate activation."""
        return QuantConfig(quantize_weights=True, quantize_biases=True,
                           binary_output=True)

    @staticmethod
    def hardware():
        """Fully hardware-compatible (adds hard-σ gate + 6 b z)."""
        return QuantConfig(quantize_weights=True, quantize_biases=True,
                           binary_output=True, hard_sigmoid_gate=True,
                           quantize_gate_6b=True)


QAT_PHASES = (
    QuantConfig.float_baseline(),                                   # phase 0
    QuantConfig(quantize_weights=True, quantize_biases=True),       # phase 1
    QuantConfig.quantized(),                                        # phase 2
    QuantConfig.hardware(),                                         # phase 3
)


def gate_fn(cfg: QuantConfig):
    if cfg.hard_sigmoid_gate:
        return hard_sigmoid_q6 if cfg.quantize_gate_6b else hard_sigmoid
    return sigmoid


def output_fn(cfg: QuantConfig):
    if cfg.binary_output:
        return lambda x: heaviside_ste(x, surrogate_width=cfg.surrogate_width)
    return lambda x: x


def maybe_quant_weights(w, cfg: QuantConfig):
    if cfg.quantize_weights:
        wq, _ = quantize_weights_2b(w)
        return wq
    return w


def maybe_quant_bias(b, cfg: QuantConfig):
    return quantize_bias_6b(b) if cfg.quantize_biases else b


def maybe_quant_gate_bias(b, cfg: QuantConfig):
    """Gate bias: fixed ADC-offset grid in full hardware mode, else 6 b."""
    if cfg.quantize_gate_6b:
        return quantize_gate_bias_adc(b)
    return maybe_quant_bias(b, cfg)
