"""Plain PyTorch switched-capacitor IMC projection, paper Eq. 6 (port of
``repro.kernels.imc_mvm.ref``).

Binary activations x_i in {0, 1} connect the shared row lines to the four
weight potentials; each synapse samples the line its 2 b code selects,
and column-wise charge sharing settles at the MEAN of the sampled
voltages.  In weight units (relative to the zero level V_0):

    y_j = (1/K) · Σ_i  x_i · Δ_j · level(code_ij),
    level(c) = c − 1.5  ∈  {−1.5, −0.5, +0.5, +1.5}

a product of a binary activation vector with a 2 b-dequantized weight
matrix, scaled by 1/K (charge sharing normalizes by the number of
capacitors, not by the number of active inputs).  :func:`imc_mvm_ref` is
the plain version of the CUDA kernel ``csrc/imc_mvm.cu``.
"""
from __future__ import annotations

import torch

LEVEL_OFFSET = 1.5  # level(c) = c - 1.5 for c in {0, 1, 2, 3}


def dequantize_codes(codes, scale):
    """codes: int (..., K, N) in [0, 4); scale Δ: a float or (N,)."""
    return (codes.float() - LEVEL_OFFSET) * scale


def imc_mvm_ref(x, codes, scale):
    """x: (M, K) in {0, 1}; codes: (K, N) 2 b; scale: a float or (N,) ->
    (M, N) fp32, the charge-sharing column mean (x @ W_deq) / K."""
    K = x.shape[-1]
    w = dequantize_codes(codes, scale)
    return (x.float() @ w) / K
