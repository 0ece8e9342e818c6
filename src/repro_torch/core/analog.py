"""Behavioral switched-capacitor simulator for the MINIMALIST cores (port
of ``repro.core.analog``, paper §3).

It executes the *circuit* — charge sharing on capacitor banks, a 6 b SAR
ADC with tunable slope/offset, capacitor-swap state updates and a
comparator — in the voltage domain, with capacitor mismatch and
comparator noise.  Circuit ↔ model: a column of K synapse rows plus one
always-on bias row settles at

    v − V0 = α · (W·x + b) ,      α = ΔV / (Δ_sw · (K + 1))   [volts/unit]

and every downstream element is affine or threshold-based, so the ideal
circuit is an exact scaled image of the quantized software model: the
SAR ADC realizes z = q6(hard_sigmoid(s)) (input LSB 6α/63, the z-bias on
the DAC preset grid), the swap of k of 63 unit segments realizes
h ← (k/63)·h̃ + (1 − k/63)·h, and the comparator realizes Θ(h).

Arithmetic is fp32 on the inputs' device, as the reference's.  Random
draws (mismatch, comparator noise) come from an explicit
``torch.Generator``; they are not ``jax.random``'s numbers, so the tests
hand both packages the same numpy arrays.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.core import quant

# ---------------------------------------------------------------------------
# Configuration
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AnalogConfig:
    v_dd: float = 0.8            # supply [V]
    v0_frac: float = 0.5         # zero level V0 = v0_frac * v_dd
    delta_v: float = 0.1         # weight-level spacing ΔV [V]
    c_unit_f: float = 1.0e-15    # unit sampling capacitor [F]
    mismatch_sigma: float = 0.0  # relative capacitor mismatch σ(C)/C
    comparator_noise_v: float = 0.0  # comparator input-referred noise σ [V]
    adc_bits: int = 6
    gate_units: int = quant.GATE_UNITS  # 63 binary-scaled segment units

    @property
    def v0(self):
        return self.v0_frac * self.v_dd

    def weight_voltages(self):
        """The four equidistant potentials V_00..V_11 around V0."""
        lv = np.array([-1.5, -0.5, 0.5, 1.5]) * self.delta_v
        return self.v0 + lv


# ---------------------------------------------------------------------------
# Weight export: trained (quantized) software params -> hardware images
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class LayerImage:
    """Hardware image of one MinGRU block (tensors on the params'
    device)."""
    codes_h: torch.Tensor        # (K, N) int64 2 b codes for W^h
    codes_z: torch.Tensor        # (K, N)
    bias_h_v: torch.Tensor       # (N,) bias-row voltage offsets [V]
    adc_offset_code: torch.Tensor  # (N,) int32 signed DAC preset codes
    alpha: float                 # volts per software model-unit
    scale: float                 # shared software weight step Δ_sw
    k_rows: int


def export_layer(block, cfg: AnalogConfig) -> LayerImage:
    """Map a trained ``MinGRUBlock``'s params onto circuit quantities."""
    p = {k: getattr(block, k).detach().float()
         for k in ("wh", "bh", "wz", "bz")}
    K = p["wh"].shape[0]
    with torch.no_grad():
        # one shared Δ_sw per layer (both matrices share the 4 row rails)
        scale = float(torch.maximum(quant.weight_scale(p["wh"]),
                                    quant.weight_scale(p["wz"])))
        codes_h = quant.quantize_weights_2b(p["wh"], scale)[1].long()
        codes_z = quant.quantize_weights_2b(p["wz"], scale)[1].long()
        alpha = cfg.delta_v / (scale * (K + 1))
        # h̃ bias: 6 b quantized, on the bias row; the (K+1)-way share
        # contributes α·b for v_bias = (K+1)·α·b_q
        bias_h_v = quant.quantize_bias_6b(p["bh"]) * ((K + 1) * alpha)
        # z bias: DAC preset — integer codes on the 6/63 model-unit grid
        bz_q = quant.quantize_gate_bias_adc(p["bz"])
        adc_offset_code = torch.round(
            quant._div(bz_q, quant.ADC_GATE_BIAS_LSB)).to(torch.int32)
    return LayerImage(codes_h=codes_h, codes_z=codes_z, bias_h_v=bias_h_v,
                      adc_offset_code=adc_offset_code, alpha=alpha,
                      scale=scale, k_rows=K)


# ---------------------------------------------------------------------------
# Circuit primitives
# ---------------------------------------------------------------------------


def charge_sharing_mvm(x_bin, codes, bias_v, cfg: AnalogConfig, caps=None):
    """Column charge sharing (Eq. 6 + bias row).

    x_bin: (B, K) in {0,1}; codes: (K, N); bias_v: (N,) volts around V0.
    caps: optional (K+1, N) per-capacitor values (mismatch); defaults 1.
    Returns settled column voltages (B, N).
    """
    dev = x_bin.device
    vw = torch.as_tensor(cfg.weight_voltages(), dtype=torch.float32,
                         device=dev)
    v_syn = vw[torch.as_tensor(codes, device=dev).long()]   # (K, N) volts
    K = x_bin.shape[1]
    N = v_syn.shape[1]
    if caps is None:
        caps = torch.ones(K + 1, N, device=dev)
    c_syn, c_bias = caps[:K], caps[K]
    # x_i = 0 clamps that row's rails to V0 (paper §3.1.1)
    xb = x_bin[:, :, None]
    v_eff = xb * v_syn[None] + (1 - xb) * cfg.v0
    num = torch.einsum("bkn,kn->bn", v_eff, c_syn) \
        + c_bias * (cfg.v0 + bias_v)
    den = c_syn.sum(0) + c_bias
    return num / den


def sar_adc(v_in, cfg: AnalogConfig, *, lsb_volts, offset_code=0,
            generator=None):
    """6 b SAR ADC (Fig. 3) as an explicit successive-approximation loop.

    ``lsb_volts`` is the input-referred LSB (the C_ADC/C_IMC segment
    ratio: the slope); ``offset_code`` the signed DAC preset (§3.1.2).
    code = clip(floor((v−V0)/lsb) + 32 + offset, 0, 63): mid-rise around
    V0, matching q6(hard_sigmoid) when lsb = 6α/63.  With a
    ``generator`` and comparator noise, each SAR decision sees fresh
    input-referred noise.  Returns int32 codes in [0, 2^bits − 1].
    """
    bits = cfg.adc_bits
    full = 2 ** bits
    if generator is not None and cfg.comparator_noise_v > 0:
        noise = cfg.comparator_noise_v * torch.randn(
            tuple(v_in.shape) + (bits,), generator=generator,
            device=v_in.device)
    else:
        noise = torch.zeros(tuple(v_in.shape) + (bits,), device=v_in.device)
    # −0.5 LSB preset: thresholds at half-LSB positions (mid-rise).  The
    # preset voltage is formed in fp64 and rounded once, as the reference
    # forms it (numpy codes times a Python float).
    offset = torch.as_tensor(offset_code, device=v_in.device)
    preset = ((full // 2 + offset.double() - 0.5) * lsb_volts).float()
    v_eff = v_in - cfg.v0 + preset
    code = torch.zeros(v_eff.shape, dtype=torch.int32, device=v_in.device)
    for b in range(bits - 1, -1, -1):
        trial = code + (1 << b)
        v_dac = trial * lsb_volts
        keep = (v_eff + noise[..., bits - 1 - b]) >= v_dac
        code = torch.where(keep, trial, code)
    return code


def adc_transfer_closed_form(v_in, cfg: AnalogConfig, *, lsb_volts,
                             offset_code=0):
    """Noise-free closed form of sar_adc (cross-check for the SAR loop)."""
    full = 2 ** cfg.adc_bits
    offset = torch.as_tensor(offset_code, device=v_in.device)
    code = torch.floor(quant._div(v_in - cfg.v0, lsb_volts) - 0.5) \
        + full // 2 + offset
    return torch.clamp(code, 0, full - 1).to(torch.int32)


def state_update_swap(v_h, v_htilde, z_code, cfg: AnalogConfig,
                      seg_caps=None):
    """Capacitor-swap state update (§3.1.3).

    v_h, v_htilde: (B, N) bank voltages; z_code: (B, N) ADC codes in
    [0, 63] = number of unit segments to swap.  seg_caps: optional
    (63, N) unit-segment capacitances for mismatch.  Ideal:
    v ← (k/63)·h̃ + (1−k/63)·h; with mismatch the ratio is
    Σ_{i<k} C_i / ΣC_i."""
    S = cfg.gate_units
    if seg_caps is None:
        frac = quant._div(z_code.float(), float(S))
    else:
        csum = torch.cat([torch.zeros(1, seg_caps.shape[1],
                                      device=seg_caps.device),
                          torch.cumsum(seg_caps, 0)], 0)
        total = csum[-1]
        frac = torch.gather(csum, 0, z_code.long()) / total
    return frac * v_htilde + (1.0 - frac) * v_h


def comparator(v, v_ref, cfg: AnalogConfig, generator=None):
    """Clocked comparator: Θ(v − v_ref) with optional input noise."""
    if generator is not None and cfg.comparator_noise_v > 0:
        v = v + cfg.comparator_noise_v * torch.randn(
            v.shape, generator=generator, device=v.device)
    return (v > v_ref).float()


# ---------------------------------------------------------------------------
# Full analog network (mirror of core.mingru.MinimalistNetwork)
# ---------------------------------------------------------------------------


def make_mismatch(generator, images: Sequence[LayerImage],
                  cfg: AnalogConfig):
    """Draw per-device capacitor mismatch for every layer (fixed per chip)
    from ``generator``: {"caps_h", "caps_z": (K+1, N), "segs": (63, N)}."""
    dev = generator.device
    out = []
    for img in images:
        K1, N = img.k_rows + 1, img.codes_h.shape[1]

        def draw(*shape):
            return torch.abs(1.0 + cfg.mismatch_sigma * torch.randn(
                shape, generator=generator, device=dev))
        out.append({"caps_h": draw(K1, N), "caps_z": draw(K1, N),
                    "segs": draw(cfg.gate_units, N)})
    return out


@torch.no_grad()
def analog_forward(images: Sequence[LayerImage], x_seq, cfg: AnalogConfig,
                   mismatch=None, generator=None, collect_traces=True,
                   forced_inputs=None):
    """Run the switched-capacitor network on a binary input sequence.

    x_seq: (B, T, K0) in {0,1}.  Returns (readout in software model units
    (B, N_last), per-layer traces [{"z","htilde","h","out"}] stacked over
    time in model units) — the paper-Fig.-4 payload.

    ``forced_inputs``: optional list of (B, T, K_li) binary tensors, one
    per layer ≥ 1, substituting the software model's inter-layer
    activations for the analog ones (open-loop verification: a comparator
    decision on a state sitting exactly at threshold is noise-determined
    in any real circuit, so forcing isolates each layer).
    """
    B, T, _ = x_seq.shape
    dev = x_seq.device
    v_h = [torch.full((B, img.codes_h.shape[1]), cfg.v0, device=dev)
           for img in images]
    traces = [{"z": [], "htilde": [], "h": [], "out": []} for _ in images]
    for t in range(T):
        x = x_seq[:, t, :]
        for li, img in enumerate(images):
            if forced_inputs is not None and li >= 1:
                x = torch.as_tensor(forced_inputs[li - 1],
                                    device=dev)[:, t, :]
            mm = mismatch[li] if mismatch is not None else {}
            v_ht = charge_sharing_mvm(x, img.codes_h, img.bias_h_v, cfg,
                                      caps=mm.get("caps_h"))
            v_z = charge_sharing_mvm(
                x, img.codes_z, torch.zeros(img.codes_z.shape[1],
                                            device=dev),
                cfg, caps=mm.get("caps_z"))
            # ADC slope: input LSB = 6α/63 volts matches q6(hard_sigmoid)
            lsb = 6.0 * img.alpha / quant.GATE_UNITS
            z_code = sar_adc(v_z, cfg, lsb_volts=lsb,
                             offset_code=img.adc_offset_code,
                             generator=generator)
            v_h[li] = state_update_swap(v_h[li], v_ht, z_code, cfg,
                                        seg_caps=mm.get("segs"))
            x = comparator(v_h[li], cfg.v0, cfg, generator=generator)
            if collect_traces:
                traces[li]["htilde"].append(
                    quant._div(v_ht - cfg.v0, img.alpha))
                traces[li]["z"].append(
                    quant._div(z_code.float(), float(quant.GATE_UNITS)))
                traces[li]["h"].append(quant._div(v_h[li] - cfg.v0,
                                                  img.alpha))
                traces[li]["out"].append(x)
    readout = quant._div(v_h[-1] - cfg.v0, images[-1].alpha)
    if collect_traces:
        traces = [{k: torch.stack(v, dim=1) for k, v in tr.items()}
                  for tr in traces]
    return readout, traces


# ---------------------------------------------------------------------------
# Energy model (paper §4.2)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class EnergyConfig:
    c_sample_f: float = 2.0e-15        # sampling capacitor [F]
    c_switch_f: float = 0.5e-15        # transmission-gate gate cap [F]
    c_line_f_per_row: float = 1.0e-15  # shared-line parasitic per synapse [F]
    v_dd: float = 0.8


def energy_per_step(rows: int, cols: int, n_cores: int,
                    ecfg: EnergyConfig = EnergyConfig(),
                    z_mean: float = 1.0) -> dict:
    """Structural energy estimate per time step (worst case z_mean = 1):
    precharge of the h̃ and z sampling caps, the 4 shared weight rails per
    row, S1/S2 switch toggles and swap switches ∝ z — the paper's
    accounting (SAR DAC, routing, control and clocking excluded)."""
    n_syn = rows * cols * n_cores
    e_cap = ecfg.c_sample_f * ecfg.v_dd ** 2
    e_sw = ecfg.c_switch_f * ecfg.v_dd ** 2
    e_line = ecfg.c_line_f_per_row * ecfg.v_dd ** 2

    e_precharge = n_syn * 2 * e_cap            # h̃ + z sampling (worst case)
    e_lines = n_syn * 4 * e_line               # 4 weight rails per row
    e_switches = n_syn * (2 + 2) * 2 * e_sw    # S1*/S2* toggle pairs
    e_swap = n_syn * 2 * e_sw * z_mean + n_syn * e_cap * z_mean * 0.5
    total = e_precharge + e_lines + e_switches + e_swap
    return {
        "precharge_J": e_precharge,
        "lines_J": e_lines,
        "switches_J": e_switches,
        "swap_J": e_swap,
        "total_J": total,
        "total_pJ": total * 1e12,
    }
