"""The architectures of this slice (port of ``repro.configs.archs``):
SmolLM-360M's geometry, the paper's technique at LM scale, its
hardware-mode twin, the paper's sMNIST network dims, ``reduced()`` and
``get_config``.  Values are the reference's own."""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import (MINGRU, LayerSpec, MambaConfig,
                                      MLAConfig, ModelConfig, MoEConfig)

SMOLLM_360M = ModelConfig(
    # [hf:HuggingFaceTB/SmolLM-360M; hf] — llama-arch small
    name="smollm-360m",
    n_layers=32, d_model=960, n_heads=15, n_kv_heads=5, head_dim=64,
    d_ff=2560, vocab=49152, rope_theta=1e4, tie_embeddings=True,
)

# sMNIST network of paper Fig. 5: dims 1-64-64-64-64-10
MINIMALIST_SMNIST_DIMS = (1, 64, 64, 64, 64, 10)

# The paper's technique at LM scale: smollm geometry with minGRU time mixing
MINIMALIST_LM_360M = dataclasses.replace(
    SMOLLM_360M,
    name="minimalist-lm-360m",
    pattern=(LayerSpec(MINGRU),),
    mingru_quant="float",
)

MINIMALIST_LM_HW = dataclasses.replace(
    MINIMALIST_LM_360M, name="minimalist-lm-360m-hw", mingru_quant="hardware")

ARCHS = {c.name: c for c in [SMOLLM_360M, MINIMALIST_LM_360M,
                             MINIMALIST_LM_HW]}


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Shrink a config for CPU smoke tests, preserving structure
    (``repro.configs.archs.reduced``)."""
    n_unit = len(cfg.pattern)
    kw = dict(
        name=cfg.name + "-smoke",
        d_model=64, n_layers=len(cfg.head_layers) + n_unit * 2 +
        len(cfg.tail_layers),
        vocab=512,
        n_heads=4 if cfg.n_heads else 0,
        n_kv_heads=2 if cfg.n_kv_heads else 0,
        head_dim=16 if cfg.head_dim else 0,
        d_ff=128 if cfg.d_ff else 0,
        frontend_embed_dim=64 if cfg.frontend_embed_dim else 0,
        frontend_seq=12 if cfg.frontend_seq else 0,
        sliding_window=8,
        n_enc_layers=2 if cfg.n_enc_layers else 0,
    )
    if cfg.moe:
        kw["moe"] = MoEConfig(n_experts=4, top_k=2, d_ff_expert=32,
                              n_shared=cfg.moe.n_shared,
                              dispatch=cfg.moe.dispatch)
    if cfg.mla:
        kw["mla"] = MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                              qk_nope_head_dim=16, qk_rope_head_dim=8,
                              v_head_dim=16)
    if cfg.mamba:
        kw["mamba"] = MambaConfig(d_state=4, d_conv=4, expand=2)
    if cfg.head_layers:
        kw["head_layers"] = cfg.head_layers[:1]
        kw["n_layers"] = 1 + n_unit * 2 + len(cfg.tail_layers)
    return dataclasses.replace(cfg, **kw)


def get_config(name: str) -> ModelConfig:
    if name.endswith("-smoke"):
        return reduced(ARCHS[name[:-len("-smoke")]])
    return ARCHS[name]
