"""The reference's 14 architectures (port of ``repro.configs.archs``):
Qwen3-MoE-30B-A3B (GQA with 128 routed experts top-8), DeepSeek-V3-671B
(MLA, 3 dense head layers then MoE with a shared expert), StableLM-12B
(GQA at head dim 160), Mistral-Large-123B (GQA group 12), SmolLM-360M
(global GQA), Gemma-3-4B (5:1 sliding-window:global GQA), LLaVA-NeXT-34B
(a decoder LM behind a stubbed patch-embedding prefix), Whisper-small
(encoder-decoder over stubbed frame embeddings), Falcon-Mamba-7B
(attention-free Mamba-1), Jamba-1.5-Large-398B (Mamba and attention 7:1,
MoE every other layer), the paper's technique at LM scale at 360M and
100M and their hardware-mode twins, the paper's sMNIST network dims,
``ASSIGNED``, ``reduced()`` and ``get_config``.  Values are the
reference's own.  ``input_specs``, ``shape_supported`` and
``LONG_CONTEXT_OK`` belong to the dry-run, which is not ported."""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import (ATTN, ATTN_LOCAL, MAMBA, MINGRU, MLA,
                                      LayerSpec, MambaConfig, MLAConfig,
                                      ModelConfig, MoEConfig)

QWEN3_MOE_30B = ModelConfig(
    # [hf:Qwen/Qwen3-30B-A3B; hf]
    name="qwen3-moe-30b-a3b",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4, head_dim=128,
    d_ff=768, vocab=151936,
    pattern=(LayerSpec(ATTN, moe=True),),
    moe=MoEConfig(n_experts=128, top_k=8, d_ff_expert=768),
    rope_theta=1e6, tie_embeddings=False,
)

DEEPSEEK_V3_671B = ModelConfig(
    # [arXiv:2412.19437; hf] — MLA, 1 shared + 256 routed top-8, MTP,
    # first 3 layers dense (d_ff 18432), the rest MoE (expert d_ff 2048)
    name="deepseek-v3-671b",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128, head_dim=128,
    d_ff=18432, vocab=129280,
    head_layers=(LayerSpec(MLA, d_ff=18432),) * 3,
    pattern=(LayerSpec(MLA, moe=True),),
    moe=MoEConfig(n_experts=256, top_k=8, d_ff_expert=2048, n_shared=1),
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    rope_theta=1e4, tie_embeddings=False, mtp_depth=1,
)

STABLELM_12B = ModelConfig(
    # [hf:stabilityai/stablelm-2-12b; hf]
    name="stablelm-12b",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, head_dim=160,
    d_ff=13824, vocab=100352,
    pattern=(LayerSpec(ATTN),), rope_theta=1e4, tie_embeddings=False,
)

MISTRAL_LARGE_123B = ModelConfig(
    # [hf:mistralai/Mistral-Large-Instruct-2407; unverified]
    name="mistral-large-123b",
    n_layers=88, d_model=12288, n_heads=96, n_kv_heads=8, head_dim=128,
    d_ff=28672, vocab=32768,
    pattern=(LayerSpec(ATTN),), rope_theta=1e6, tie_embeddings=False,
)

SMOLLM_360M = ModelConfig(
    # [hf:HuggingFaceTB/SmolLM-360M; hf] — llama-arch small
    name="smollm-360m",
    n_layers=32, d_model=960, n_heads=15, n_kv_heads=5, head_dim=64,
    d_ff=2560, vocab=49152,
    pattern=(LayerSpec(ATTN),), rope_theta=1e4, tie_embeddings=True,
)

GEMMA3_4B = ModelConfig(
    # [hf:google/gemma-3-4b-pt; unverified] — 5:1 local:global, window 1024
    name="gemma3-4b",
    n_layers=34, d_model=2560, n_heads=8, n_kv_heads=4, head_dim=256,
    d_ff=10240, vocab=262144, sliding_window=1024,
    pattern=(LayerSpec(ATTN_LOCAL),) * 5 + (LayerSpec(ATTN),),
    tail_layers=(LayerSpec(ATTN_LOCAL),) * 3 + (LayerSpec(ATTN),),
    rope_theta=1e6, tie_embeddings=True,
)

LLAVA_NEXT_34B = ModelConfig(
    # [hf:llava-hf/llava-v1.6-34b-hf; unverified] — anyres tiling stubbed:
    # the caller passes precomputed patch embeddings (B, n_patches, D)
    name="llava-next-34b",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8, head_dim=128,
    d_ff=20480, vocab=64000,
    pattern=(LayerSpec(ATTN),), arch_type="vlm",
    frontend_embed_dim=7168, frontend_seq=576,
    rope_theta=5e6, tie_embeddings=False,
)

WHISPER_SMALL = ModelConfig(
    # [arXiv:2212.04356; unverified] — enc-dec, conv frontend stubbed
    name="whisper-small",
    n_layers=12, n_enc_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
    head_dim=64, d_ff=3072, vocab=51865,
    pattern=(LayerSpec(ATTN),), arch_type="audio",
    frontend_embed_dim=768, frontend_seq=1500, tie_embeddings=True,
)

FALCON_MAMBA_7B = ModelConfig(
    # [arXiv:2410.05355; unverified] — mamba1 arch, attention-free
    name="falcon-mamba-7b",
    n_layers=64, d_model=4096, n_heads=0, n_kv_heads=0, head_dim=0,
    d_ff=0, vocab=65024,
    pattern=(LayerSpec(MAMBA),),
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
    tie_embeddings=False,
)

# Jamba block: 8 layers, attention at position 4, Mamba elsewhere (1:7);
# MoE every other layer (16 experts top-2). [arXiv:2403.19887; hf]
_JAMBA_UNIT = tuple(
    LayerSpec(ATTN if i == 4 else MAMBA, moe=(i % 2 == 1))
    for i in range(8)
)

JAMBA_15_LARGE_398B = ModelConfig(
    name="jamba-1.5-large-398b",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=24576, vocab=65536,
    pattern=_JAMBA_UNIT,
    moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=24576),
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
    tie_embeddings=False,
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

# ~100M-param variant for the end-to-end training example
MINIMALIST_LM_100M = ModelConfig(
    name="minimalist-lm-100m",
    n_layers=16, d_model=1152, n_heads=0, n_kv_heads=0, head_dim=0,
    d_ff=0, vocab=49152,
    pattern=(LayerSpec(MINGRU),),
    tie_embeddings=True, mingru_quant="float",
)

MINIMALIST_LM_100M_HW = dataclasses.replace(
    MINIMALIST_LM_100M, name="minimalist-lm-100m-hw",
    mingru_quant="hardware")

MINIMALIST_LM_HW = dataclasses.replace(
    MINIMALIST_LM_360M, name="minimalist-lm-360m-hw", mingru_quant="hardware")

ARCHS = {c.name: c for c in [
    QWEN3_MOE_30B, DEEPSEEK_V3_671B, STABLELM_12B, MISTRAL_LARGE_123B,
    SMOLLM_360M, GEMMA3_4B, LLAVA_NEXT_34B, WHISPER_SMALL, FALCON_MAMBA_7B,
    JAMBA_15_LARGE_398B, MINIMALIST_LM_360M, MINIMALIST_LM_HW,
    MINIMALIST_LM_100M, MINIMALIST_LM_100M_HW,
]}

ASSIGNED = [c.name for c in [
    QWEN3_MOE_30B, DEEPSEEK_V3_671B, STABLELM_12B, MISTRAL_LARGE_123B,
    SMOLLM_360M, GEMMA3_4B, LLAVA_NEXT_34B, WHISPER_SMALL, FALCON_MAMBA_7B,
    JAMBA_15_LARGE_398B,
]]


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
