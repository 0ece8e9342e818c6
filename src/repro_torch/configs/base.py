"""Architecture and serving configuration schema (port of
``repro.configs.base``).

The dataclasses are the reference's own, field for field, with the same
``__post_init__`` validation.  Two fields name port backends instead of
the TPU ones: ``ModelConfig.scan_backend`` takes a value of
:data:`SCAN_BACKENDS` (the hand-written CUDA kernel replaces
``pallas``/``pallas_tpu``), and ``paged_impl`` keeps only ``gather``
until the paged-attention kernels are ported.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

# Block kinds
ATTN = "attn"            # global self-attention (GQA)
ATTN_LOCAL = "attn_local"  # sliding-window self-attention
MLA = "mla"              # DeepSeek multi-head latent attention
MAMBA = "mamba"          # Mamba-1 selective SSM
MINGRU = "mingru"        # paper's minGRU time-mixing block

#: Legal values of :attr:`MoEConfig.dispatch`.
MOE_DISPATCH_MODES = ("pooled", "per_request", "auto")

#: Legal values of :attr:`ModelConfig.paged_impl` (the Pallas paged
#: kernels are not ported yet; ``gather`` is the dense-view oracle).
PAGED_IMPLS = ("gather",)

#: Legal values of :attr:`ModelConfig.kv_dtype`.
KV_DTYPES = ("bf16", "int8")

#: Legal values of :attr:`ModelConfig.scan_backend`:
#:   kernel — the hand-written CUDA scan on CUDA tensors, its plain
#:            version (the associative reference) on CPU tensors
#:   assoc  — the associative (log-depth, fp32) reference on any device
#:   seq    — the definitional sequential reference on any device
SCAN_BACKENDS = ("kernel", "assoc", "seq")


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0
    capacity_factor: float = 1.25
    router_noise: float = 0.0
    groups: int = 1
    dispatch: str = "auto"

    def __post_init__(self):
        if self.dispatch not in MOE_DISPATCH_MODES:
            raise ValueError(
                f"dispatch must be one of {MOE_DISPATCH_MODES}, "
                f"got {self.dispatch!r}")
        if self.groups < 1:
            raise ValueError(f"groups must be >= 1, got {self.groups}")
        if not 1 <= self.top_k <= self.n_experts:
            raise ValueError(
                f"top_k must be in [1, n_experts={self.n_experts}], "
                f"got {self.top_k}")


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    kind: str = ATTN          # one of the block kinds above
    moe: bool = False         # MoE MLP instead of dense MLP
    d_ff: Optional[int] = None  # dense-MLP width override


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    d_model: int
    n_layers: int
    vocab: int
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    # n_head_layers of head_pattern, then pattern repeated, then tail
    pattern: Sequence[LayerSpec] = (LayerSpec(),)
    head_layers: Sequence[LayerSpec] = ()
    tail_layers: Sequence[LayerSpec] = ()
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    mamba: Optional[MambaConfig] = None
    sliding_window: int = 4096
    rope_theta: float = 1e4
    arch_type: str = "decoder"
    n_enc_layers: int = 0
    frontend_embed_dim: int = 0
    frontend_seq: int = 0
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    # paper technique hooks: float | quantized | hardware
    mingru_quant: str = "float"
    mtp_depth: int = 0
    attention_impl: str = "naive"
    ssm_impl: str = "xla"
    scan_backend: str = "kernel"
    paged_impl: str = "gather"
    kv_dtype: str = "bf16"
    moe_constraints: bool = False

    def __post_init__(self):
        if self.paged_impl not in PAGED_IMPLS:
            raise ValueError(
                f"paged_impl must be one of {PAGED_IMPLS}, "
                f"got {self.paged_impl!r}")
        if self.kv_dtype not in KV_DTYPES:
            raise ValueError(
                f"kv_dtype must be one of {KV_DTYPES}, "
                f"got {self.kv_dtype!r}")
        if self.scan_backend not in SCAN_BACKENDS:
            raise ValueError(
                f"scan_backend must be one of {SCAN_BACKENDS}, "
                f"got {self.scan_backend!r}")

    def layer_specs(self) -> list:
        n_rep = (self.n_layers - len(self.head_layers) - len(self.tail_layers))
        if n_rep % len(self.pattern):
            raise ValueError(
                f"{self.name}: {self.n_layers} layers do not decompose into "
                f"head({len(self.head_layers)}) + k*pattern("
                f"{len(self.pattern)}) + tail({len(self.tail_layers)})")
        reps = n_rep // len(self.pattern)
        return (list(self.head_layers) + list(self.pattern) * reps
                + list(self.tail_layers))

    @property
    def n_repeats(self) -> int:
        n_rep = (self.n_layers - len(self.head_layers)
                 - len(self.tail_layers))
        return n_rep // len(self.pattern)

    @property
    def vocab_padded(self) -> int:
        """Vocab rounded up to a multiple of 512 (logits masked past
        ``vocab``)."""
        return (self.vocab + 511) // 512 * 512


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Continuous-batching serving knobs (consumed by
    repro_torch.launch.serve.build_engine)."""
    slots: int = 8
    max_len: int = 256
    prefill_chunk: int = 256
    kv_layout: str = "dense"
    page_size: int = 16
    num_pages: int = 0
    prefix_cache: bool = False
    policy: str = "fifo"
    spec_k: int = 1
    drafter: str = ""

    def __post_init__(self):
        if self.spec_k < 1:
            raise ValueError(f"spec_k must be >= 1, got {self.spec_k}")
        if self.spec_k > 1 and not self.drafter:
            raise ValueError(
                f"spec_k={self.spec_k} needs a drafter — name a pure "
                "O(1)-state arch (ServeConfig.drafter) to propose the "
                "speculative tokens")
        if self.drafter and self.kv_layout != "paged":
            raise ValueError(
                "speculative decoding needs kv_layout='paged': rollback "
                "relies on uncommitted pages (the pool never holds a "
                f"rejected token), got kv_layout={self.kv_layout!r}")
        if self.drafter and self.prefix_cache:
            raise ValueError(
                "speculative decoding and prefix_cache are mutually "
                "exclusive")


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request decoding knobs (see repro_torch.serve.sampling).

    The defaults are greedy argmax.  ``seed`` is hashed with the request
    uid, the absolute token position and the vocab index, so a request's
    tokens are reproducible regardless of co-batched traffic."""
    temperature: float = 0.0  # <= 0 means greedy
    top_k: int = 0            # 0 disables
    top_p: float = 1.0        # >= 1 disables; else minimal nucleus
    seed: int = 0

    def validate(self):
        if not self.temperature >= 0:          # NaN fails this too
            raise ValueError("temperature must be >= 0 and not NaN")
        if not 0 <= self.top_k <= 2**31 - 1:
            raise ValueError("top_k must be in [0, 2**31)")
        if self.top_p <= 0:
            raise ValueError("top_p must be > 0 (>= 1 disables the filter)")
        if not 0 <= self.seed <= 2**32 - 1:
            raise ValueError("seed must be a uint32 (in [0, 2**32))")
        return self
