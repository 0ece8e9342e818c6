"""Architecture and serving configuration schema (port of
``repro.configs.base``).

The dataclasses are the reference's own, field for field, with the same
``__post_init__`` validation, plus checks of ``attention_impl`` against
:data:`ATTENTION_IMPLS` and of ``ssm_impl`` against :data:`SSM_IMPLS`.
Two fields name port backends instead of the TPU ones:
``ModelConfig.scan_backend`` takes a value of
:data:`SCAN_BACKENDS` (the hand-written CUDA kernel replaces
``pallas``/``pallas_tpu``), and ``paged_impl`` takes a value of
:data:`PAGED_IMPLS` (``kernel``, the hand-written paged GQA and MLA
decode kernels, is the default, as the reference defaults to its kernel).
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

#: Legal values of :attr:`ModelConfig.paged_impl`:
#:   kernel — the hand-written CUDA paged GQA and MLA decode kernels on
#:            CUDA tensors, their plain versions (``paged_gqa_ref``,
#:            ``paged_mla_ref``, fp32 softmax numerics) on CPU tensors
#:   gather — the dense-view oracle: gathers each slot's page chain and
#:            runs the dense decode math (bitwise equal to kv_layout="dense")
PAGED_IMPLS = ("gather", "kernel")

#: Legal values of :attr:`ModelConfig.attention_impl`:
#:   naive — the masked softmax over the full (S, S) scores
#:   flash — the flash-attention op: the hand-written CUDA forward and
#:           backward kernels on CUDA tensors, their plain versions on CPU
#:           tensors
#:   stub  — the dry-run's O(S·d) stand-in (``launch.dryrun`` adds the
#:           flash kernels' analytic cost in its place)
ATTENTION_IMPLS = ("naive", "flash", "stub")

#: Legal values of :attr:`ModelConfig.kv_dtype`.
KV_DTYPES = ("bf16", "int8")

#: Legal values of :attr:`ModelConfig.ssm_impl` (Mamba layers):
#:   xla   — the reference's name for the materializing path: the
#:           full-sequence forward is prefill from a blank carry, one
#:           linear scan over the (B, T, d_inner·d_state) discretized terms
#:   fused — the fused selective-scan op: the hand-written CUDA forward and
#:           backward kernels on CUDA tensors, their plain versions on CPU
#:           tensors
#:   stub  — the dry-run's O(T·d_inner) stand-in (``launch.dryrun`` adds
#:           the fused scan's analytic cost in its place)
SSM_IMPLS = ("xla", "fused", "stub")

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
    # dispatch groups of the pooled path (the reference's DP degree);
    # groups=1 is one pool over every token of a call
    groups: int = 1
    # how tokens reach their experts (models.moe.resolve_dispatch):
    # "pooled" (capacity-limited, batch-dependent: the training path),
    # "per_request" (drop-free per batch row) or "auto" (pooled for
    # training, per_request prefill and gather-GEMM decode for serving)
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
    paged_impl: str = "kernel"
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
        if self.attention_impl not in ATTENTION_IMPLS:
            raise ValueError(
                f"attention_impl must be one of {ATTENTION_IMPLS}, "
                f"got {self.attention_impl!r}")
        if self.ssm_impl not in SSM_IMPLS:
            raise ValueError(
                f"ssm_impl must be one of {SSM_IMPLS}, "
                f"got {self.ssm_impl!r}")
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

    def param_count(self) -> int:
        """Analytical parameter count (``ModelConfig.param_count``)."""
        d = self.d_model
        total = self.vocab_padded * d                       # embedding
        if not self.tie_embeddings:
            total += self.vocab_padded * d
        for spec in self.layer_specs():
            if spec.kind in (ATTN, ATTN_LOCAL):
                total += d * self.n_heads * self.head_dim          # q
                total += 2 * d * self.n_kv_heads * self.head_dim   # k, v
                total += self.n_heads * self.head_dim * d          # o
            elif spec.kind == MLA:
                m = self.mla
                qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
                total += d * m.q_lora_rank \
                    + m.q_lora_rank * self.n_heads * qk_head
                total += d * (m.kv_lora_rank + m.qk_rope_head_dim)
                total += m.kv_lora_rank * self.n_heads * (
                    m.qk_nope_head_dim + m.v_head_dim)
                total += self.n_heads * m.v_head_dim * d
            elif spec.kind == MAMBA:
                mc = self.mamba
                di = mc.d_inner(d)
                total += d * 2 * di                  # in_proj
                total += di * mc.d_conv              # conv
                total += di * (2 * mc.d_state + 1)   # B, C, dt proj (approx)
                total += di * mc.d_state + di        # A_log, D
                total += di * d                      # out_proj
            elif spec.kind == MINGRU:
                total += 2 * (d * d + d)             # W^h, W^z + biases
            # an MLP follows any mixer kind (jamba puts MoE after Mamba)
            if spec.moe:
                e = self.moe
                total += d * e.n_experts              # router
                total += e.n_experts * 3 * d * e.d_ff_expert
                total += e.n_shared * 3 * d * e.d_ff_expert
            else:
                total += 3 * d * (spec.d_ff or self.d_ff)   # SwiGLU
            total += 2 * d                            # norms
        return int(total)

    def active_param_count(self) -> int:
        """Parameters a token activates (MoE: top-k and shared experts
        only; ``ModelConfig.active_param_count``)."""
        if self.moe is None:
            return self.param_count()
        e, d = self.moe, self.d_model
        n_moe = sum(1 for s in self.layer_specs() if s.moe)
        per_expert = 3 * d * e.d_ff_expert
        return int(self.param_count() - n_moe * e.n_experts * per_expert
                   + n_moe * (e.top_k + e.n_shared) * per_expert)


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


# The four assigned input-shape regimes
SHAPES = {
    "train_4k": dict(kind="train", seq_len=4096, global_batch=256),
    "prefill_32k": dict(kind="prefill", seq_len=32768, global_batch=32),
    "decode_32k": dict(kind="decode", seq_len=32768, global_batch=128),
    "long_500k": dict(kind="decode", seq_len=524288, global_batch=1),
}
