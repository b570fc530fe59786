"""Model / run configuration dataclasses.

Every assigned architecture is expressed as a ``ModelConfig``. The model zoo
(`repro_torch.models`) reads only this dataclass, so adding an architecture is a
pure-config exercise.

Layer stacking: the forward pass scans over *block groups*. A block group is
a short heterogeneous sequence of layers (e.g. Jamba's
[mamba x7, attn] x 9) whose params are stacked on a leading axis. For
homogeneous models the group is a single layer repeated ``n_layers`` times.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Sequence, Tuple


class LayerKind(str, enum.Enum):
    ATTN = "attn"          # (self-)attention + MLP/MoE
    MAMBA = "mamba"        # mamba-1 SSM block + MLP/MoE (jamba) or pure (falcon-mamba)
    CROSS_ATTN = "cross"   # decoder layer with self-attn + cross-attn + MLP


class AttnKind(str, enum.Enum):
    GQA = "gqa"            # standard multi-head / grouped-query attention
    MLA = "mla"            # DeepSeek multi-head latent attention


class FFNKind(str, enum.Enum):
    DENSE = "dense"
    MOE = "moe"
    NONE = "none"          # pure SSM blocks (falcon-mamba)


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_routed_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    # d_ff of each expert (routed); shared experts use the same width.
    expert_d_ff: int = 0
    # layers whose FFN stays dense (e.g. deepseek first layer); width below.
    first_k_dense: int = 0
    dense_d_ff: int = 0
    # apply MoE only every Nth layer (jamba: 2). 1 = every layer.
    moe_every: int = 1
    router_jitter: float = 0.0


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    q_lora_rank: int = 0   # 0 = no q compression (deepseek-v2-lite)


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2        # d_inner = expand * d_model
    dt_rank: int = 0       # 0 -> ceil(d_model / 16)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"  # dense | vlm | moe | ssm | audio | hybrid

    n_layers: int = 2
    d_model: int = 64
    n_heads: int = 4
    n_kv_heads: int = 4
    d_ff: int = 128
    vocab_size: int = 256
    head_dim: int = 0               # 0 -> d_model // n_heads

    attn_kind: AttnKind = AttnKind.GQA
    ffn_kind: FFNKind = FFNKind.DENSE
    qk_norm: bool = False           # qwen3
    rotary_pct: float = 1.0         # stablelm-2 uses 0.25
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None

    # Hybrid stacks: period + index of the attention layer inside the period.
    # jamba: attn_period=8, attn_offset=4  (1 attn : 7 mamba).
    attn_period: int = 1            # 1 = every layer is `primary_kind`
    attn_offset: int = 0
    primary_kind: LayerKind = LayerKind.ATTN

    # Encoder-decoder (seamless): n_enc_layers encoder on top of stub
    # frame-embeddings; n_layers above is then the DECODER depth.
    is_encoder_decoder: bool = False
    n_enc_layers: int = 0

    # Modality frontend stubs.
    # vlm: n_patches patch-embeddings prepended to the token sequence.
    # audio: encoder input is (batch, n_frames, d_model) embeddings.
    n_patches: int = 0
    n_frames: int = 0

    # numerics
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"

    # --- derived ---
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def d_inner(self) -> int:
        assert self.ssm is not None
        return self.ssm.expand * self.d_model

    @property
    def resolved_dt_rank(self) -> int:
        assert self.ssm is not None
        return self.ssm.dt_rank or -(-self.d_model // 16)

    def layer_kinds(self) -> Tuple[LayerKind, ...]:
        """Per-layer kind for the decoder stack."""
        kinds = []
        for i in range(self.n_layers):
            if self.primary_kind == LayerKind.MAMBA and self.attn_period > 1:
                # hybrid: attention at attn_offset within each period
                kinds.append(LayerKind.ATTN if i % self.attn_period == self.attn_offset
                             else LayerKind.MAMBA)
            else:
                kinds.append(self.primary_kind)
        return tuple(kinds)

    def block_group(self) -> Tuple[Tuple[LayerKind, ...], int]:
        """(repeating group pattern, n_groups) for scan-over-groups."""
        kinds = self.layer_kinds()
        if self.attn_period > 1:
            period = self.attn_period
            assert self.n_layers % period == 0, (self.name, self.n_layers, period)
            return kinds[:period], self.n_layers // period
        return (kinds[0],), self.n_layers

    def uses_moe_at(self, layer_idx: int) -> bool:
        if self.ffn_kind != FFNKind.MOE or self.moe is None:
            return False
        if layer_idx < self.moe.first_k_dense:
            return False
        return (layer_idx - self.moe.first_k_dense) % self.moe.moe_every == 0

    def kv_bytes_per_token(self) -> int:
        """bf16 bytes of KV state per token (attention layers only)."""
        n_attn = sum(1 for k in self.layer_kinds() if k in (LayerKind.ATTN, LayerKind.CROSS_ATTN))
        if self.attn_kind == AttnKind.MLA:
            assert self.mla is not None
            per_layer = self.mla.kv_lora_rank + self.mla.qk_rope_head_dim
        else:
            per_layer = 2 * self.n_kv_heads * self.resolved_head_dim
        return n_attn * per_layer * 2


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input shape (an EXPERIMENTS.md cell column)."""
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4096, 256, "train"),
    ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    ShapeConfig("decode_32k", 32768, 128, "decode"),
    ShapeConfig("long_500k", 524288, 1, "decode"),
)


def get_shape(name: str) -> ShapeConfig:
    for s in SHAPES:
        if s.name == name:
            return s
    raise KeyError(f"unknown shape {name!r}; have {[s.name for s in SHAPES]}")


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """long_500k only for sub-quadratic (ssm / hybrid) archs, per assignment."""
    if shape.name == "long_500k" and cfg.family not in ("ssm", "hybrid"):
        return False, "long_500k skipped: pure full-attention arch (see DESIGN.md §6)"
    return True, ""
