"""jamba-1.5-large-398b [hybrid] — 72L d_model=8192 64H (GQA kv=8) d_ff=24576.

vocab=65536, MoE 16 experts top-2, Mamba+attention 1:7 interleave (one
attention layer per period of 8, at offset 4), MoE every 2nd layer.
[arXiv:2403.19887; hf]. ~398B total / ~94B active params.
"""
from repro_torch.configs.base import FFNKind, LayerKind, ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    head_dim=128,
    primary_kind=LayerKind.MAMBA,
    attn_period=8,
    attn_offset=4,
    ffn_kind=FFNKind.MOE,
    moe=MoEConfig(
        n_routed_experts=16,
        n_shared_experts=0,
        top_k=2,
        expert_d_ff=24576,
        moe_every=2,
    ),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
)
