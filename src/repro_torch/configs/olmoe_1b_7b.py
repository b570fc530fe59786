"""olmoe-1b-7b [moe] — 16L d_model=2048 16H (GQA kv=16) d_ff=1024 vocab=50304.

MoE: 64 experts, top-8, no shared experts. [arXiv:2409.02060; hf].
"""
from repro_torch.configs.base import FFNKind, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    vocab_size=50304,
    ffn_kind=FFNKind.MOE,
    qk_norm=True,            # OLMoE uses QK-norm
    moe=MoEConfig(
        n_routed_experts=64,
        n_shared_experts=0,
        top_k=8,
        expert_d_ff=1024,
        moe_every=1,
    ),
)
