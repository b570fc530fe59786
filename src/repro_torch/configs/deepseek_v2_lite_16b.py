"""deepseek-v2-lite-16b [moe] — 27L d_model=2048 16H d_ff=1408 vocab=102400.

MLA kv_lora=512, MoE 64 routed experts top-6 + 2 shared, first layer dense.
[arXiv:2405.04434; hf].

NOTE: the assignment line lists both "MoE 64e top-6" and "160 routed"; the
published HF config (DeepSeek-V2-Lite) has 64 routed + 2 shared. We use the
primary "64e" spec; discrepancy recorded in DESIGN.md §6.

MLA stores a single (kv_lora_rank + qk_rope_head_dim)-dim latent per token —
architectural KV compression that AdaptCache's lossy compression stacks on.
"""
from repro_torch.configs.base import AttnKind, FFNKind, MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,           # MLA: heads share one latent; kept for bookkeeping
    d_ff=1408,               # moe intermediate size
    vocab_size=102400,
    attn_kind=AttnKind.MLA,
    ffn_kind=FFNKind.MOE,
    mla=MLAConfig(
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
        q_lora_rank=0,
    ),
    moe=MoEConfig(
        n_routed_experts=64,
        n_shared_experts=2,
        top_k=6,
        expert_d_ff=1408,
        first_k_dense=1,
        dense_d_ff=10944,
        moe_every=1,
    ),
)
