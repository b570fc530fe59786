"""falcon-mamba-7b [ssm] — 64L d_model=4096 (attn-free) vocab=65024, ssm_state=16.

Mamba-1 architecture. [arXiv:2410.05355; unverified].

No KV cache: the cacheable per-session artifact is the fixed-size
(conv_state, ssm_state) snapshot; AdaptCache's quantization arm applies,
token dropping does not (DESIGN.md §6).
"""
from repro_torch.configs.base import FFNKind, LayerKind, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=1,               # unused (attn-free)
    n_kv_heads=1,
    d_ff=0,
    vocab_size=65024,
    primary_kind=LayerKind.MAMBA,
    ffn_kind=FFNKind.NONE,
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
    tie_embeddings=True,
)
