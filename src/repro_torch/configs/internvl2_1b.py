"""internvl2-1b [vlm] — 24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151655.

[arXiv:2404.16821; hf]. InternViT + Qwen2-0.5B-style language backbone.
The vision frontend is a STUB per the assignment: ``input_specs()`` provides
precomputed patch embeddings (batch, n_patches, d_model) that are prepended
to the token embedding sequence.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab_size=151655,
    n_patches=256,
    tie_embeddings=True,
)
