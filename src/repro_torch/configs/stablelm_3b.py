"""stablelm-3b [dense] — 32L d_model=2560 32H (GQA kv=32) d_ff=6912 vocab=50304.

[hf:stabilityai/stablelm-2-1_6b; unverified]. StableLM-2 family uses partial
rotary embeddings (25% of head dim).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-3b",
    family="dense",
    n_layers=32,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=6912,
    vocab_size=50304,
    rotary_pct=0.25,
)
