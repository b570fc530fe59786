"""adaptcache-8b — the paper's own serving model (Llama-3.1-8B-Instruct).

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256, rope theta 500k.
Used by the paper-validation benchmarks and the serving examples (in smoke-
reduced form on CPU).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="adaptcache-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    head_dim=128,
    rope_theta=500000.0,
)
