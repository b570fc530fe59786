"""minicpm-2b [dense] — 40L d_model=2304 36H (GQA kv=36) d_ff=5760 vocab=122753.

[arXiv:2404.06395; hf]. Llama-like architecture; the WSD learning-rate
schedule is a training-time property (see repro_torch.training.optimizer.wsd_schedule).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b",
    family="dense",
    n_layers=40,
    d_model=2304,
    n_heads=36,
    n_kv_heads=36,
    d_ff=5760,
    vocab_size=122753,
    tie_embeddings=True,
)
