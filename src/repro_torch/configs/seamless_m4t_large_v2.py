"""seamless-m4t-large-v2 [audio] — 24L d_model=1024 16H d_ff=8192 vocab=256206.

Encoder-decoder, multimodal. [arXiv:2308.11596; hf]. The assignment specifies
the transformer BACKBONE only: 24 encoder layers over STUB frame embeddings
(precomputed (batch, n_frames, d_model) from input_specs()) + 24 decoder
layers with self- and cross-attention.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    n_layers=24,             # decoder depth
    n_enc_layers=24,
    is_encoder_decoder=True,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=256206,
    n_frames=1024,           # stub frontend output length (≈ 20 s of audio)
)
