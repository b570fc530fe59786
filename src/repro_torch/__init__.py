"""PyTorch port of the AdaptCache reproduction (``repro``), for NVIDIA GPUs.

Same subpackages, public names, ``KVData`` layout and ``summarize`` keys as
``repro``; imports nothing of it and nothing of JAX. Entry points run on
CUDA unless the caller passes ``device="cpu"``.
"""
