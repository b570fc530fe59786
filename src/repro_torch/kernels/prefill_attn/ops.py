"""Public causal prefill attention in the model's GQA layout: the one place
that picks a path.

A tensor on the CPU goes to the plain version
(``ref.causal_attention_gqa_ref``: each KV head repeated over its query
heads, as the reference does); a CUDA tensor goes to the hand-written
kernels (``kernel.py``), which read KV head ``h // g`` in place and build
no repeated copy. On the card, inputs that are all bf16 stay bf16 and
any other mix is widened to f32; at a head dim that is a multiple of 16
(16, 32, 64, 128), with 16-byte aligned tensors, either type reaches a
tensor-core kernel, and every other layout the CUDA-core kernel. Anything
else raises: nothing falls back from one path to another.
"""
from __future__ import annotations

import torch

from repro_torch.device import on_cpu
from repro_torch.kernels.prefill_attn import kernel as _k
from repro_torch.kernels.prefill_attn import ref as _r


def causal_attention(q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor) -> torch.Tensor:
    """q: (B, S, H, hd); k/v: (B, S, Kv, hd) GQA, f32 or bf16. Returns
    (B, S, H, hd) f32."""
    h, kv = q.shape[2], k.shape[2]
    if h % kv:
        raise ValueError(f"{h} query heads do not share {kv} KV heads")
    if not on_cpu(q, "causal attention"):
        dtype = (torch.bfloat16 if all(x.dtype == torch.bfloat16
                                       for x in (q, k, v)) else torch.float32)
        return _k.flash_attention(q.to(dtype).contiguous(),
                                  k.to(dtype).contiguous(),
                                  v.to(dtype).contiguous())
    return _r.causal_attention_gqa_ref(q, k, v)
