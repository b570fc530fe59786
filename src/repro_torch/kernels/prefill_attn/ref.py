"""Plain-torch causal attention for prefill: the kernel's oracle.

Counterpart of ``repro.kernels.prefill_attn.ref``: q/k/v ([P,] S, hd)
planes, causal, f32 math (bf16 inputs are widened first), masked with the
finite -1e30. Takes an optional leading plane dimension where the
reference used ``vmap``; ``causal_attention_gqa_ref`` takes the model's
GQA layout.
"""
from __future__ import annotations

import torch


def causal_attention_ref(q, k, v) -> torch.Tensor:
    s, hd = q.shape[-2:]
    scores = (q.float() @ k.float().transpose(-1, -2)) * (hd ** -0.5)
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
    return torch.softmax(scores, dim=-1) @ v.float()


def causal_attention_gqa_ref(q, k, v) -> torch.Tensor:
    """q (B, S, H, hd), k/v (B, S, Kv, hd) -> (B, S, H, hd) f32: each KV
    head repeated over its H / Kv query heads, as the reference's
    ``ops.causal_attention`` does, then ``causal_attention_ref`` per
    (batch, head) plane."""
    b, s, h, hd = q.shape
    g = h // k.shape[2]
    qp = q.transpose(1, 2).reshape(b * h, s, hd)
    kp, vp = (x.transpose(1, 2).unsqueeze(2).expand(-1, -1, g, -1, -1)
              .reshape(b * h, s, hd) for x in (k, v))
    out = causal_attention_ref(qp, kp, vp)
    return out.reshape(b, h, s, hd).transpose(1, 2)
