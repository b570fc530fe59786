"""Shared primitives: RMSNorm, RoPE (partial-rotary), the gated MLP.

Counterpart of ``repro.models.layers``: plain functions over a parameter
dict, same math and layouts.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

Params = Dict[str, Any]


def _dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5
            ) -> torch.Tensor:
    dt = x.dtype
    xf = x.to(torch.float32)
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(dt) * w


# ---------------------------------------------------------------------------
# RoPE with partial-rotary support (stablelm-2 rotary_pct=0.25).
# ---------------------------------------------------------------------------

def rope_freqs(rot_dim: int, theta: float, device) -> torch.Tensor:
    """(rot_dim/2,) inverse frequencies, float32."""
    exps = torch.arange(0, rot_dim, 2, dtype=torch.float32,
                        device=device) / rot_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               rotary_pct: float = 1.0) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) int. Rotates first rot_dim dims."""
    d = x.shape[-1]
    rot = int(d * rotary_pct)
    rot -= rot % 2
    if rot == 0:
        return x
    xr, xp = x[..., :rot], x[..., rot:]
    inv = rope_freqs(rot, theta, x.device)                    # (rot/2,)
    ang = positions.to(torch.float32)[..., None] * inv        # (B, S, rot/2)
    cos = torch.cos(ang)[:, :, None, :]                       # (B, S, 1, rot/2)
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = xr.to(torch.float32).chunk(2, dim=-1)            # rotate-half
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return torch.cat([out.to(x.dtype), xp], dim=-1)


# ---------------------------------------------------------------------------
# Gated MLP (SwiGLU — llama family).
# ---------------------------------------------------------------------------

def mlp_fwd(p: Params, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(x @ p["wi_gate"]) * (x @ p["wi_up"])
    return h @ p["wo"]
