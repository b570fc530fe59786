"""CUDA causal flash attention (GQA) for Hopper, bound with ctypes.

Replaces the TPU kernel ``flash_attention`` of
``src/repro/kernels/prefill_attn/kernel.py`` and the GQA repeat of its
``ops.causal_attention``: the kernel in ``csrc/flash_attn.cu`` reads the
model layout and indexes KV head ``h // (H // Kv)`` itself; its header
says what bounds it on the card and what the design does about it. The
library is built at first use by ``kernels/_build.py``; nothing is built
or loaded at import.

``LAUNCHES["flash_attention"]`` counts kernel launches, one a call.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict

import torch

from repro_torch.kernels._build import (CudaLibrary, check_rc, check_tensor,
                                        stream_of)

LAUNCHES: Dict[str, int] = {"flash_attention": 0}
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _bind(lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.flash_attn.argtypes = [ptr] * 4 + [i32] * 6 + [ctypes.c_float, ptr]
    lib.flash_attn.restype = i32


LIBRARY = CudaLibrary("flash_attn", Path(__file__).parent, _bind)


def flash_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """q (B, S, H, hd), k/v (B, S, Kv, hd), all f32 or all bf16, on the
    card. Returns (B, S, H, hd) f32, causal."""
    if q.ndim != 4 or q.dtype not in DTYPES:
        raise ValueError(f"q must be (B, S, H, hd) f32 or bf16, got "
                         f"{tuple(q.shape)} {q.dtype}")
    b, s, h, hd = q.shape
    kv = k.shape[2] if k.ndim == 4 else 0
    if kv <= 0 or h % kv:
        raise ValueError(f"{h} query heads do not share {kv} KV heads")
    check_tensor("q", q, q.dtype, (b, s, h, hd))
    check_tensor("k", k, q.dtype, (b, s, kv, hd))
    check_tensor("v", v, q.dtype, (b, s, kv, hd))
    out = torch.empty((b, s, h, hd), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        rc = LIBRARY.lib().flash_attn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s,
            h, kv, hd, DTYPES[q.dtype], hd ** -0.5, stream_of(q))
    check_rc("flash_attn", rc)
    LAUNCHES["flash_attention"] += 1
    return out
