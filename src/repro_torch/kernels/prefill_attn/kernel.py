"""CUDA causal flash attention (GQA) for Hopper, bound with ctypes.

Replaces the TPU kernel ``flash_attention`` of
``src/repro/kernels/prefill_attn/kernel.py`` and the GQA repeat of its
``ops.causal_attention``: the kernels in ``csrc/flash_attn.cu`` read the
model layout and index KV head ``h // (H // Kv)`` themselves; its header
says what bounds each on the card and what the design does about it. Its
C entry picks the kernel by type and shape: bf16 inputs whose head dim
is a multiple of 16, with 16-byte aligned pointers, take the tensor-core
kernel (``flash_fwd_mma``: ``mma.sync`` bf16, a two-part P, a
``cp.async`` ring); f32 inputs and every other bf16 input take the
CUDA-core one (``flash_fwd``). The library is built at first use by
``kernels/_build.py``; nothing is built or loaded at import.

``LAUNCHES["flash_attention"]`` counts kernel launches, one a call;
``LAUNCHES["flash_attention_mma"]`` counts those that took the
tensor-core kernel.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict

import torch

from repro_torch.kernels._build import (CudaLibrary, check_rc, check_tensor,
                                        stream_of)

LAUNCHES: Dict[str, int] = {"flash_attention": 0, "flash_attention_mma": 0}
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _bind(lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.flash_attn.argtypes = [ptr] * 4 + [i32] * 6 + [ctypes.c_float, ptr]
    lib.flash_attn.restype = i32


LIBRARY = CudaLibrary("flash_attn", Path(__file__).parent, _bind)


def flash_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """q (B, S, H, hd), k/v (B, S, Kv, hd), all f32 or all bf16, on the
    card. Returns (B, S, H, hd) f32, causal. bf16 at hd 16, 32, 64 or 128
    runs on the tensor cores, everything else on the CUDA cores."""
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
    # the C entry's choice of the tensor-core kernel
    if (q.dtype == torch.bfloat16 and hd % 16 == 0
            and all(t.data_ptr() % 16 == 0 for t in (q, k, v, out))):
        LAUNCHES["flash_attention_mma"] += 1
    return out
