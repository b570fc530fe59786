"""CUDA causal flash attention (GQA) for Hopper, bound with ctypes.

Replaces the TPU kernel ``flash_attention`` of
``src/repro/kernels/prefill_attn/kernel.py`` and the GQA repeat of its
``ops.causal_attention``: the kernels in ``csrc/flash_attn.cu`` read the
model layout and index KV head ``h // (H // Kv)`` themselves; its header
says what bounds each on the card and what the design does about it. Its
C entry picks the kernel by type and shape: inputs whose head dim is a
multiple of 16, with 16-byte aligned pointers, take a tensor-core kernel
(``mma.sync`` bf16 fed by ``cp.async``): ``flash_fwd_mma`` for bf16 (a
two-part P), ``flash_fwd_mma_f32`` for f32 (the scores from three-part Q
and K, P V from two-part P and V). Every other input takes the CUDA-core
one (``flash_fwd``). The library is built at first use by
``kernels/_build.py``; nothing is built or loaded at import.

``LAUNCHES["flash_attention"]`` counts kernel launches, one a call, and
the other three keys split it by the kernel that the C entry reports it
launched (``flash_attn_last_kernel``): ``flash_attention_cores``
(``flash_fwd``), ``flash_attention_mma`` (``flash_fwd_mma``) and
``flash_attention_mma_f32`` (``flash_fwd_mma_f32``).
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict

import torch

from repro_torch.kernels._build import (CudaLibrary, check_rc, check_tensor,
                                        stream_of)

# the LAUNCHES key of each kernel, by the number the C entry reports
KERNELS = ("flash_attention_cores", "flash_attention_mma",
           "flash_attention_mma_f32")
LAUNCHES: Dict[str, int] = {"flash_attention": 0,
                            **{key: 0 for key in KERNELS}}
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _bind(lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.flash_attn.argtypes = [ptr] * 4 + [i32] * 6 + [ctypes.c_float, ptr]
    lib.flash_attn.restype = i32
    lib.flash_attn_last_kernel.argtypes = []
    lib.flash_attn_last_kernel.restype = i32


LIBRARY = CudaLibrary("flash_attn", Path(__file__).parent, _bind)


def flash_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """q (B, S, H, hd), k/v (B, S, Kv, hd), all f32 or all bf16, on the
    card. Returns (B, S, H, hd) f32, causal. hd 16, 32, 64 or 128 with
    16-byte aligned tensors runs on the tensor cores, everything else on
    the CUDA cores."""
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
    lib = LIBRARY.lib()
    with torch.cuda.device(q.device):
        rc = lib.flash_attn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s,
            h, kv, hd, DTYPES[q.dtype], hd ** -0.5, stream_of(q))
    check_rc("flash_attn", rc)
    LAUNCHES["flash_attention"] += 1
    LAUNCHES[KERNELS[lib.flash_attn_last_kernel()]] += 1
    return out
