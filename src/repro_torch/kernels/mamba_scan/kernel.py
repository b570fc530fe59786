"""CUDA selective scan (mamba-1) for Hopper, bound with ctypes.

Replaces the TPU kernel ``selective_scan`` of
``src/repro/kernels/mamba_scan/kernel.py``. The kernel lives in
``csrc/selective_scan.cu``, whose header says what bounds it on the card
and what the design does about it. The library is built at first use by
``kernels/_build.py``; nothing is built or loaded at import.

``LAUNCHES["selective_scan"]`` counts kernel launches, one a call.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Tuple

import torch

from repro_torch.kernels._build import (CudaLibrary, check_rc, check_tensor,
                                        stream_of)

LAUNCHES: Dict[str, int] = {"selective_scan": 0}


def _bind(lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.selective_scan.argtypes = [ptr] * 8 + [i32] * 4 + [ptr]
    lib.selective_scan.restype = i32


LIBRARY = CudaLibrary("selective_scan", Path(__file__).parent, _bind)


def selective_scan(dt: torch.Tensor, x: torch.Tensor, bs: torch.Tensor,
                   cs: torch.Tensor, a: torch.Tensor, h0: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dt, x (B, S, D); bs, cs (B, S, N); a (D, N); h0 (B, D, N); all
    contiguous f32 on the card, N dividing 32. Returns (y (B, S, D),
    hT (B, D, N)) f32."""
    if dt.ndim != 3 or bs.ndim != 3:
        raise ValueError(f"dt must be (B, S, D) and bs (B, S, N), got "
                         f"{tuple(dt.shape)} and {tuple(bs.shape)}")
    b, s, d = dt.shape
    n = bs.shape[-1]
    if n <= 0 or 32 % n:
        raise ValueError(f"the state size N = {n} must divide 32")
    if s == 0:
        raise ValueError("selective scan over an empty sequence")
    f32 = torch.float32
    check_tensor("dt", dt, f32, (b, s, d))
    check_tensor("x", x, f32, (b, s, d))
    check_tensor("bs", bs, f32, (b, s, n))
    check_tensor("cs", cs, f32, (b, s, n))
    check_tensor("a", a, f32, (d, n))
    check_tensor("h0", h0, f32, (b, d, n))
    y = torch.empty((b, s, d), dtype=f32, device=dt.device)
    h_t = torch.empty((b, d, n), dtype=f32, device=dt.device)
    with torch.cuda.device(dt.device):
        rc = LIBRARY.lib().selective_scan(
            dt.data_ptr(), x.data_ptr(), bs.data_ptr(), cs.data_ptr(),
            a.data_ptr(), h0.data_ptr(), y.data_ptr(), h_t.data_ptr(), b, s,
            d, n, stream_of(dt))
    check_rc("selective_scan", rc)
    LAUNCHES["selective_scan"] += 1
    return y, h_t
