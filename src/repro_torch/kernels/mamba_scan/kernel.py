"""CUDA selective scan (mamba-1) for Hopper, forward and backward, bound
with ctypes.

Replaces the TPU kernel ``selective_scan`` of
``src/repro/kernels/mamba_scan/kernel.py``; the backward is the
vector-Jacobian product that ``jax.grad`` derives from the reference's
``lax.scan`` (``src/repro/models/mamba.py``), which has no TPU kernel. Both
live in ``csrc/selective_scan.cu``, whose comments say what bounds each on
the card and what the design does about it. The library is built at first
use by ``kernels/_build.py``; nothing is built or loaded at import.

``LAUNCHES["selective_scan"]`` counts forward launches, one a call;
``LAUNCHES["selective_scan_bwd"]`` counts backward calls, one a call (each
launches the backward and the sum of its partials).
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels._build import (CudaLibrary, check_rc, check_tensor,
                                        stream_of)

LAUNCHES: Dict[str, int] = {"selective_scan": 0, "selective_scan_bwd": 0}


def _bind(lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.selective_scan.argtypes = [ptr] * 9 + [i32] * 4 + [ptr]
    lib.selective_scan.restype = i32
    lib.selective_scan_bwd.argtypes = [ptr] * 15 + [i32] * 4 + [ptr]
    lib.selective_scan_bwd.restype = i32
    for entry in (lib.selective_scan_checkpoint_steps,
                  lib.selective_scan_channels):
        entry.argtypes = [i32]
        entry.restype = i32


LIBRARY = CudaLibrary("selective_scan", Path(__file__).parent, _bind)


def _dims(dt: torch.Tensor, bs: torch.Tensor) -> Tuple[int, int, int, int]:
    if dt.ndim != 3 or bs.ndim != 3:
        raise ValueError(f"dt must be (B, S, D) and bs (B, S, N), got "
                         f"{tuple(dt.shape)} and {tuple(bs.shape)}")
    b, s, d = dt.shape
    n = bs.shape[-1]
    if n <= 0 or 32 % n:
        raise ValueError(f"the state size N = {n} must divide 32")
    if s == 0:
        raise ValueError("selective scan over an empty sequence")
    return b, s, d, n


def _check_inputs(dt, x, bs, cs, a, dims) -> None:
    b, s, d, n = dims
    f32 = torch.float32
    check_tensor("dt", dt, f32, (b, s, d))
    check_tensor("x", x, f32, (b, s, d))
    check_tensor("bs", bs, f32, (b, s, n))
    check_tensor("cs", cs, f32, (b, s, n))
    check_tensor("a", a, f32, (d, n))


def checkpoint_shape(b: int, s: int, d: int, n: int) -> Tuple[int, ...]:
    """The forward's checkpoints: the state entering each segment of the
    kernel's checkpoint interval, (B, ceil(S / interval), D, N)."""
    steps = LIBRARY.lib().selective_scan_checkpoint_steps(n)
    return (b, math.ceil(s / steps), d, n)


def selective_scan(dt: torch.Tensor, x: torch.Tensor, bs: torch.Tensor,
                   cs: torch.Tensor, a: torch.Tensor, h0: torch.Tensor,
                   checkpoints: bool = False) -> Tuple[torch.Tensor, ...]:
    """dt, x (B, S, D); bs, cs (B, S, N); a (D, N); h0 (B, D, N); all
    contiguous f32 on the card, N dividing 32. Returns (y (B, S, D),
    hT (B, D, N)) f32, and with ``checkpoints`` also the states that
    ``selective_scan_bwd`` recomputes from (``checkpoint_shape``)."""
    dims = b, s, d, n = _dims(dt, bs)
    _check_inputs(dt, x, bs, cs, a, dims)
    check_tensor("h0", h0, torch.float32, (b, d, n))
    y = torch.empty((b, s, d), dtype=torch.float32, device=dt.device)
    h_t = torch.empty((b, d, n), dtype=torch.float32, device=dt.device)
    ckpt = (torch.empty(checkpoint_shape(*dims), dtype=torch.float32,
                        device=dt.device) if checkpoints else None)
    with torch.cuda.device(dt.device):
        rc = LIBRARY.lib().selective_scan(
            dt.data_ptr(), x.data_ptr(), bs.data_ptr(), cs.data_ptr(),
            a.data_ptr(), h0.data_ptr(), y.data_ptr(), h_t.data_ptr(),
            None if ckpt is None else ckpt.data_ptr(), b, s, d, n,
            stream_of(dt))
    check_rc("selective_scan", rc)
    LAUNCHES["selective_scan"] += 1
    return (y, h_t) if ckpt is None else (y, h_t, ckpt)


def selective_scan_bwd(dt: torch.Tensor, x: torch.Tensor, bs: torch.Tensor,
                       cs: torch.Tensor, a: torch.Tensor, ckpt: torch.Tensor,
                       dy: torch.Tensor, dh_t: Optional[torch.Tensor] = None,
                       want_dh0: bool = True
                       ) -> Tuple[Optional[torch.Tensor], ...]:
    """The scan's backward from the forward's checkpoints: dy (B, S, D) the
    gradient of y, ``dh_t`` (B, D, N) that of hT or None (zero). Returns
    (ddt, dx, dbs, dcs, da, dh0) f32, shaped as the inputs (dh0 None
    unless ``want_dh0``). Deterministic: no float atomics."""
    dims = b, s, d, n = _dims(dt, bs)
    _check_inputs(dt, x, bs, cs, a, dims)
    f32, dev = torch.float32, dt.device
    check_tensor("ckpt", ckpt, f32, checkpoint_shape(*dims))
    check_tensor("dy", dy, f32, (b, s, d))
    if dh_t is not None:
        check_tensor("dh_t", dh_t, f32, (b, d, n))
    ddt, dx = (torch.empty((b, s, d), dtype=f32, device=dev)
               for _ in range(2))
    dbs, dcs = (torch.empty((b, s, n), dtype=f32, device=dev)
                for _ in range(2))
    da = torch.empty((d, n), dtype=f32, device=dev)
    dh0 = torch.empty((b, d, n), dtype=f32, device=dev) if want_dh0 else None
    lib = LIBRARY.lib()
    blocks = math.ceil(d / lib.selective_scan_channels(n))
    work = torch.empty(2 * blocks * b * s * n + b * d * n, dtype=f32,
                       device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(dev):
        rc = lib.selective_scan_bwd(
            *(ptr(t) for t in (dt, x, bs, cs, a, ckpt, dy, dh_t, ddt, dx, dbs,
                               dcs, da, dh0, work)), b, s, d, n,
            stream_of(dt))
    check_rc("selective_scan_bwd", rc)
    LAUNCHES["selective_scan_bwd"] += 1
    return ddt, dx, dbs, dcs, da, dh0
