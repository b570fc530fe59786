"""Public KIVI quantize / dequantize: the one place that picks a path.

A tensor on the CPU goes to the plain version (``ref.py``); a CUDA tensor
goes to the hand-written kernel (``kernel.py``), which raises on what it
cannot take. Nothing falls back from one to the other.

K-style (axis 0) and V-style (axis 1) grouping each have their own kernel
entry, so nothing is transposed, and F is not padded to a multiple of 128:
the reference (``repro.kernels.kivi.ops``) pads only for the TPU's lanes,
and the results are identical either way.
"""
from __future__ import annotations

import torch

from repro_torch.device import on_cpu
from repro_torch.kernels.kivi import kernel as _k
from repro_torch.kernels.kivi import ref as _r
from repro_torch.kernels.kivi.ref import Quantized, compressed_nbytes  # noqa: F401


def quantize(x: torch.Tensor, bits: int, group_size: int,
             axis: int) -> Quantized:
    if on_cpu(x, "KIVI"):
        return _r.quantize_ref(x, bits, group_size, axis)
    packed, scale, zero = _k.quantize(x.to(torch.float32).contiguous(),
                                      bits, group_size, axis)
    return Quantized(packed, scale, zero, bits, group_size, axis,
                     x.shape[axis])


def dequantize(qt: Quantized, out_dtype=torch.float32) -> torch.Tensor:
    if on_cpu(qt.packed, "KIVI"):
        return _r.dequantize_ref(qt, out_dtype)
    x = _k.dequantize(qt.packed, qt.scale, qt.zero, qt.bits, qt.group_size,
                      qt.axis, qt.orig_dim)
    return x.to(out_dtype)


def quantize_kv(k: torch.Tensor, v: torch.Tensor, bits: int,
                group_size: int = 64):
    """KIVI convention: K per-channel (axis 0), V per-token (axis 1)."""
    return (quantize(k, bits, group_size, 0),
            quantize(v, bits, min(group_size, v.shape[1]), 1))
