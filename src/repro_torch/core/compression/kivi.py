"""KIVI compression method (quantization arm of AdaptCache).

Wraps repro_torch.kernels.kivi: K per-channel / V per-token asymmetric group
quantization at 8/4/2 bits. Rate ladder is analytic:
    r(bits) = bits/(8*itemsize) + 2*4/(group*itemsize)   (codes + scale/zero)
SSM entries (no token axis) are quantized per-row-group — quant-only archs
(falcon-mamba) use this arm; token dropping is inapplicable (DESIGN.md §6).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.compression.base import (
    CompressedEntry, CompressionMethod, KVData, kv_nbytes,
)
from repro_torch.device import resolve_device
from repro_torch.kernels.kivi import ops as kivi_ops
from repro_torch.kernels.kivi.ref import Quantized

BITS_LADDER = (8, 4, 2)


class KIVICompression(CompressionMethod):
    name = "kivi"

    def __init__(self, group_size: int = 64, device="cuda"):
        self.group_size = group_size
        # where quantize/dequantize run: the serving runner's device
        self.device = resolve_device(device)

    # -- rate bookkeeping ----------------------------------------------------
    def _rate_for_bits(self, kv: KVData, bits: int) -> float:
        return self.estimate_quantized_nbytes(kv, bits) / max(kv_nbytes(kv), 1)

    def _bits_for_rate(self, kv: KVData, rate: float) -> int:
        pairs = [(abs(self._rate_for_bits(kv, b) - rate), b) for b in BITS_LADDER]
        return min(pairs)[1]

    def rates(self, kv: Optional[KVData] = None) -> Sequence[float]:
        if kv is None:
            # nominal fp32 entry rates
            return tuple((b / 32) + 8 / (self.group_size * 4) for b in BITS_LADDER)
        return tuple(self._rate_for_bits(kv, b) for b in BITS_LADDER)

    def estimate_quantized_nbytes(self, kv: KVData, bits: int) -> int:
        total = 0
        for name, a in kv.items():
            if name == "positions":
                total += a.nbytes
                continue
            rows = int(np.prod(a.shape[:-1], dtype=np.int64))
            f = a.shape[-1]
            axis = _axis_for(name)
            g = _round_group(min(self.group_size, rows if axis == 0 else f),
                             bits)
            if axis == 0:
                rows_p = -(-rows // g) * g
                codes = rows_p * f * bits // 8
                n_groups = (rows_p // g) * f
            else:
                f_p = -(-f // g) * g
                codes = rows * f_p * bits // 8
                n_groups = rows * (f_p // g)
            total += codes + n_groups * 2 * 4
        return int(total)

    def estimate_nbytes(self, kv: KVData, rate: float) -> int:
        return self.estimate_quantized_nbytes(kv, self._bits_for_rate(kv, rate))

    # -- compress / decompress ------------------------------------------------
    def compress(self, kv: KVData, rate: float,
                 bits: Optional[int] = None) -> CompressedEntry:
        bits = bits if bits is not None else self._bits_for_rate(kv, rate)
        arrays: Dict[str, np.ndarray] = {}
        meta = {"bits": bits, "group": {}, "shape": {}, "axis": {},
                "dtype": {}}
        for name, a in kv.items():
            if name == "positions":
                arrays[name] = np.asarray(a)
                continue
            axis = _axis_for(name)
            mat, lead_shape = _to_2d(a)
            g = _round_group(min(self.group_size, mat.shape[axis]), bits)
            # pad the grouped axis to a multiple of the group size
            dim = mat.shape[axis]
            pad = (-dim) % g
            if pad:
                widths = [(0, pad), (0, 0)] if axis == 0 else [(0, 0), (0, pad)]
                mat = np.pad(mat, widths)
            qt = kivi_ops.quantize(_on_device(mat, self.device), bits, g,
                                   axis)
            arrays[f"{name}.packed"] = qt.packed.cpu().numpy()
            arrays[f"{name}.scale"] = qt.scale.cpu().numpy()
            arrays[f"{name}.zero"] = qt.zero.cpu().numpy()
            meta["group"][name] = g
            meta["shape"][name] = a.shape
            meta["axis"][name] = axis
            meta["dtype"][name] = str(a.dtype)
        true_rate = sum(v.nbytes for v in arrays.values()) / max(kv_nbytes(kv), 1)
        return CompressedEntry(self.name, true_rate, arrays, meta)

    def decompress(self, entry: CompressedEntry) -> KVData:
        out: KVData = {}
        for name, shape in entry.meta["shape"].items():
            axis = entry.meta["axis"][name]
            g = entry.meta["group"][name]
            bits = entry.meta["bits"]
            packed = _on_device(entry.arrays[f"{name}.packed"], self.device)
            scale = _on_device(entry.arrays[f"{name}.scale"], self.device)
            zero = _on_device(entry.arrays[f"{name}.zero"], self.device)
            rows = int(np.prod(shape[:-1], dtype=np.int64))
            f = shape[-1]
            g = _round_group(g, bits)
            # padded dims as stored
            if axis == 0:
                padded_dim = -(-rows // g) * g
            else:
                padded_dim = -(-f // g) * g
            qt = Quantized(packed, scale, zero, bits, g, axis, padded_dim)
            mat = kivi_ops.dequantize(qt).cpu().numpy()
            mat = mat[:rows, :f]                     # strip padding
            out[name] = mat.reshape(shape).astype(entry.meta["dtype"][name])
        if "positions" in entry.arrays:
            out["positions"] = entry.arrays["positions"]
        return out


def _on_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array as a tensor on ``device``. Arrays read back from a
    storage tier may be read-only views; torch wants writable memory."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:
        a = a.copy()
    return torch.from_numpy(a).to(device)


def _axis_for(name: str) -> int:
    """KIVI: K per-channel (grouped along tokens, axis 0); V and state
    tensors per-row (grouped along the feature axis)."""
    return 0 if name == "k" else 1


def _to_2d(a: np.ndarray):
    """(L, T, F) -> (L*T, F); already-2d stays."""
    if a.ndim == 2:
        return a, a.shape
    return a.reshape(-1, a.shape[-1]), a.shape


def _round_group(g: int, bits: int) -> int:
    """group size must be a positive multiple of codes-per-byte (packing
    keeps each group's codes byte-aligned)."""
    cpb = 8 // bits
    return max(cpb, (g // cpb) * cpb)
