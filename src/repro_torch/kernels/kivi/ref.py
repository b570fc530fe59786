"""Plain-torch KIVI asymmetric group-wise quantization: the kernel's oracle.

Counterpart of ``repro.kernels.kivi.ref`` (same layouts and packing): x is
(T, F); K is grouped along tokens (axis 0, per-channel), V along channels
(axis 1, per-token); sub-byte codes are packed along the grouped axis, 8 /
bits of them per uint8, code j at bit offset j * bits.

The arithmetic is the reference's as the serving path runs it, compiled by
XLA under ``jit`` (``repro.kernels.kivi.ops``), so the results are
bit-equal to it:

* ``scale = (max - min) * f32(1 / (2^bits - 1))``: XLA folds the division
  by the constant into a product with its f32 reciprocal;
* ``codes = clip(round_half_even((x - min) / safe), 0, 2^bits - 1)``, a
  correctly rounded f32 division;
* ``x' = fma(code, scale, zero)``, rounded once: XLA contracts
  ``code * scale + zero`` into a fused multiply-add.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Quantized:
    packed: torch.Tensor   # uint8, grouped axis shrunk by (8 // bits)
    scale: torch.Tensor    # f32, grouped axis shrunk by group_size
    zero: torch.Tensor     # f32, same shape as scale
    bits: int = 8
    group_size: int = 64
    # grouped axis: 0=token/K-style, 1=channel/V-style
    axis: int = 0
    orig_dim: int = 0


def _codes_per_byte(bits: int) -> int:
    if bits not in (2, 4, 8):
        raise ValueError(f"bits must be 2, 4 or 8, got {bits}")
    return 8 // bits


def inv_levels(bits: int) -> float:
    """The f32 reciprocal of the top code 2^bits - 1 (scale multiplier)."""
    return float(np.float32(1.0 / (2 ** bits - 1)))


def quantize_ref(x: torch.Tensor, bits: int, group_size: int,
                 axis: int) -> Quantized:
    if x.ndim != 2:
        raise ValueError(f"need a 2-D matrix, got {tuple(x.shape)}")
    t = x.shape[axis]
    cpb = _codes_per_byte(bits)
    if t % group_size or group_size % cpb:
        raise ValueError(f"shape {tuple(x.shape)} axis {axis} does not "
                         f"split into groups of {group_size}")

    xf = x.to(torch.float32)
    if axis == 1:
        xf = xf.t()                     # normalize: grouped axis first
    g = xf.shape[0] // group_size
    f = xf.shape[1]
    xg = xf.reshape(g, group_size, f)
    zero = xg.amin(dim=1)                                     # (g, f)
    inv = torch.tensor(inv_levels(bits), dtype=torch.float32,
                       device=x.device)
    scale = (xg.amax(dim=1) - zero) * inv
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round((xg - zero[:, None]) / safe[:, None]),
                    0, 2 ** bits - 1).to(torch.int32)         # (g, gs, f)

    q = q.reshape(g * group_size // cpb, cpb, f)
    shifts = (torch.arange(cpb, dtype=torch.int32, device=x.device)
              * bits)[None, :, None]
    packed = (q << shifts).sum(dim=1).to(torch.uint8)         # (t/cpb, f)

    if axis == 1:
        packed, scale, zero = packed.t(), scale.t(), zero.t()
    return Quantized(packed.contiguous(), scale.contiguous(),
                     zero.contiguous(), bits, group_size, axis, t)


def _fma_f32(q: torch.Tensor, s: torch.Tensor, z: torch.Tensor
             ) -> torch.Tensor:
    """Correctly rounded f32 ``q * s + z`` for integer codes q < 256.

    ``q * s`` is exact in f64 (at most 8 + 24 significant bits), so the
    f64 sum carries one rounding and the f64 -> f32 conversion a second.
    The two differ from one rounding only where the f64 sum lands exactly
    on the midpoint of two f32 values; there the exact error of the sum
    (TwoSum) says which side the true value lies on."""
    a = q.to(torch.float64) * s.to(torch.float64)
    b = z.to(torch.float64)
    r = a + b
    bv = r - a
    err = (a - (r - bv)) + (b - bv)                 # a + b == r + err
    out = r.to(torch.float32)
    diff = r - out.to(torch.float64)                # exact
    toward = torch.where(diff > 0, torch.full_like(out, float("inf")),
                         torch.full_like(out, float("-inf")))
    other = torch.nextafter(out, toward)
    tie = (diff != 0) & (other.to(torch.float64) - out.to(torch.float64)
                         == 2 * diff)
    past = tie & (err != 0) & ((err > 0) == (diff > 0))
    return torch.where(past, other, out)


def dequantize_ref(qt: Quantized, dtype=torch.float32) -> torch.Tensor:
    cpb = _codes_per_byte(qt.bits)
    packed, scale, zero = qt.packed, qt.scale, qt.zero
    if qt.axis == 1:
        packed, scale, zero = packed.t(), scale.t(), zero.t()

    tp, f = packed.shape
    shifts = (torch.arange(cpb, dtype=torch.int32, device=packed.device)
              * qt.bits)[None, :, None]
    q = (packed.to(torch.int32)[:, None, :] >> shifts) & (2 ** qt.bits - 1)
    q = q.reshape(tp * cpb, f)                                # (t, f)

    g = qt.orig_dim // qt.group_size
    qg = q.reshape(g, qt.group_size, f)
    x = _fma_f32(qg, scale[:, None], zero[:, None])
    x = x.reshape(qt.orig_dim, f)
    if qt.axis == 1:
        x = x.t()
    return x.contiguous().to(dtype)


def quantize_kv_ref(k: torch.Tensor, v: torch.Tensor, bits: int,
                    group_size: int = 64) -> Tuple[Quantized, Quantized]:
    """k, v: (T, F) — K per-channel (grouped over tokens), V per-token."""
    return (quantize_ref(k, bits, group_size, axis=0),
            quantize_ref(v, bits, min(group_size, v.shape[1]), axis=1))


def compressed_nbytes(qt: Quantized) -> int:
    return (qt.packed.numel() * qt.packed.element_size()
            + qt.scale.numel() * 4 + qt.zero.numel() * 4)
