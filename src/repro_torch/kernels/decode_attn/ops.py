"""Public plane-major decode attention over KIVI-packed KV: the one place
that picks a path.

A tensor on the CPU goes to the plain version
(``ref.decode_attention_planes_ref``: dequantize each plane, then exact
attention); a CUDA tensor goes to the hand-written kernel (``kernel.py``),
which raises on what it cannot take. Nothing falls back from one to the
other. There is no ``tb``: it was the TPU kernel's VMEM tile, and the CUDA
kernel picks its own split of the tokens.
"""
from __future__ import annotations

import torch

from repro_torch.device import on_cpu
from repro_torch.kernels.decode_attn import kernel as _k
from repro_torch.kernels.decode_attn import ref as _r


def check_layout(t: int, hd: int, bits: int, k_group: int,
                 v_group: int) -> None:
    """The packed layout's constraints: K groups whole along the tokens and
    V groups whole along the channels, each a whole number of bytes."""
    if bits not in (2, 4, 8):
        raise ValueError(f"bits must be 2, 4 or 8, got {bits}")
    cpb = 8 // bits
    if (k_group <= 0 or v_group <= 0 or t % k_group or k_group % cpb
            or hd % v_group or v_group % cpb):
        raise ValueError(f"T={t}, hd={hd} do not fit k_group={k_group}, "
                         f"v_group={v_group} at {bits} bits")


def decode_attention_planes(q, k_packed, k_scale, k_zero,
                            v_packed, v_scale, v_zero, cur_len, *,
                            bits: int, k_group: int,
                            v_group: int) -> torch.Tensor:
    """Plane-major fused decode attention.

    q: (P, Gq, hd); packed K/V per plane as in ``kernel.py``; cur_len
    (P, 1) i32. Returns (P, Gq, hd) f32.
    """
    t, hd = v_packed.shape[1], q.shape[-1]
    check_layout(t, hd, bits, k_group, v_group)
    if on_cpu(q, "decode attention"):
        return _r.decode_attention_planes_ref(
            q, k_packed, k_scale, k_zero, v_packed, v_scale, v_zero,
            cur_len, bits=bits, k_group=k_group, v_group=v_group)
    return _k.decode_attention(
        q.float().contiguous(), k_packed, k_scale, k_zero, v_packed,
        v_scale, v_zero, cur_len.to(torch.int32).reshape(-1, 1).contiguous(),
        bits=bits, k_group=k_group, v_group=v_group)
