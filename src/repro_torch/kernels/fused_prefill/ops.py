"""Public plane-major chunk prefill over a KIVI-packed prefix: the one place
that picks a path.

A tensor on the CPU goes to the plain version
(``ref.chunk_prefill_planes_ref``: dequantize each plane, then attend); a
CUDA tensor goes to the hand-written kernels (``kernel.py``), which raise
on what they cannot take. Nothing falls back from one to the other, and
there is no ``tb`` (the TPU kernel's VMEM tile). On the card, head dims
16, 32, 64 and 128 with both groups multiples of 8 (the model's, hd 128
and group 64, among them) run on the tensor cores (``fused_mma``); other
layouts on the CUDA cores (``fused_split``), within the same tolerance.
"""
from __future__ import annotations

import torch

from repro_torch.device import on_cpu
from repro_torch.kernels.decode_attn.ops import check_layout
from repro_torch.kernels.fused_prefill import kernel as _k
from repro_torch.kernels.fused_prefill import ref as _r


def chunk_prefill_planes(q, k_packed, k_scale, k_zero,
                         v_packed, v_scale, v_zero,
                         k_chunk, v_chunk, cur_len, *,
                         bits: int, k_group: int,
                         v_group: int) -> torch.Tensor:
    """Plane-major fused chunk prefill.

    q / k_chunk / v_chunk: (P, C, hd); packed prefix K/V per plane as in
    ``decode_attn/kernel.py``; cur_len (P, 1) i32. Returns (P, C, hd) f32:
    the chunk's attention over [resident prefix; chunk] with causal chunk
    masking.
    """
    t, hd = v_packed.shape[1], q.shape[-1]
    check_layout(t, hd, bits, k_group, v_group)
    if on_cpu(q, "chunk prefill"):
        return _r.chunk_prefill_planes_ref(
            q, k_packed, k_scale, k_zero, v_packed, v_scale, v_zero,
            k_chunk, v_chunk, cur_len, bits=bits, k_group=k_group,
            v_group=v_group)
    return _k.chunk_prefill(
        q.float().contiguous(), k_packed, k_scale, k_zero, v_packed,
        v_scale, v_zero, k_chunk.float().contiguous(),
        v_chunk.float().contiguous(),
        cur_len.to(torch.int32).reshape(-1, 1).contiguous(),
        bits=bits, k_group=k_group, v_group=v_group)
