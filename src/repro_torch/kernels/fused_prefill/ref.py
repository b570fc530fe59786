"""Plain-torch chunk-prefill attention over a KIVI-quantized prefix: the
kernel's oracle.

Counterpart of ``repro.kernels.fused_prefill.ref``. C fresh query tokens
attend (a) the T-token cached prefix, every position of which precedes
every chunk position, masked to the valid length ``cur_len``, and (b) the
chunk's own keys and values under the causal mask. The oracle runs exact
softmax attention over the concatenated [prefix; chunk] keys, masking with
the finite -1e30. Functions take an optional leading plane dimension where
the reference used ``vmap``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.decode_attn.ref import (_dequant_cols, _dequant_rows,
                                                 _lengths)
from repro_torch.kernels.kivi.ref import Quantized, dequantize_ref

NEG_INF = -1e30


def chunk_prefill_ref(q, k_prefix, v_prefix, k_chunk, v_chunk,
                      cur_len) -> torch.Tensor:
    """q/k_chunk/v_chunk: ([P,] C, hd); k_prefix/v_prefix: ([P,] T, hd)
    dense; cur_len: a scalar, or (P,) / (P, 1) per plane. Returns ([P,] C,
    hd) f32."""
    c, hd = q.shape[-2:]
    t = k_prefix.shape[-2]
    k = torch.cat([k_prefix.float(), k_chunk.float()], dim=-2)
    v = torch.cat([v_prefix.float(), v_chunk.float()], dim=-2)
    scores = (q.float() @ k.transpose(-1, -2)) * (hd ** -0.5)   # (C, T+C)
    kpos = torch.arange(t + c, device=q.device)
    qpos = torch.arange(c, device=q.device)[:, None]
    # prefix columns: visible iff resident (kpos < cur_len); chunk
    # columns: causal within the chunk (kpos - t <= qpos)
    visible = torch.where(kpos < t, kpos < _lengths(cur_len, q),
                          kpos - t <= qpos)
    scores = torch.where(visible, scores, torch.full_like(scores, NEG_INF))
    return torch.softmax(scores, dim=-1) @ v


def chunk_prefill_quantized_ref(q, kq: Quantized, vq: Quantized,
                                k_chunk, v_chunk, cur_len) -> torch.Tensor:
    """Dequantize-then-attend, the pipeline the fused kernel replaces (one
    plane: K and V as KIVI ``Quantized`` (T, hd))."""
    return chunk_prefill_ref(q, dequantize_ref(kq), dequantize_ref(vq),
                             k_chunk, v_chunk, cur_len)


def chunk_prefill_planes_ref(q, k_packed, k_scale, k_zero, v_packed,
                             v_scale, v_zero, k_chunk, v_chunk, cur_len, *,
                             bits: int, k_group: int,
                             v_group: int) -> torch.Tensor:
    """The plain version of ``ops.chunk_prefill_planes``: dequantize each
    prefix plane, then ``chunk_prefill_ref``."""
    t = v_packed.shape[-2]
    k = _dequant_rows(k_packed, k_scale, k_zero, bits, k_group, t)
    v = _dequant_cols(v_packed, v_scale, v_zero, bits, v_group)
    return chunk_prefill_ref(q, k, v, k_chunk, v_chunk, cur_len)
