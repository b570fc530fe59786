"""Plain-torch decode attention over KIVI-quantized KV: the kernel's oracle.

Counterpart of ``repro.kernels.decode_attn.ref`` and of the plane
dequantizers of ``repro.kernels.decode_attn.ops``. Query rows attend over
T cached tokens whose K/V are stored packed (K per-channel along tokens, V
per-token along channels); the oracle dequantizes fully and runs exact
softmax attention, masked to positions < cur_len with the finite -1e30 (so
``cur_len = 0`` gives the uniform mean of all T values).

Every function takes an optional leading plane dimension where the
reference used ``vmap``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.kivi.ref import Quantized, dequantize_ref

NEG_INF = -1e30


def _lengths(cur_len, like: torch.Tensor) -> torch.Tensor:
    """cur_len as a tensor broadcastable over (..., rows, T) scores."""
    n = torch.as_tensor(cur_len, device=like.device)
    return n.reshape(n.shape[:1] + (1, 1)) if n.ndim else n


def decode_attention_dense_ref(q, k, v, cur_len) -> torch.Tensor:
    """q: ([P,] Gq, hd); k/v: ([P,] T, hd); cur_len: a scalar, or (P,) /
    (P, 1) per plane. f32 math; returns ([P,] Gq, hd) f32."""
    t = k.shape[-2]
    scores = (q.float() @ k.float().transpose(-1, -2)) * (q.shape[-1] ** -0.5)
    mask = torch.arange(t, device=q.device) < _lengths(cur_len, q)
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    return torch.softmax(scores, dim=-1) @ v.float()


def decode_attention_quantized_ref(q, kq: Quantized, vq: Quantized,
                                   cur_len) -> torch.Tensor:
    """One plane: q (Gq, hd), K and V as KIVI ``Quantized`` (T, hd)."""
    return decode_attention_dense_ref(q, dequantize_ref(kq),
                                      dequantize_ref(vq), cur_len)


def _codes(packed: torch.Tensor, bits: int, dim: int) -> torch.Tensor:
    """Unpack uint8 codes along ``dim`` (code j at bit offset j * bits)."""
    cpb = 8 // bits
    p = packed.to(torch.int32)
    shifts = torch.arange(cpb, dtype=torch.int32, device=p.device) * bits
    q = (p.unsqueeze(dim + 1) >> shifts.reshape((cpb,) + (1,) * (
        p.ndim - dim - 1))) & (2 ** bits - 1)
    shape = list(p.shape)
    shape[dim] *= cpb
    return q.reshape(shape).to(torch.float32)


def _repeat(x: torch.Tensor, group: int, dim: int) -> torch.Tensor:
    """Each entry repeated ``group`` times along ``dim`` (a view expanded
    and reshaped, so nothing waits on the device)."""
    dim %= x.ndim
    shape = list(x.shape)
    out = x.unsqueeze(dim + 1).expand(*shape[:dim + 1], group,
                                      *shape[dim + 1:])
    shape[dim] *= group
    return out.reshape(shape)


def _dequant_rows(packed, scale, zero, bits: int, group: int, t: int):
    """K planes: packed ([P,] T/cpb, hd) along tokens, scale/zero ([P,]
    T/group, hd) -> ([P,] T, hd) f32."""
    q = _codes(packed, bits, packed.ndim - 2)
    s = _repeat(scale, group, -2)[..., :t, :]
    z = _repeat(zero, group, -2)[..., :t, :]
    return q * s + z


def _dequant_cols(packed, scale, zero, bits: int, group: int):
    """V planes: packed ([P,] T, hd/cpb) along channels, scale/zero ([P,]
    T, hd/group) -> ([P,] T, hd) f32."""
    q = _codes(packed, bits, packed.ndim - 1)
    s = _repeat(scale, group, -1)
    z = _repeat(zero, group, -1)
    return q * s + z


def decode_attention_planes_ref(q, k_packed, k_scale, k_zero, v_packed,
                                v_scale, v_zero, cur_len, *, bits: int,
                                k_group: int, v_group: int) -> torch.Tensor:
    """The plain version of ``ops.decode_attention_planes``: dequantize
    each plane, then exact attention."""
    t = v_packed.shape[-2]
    k = _dequant_rows(k_packed, k_scale, k_zero, bits, k_group, t)
    v = _dequant_cols(v_packed, v_scale, v_zero, bits, v_group)
    return decode_attention_dense_ref(q, k, v, cur_len)
