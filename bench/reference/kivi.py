"""Plain KIVI: asymmetric group quantization as the port stores it, and
the stored entry's layouts, re-derived from the entry's own metadata.

A stored KIVI array is the (rows, F) matrix of a KV array (its leading
dims flattened), padded along the grouped axis to a whole number of
groups: K is grouped along rows (axis 0), V and the rest along F
(axis 1). ``bits`` bit codes are packed along the grouped axis, 8 // bits
a byte, code j at bit offset j * bits. ``scale = (max - min) * f32(1 /
(2^bits - 1))``, ``code = clip(round_half_even((x - min) / scale), 0,
2^bits - 1)`` (a zero scale divides by 1), ``x' = code * scale + min``
rounded once to f32.

A Mamba layer's ``ssm`` and ``conv`` arrays have no token axis: token
dropping passes them whole, and KIVI quantizes them as it does V.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from bench.reference.model import STATE   # arrays with no token axis


def _tokens(kv: Dict) -> int:
    """The token count of an entry: axis 1 of its attention arrays."""
    return next(np.shape(v)[1] for k, v in kv.items()
                if k != "positions" and k not in STATE)


def keep_tokens(kv: Dict[str, np.ndarray], idx: np.ndarray
                ) -> Dict[str, np.ndarray]:
    """The arrays of ``kv`` with only rows ``idx`` of each attention
    array, the state arrays whole (``positions`` left out)."""
    return {k: np.asarray(v) if k in STATE else np.asarray(v)[:, idx]
            for k, v in kv.items() if k != "positions"}


def round_group(g: int, bits: int) -> int:
    cpb = 8 // bits
    return max(cpb, (g // cpb) * cpb)


def quantize(x: torch.Tensor, bits: int, group: int, axis: int,
             arith=torch.float32) -> Tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
    """(packed uint8, scale f32, zero f32) of a 2-D f32 matrix whose
    grouped axis is a whole number of groups. ``arith`` is the type the
    scale and the codes are worked out in (f32 as stored; the control
    takes a lower one)."""
    cpb = 8 // bits
    xf = x.to(torch.float32)
    if axis == 1:
        xf = xf.t()
    g, f = xf.shape[0] // group, xf.shape[1]
    xg = xf.reshape(g, group, f).to(arith)
    zero = xg.amin(dim=1)
    inv = torch.tensor(float(np.float32(1.0 / (2 ** bits - 1))), dtype=arith,
                       device=x.device)
    scale = (xg.amax(dim=1) - zero) * inv
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round((xg - zero[:, None]) / safe[:, None]),
                    0, 2 ** bits - 1).to(torch.int32)
    q = q.reshape(g * group // cpb, cpb, f)
    shifts = (torch.arange(cpb, dtype=torch.int32, device=x.device)
              * bits)[None, :, None]
    packed = (q << shifts).sum(dim=1).to(torch.uint8)
    scale, zero = scale.to(torch.float32), zero.to(torch.float32)
    if axis == 1:
        packed, scale, zero = packed.t(), scale.t(), zero.t()
    return packed.contiguous(), scale.contiguous(), zero.contiguous()


def dequantize(packed: torch.Tensor, scale: torch.Tensor, zero: torch.Tensor,
               bits: int, group: int, axis: int) -> torch.Tensor:
    """The padded (rows, F) f32 matrix of stored codes."""
    cpb = 8 // bits
    if axis == 1:
        packed, scale, zero = packed.t(), scale.t(), zero.t()
    tp, f = packed.shape
    shifts = (torch.arange(cpb, dtype=torch.int32, device=packed.device)
              * bits)[None, :, None]
    q = (packed.to(torch.int32)[:, None, :] >> shifts) & (2 ** bits - 1)
    q = q.reshape(tp * cpb // group, group, f).to(torch.float64)
    x = (q * scale.to(torch.float64)[:, None] + zero.to(torch.float64)[:, None])
    x = x.to(torch.float32).reshape(tp * cpb, f)
    return x.t() if axis == 1 else x


def _to_device(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _kivi_arrays(arrays: Dict[str, np.ndarray], meta: Dict,
                 device) -> Dict[str, torch.Tensor]:
    out = {}
    bits = meta["bits"]
    for name, shape in meta["shape"].items():
        axis, g = meta["axis"][name], round_group(meta["group"][name], bits)
        mat = dequantize(_to_device(arrays[f"{name}.packed"], device),
                         _to_device(arrays[f"{name}.scale"], device),
                         _to_device(arrays[f"{name}.zero"], device),
                         bits, g, axis)
        rows = int(np.prod(shape[:-1]))
        out[name] = mat[:rows, :shape[-1]].reshape(tuple(shape))
    return out


def entry_kv(method: str, arrays: Dict[str, np.ndarray], meta: Dict,
             device) -> Tuple[Dict[str, torch.Tensor], np.ndarray]:
    """A stored entry as f32 arrays on ``device`` (attention rows (L,
    T_kept, F), Mamba states whole) and the original positions of its
    kept rows."""
    if method in ("none", "streaming_llm"):
        kv = {k: _to_device(v, device).to(torch.float32)
              for k, v in arrays.items() if k != "positions"}
    elif method == "kivi":
        kv = _kivi_arrays(arrays, meta, device)
    elif method == "drop_kivi":
        kv = _kivi_arrays(arrays, meta["kivi"], device)
    else:
        raise ValueError(f"no plain decoding of method {method!r}")
    pos = np.asarray(arrays["positions"]) if "positions" in arrays \
        else np.arange(_tokens(kv))
    return kv, pos


def keep_indices(t: int, keep: float, n_sink: int) -> np.ndarray:
    """StreamingLLM's kept rows: the first ``n_sink`` and the most recent."""
    n_keep = min(max(n_sink + 1, int(round(t * keep))), t)
    n_recent = n_keep - n_sink
    if n_recent <= 0:
        return np.arange(n_keep)
    return np.concatenate([np.arange(n_sink), np.arange(t - n_recent, t)])


def kivi_payload(kv: Dict[str, np.ndarray], meta: Dict, device,
                 arith=torch.float32) -> Dict[str, torch.Tensor]:
    """The packed/scale/zero arrays that KIVI at the entry's bits and
    groups gives for the input ``kv``."""
    out = {}
    bits = meta["bits"]
    for name, shape in meta["shape"].items():
        a = np.asarray(kv[name], dtype=np.float32)
        mat = _to_device(a.reshape(-1, a.shape[-1]), device)
        axis, g = meta["axis"][name], round_group(meta["group"][name], bits)
        pad = (-mat.shape[axis]) % g
        if pad:
            mat = torch.nn.functional.pad(
                mat, (0, 0, 0, pad) if axis == 0 else (0, pad))
        p, s, z = quantize(mat, bits, g, axis, arith)
        out[f"{name}.packed"], out[f"{name}.scale"], out[f"{name}.zero"] = p, s, z
    return out


def kept_rows(kv: Dict[str, np.ndarray], keep: float, n_sink: int
              ) -> Tuple[np.ndarray, np.ndarray]:
    """StreamingLLM's rule on the input ``kv``: the row indices it keeps
    and their original positions."""
    t = _tokens(kv)
    idx = keep_indices(t, keep, n_sink)
    pos = np.asarray(kv["positions"]) if "positions" in kv else np.arange(t)
    return idx, pos[idx]


def expected_arrays(method: str, kv: Dict[str, np.ndarray], meta: Dict,
                    device, n_sink: int = 4) -> Dict[str, torch.Tensor]:
    """What a correct compression of ``kv`` stores, at the method and
    settings (bits, groups, kept share) that the entry records."""
    if method == "none":
        return {k: _to_device(np.asarray(v), device) for k, v in kv.items()}
    if method in ("streaming_llm", "drop_kivi"):
        keep = meta["keep_frac"] if method == "streaming_llm" else meta["keep"]
        idx, pos = kept_rows(kv, keep, n_sink)
        kept = keep_tokens(kv, idx)
        if method == "streaming_llm":
            out = {k: _to_device(v, device) for k, v in kept.items()}
        else:
            out = kivi_payload(kept, meta["kivi"], device)
        out["positions"] = _to_device(pos.astype(np.int32), device)
        return out
    if method == "kivi":
        out = kivi_payload(kv, meta, device)
        if "positions" in kv:
            out["positions"] = _to_device(np.asarray(kv["positions"]), device)
        return out
    raise ValueError(f"no plain compression of method {method!r}")
