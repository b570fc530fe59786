"""CUDA chunk-prefill attention over a KIVI-packed prefix for Hopper, bound
with ctypes.

Replaces the TPU kernel ``fused_chunk_prefill`` of
``src/repro/kernels/fused_prefill/kernel.py``. The kernels live in
``csrc/fused_prefill.cu``, which includes decode_attn's
``csrc/kivi_planes.cuh`` for the packed layout; its header says what bounds
them on the card and what the design does about it. The library is built
at first use by ``kernels/_build.py``; nothing is built or loaded at
import.

``LAUNCHES["fused_prefill"]`` counts kernel launches: each call launches
two, the split pass (prefix splits plus the chunk's own block) and the
merge pass.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import Dict

import torch

from repro_torch.kernels._build import (CudaLibrary, check_rc, check_tensor,
                                        stream_of)
from repro_torch.kernels.decode_attn.kernel import packed_shapes, split_len

LAUNCHES: Dict[str, int] = {"fused_prefill": 0}
ROWS_PER_BLOCK = 32


def _bind(lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.fused_prefill.argtypes = ([ptr] * 14 + [i32] * 8
                                  + [ctypes.c_float, ptr])
    lib.fused_prefill.restype = i32


LIBRARY = CudaLibrary("fused_prefill", Path(__file__).parent, _bind)


def chunk_prefill(q, k_packed, k_scale, k_zero, v_packed, v_scale, v_zero,
                  k_chunk, v_chunk, cur_len, *, bits: int, k_group: int,
                  v_group: int) -> torch.Tensor:
    """q/k_chunk/v_chunk (P, C, hd) f32 and the packed prefix planes on the
    card; cur_len (P, 1) i32. Returns (P, C, hd) f32."""
    p, c, hd = q.shape
    t = v_packed.shape[1]
    for name, x in (("q", q), ("k_chunk", k_chunk), ("v_chunk", v_chunk)):
        check_tensor(name, x, torch.float32, (p, c, hd))
    packed = dict(k_packed=k_packed, k_scale=k_scale, k_zero=k_zero,
                  v_packed=v_packed, v_scale=v_scale, v_zero=v_zero)
    for name, (shape, dtype) in packed_shapes(p, t, hd, bits, k_group,
                                              v_group).items():
        check_tensor(name, packed[name], dtype, shape)
    check_tensor("cur_len", cur_len, torch.int32, (p, 1))
    sl = split_len(t, p * math.ceil(c / ROWS_PER_BLOCK))
    n_splits = math.ceil(t / sl) + 1            # + the chunk's own block
    dev = q.device
    m_ws = torch.empty((p, n_splits, c), dtype=torch.float32, device=dev)
    l_ws = torch.empty_like(m_ws)
    acc_ws = torch.empty((p, n_splits, c, hd), dtype=torch.float32,
                         device=dev)
    out = torch.empty((p, c, hd), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = LIBRARY.lib().fused_prefill(
            q.data_ptr(), k_packed.data_ptr(), k_scale.data_ptr(),
            k_zero.data_ptr(), v_packed.data_ptr(), v_scale.data_ptr(),
            v_zero.data_ptr(), k_chunk.data_ptr(), v_chunk.data_ptr(),
            cur_len.data_ptr(), m_ws.data_ptr(), l_ws.data_ptr(),
            acc_ws.data_ptr(), out.data_ptr(), p, c, t, hd, bits, k_group,
            v_group, sl, hd ** -0.5, stream_of(q))
    check_rc("fused_prefill", rc)
    LAUNCHES["fused_prefill"] += 2
    return out
