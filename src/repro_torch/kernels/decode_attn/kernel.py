"""CUDA flash-decode attention over KIVI-packed KV for Hopper, bound with
ctypes.

Replaces the TPU kernel ``fused_decode_attention`` of
``src/repro/kernels/decode_attn/kernel.py``. The kernels live in
``csrc/decode_attn.cu`` (with ``csrc/kivi_planes.cuh``), whose header says
what bounds them on the card and what the design does about it. The
library is built at first use by ``kernels/_build.py``; nothing is built
or loaded at import.

``LAUNCHES["decode_attn"]`` counts kernel launches: each call launches
two, the split pass and the merge pass.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import Dict

import torch

from repro_torch.kernels._build import (CudaLibrary, check_rc, check_tensor,
                                        stream_of)

LAUNCHES: Dict[str, int] = {"decode_attn": 0}
TILE = 32                     # tokens per shared-memory tile (flash_tile.cuh)
# eight blocks for each of the H100's 132 SMs: a block walks its tiles one
# after another and waits on each tile's loads, so more, shorter splits
# overlap that wait across blocks
TARGET_BLOCKS = 1056


def _bind(lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.decode_attn.argtypes = [ptr] * 12 + [i32] * 8 + [ctypes.c_float, ptr]
    lib.decode_attn.restype = i32


LIBRARY = CudaLibrary("decode_attn", Path(__file__).parent, _bind)


def split_len(t: int, blocks_per_split: int) -> int:
    """Tokens per split: whole tiles, enough splits that the grid holds
    about TARGET_BLOCKS blocks (at most one split per tile)."""
    n_tiles = math.ceil(t / TILE)
    n_splits = max(1, min(n_tiles, math.ceil(TARGET_BLOCKS
                                             / max(1, blocks_per_split))))
    return math.ceil(n_tiles / n_splits) * TILE


def packed_shapes(p: int, t: int, hd: int, bits: int, k_group: int,
                  v_group: int):
    cpb = 8 // bits
    return {"k_packed": ((p, t // cpb, hd), torch.uint8),
            "k_scale": ((p, t // k_group, hd), torch.float32),
            "k_zero": ((p, t // k_group, hd), torch.float32),
            "v_packed": ((p, t, hd // cpb), torch.uint8),
            "v_scale": ((p, t, hd // v_group), torch.float32),
            "v_zero": ((p, t, hd // v_group), torch.float32)}


def decode_attention(q, k_packed, k_scale, k_zero, v_packed, v_scale,
                     v_zero, cur_len, *, bits: int, k_group: int,
                     v_group: int) -> torch.Tensor:
    """q (P, Gq, hd) f32 and the packed planes on the card; cur_len (P, 1)
    i32. Returns (P, Gq, hd) f32."""
    p, gq, hd = q.shape
    t = v_packed.shape[1]
    check_tensor("q", q, torch.float32, (p, gq, hd))
    packed = dict(k_packed=k_packed, k_scale=k_scale, k_zero=k_zero,
                  v_packed=v_packed, v_scale=v_scale, v_zero=v_zero)
    for name, (shape, dtype) in packed_shapes(p, t, hd, bits, k_group,
                                              v_group).items():
        check_tensor(name, packed[name], dtype, shape)
    check_tensor("cur_len", cur_len, torch.int32, (p, 1))
    # the rows a block takes, as flash::rows_per_warp picks them
    rows_per_block = 4 if gq <= 4 else 8 if gq <= 8 else 32
    sl = split_len(t, p * math.ceil(gq / rows_per_block))
    n_splits = math.ceil(t / sl)
    dev = q.device
    m_ws = torch.empty((p, n_splits, gq), dtype=torch.float32, device=dev)
    l_ws = torch.empty_like(m_ws)
    acc_ws = torch.empty((p, n_splits, gq, hd), dtype=torch.float32,
                         device=dev)
    out = torch.empty((p, gq, hd), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = LIBRARY.lib().decode_attn(
            q.data_ptr(), k_packed.data_ptr(), k_scale.data_ptr(),
            k_zero.data_ptr(), v_packed.data_ptr(), v_scale.data_ptr(),
            v_zero.data_ptr(), cur_len.data_ptr(), m_ws.data_ptr(),
            l_ws.data_ptr(), acc_ws.data_ptr(), out.data_ptr(), p, gq, t, hd,
            bits, k_group, v_group, sl, hd ** -0.5, stream_of(q))
    check_rc("decode_attn", rc)
    LAUNCHES["decode_attn"] += 2
    return out
