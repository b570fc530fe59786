"""CUDA flash-decode attention over KIVI-packed KV for Hopper, bound with
ctypes.

Replaces the TPU kernel ``fused_decode_attention`` of
``src/repro/kernels/decode_attn/kernel.py``. The kernel, ``decode_ring``,
lives in ``csrc/decode_attn.cu`` (with ``csrc/kivi_planes.cuh``), whose
header says what bounds it on the card and what the design does about it.
The library is built at first use by ``kernels/_build.py``; nothing is
built or loaded at import.

Every layout that the packed planes allow takes the one kernel: a
64-token ``cp.async`` ring, about one block an SM (``RING_BLOCKS``), the
splits merged inside the launch by the last block to arrive, so one launch
a call, and ``LAUNCHES["decode_attn"]`` counts one a call.

The last block finds itself by an arrival counter (a ticket) per plane and
row block, which each call leaves at zero. The counters of one device and
stream are shared by the calls on that stream, which run one after
another; calls on two streams use two buffers. A buffer is allocated and
zeroed at the first call on its stream, which must not be under CUDA graph
capture: call once on the capturing stream before capturing. A graph's
calls keep the buffer of the stream they were captured on, so do not
replay it while other calls run on that stream.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import Dict, Tuple

import torch

from repro_torch.kernels._build import (CudaLibrary, check_rc, check_tensor,
                                        stream_of)

LAUNCHES: Dict[str, int] = {"decode_attn": 0}
RING_TILE = 64                # tokens a tile of decode_ring
# one block for each of the H100's 132 SMs (16 splits at P 8): on an H100
# 8 and 32 splits took longer at the main shape (PERF.md)
RING_BLOCKS = 132
MAX_ROWS = 8                  # query rows a decode_ring block

_TICKETS: Dict[Tuple[int, int], torch.Tensor] = {}


def _bind(lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.decode_attn.argtypes = [ptr] * 13 + [i32] * 9 + [ctypes.c_float, ptr]
    lib.decode_attn.restype = i32


LIBRARY = CudaLibrary("decode_attn", Path(__file__).parent, _bind)


def ring_rows(gq: int) -> int:
    """Query rows a decode_ring block takes."""
    return 1 if gq <= 1 else 2 if gq <= 2 else 4 if gq <= 4 else MAX_ROWS


def ring_split_len(t: int, blocks_per_split: int) -> int:
    """Tokens per split of decode_ring: whole 64-token tiles, about
    RING_BLOCKS blocks in the grid (at least one tile a split)."""
    n_tiles = math.ceil(t / RING_TILE)
    n_splits = max(1, min(n_tiles, RING_BLOCKS // max(1, blocks_per_split)))
    return math.ceil(n_tiles / n_splits) * RING_TILE


def _tickets(device: torch.device, n: int) -> torch.Tensor:
    """The arrival counters of the calls on ``device``'s current stream:
    zeroed once, left zero by every call (its last blocks reset what they
    used)."""
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    buf = _TICKETS.get(key)
    if buf is None or buf.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "decode_attention: the first call on a stream must not be "
                "captured into a CUDA graph (its arrival counters would be "
                "zeroed only when the graph replays); call it once on the "
                "capturing stream before capturing")
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _TICKETS[key] = buf
    return buf


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
    rpb = ring_rows(gq)
    row_blocks = math.ceil(gq / rpb)
    sl = ring_split_len(t, p * row_blocks)
    n_splits = math.ceil(t / sl)
    dev = q.device
    m_ws = torch.empty((p, n_splits, gq), dtype=torch.float32, device=dev)
    l_ws = torch.empty_like(m_ws)
    acc_ws = torch.empty((p, n_splits, gq, hd), dtype=torch.float32,
                         device=dev)
    out = torch.empty((p, gq, hd), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        tickets = _tickets(dev, p * row_blocks)
        rc = LIBRARY.lib().decode_attn(
            q.data_ptr(), k_packed.data_ptr(), k_scale.data_ptr(),
            k_zero.data_ptr(), v_packed.data_ptr(), v_scale.data_ptr(),
            v_zero.data_ptr(), cur_len.data_ptr(), m_ws.data_ptr(),
            l_ws.data_ptr(), acc_ws.data_ptr(), tickets.data_ptr(),
            out.data_ptr(), p, gq, rpb, t, hd, bits, k_group, v_group, sl,
            hd ** -0.5, stream_of(q))
    check_rc("decode_attn", rc)
    LAUNCHES["decode_attn"] += 1
    return out
