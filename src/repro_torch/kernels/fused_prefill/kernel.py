"""CUDA chunk-prefill attention over a KIVI-packed prefix for Hopper, bound
with ctypes.

Replaces the TPU kernel ``fused_chunk_prefill`` of
``src/repro/kernels/fused_prefill/kernel.py``. The kernels live in
``csrc/fused_prefill.cu``, which includes decode_attn's
``csrc/kivi_planes.cuh`` for the packed layout; its header says what bounds
them on the card and what the design does about it. Its C entry picks the
kernel by shape: head dims 16, 32, 64 and 128 with both groups multiples
of 8 and 16-byte aligned pointers take the tensor-core kernel
(``fused_mma``: each 64-token tile dequantized once in f32, then K, V, q
and P each split into two bf16 parts and multiplied by ``mma.sync`` as
three products, the packed tiles through a ``cp.async`` ring), every
other layout the CUDA-core one
(``fused_split``). ``tensor_cores`` repeats that choice here, which sets
the split of the prefix for each kernel. The library is built at first
use by ``kernels/_build.py``; nothing is built or loaded at import.

``LAUNCHES["fused_prefill"]`` counts kernel launches: each call launches
two, the split pass (prefix splits plus the chunk's own block) and the
merge pass. ``LAUNCHES["fused_prefill_mma"]`` counts the calls (one a
call) whose split pass ran on the tensor-core kernel.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import Dict

import torch

from repro_torch.kernels._build import (CudaLibrary, check_rc, check_tensor,
                                        stream_of)
from repro_torch.kernels.decode_attn.kernel import packed_shapes

LAUNCHES: Dict[str, int] = {"fused_prefill": 0, "fused_prefill_mma": 0}
ROWS_PER_BLOCK = 32
TILE = 32                     # tokens a tile of fused_split (flash_tile.cuh)
# eight blocks for each of the H100's 132 SMs: a fused_split block walks
# its tiles one after another and waits on each tile's loads, so more,
# shorter splits overlap that wait across blocks
TARGET_BLOCKS = 1056
MMA_TILE = 64                 # tokens a tile of the tensor-core kernel
# two blocks for each of the H100's 132 SMs: each block of the tensor-core
# kernel walks its tiles through a cp.async ring, so a few long splits
# suffice, and every split adds (C, hd) f32 to the workspace
MMA_TARGET_BLOCKS = 264


def _bind(lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.fused_prefill.argtypes = ([ptr] * 14 + [i32] * 8
                                  + [ctypes.c_float, ptr])
    lib.fused_prefill.restype = i32


LIBRARY = CudaLibrary("fused_prefill", Path(__file__).parent, _bind)


def tensor_cores(hd: int, k_group: int, v_group: int, *tensors) -> bool:
    """The C entry's choice of the tensor-core kernel: hd 16, 32, 64 or
    128, both groups multiples of 8, every tensor 16-byte aligned."""
    return (hd in (16, 32, 64, 128) and k_group % 8 == 0
            and v_group % 8 == 0
            and all(t.data_ptr() % 16 == 0 for t in tensors))


def split_len(t: int, blocks_per_split: int) -> int:
    """Tokens per split for the CUDA-core kernel: whole 32-token tiles,
    enough splits that the grid holds about TARGET_BLOCKS blocks (at most
    one split per tile)."""
    n_tiles = math.ceil(t / TILE)
    n_splits = max(1, min(n_tiles, math.ceil(TARGET_BLOCKS
                                             / max(1, blocks_per_split))))
    return math.ceil(n_tiles / n_splits) * TILE


def mma_split_len(t: int, blocks_per_split: int) -> int:
    """Tokens per split for the tensor-core kernel: whole 64-token tiles,
    about MMA_TARGET_BLOCKS blocks in the grid (at least one tile a
    split)."""
    n_tiles = math.ceil(t / MMA_TILE)
    n_splits = max(1, min(n_tiles, MMA_TARGET_BLOCKS
                          // max(1, blocks_per_split)))
    return math.ceil(n_tiles / n_splits) * MMA_TILE


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
    row_blocks = p * math.ceil(c / ROWS_PER_BLOCK)
    mma = tensor_cores(hd, k_group, v_group, q, k_chunk, v_chunk,
                       *packed.values())
    sl = (mma_split_len if mma else split_len)(t, row_blocks)
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
    LAUNCHES["fused_prefill_mma"] += int(mma)
    return out
