"""CUDA KIVI quantize / dequantize for Hopper, bound with ctypes.

Replaces the TPU kernels ``quantize_pallas`` and ``dequantize_pallas`` of
``src/repro/kernels/kivi/kernel.py``. The kernels live in ``csrc/kivi.cu``,
whose header says what bounds them on the card and what the design does
about it.

The shared library is built with ``nvcc`` for ``sm_90a`` at first use by
``kernels/_build.py`` (into ``build/`` beside this file, under a name that
hashes the source and the flags). Nothing is compiled or loaded at import,
so the CPU tests import this module freely.

``LAUNCHES`` counts the kernel launches of each entry; a wrapper adds one
where it launches and nowhere else.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Tuple

import torch

from repro_torch.kernels._build import (CudaLibrary, check_rc, check_tensor,
                                        stream_of)
from repro_torch.kernels.kivi.ref import inv_levels

LAUNCHES: Dict[str, int] = {"quantize_k": 0, "quantize_v": 0,
                            "dequantize_k": 0, "dequantize_v": 0}


def _bind(lib: ctypes.CDLL) -> None:
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.kivi_quantize.argtypes = [ptr, ptr, ptr, ptr, i64, i64, i32, i32,
                                  i32, ctypes.c_float, ptr]
    lib.kivi_quantize.restype = i32
    lib.kivi_dequantize.argtypes = [ptr, ptr, ptr, ptr, i64, i64, i32, i32,
                                    i32, ptr]
    lib.kivi_dequantize.restype = i32


LIBRARY = CudaLibrary("kivi", Path(__file__).parent, _bind)


def _check_grouping(grouped: int, bits: int, group_size: int) -> int:
    if bits not in (2, 4, 8):
        raise ValueError(f"bits must be 2, 4 or 8, got {bits}")
    cpb = 8 // bits
    if group_size <= 0 or group_size % cpb or grouped % group_size:
        raise ValueError(f"grouped dim {grouped} and group size "
                         f"{group_size} do not fit {bits}-bit packing")
    return cpb


def quantize(x: torch.Tensor, bits: int, group_size: int, axis: int
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (T, F) f32 on the card, grouped along ``axis``. Returns
    (packed u8, scale f32, zero f32) in the layout of ``ref.quantize_ref``."""
    if x.ndim != 2 or axis not in (0, 1):
        raise ValueError(f"need a 2-D matrix and axis 0/1, got "
                         f"{tuple(x.shape)}, axis={axis}")
    rows, cols = x.shape
    check_tensor("x", x, torch.float32, (rows, cols))
    cpb = _check_grouping(x.shape[axis], bits, group_size)
    if axis == 0:
        p_shape, s_shape = (rows // cpb, cols), (rows // group_size, cols)
    else:
        p_shape, s_shape = (rows, cols // cpb), (rows, cols // group_size)
    packed = torch.empty(p_shape, dtype=torch.uint8, device=x.device)
    scale = torch.empty(s_shape, dtype=torch.float32, device=x.device)
    zero = torch.empty(s_shape, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = LIBRARY.lib().kivi_quantize(
            x.data_ptr(), packed.data_ptr(), scale.data_ptr(),
            zero.data_ptr(), rows, cols, bits, group_size, axis,
            inv_levels(bits), stream_of(x))
    check_rc("kivi_quantize", rc)
    LAUNCHES["quantize_k" if axis == 0 else "quantize_v"] += 1
    return packed, scale, zero


def dequantize(packed: torch.Tensor, scale: torch.Tensor, zero: torch.Tensor,
               bits: int, group_size: int, axis: int, orig_dim: int
               ) -> torch.Tensor:
    """Inverse of ``quantize``: (T, F) f32, T (axis 0) or F (axis 1) equal
    to ``orig_dim``."""
    if packed.ndim != 2 or axis not in (0, 1):
        raise ValueError(f"need a 2-D packed matrix and axis 0/1, got "
                         f"{tuple(packed.shape)}, axis={axis}")
    cpb = _check_grouping(orig_dim, bits, group_size)
    if axis == 0:
        rows, cols = orig_dim, packed.shape[1]
        p_shape, s_shape = (rows // cpb, cols), (rows // group_size, cols)
    else:
        rows, cols = packed.shape[0], orig_dim
        p_shape, s_shape = (rows, cols // cpb), (rows, cols // group_size)
    check_tensor("packed", packed, torch.uint8, p_shape)
    check_tensor("scale", scale, torch.float32, s_shape)
    check_tensor("zero", zero, torch.float32, s_shape)
    out = torch.empty((rows, cols), dtype=torch.float32,
                      device=packed.device)
    with torch.cuda.device(packed.device):
        rc = LIBRARY.lib().kivi_dequantize(
            packed.data_ptr(), scale.data_ptr(), zero.data_ptr(),
            out.data_ptr(), rows, cols, bits, group_size, axis,
            stream_of(packed))
    check_rc("kivi_dequantize", rc)
    LAUNCHES["dequantize_k" if axis == 0 else "dequantize_v"] += 1
    return out
