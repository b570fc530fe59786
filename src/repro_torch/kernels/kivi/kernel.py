"""CUDA KIVI quantize / dequantize for Hopper, bound with ctypes.

Replaces the TPU kernels ``quantize_pallas`` and ``dequantize_pallas`` of
``src/repro/kernels/kivi/kernel.py``. The kernels live in ``csrc/kivi.cu``,
whose header says what bounds them on the card and what the design does
about it.

The shared library is compiled with ``nvcc`` for ``sm_90a`` at first use,
into ``build/`` beside this file, under a name that hashes the source and
the flags (an edited source builds anew). Nothing is compiled or loaded at
import, so the CPU tests import this module freely.

``LAUNCHES`` counts the kernel launches of each entry; a wrapper adds one
where it launches and nowhere else.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Tuple

import torch

from repro_torch.kernels.kivi.ref import inv_levels

LAUNCHES: Dict[str, int] = {"quantize_k": 0, "quantize_v": 0,
                            "dequantize_k": 0, "dequantize_v": 0}

CSRC = Path(__file__).parent / "csrc" / "kivi.cu"
BUILD_DIR = Path(__file__).parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def library_path() -> Path:
    digest = hashlib.sha256(CSRC.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libkivi-{digest[:16]}.so"


def build() -> Tuple[Path, str]:
    """Compile ``csrc/kivi.cu`` unless this source is already built.

    Returns (library path, nvcc's output: ptxas register and spill counts;
    empty when the library was already there)."""
    out = library_path()
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC)],
                          capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {CSRC}:\n{proc.stdout}"
                           f"{proc.stderr}")
    os.replace(tmp, out)          # atomic: concurrent builders agree
    return out, proc.stdout + proc.stderr


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()[0]))
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.kivi_quantize.argtypes = [ptr, ptr, ptr, ptr, i64, i64, i32, i32,
                                  i32, ctypes.c_float, ptr]
    lib.kivi_quantize.restype = i32
    lib.kivi_dequantize.argtypes = [ptr, ptr, ptr, ptr, i64, i64, i32, i32,
                                    i32, ptr]
    lib.kivi_dequantize.restype = i32
    return lib


def _check(name: str, t: torch.Tensor, dtype: torch.dtype,
           shape: Tuple[int, ...]) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


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
    _check("x", x, torch.float32, (rows, cols))
    cpb = _check_grouping(x.shape[axis], bits, group_size)
    if axis == 0:
        p_shape, s_shape = (rows // cpb, cols), (rows // group_size, cols)
    else:
        p_shape, s_shape = (rows, cols // cpb), (rows, cols // group_size)
    packed = torch.empty(p_shape, dtype=torch.uint8, device=x.device)
    scale = torch.empty(s_shape, dtype=torch.float32, device=x.device)
    zero = torch.empty(s_shape, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _lib().kivi_quantize(
            x.data_ptr(), packed.data_ptr(), scale.data_ptr(),
            zero.data_ptr(), rows, cols, bits, group_size, axis,
            inv_levels(bits), stream)
    if rc != 0:
        raise RuntimeError(f"kivi_quantize launch failed: CUDA error {rc}")
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
    _check("packed", packed, torch.uint8, p_shape)
    _check("scale", scale, torch.float32, s_shape)
    _check("zero", zero, torch.float32, s_shape)
    out = torch.empty((rows, cols), dtype=torch.float32,
                      device=packed.device)
    with torch.cuda.device(packed.device):
        stream = torch.cuda.current_stream(packed.device).cuda_stream
        rc = _lib().kivi_dequantize(
            packed.data_ptr(), scale.data_ptr(), zero.data_ptr(),
            out.data_ptr(), rows, cols, bits, group_size, axis, stream)
    if rc != 0:
        raise RuntimeError(f"kivi_dequantize launch failed: CUDA error {rc}")
    LAUNCHES["dequantize_k" if axis == 0 else "dequantize_v"] += 1
    return out
