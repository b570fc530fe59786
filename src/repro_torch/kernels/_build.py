"""Build-at-first-use for the port's CUDA libraries, bound with ctypes.

Each kernel package keeps its CUDA C++ under ``csrc/`` with a plain C
interface. ``CudaLibrary`` compiles one ``.cu`` with ``nvcc`` for
``sm_90a`` into ``build/`` beside the package, under a name that hashes the
source, every local header it includes (``#include "..."``, followed
recursively) and the flags, so an edited source or header builds anew.
Nothing is compiled or loaded at import, so the CPU tests import every
kernel module freely; a build or load that fails raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, List, Optional, Sequence, Tuple

import torch

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)


def _sources(cu: Path) -> List[Path]:
    """``cu`` and every local header it includes, in a fixed order."""
    seen: List[Path] = []
    todo = [cu.resolve()]
    while todo:
        f = todo.pop()
        if f in seen:
            continue
        seen.append(f)
        todo += [(f.parent / m).resolve()
                 for m in _INCLUDE.findall(f.read_text())]
    return seen


class CudaLibrary:
    """One shared library: ``csrc/<name>.cu`` of a kernel package.

    ``bind`` sets the ctypes signatures of its C entries once it is
    loaded."""

    def __init__(self, name: str, package_dir: Path,
                 bind: Callable[[ctypes.CDLL], None]):
        self.name = name
        self.source = package_dir / "csrc" / f"{name}.cu"
        self.build_dir = package_dir / "build"
        self._bind = bind
        self._lib: Optional[ctypes.CDLL] = None

    def path(self) -> Path:
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for f in _sources(self.source):
            h.update(f.name.encode() + f.read_bytes())
        return self.build_dir / f"lib{self.name}-{h.hexdigest()[:16]}.so"

    def build(self) -> Tuple[Path, str]:
        """Compile unless this source is already built. Returns (library
        path, nvcc's output with ptxas's register and spill counts; empty
        when the library was already there)."""
        out = self.path()
        if out.exists():
            return out, ""
        self.build_dir.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp),
                               str(self.source)],
                              capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {self.source}:\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)          # atomic: concurrent builds agree
        return out, proc.stdout + proc.stderr

    def lib(self) -> ctypes.CDLL:
        if self._lib is None:
            lib = ctypes.CDLL(str(self.build()[0]))
            self._bind(lib)
            self._lib = lib
        return self._lib


def build_all(libs: Sequence[CudaLibrary]) -> List[Tuple[Path, str]]:
    """Build several libraries at once, one ``nvcc`` each, all started
    together; raises if any build fails."""
    with ThreadPoolExecutor(max_workers=max(1, len(libs))) as pool:
        return list(pool.map(lambda lib: lib.build(), libs))


def stream_of(t: torch.Tensor) -> int:
    """PyTorch's current stream on ``t``'s card, as a ctypes pointer."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check_tensor(name: str, t: torch.Tensor, dtype: torch.dtype,
                 shape: Tuple[int, ...]) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of this type and
    shape: what every kernel binding takes."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_rc(entry: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {rc}")
