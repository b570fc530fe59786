"""Public selective scan: the one place that picks a path.

A tensor on the CPU goes to the plain version (``ref.selective_scan_ref``,
a sequential loop over time); a CUDA tensor goes to the hand-written
kernel (``kernel.py``), which raises on what it cannot take. Nothing falls
back from one to the other. Unlike the reference's TPU kernel, the CUDA
kernel takes any sequence length: no chunk size has to divide it.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.device import on_cpu
from repro_torch.kernels.mamba_scan import kernel as _k
from repro_torch.kernels.mamba_scan import ref as _r


def selective_scan(dt, x, bs, cs, a, h0
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shapes as in ``ref.py``. Returns (y (B, S, D) f32, hT (B, D, N)
    f32)."""
    if on_cpu(dt, "selective scan"):
        return _r.selective_scan_ref(dt, x, bs, cs, a, h0)
    return _k.selective_scan(*(t.to(torch.float32).contiguous()
                               for t in (dt, x, bs, cs, a, h0)))
