"""Public selective scan: the one place that picks a path.

A tensor on the CPU goes to the plain version (``ref.selective_scan_ref``,
a sequential loop over time), and autograd differentiates that loop, as
``jax.grad`` differentiates the reference's ``lax.scan``. A CUDA tensor
goes to the hand-written kernel (``kernel.py``), which raises on what it
cannot take: under no grad, or with no input that requires grad, the
forward alone, as serving runs it; otherwise ``_Scan``, whose forward also
writes the kernel's checkpoints and whose backward is the backward kernel.
Nothing falls back from one path to another. Unlike the reference's TPU
kernel, the CUDA kernels take any sequence length: no chunk size has to
divide it.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.device import on_cpu
from repro_torch.kernels.mamba_scan import kernel as _k
from repro_torch.kernels.mamba_scan import ref as _r


class _Scan(torch.autograd.Function):
    """The CUDA scan under autograd: f32 contiguous inputs on the card."""

    @staticmethod
    def forward(ctx, dt, x, bs, cs, a, h0):
        y, h_t, ckpt = _k.selective_scan(dt, x, bs, cs, a, h0,
                                         checkpoints=True)
        ctx.save_for_backward(dt, x, bs, cs, a, ckpt)
        ctx.set_materialize_grads(False)
        return y, h_t

    @staticmethod
    def backward(ctx, dy, dh_t):
        dt, x, bs, cs, a, ckpt = ctx.saved_tensors
        dy = (torch.zeros_like(dt) if dy is None
              else dy.to(torch.float32).contiguous())
        if dh_t is not None:
            dh_t = dh_t.to(torch.float32).contiguous()
        return _k.selective_scan_bwd(dt, x, bs, cs, a, ckpt, dy, dh_t,
                                     want_dh0=ctx.needs_input_grad[5])


def selective_scan(dt, x, bs, cs, a, h0
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shapes as in ``ref.py``. Returns (y (B, S, D) f32, hT (B, D, N)
    f32)."""
    if on_cpu(dt, "selective scan"):
        return _r.selective_scan_ref(dt, x, bs, cs, a, h0)
    args = tuple(t.to(torch.float32).contiguous()
                 for t in (dt, x, bs, cs, a, h0))
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _Scan.apply(*args)
    return _k.selective_scan(*args)
