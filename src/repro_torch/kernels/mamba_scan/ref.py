"""Plain-torch selective scan (the mamba-1 inner recurrence): the kernel's
oracle.

Counterpart of ``repro.kernels.mamba_scan.ref``: a sequential loop over
time in f32, in the reference's operation order. Inputs are the
post-activation selective parameters:

    dt (B, S, D)  softplus'd step sizes
    x  (B, S, D)  post-conv, post-silu activations
    bs (B, S, N)  input-selection vectors
    cs (B, S, N)  output-selection vectors
    a  (D, N)     negative decay matrix (= -exp(a_log))
    h0 (B, D, N)  initial state

Returns y (B, S, D) f32 and the final state hT (B, D, N) f32:
``h_t = exp(dt_t * a) * h_{t-1} + dt_t * x_t * B_t``, ``y_t = C_t . h_t``.
"""
from __future__ import annotations

from typing import Tuple

import torch


def selective_scan_ref(dt, x, bs, cs, a, h0
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    dt, x, bs, cs, a = (t.to(torch.float32) for t in (dt, x, bs, cs, a))
    h = h0.to(torch.float32)
    ys = []
    for t in range(dt.shape[1]):
        dt_t = dt[:, t, :, None]                          # (B, D, 1)
        da = torch.exp(dt_t * a)                          # (B, D, N)
        h = h * da + dt_t * x[:, t, :, None] * bs[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, cs[:, t]))
    y = (torch.stack(ys, dim=1) if ys
         else dt.new_zeros(dt.shape))                     # (B, S, D)
    return y, h
