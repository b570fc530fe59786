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
``selective_scan_bwd_ref`` is its vector-Jacobian product, the backward
kernel's oracle.
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


def selective_scan_bwd_ref(dt, x, bs, cs, a, h0, dy, dhT=None
                           ) -> Tuple[torch.Tensor, ...]:
    """The scan's vector-Jacobian product, as an explicit reverse-time
    recurrence in f32 (not autograd): the gradients that ``jax.grad``
    derives from the reference's ``lax.scan``, and the backward kernel's
    oracle.

    dy (B, S, D) is the gradient of y, dhT (B, D, N) that of hT (None: 0).
    Returns (ddt, dx, dbs, dcs, da, dh0), each shaped as its input. With
    ``g_t`` the gradient of h_t and ``e_t = exp(dt_t a)``::

        g_{S-1} = dhT + dy_{S-1} C_{S-1},  g_t = g_{t+1} e_{t+1} + dy_t C_t
        dC_t = sum_d dy_t h_t,  dB_t = sum_d g_t dt_t x_t
        dx_t = sum_n g_t dt_t B_t
        ddt_t = sum_n g_t (a e_t h_{t-1} + x_t B_t)
        da = sum_{b,t} g_t e_t h_{t-1} dt_t,  dh0 = g_0 e_0
    """
    dt, x, bs, cs, a, dy = (t.to(torch.float32)
                            for t in (dt, x, bs, cs, a, dy))
    s = dt.shape[1]
    h = h0.to(torch.float32)
    hs, es = [], []                                       # h_{t-1}, e_t
    for t in range(s):
        dt_t = dt[:, t, :, None]
        es.append(torch.exp(dt_t * a))
        hs.append(h)
        h = h * es[t] + dt_t * x[:, t, :, None] * bs[:, t, None, :]
    hs.append(h)                                          # hs[t + 1] = h_t
    g = (torch.zeros_like(h) if dhT is None
         else dhT.to(torch.float32).clone())
    ddt, dx, dbs, dcs = (torch.empty_like(v) for v in (dt, x, bs, cs))
    da = torch.zeros_like(a)
    for t in reversed(range(s)):
        dt_t, x_t, b_t = dt[:, t], x[:, t], bs[:, t]
        g = g + dy[:, t, :, None] * cs[:, t, None, :]     # g_t
        q = es[t] * hs[t]                                 # e_t h_{t-1}
        dcs[:, t] = torch.einsum("bd,bdn->bn", dy[:, t], hs[t + 1])
        dbs[:, t] = torch.einsum("bdn,bd->bn", g, dt_t * x_t)
        dx[:, t] = torch.einsum("bdn,bn->bd", g, b_t) * dt_t
        ddt[:, t] = (g * (a * q + x_t[..., None] * b_t[:, None, :])).sum(-1)
        da = da + (g * q * dt_t[..., None]).sum(0)
        g = g * es[t]                                     # g_t e_t
    return ddt, dx, dbs, dcs, da, g
