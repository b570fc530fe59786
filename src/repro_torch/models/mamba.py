"""Mamba-1 selective-SSM block (falcon-mamba, Jamba).

Counterpart of ``repro.models.mamba``. The full-sequence path runs the
selective scan through ``kernels/mamba_scan/ops.selective_scan`` (the
reference runs the same recurrence as a ``lax.scan`` and names its Pallas
kernel as the fast path of that scan); ``d_skip`` and the ``silu(z)`` gate
stay outside the kernel, as in the reference's kernel test. Decode is the
plain recurrent step.

With ``SSMConfig.inner_norms`` (Jamba) dt, B and C are RMS-normalised
after ``x_proj`` (leaves ``dt_norm``, ``b_norm``, ``c_norm``, at the
model's ``norm_eps``), dt before ``dt_proj``.

Decode keeps a fixed-size recurrent cache per layer:
    conv: (B, d_conv - 1, d_inner)   the causal conv's tail window
    ssm : (B, d_inner, d_state)      the SSM hidden state, f32
The decode step updates both in place.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.mamba_scan import ops as scan_ops
from repro_torch.launch.sharding import (
    constrain, on_local_shards, reduce_partial,
)
from repro_torch.models.layers import Params, rmsnorm
from repro_torch.runtime import trace

# leaves kept in f32 whatever the param dtype, as the reference does
F32_LEAVES = frozenset({"a_log", "d_skip"})


def param_shapes(cfg: ModelConfig, lead: Tuple[int, ...] = ()) -> Params:
    """The layer's parameter shapes, with ``lead`` (the stacked layer
    groups) in front of each."""
    s = cfg.ssm
    d, d_in, r = cfg.d_model, cfg.d_inner, cfg.resolved_dt_rank
    shapes = {"in_proj": (d, 2 * d_in), "conv_w": (s.d_conv, d_in),
              "conv_b": (d_in,), "x_proj": (d_in, r + 2 * s.d_state),
              "dt_proj": (r, d_in), "dt_bias": (d_in,),
              "a_log": (d_in, s.d_state), "d_skip": (d_in,),
              "out_proj": (d_in, d)}
    if s.inner_norms:
        shapes.update(dt_norm=(r,), b_norm=(s.d_state,), c_norm=(s.d_state,))
    return {k: tuple(lead) + v for k, v in shapes.items()}


def init_mamba_leaf(gen: torch.Generator, cfg: ModelConfig, name: str,
                    shape: Tuple[int, ...], dtype) -> torch.Tensor:
    """Leaf ``name`` of a mamba block (``shape`` may lead with stacked
    layer groups) on ``gen``'s device, with the reference's init scheme:
    the three matrices N(0, 1/d_in), ``conv_w`` N(0, 1/d_conv), ``conv_b``
    zeros, ``dt_bias`` the inverse softplus of U(0.001, 0.1), ``a_log =
    log(1..N)`` and ``d_skip`` ones in f32, the inner norms ones. Random
    matrices are drawn one layer at a time, so no f32 copy of a whole
    stack exists."""
    dev = gen.device
    if name.endswith("_norm"):
        return torch.ones(shape, dtype=dtype, device=dev)
    if name in ("in_proj", "x_proj", "dt_proj", "out_proj", "conv_w"):
        scale = (cfg.ssm.d_conv if name == "conv_w" else shape[-2]) ** -0.5
        out = torch.empty(shape, dtype=dtype, device=dev)
        for layer in out.view((-1,) + tuple(shape[-2:])):
            layer.copy_(torch.randn(layer.shape, generator=gen, device=dev)
                        * scale)
        return out
    if name == "dt_bias":
        u = torch.rand(shape, generator=gen, device=dev)
        dt = torch.clamp(u * 0.099 + 0.001, min=1e-4)
        return torch.log(torch.expm1(dt)).to(dtype)
    if name == "a_log":
        n = torch.arange(1, cfg.ssm.d_state + 1, dtype=torch.float32,
                         device=dev)
        return torch.log(n).expand(shape).contiguous()
    if name == "d_skip":
        return torch.ones(shape, dtype=torch.float32, device=dev)
    return torch.zeros(shape, dtype=dtype, device=dev)       # conv_b


def init_mamba_cache(cfg: ModelConfig, batch: int, dtype, device,
                     lead: Tuple[int, ...] = ()) -> Params:
    s = cfg.ssm
    return {
        "conv": torch.zeros(tuple(lead) + (batch, s.d_conv - 1, cfg.d_inner),
                            dtype=dtype, device=device),
        "ssm": torch.zeros(tuple(lead) + (batch, cfg.d_inner, s.d_state),
                           dtype=torch.float32, device=device),
    }


# logical specs of the scan's operands: (B, S, d_inner) and (B, S, N)
_BSD = ("data", None, "model")
_BSN = ("data", None, None)


class _MetaScan(torch.autograd.Function):
    """The scan's shapes on the meta device, where no kernel and no plain
    loop can run (the dry run holds no data): y (B, S, D) and hT (B, D, N)
    in f32, and under autograd gradients of the inputs' shapes, so the
    layers around the scan run forward and backward as they would."""

    @staticmethod
    def forward(ctx, dt, x, bs, cs, a, h0):
        ctx.shapes = [(t.shape, t.dtype) for t in (dt, x, bs, cs, a, h0)]
        return (dt.new_empty(dt.shape, dtype=torch.float32),
                h0.new_empty(h0.shape, dtype=torch.float32))

    @staticmethod
    def backward(ctx, dy, dh_t):
        return tuple(torch.empty(s, dtype=d, device="meta")
                     for s, d in ctx.shapes)


def _scan(dt, x, bs, cs, a, h0):
    """The selective scan of plain (local) tensors: the kernel's ops on
    CUDA and the CPU, ``_MetaScan`` on the meta device."""
    if dt.is_meta:
        return _MetaScan.apply(dt, x, bs, cs, a, h0)
    return scan_ops.selective_scan(dt, x, bs, cs, a, h0)


def _ssm_params(p: Params, cfg: ModelConfig, xc: torch.Tensor):
    """xc: (..., d_inner) post-conv activations -> (dt, B, C) selective
    params, f32."""
    n, r = cfg.ssm.d_state, cfg.resolved_dt_rank
    # (..., r + 2n); under a mesh a sum over d_inner's shards, reduced
    # here before it is split
    proj = reduce_partial(xc @ p["x_proj"])
    dt, b_sel, c_sel = proj[..., :r], proj[..., r:r + n], proj[..., r + n:]
    if cfg.ssm.inner_norms:
        dt = rmsnorm(dt, p["dt_norm"], cfg.norm_eps)
        b_sel = rmsnorm(b_sel, p["b_norm"], cfg.norm_eps)
        c_sel = rmsnorm(c_sel, p["c_norm"], cfg.norm_eps)
    dt = F.softplus((dt @ p["dt_proj"] + p["dt_bias"]).to(torch.float32))
    return dt, b_sel.to(torch.float32), c_sel.to(torch.float32)


def mamba_fwd(p: Params, cfg: ModelConfig, x: torch.Tensor,
              cache: Optional[Params] = None, decode: bool = False
              ) -> Tuple[torch.Tensor, Params]:
    """x: (B, S, d_model). Returns (out (B, S, d_model), cache).

    Full sequence: the new cache is returned and ``cache`` (if given) is
    only read, for the conv window and the initial state h0. Decode
    (S == 1): ``cache`` is updated in place, after the new values are
    computed from the old ones, and returned."""
    s = cfg.ssm
    b, seq, _ = x.shape
    if decode:
        if seq != 1 or cache is None:
            raise ValueError("decode takes one token and a cache")
        with trace.span("mamba.step"):
            return _decode(p, cfg, x, cache)

    # full sequence: causal depthwise conv, then the selective scan
    xs, z = (x @ p["in_proj"]).chunk(2, dim=-1)              # (B, S, d_in)
    xs = constrain(xs, ("data", None, "model"))
    pad = (torch.zeros((b, s.d_conv - 1, cfg.d_inner), dtype=xs.dtype,
                       device=x.device)
           if cache is None else cache["conv"])
    padded = torch.cat([pad, xs], dim=1)                     # (B, S+c-1, d_in)
    xc = sum(padded[:, i:i + seq] * p["conv_w"][i] for i in range(s.d_conv))
    xc = F.silu(xc + p["conv_b"])                            # (B, S, d_in)

    dt, b_sel, c_sel = _ssm_params(p, cfg, xc)               # (B, S, .)
    a = -torch.exp(p["a_log"])                               # (d_in, n)
    h0 = (torch.zeros((b, cfg.d_inner, s.d_state), dtype=torch.float32,
                      device=x.device)
          if cache is None else cache["ssm"])
    # under a mesh the scan runs on each rank's local channels: the kernel
    # reads raw pointers, so no DTensor reaches it
    y, h_t = on_local_shards(
        _scan,
        (_BSD, _BSD, _BSN, _BSN, ("model", None), ("data", "model", None)),
        (0, 5), dt, xc.to(torch.float32), b_sel, c_sel, a, h0)
    y = y + p["d_skip"] * xc.to(torch.float32)
    y = y.to(x.dtype) * F.silu(z)
    new_cache = {"conv": padded[:, -(s.d_conv - 1):], "ssm": h_t}
    return y @ p["out_proj"], new_cache


def _decode(p: Params, cfg: ModelConfig, x: torch.Tensor, cache: Params
            ) -> Tuple[torch.Tensor, Params]:
    """One token's step: the projections and the recurrent update, the
    conv window and the state updated in place."""
    xs, z = (x @ p["in_proj"]).chunk(2, dim=-1)              # (B, 1, d_in)
    xs = constrain(xs, ("data", None, "model"))
    window = torch.cat([cache["conv"], xs], dim=1)           # (B, c, d_in)
    xc = torch.einsum("bkd,kd->bd", window, p["conv_w"]) + p["conv_b"]
    xc = F.silu(xc)[:, None]                                 # (B, 1, d_in)
    dt, b_sel, c_sel = _ssm_params(p, cfg, xc)
    a = -torch.exp(p["a_log"])                               # (d_in, n)
    da = torch.exp(dt[:, 0, :, None] * a)                    # (B, d_in, n)
    dbx = (dt[:, 0, :, None] * b_sel[:, 0, None, :]
           * xc[:, 0, :, None].to(torch.float32))
    h = cache["ssm"] * da + dbx
    y = torch.einsum("bdn,bn->bd", h, c_sel[:, 0])
    y = y + p["d_skip"] * xc[:, 0].to(torch.float32)
    y = (y.to(x.dtype) * F.silu(z[:, 0]))[:, None]
    cache["conv"].copy_(window[:, 1:])
    cache["ssm"].copy_(h)
    return y @ p["out_proj"], cache
