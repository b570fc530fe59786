"""Mixture-of-Experts FFN: top-k routing, shared experts, capacity dispatch.

Counterpart of ``repro.models.moe``'s ``moe_fwd`` (the path the reference
takes without mesh rules). Dispatch is sort-based: the (token, expert)
slots are argsorted by expert id, stably, and each slot's position within
its expert's run is ``searchsorted``; slots past the per-expert capacity
C = ceil(T·k/E · capacity_factor) are dropped (``dropless`` sets C = T).

The reference packs the kept slots into an (E, C, d) buffer and runs every
expert over all C rows, empty ones included (an expert maps a zero row to
zero). Here each expert runs over its kept rows only, a contiguous run of
the sorted order: the same function, without the rows that hold no token.
Each slot's weighted output goes back to its (token, k) place and a token's
k contributions are summed in ``x.dtype``, then the shared expert is added.

Router: softmax over the logits in f32, top-k, the top-k weights
renormalised. Ties go to the lower expert index, as ``jax.lax.top_k``
breaks them: a stable descending sort takes the place of ``topk``, whose
order on ties torch leaves open.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import Params, mlp_fwd

CAPACITY_FACTOR = 1.25


def param_shapes(cfg: ModelConfig, lead: Tuple[int, ...] = ()) -> Params:
    """The MoE FFN's parameter shapes, with ``lead`` (the stacked layer
    groups) in front of each: the router (d, E), the stacked experts (E, d,
    ff) / (E, ff, d), and one gated MLP of width ff · n_shared for the
    shared experts."""
    m = cfg.moe
    d, e, ff = cfg.d_model, m.n_routed_experts, m.expert_d_ff
    lead = tuple(lead)
    p: Params = {"router": lead + (d, e),
                 "experts": {"wi_gate": lead + (e, d, ff),
                             "wi_up": lead + (e, d, ff),
                             "wo": lead + (e, ff, d)}}
    if m.n_shared_experts:
        sff = ff * m.n_shared_experts
        p["shared"] = {"wi_gate": lead + (d, sff), "wi_up": lead + (d, sff),
                       "wo": lead + (sff, d)}
    return p


def router_topk(logits: torch.Tensor, top_k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(T, E) -> weights (T, k) renormalised, indices (T, k)."""
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, idx = w[:, :top_k], idx[:, :top_k]
    w = w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-9)
    return w, idx


def capacity(t: int, k: int, e: int, capacity_factor: float = CAPACITY_FACTOR,
             dropless: bool = False) -> int:
    """Slots each expert keeps: T under ``dropless``, else
    ceil(T·k/E · capacity_factor) (at least 1), as the reference rounds it."""
    if dropless:
        return t
    return int(max(1, -(-t * k * capacity_factor // e)))


def dispatch(idx: torch.Tensor, cap: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sort-based dispatch of the (T, k) expert indices ``idx``:
    (``order``, the flat slot ids t·k + j sorted stably by expert; ``keep``,
    whether each sorted slot is within its expert's first ``cap``)."""
    flat_e = idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order].contiguous()
    first = torch.searchsorted(se, se, side="left")
    pos = torch.arange(se.numel(), device=se.device) - first
    return order, pos < cap


def moe_fwd(p: Params, cfg: ModelConfig, x: torch.Tensor,
            capacity_factor: float = CAPACITY_FACTOR,
            dropless: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out, aux). aux is the Switch-style load-balance
    loss E · Σ_e frac_tokens_e · frac_probs_e (f32)."""
    m = cfg.moe
    b, s, d = x.shape
    t, k, e = b * s, m.top_k, m.n_routed_experts
    xf = x.reshape(t, d)

    with torch.profiler.record_function("moe_dispatch"):
        logits = xf.to(torch.float32) @ p["router"].to(torch.float32)
        w, idx = router_topk(logits, k)
        probs = torch.softmax(logits, dim=-1)
        onehot = F.one_hot(idx, e).to(torch.float32).sum(dim=1)   # (T, E)
        aux = e * torch.sum(onehot.mean(dim=0) / k * probs.mean(dim=0))

        order, keep = dispatch(idx, capacity(t, k, e, capacity_factor,
                                             dropless))
        kept = order[keep]                  # flat slot ids, grouped by expert
        per_expert = torch.bincount(idx.reshape(-1)[kept], minlength=e)
        runs = per_expert.tolist()

    ex = p["experts"]
    ys = []
    start = 0
    for j, n in enumerate(runs):
        if n:
            h = xf[kept[start:start + n] // k]
            ys.append((F.silu(h @ ex["wi_gate"][j]) * (h @ ex["wi_up"][j]))
                      @ ex["wo"][j])
            start += n
    wk = w.reshape(-1)[kept].to(x.dtype)[:, None]
    slots = xf.new_zeros((t * k, d)).index_copy(0, kept, torch.cat(ys) * wk)
    out = slots.view(t, k, d).sum(dim=1)
    if "shared" in p:
        out = out + mlp_fwd(p["shared"], xf)
    return out.reshape(b, s, d).to(x.dtype), aux

