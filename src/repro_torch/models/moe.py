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
That run-based form needs the per-expert counts on the host, one blocking
read a layer.

A decode step (``decode``: one token a lane, from the model's
``decode_step``) of T·k slots no more than the experts held takes a
fixed-shape form instead, with no host read: every slot gathers its
expert's weights and all slots run at once as the reference's
``_expert_ffn`` (``bmm``). Its shapes and its work depend on no routing
decision, so the step can be captured in a CUDA graph
(``models/decode_graph.py``). Past the experts held the gather would read
more weights than the run-based form, which reads each routed expert
once, so a step of more slots keeps that form. A decode routes dropless,
so the two forms compute the same slots; they round differently (``bmm``
against per-expert products).

Router: softmax over the logits in f32, top-k, the top-k weights
renormalised (unless ``MoEConfig.renormalize`` is off, as in Jamba). Ties
go to the lower expert index, as ``jax.lax.top_k`` breaks them: a stable
descending sort takes the place of ``topk``, whose order on ties torch
leaves open.

Held experts (``MoEConfig.n_held_experts``): one chip of an
expert-parallel deployment holds experts [0, held) of the layer. The
router keeps all ``n_routed_experts`` columns, tokens route over all of
them, and only the held experts compute: a slot routed to an expert
held elsewhere adds nothing here (the decode form clamps its index for
the gather and zeroes its weight). On one chip the layer runs without the
deployment's exchange; what the other chips' experts would add is left
out. ``moe_fwd_ep`` and the mesh path take whole layers only.

Under a mesh (``launch.sharding.use_mesh``) the model calls
``moe_fwd_ep``, the reference's explicit expert parallelism: each "model"
rank computes its own experts over its local, replicated token block, and
one all-reduce over "model" combines them. Where that does not divide (the
reference's own rule), ``moe_fwd`` on DTensors runs the reference's
buffered dispatch, (E, C, d), with its sharding constraints, on
replicated operands. Both take static shapes (a buffer of C rows an
expert, empty rows included), so they also run on the dry run's fake
tensors.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate

from repro_torch.configs.base import ModelConfig
from repro_torch.launch import sharding as shlib
from repro_torch.launch.sharding import constrain
from repro_torch.models.layers import Params, mlp_fwd
from repro_torch.runtime import trace

CAPACITY_FACTOR = 1.25


def param_shapes(cfg: ModelConfig, lead: Tuple[int, ...] = ()) -> Params:
    """The MoE FFN's parameter shapes, with ``lead`` (the stacked layer
    groups) in front of each: the router (d, E), the stacked held experts
    (H, d, ff) / (H, ff, d), and one gated MLP of width ff · n_shared for
    the shared experts."""
    m = cfg.moe
    d, e, ff, h = cfg.d_model, m.n_routed_experts, m.expert_d_ff, m.held
    lead = tuple(lead)
    p: Params = {"router": lead + (d, e),
                 "experts": {"wi_gate": lead + (h, d, ff),
                             "wi_up": lead + (h, d, ff),
                             "wo": lead + (h, ff, d)}}
    if m.n_shared_experts:
        sff = ff * m.n_shared_experts
        p["shared"] = {"wi_gate": lead + (d, sff), "wi_up": lead + (d, sff),
                       "wo": lead + (sff, d)}
    return p


def router_topk(logits: torch.Tensor, top_k: int, renormalize: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(T, E) -> weights (T, k), renormalised to sum to 1 unless
    ``renormalize`` is off (then each is its softmax probability), and
    indices (T, k)."""
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, idx = w[:, :top_k], idx[:, :top_k]
    if renormalize:
        w = w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-9)
    return w, idx


def _whole_layer(cfg: ModelConfig, where: str) -> None:
    """The mesh paths split whole layers over their ranks: refuse a chip's
    share of held experts."""
    m = cfg.moe
    if m.held != m.n_routed_experts:
        raise ValueError(
            f"{where} takes every routed expert of a layer; {cfg.name} holds "
            f"{m.held} of {m.n_routed_experts} (n_held_experts): serve it "
            "with moe_fwd on plain tensors")


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


def _balance_loss(logits: torch.Tensor, idx: torch.Tensor, e: int,
                  k: int) -> torch.Tensor:
    """E · Σ_e frac_tokens_e · frac_probs_e (f32)."""
    probs = torch.softmax(logits, dim=-1)
    onehot = F.one_hot(idx, e).to(torch.float32).sum(dim=1)       # (T, E)
    return e * torch.sum(onehot.mean(dim=0) / k * probs.mean(dim=0))


def _expert_ffn(wi_g, wi_u, wo, h):
    """The stacked experts over their (E, C, d) buffer rows."""
    return torch.bmm(F.silu(torch.bmm(h, wi_g)) * torch.bmm(h, wi_u), wo)


def _buffered(xf, w, idx, e_lo: int, e_loc: int, cap: int, wi_g, wi_u, wo,
              constrained: bool = False) -> torch.Tensor:
    """The reference's sort-based dispatch into an (e_loc, cap, d) buffer
    for experts [e_lo, e_lo + e_loc): slots of other experts, and slots
    past an expert's ``cap``, go to a dropped row. Returns the (T, d)
    weighted sum of the kept slots' outputs (partial over the experts
    outside the range). ``constrained`` applies the reference's
    ``moe_fwd`` sharding constraints."""
    t, d = xf.shape
    k = idx.shape[1]
    flat_e = idx.reshape(-1)
    flat_tok = torch.arange(t, device=xf.device).repeat_interleave(k)
    order = torch.argsort(flat_e, stable=True)
    se, st, sw = flat_e[order], flat_tok[order], w.reshape(-1)[order]
    first = torch.searchsorted(se.contiguous(), se.contiguous(), side="left")
    pos = torch.arange(t * k, device=xf.device) - first
    my_e = se - e_lo
    mine = (my_e >= 0) & (my_e < e_loc) & (pos < cap)
    target = torch.where(mine, my_e * cap + pos, e_loc * cap)

    xs_sorted = xf[st]                                         # (T*k, d)
    if constrained:
        xs_sorted = constrain(xs_sorted, ("data", None))
    buf = xf.new_zeros((e_loc * cap + 1, d)).index_copy(0, target, xs_sorted)
    buf = buf[:-1].reshape(e_loc, cap, d)
    if constrained:
        buf = constrain(buf, ("model", "data", None))
    out_buf = _expert_ffn(wi_g, wi_u, wo, buf)                 # (E, C, d)
    if constrained:
        out_buf = constrain(out_buf, ("model", "data", None))
    flat_out = out_buf.reshape(e_loc * cap, d)
    gathered = torch.where(mine[:, None],
                           flat_out[torch.clamp(target, 0, e_loc * cap - 1)],
                           0)
    if constrained:
        gathered = constrain(gathered, ("data", None))
    contrib = gathered * sw[:, None].to(xf.dtype)
    out = xf.new_zeros((t, d)).index_add(0, st, contrib)       # segment sum
    if constrained:
        out = constrain(out, ("data", None))
    return out


def _moe_fwd_mesh(p: Params, cfg: ModelConfig, x: torch.Tensor,
                  capacity_factor: float, dropless: bool
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``moe_fwd`` of DTensors: every rank runs the reference's buffered
    dispatch over all E experts on replicated operands (DTensor has no
    sharding rule for ``searchsorted``), its five constraints in place on
    the local tensors."""
    _whole_layer(cfg, "the mesh MoE path")
    m = cfg.moe
    b, s, d = x.shape
    t, k, e = b * s, m.top_k, m.n_routed_experts
    cap = capacity(t, k, e, capacity_factor, dropless)

    def local(x, router, wi_g, wi_u, wo):
        xf = x.reshape(t, d)
        logits = xf.to(torch.float32) @ router.to(torch.float32)
        w, idx = router_topk(logits, k, m.renormalize)
        out = _buffered(xf, w, idx, 0, e, cap, wi_g, wi_u, wo,
                        constrained=True)
        return out.reshape(b, s, d), _balance_loss(logits, idx, e, k)

    ex = p["experts"]
    out, aux = shlib.on_local_shards(
        local, [(None,) * 3, (None,) * 2] + [(None,) * 3] * 3, (None, None),
        x, p["router"], ex["wi_gate"], ex["wi_up"], ex["wo"])
    if "shared" in p:
        out = out + mlp_fwd(p["shared"], x)
    return out.to(x.dtype), aux


def moe_fwd_ep(p: Params, cfg: ModelConfig, x: torch.Tensor,
               capacity_factor: float = CAPACITY_FACTOR,
               dropless: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Explicit expert-parallel MoE: local shards and one all-reduce (the
    reference's ``shard_map`` form).

    Within a TP block the token activations are replicated across the
    "model" axis, and the experts are sharded across it, so dispatch needs
    no cross-device token movement: every "model" rank filters its own
    experts' slots out of its local, replicated block, computes them into
    its (E/|model|, C, d) buffer, and one all-reduce over "model" (a
    ``Partial`` placement redistributed to ``Replicate``, a
    ``_c10d_functional.all_reduce``) sums the per-expert partial outputs,
    in the residual dtype. The balance loss is averaged over "data".

    Weights arrive replicated over "data": FSDP-trained experts are
    all-gathered at the boundary, TP-only serving params move nothing.
    Plain tensors count as replicated, and a plain ``x`` gets plain
    results (the whole tensors). Falls back to ``moe_fwd`` when the experts
    do not divide over "model" or the tokens and d_model do not divide
    over "data" (the reference's rule).
    """
    _whole_layer(cfg, "moe_fwd_ep")
    rules = shlib._rules()
    mesh = rules["mesh"]
    amap = rules["map"]
    d_ax, m_ax = amap.get("data"), amap.get("model")
    sizes = shlib.mesh_shape(mesh).shape
    m = cfg.moe
    e, k = m.n_routed_experts, m.top_k
    b, s, d = x.shape
    mp = sizes[m_ax] if not isinstance(m_ax, tuple) else 0
    d_names = d_ax if isinstance(d_ax, tuple) else (d_ax,)
    dp = 1
    for a in d_names:
        dp *= sizes[a]
    if mp == 0 or e % mp != 0 or (b * s) % dp != 0 or d % dp != 0:
        return moe_fwd(p, cfg, x, capacity_factor, dropless)
    e_loc = e // mp
    t_loc = (b * s) // dp
    cap = t_loc if dropless else int(max(1, -(-t_loc * k * capacity_factor
                                              // e)))
    plain = not isinstance(x, DTensor)
    rep = [Replicate()] * mesh.ndim
    names = shlib.mesh_shape(mesh).axis_names
    # x: batch over data, replicated over model; the router replicated;
    # the experts over model (EP only)
    x_pl = shlib.placements(mesh, shlib.P(d_ax, None, None))
    ex_pl = shlib.placements(mesh, shlib.P(m_ax, None, None))
    split = shlib.split_dims_of(x_pl, ex_pl)
    x_blk = shlib.local_shard(x, mesh, x_pl, split)
    router = shlib.local_shard(p["router"], mesh, rep, split)
    wi_g, wi_u, wo = (shlib.local_shard(p["experts"][n], mesh, ex_pl, split)
                      for n in ("wi_gate", "wi_up", "wo"))
    mi = mesh.get_local_rank(m_ax)

    xf = x_blk.reshape(-1, d)
    # routing in f32 through an explicit cast, as the reference's
    logits = xf.to(torch.float32) @ router.to(torch.float32)
    w, idx = router_topk(logits, k, m.renormalize)
    aux = _balance_loss(logits, idx, e, k)
    part = _buffered(xf, w, idx, mi * e_loc, e_loc, cap, wi_g, wi_u, wo)

    # combine across experts in the residual dtype: a partial sum over
    # "model" reduced to a replicated one
    part_pl = list(x_pl)
    part_pl[names.index(m_ax)] = Partial()
    out = DTensor.from_local(part.to(x_blk.dtype).reshape(x_blk.shape), mesh,
                             part_pl, run_check=False).redistribute(mesh, x_pl)
    aux_pl = [Partial("avg") if n in d_names else Replicate() for n in names]
    aux = DTensor.from_local(aux, mesh, aux_pl,
                             run_check=False).redistribute(mesh, rep)
    if plain:
        out, aux = out.full_tensor(), aux.to_local()
    if "shared" in p:
        out = out + mlp_fwd(p["shared"], x)
    return out, aux


def decode_form(cfg: ModelConfig, t: int) -> bool:
    """Whether a decode step over ``t`` tokens takes the fixed-shape form:
    while its T·k gathered experts are no more than the experts held."""
    return t * cfg.moe.top_k <= cfg.moe.held


def decode_slot_counts(cfg: ModelConfig, t: int) -> Dict[str, int]:
    """The slot counters one layer's decode form adds over ``t`` tokens:
    all T·k slots are routed, and held where the chip holds every expert
    (elsewhere that takes a read of the routing, so it is not counted)."""
    n = t * cfg.moe.top_k
    if cfg.moe.held < cfg.moe.n_routed_experts:
        return {"moe.routed_slots": n}
    return {"moe.routed_slots": n, "moe.held_slots": n}


def _decode_fwd(p: Params, cfg: ModelConfig, xf: torch.Tensor
                ) -> torch.Tensor:
    """The decode form over the (T, d) tokens ``xf``: all T·k slots at
    once, each on its expert's gathered weights, with no host read. A
    slot routed to an expert not held takes the last held one's weights
    and a weight of 0."""
    m = cfg.moe
    t, d = xf.shape
    k = m.top_k
    with trace.span("moe.route"):
        logits = xf.to(torch.float32) @ p["router"].to(torch.float32)
        w, idx = router_topk(logits, k, m.renormalize)
    if trace.ON:
        for name, n in decode_slot_counts(cfg, t).items():
            trace.count(name, n)
    e = torch.clamp(idx, max=m.held - 1).reshape(-1)          # (T·k,)
    ex = p["experts"]
    h = xf[:, None].expand(t, k, d).reshape(t * k, 1, d)
    y = _expert_ffn(ex["wi_gate"][e], ex["wi_up"][e], ex["wo"][e], h)
    wk = torch.where(idx < m.held, w, 0.0).reshape(t * k, 1).to(xf.dtype)
    return (y[:, 0] * wk).view(t, k, d).sum(dim=1)


def moe_fwd(p: Params, cfg: ModelConfig, x: torch.Tensor,
            capacity_factor: float = CAPACITY_FACTOR,
            dropless: bool = False, decode: bool = False
            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """x: (B, S, d) -> (out, aux). aux is the Switch-style load-balance
    loss E · Σ_e frac_tokens_e · frac_probs_e (f32). ``decode`` (a decode
    step on plain tensors) takes the fixed-shape form where
    ``decode_form`` allows, dropless, and returns aux None: the decode
    step has no use for it."""
    if isinstance(x, DTensor):
        return _moe_fwd_mesh(p, cfg, x, capacity_factor, dropless)
    m = cfg.moe
    b, s, d = x.shape
    t, k, e = b * s, m.top_k, m.n_routed_experts
    xf = x.reshape(t, d)
    if decode and decode_form(cfg, t):
        out = _decode_fwd(p, cfg, xf)
        if "shared" in p:
            out = out + mlp_fwd(p["shared"], xf)
        return out.reshape(b, s, d).to(x.dtype), None

    with trace.span("moe.route"):
        logits = xf.to(torch.float32) @ p["router"].to(torch.float32)
        w, idx = router_topk(logits, k, m.renormalize)
        aux = _balance_loss(logits, idx, e, k)

        order, keep = dispatch(idx, capacity(t, k, e, capacity_factor,
                                             dropless))
        kept = order[keep]                  # flat slot ids, grouped by expert
        per_expert = torch.bincount(idx.reshape(-1)[kept], minlength=e)
        with trace.span("moe.host_read") as sp:
            runs = per_expert.tolist()
            if sp:
                trace.count("host_reads")
                trace.count("d2h_bytes", per_expert.nbytes)
        # the held experts' slots lead the expert-sorted order
        n_held = sum(runs[:m.held])
        if trace.ON:
            trace.count("moe.routed_slots", sum(runs))
            trace.count("moe.held_slots", n_held)

    ex = p["experts"]
    slots = xf.new_zeros((t * k, d))
    if n_held:
        ys = []
        start = 0
        for j, n in enumerate(runs[:m.held]):
            if n:
                h = xf[kept[start:start + n] // k]
                ys.append((F.silu(h @ ex["wi_gate"][j])
                           * (h @ ex["wi_up"][j])) @ ex["wo"][j])
                start += n
        mine = kept[:n_held]
        wk = w.reshape(-1)[mine].to(x.dtype)[:, None]
        slots.index_copy_(0, mine, torch.cat(ys) * wk)
    out = slots.view(t, k, d).sum(dim=1)
    if "shared" in p:
        out = out + mlp_fwd(p["shared"], xf)
    return out.reshape(b, s, d).to(x.dtype), aux

