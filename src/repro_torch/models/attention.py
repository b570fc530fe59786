"""Attention: dense grouped-query attention (with qk-norm and partial rope),
MLA (DeepSeek's multi-head latent attention), cross-attention over an
encoder's memory, and one-token decode over a packed-uint8 quantized cache.

Counterpart of ``repro.models.attention``. Two entry modes, chosen by
shape as in the reference:
  * full   — S tokens, causal mask; returns the S-token cache rows it
    produced;
  * decode — S == 1 with a cache and ``cur_index``: writes the new row at
    ``cur_index`` (scalar, or one slot per batch lane) and attends over
    the whole fixed-capacity cache with the visibility mask.
``kv_source`` (the encoder's output, (B, T, d)) selects cross-attention:
K and V from ``kv_source`` or, when given, from the cache, only q's norm,
no RoPE and no mask; an MLA config takes the GQA form there too.

Cache layouts:
  GQA: {"k": (B, C, n_kv, hd), "v": (B, C, n_kv, hd)}
  MLA: {"ckv": (B, C, r), "krope": (B, C, rope_dim)} — the compressed
       latent, which AdaptCache's storage tier compresses further.
  quantized GQA (b bits, cpb = 8 // b codes a byte, packed along hd, low
       bits first): {"k_packed": (B, C, n_kv, hd/cpb) uint8,
       "k_scale"/"k_zero": (B, C, n_kv, 1) f32, "v_packed", "v_scale",
       "v_zero"} — each token quantized on write, per token and head.
MLA's full mode decompresses the latent into per-head K and V; its decode
uses the absorbed form (q folded through W_uk, the output through W_uv),
O(S·r) a head.

The reference's arrays are immutable and its decode returns a new cache;
here the decode write goes into the given cache tensors in place (the
returned dict holds the same tensors), which saves a copy of the cache on
every step. Attention itself is plain matmul and softmax, as the
reference's is plain jnp and no Pallas kernel.

Under a mesh the projections run on DTensors and ``constrain`` places q,
k and the decode cache at the reference's sites; the attention cores
(``_attend``, ``_mla_attend``) run on each rank's local shards: over
local heads, or, against a cache whose slots are sharded, context-parallel
with the softmax's max and sum all-reduced over the slots' shards.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.configs.base import AttnKind, ModelConfig
from repro_torch.launch.sharding import (
    _axis_size, constrain, on_local_shards, pin_grad, replicated,
    resolve_spec, unshard_unless_divides,
)
from repro_torch.models.layers import Params, apply_rope, rmsnorm

NEG_INF = -1e30

Index = Union[int, torch.Tensor]


def param_shapes(cfg: ModelConfig, lead: Tuple[int, ...] = (),
                 cross: bool = False) -> Params:
    """The layer's parameter shapes, with ``lead`` (the stacked layer
    groups) in front of each. Cross-attention (``cross``) takes the GQA
    shapes whatever the config's attention kind."""
    d, h, lead = cfg.d_model, cfg.n_heads, tuple(lead)
    if cfg.attn_kind == AttnKind.MLA and not cross:
        m = cfg.mla
        r, nope, rope = m.kv_lora_rank, m.qk_nope_head_dim, m.qk_rope_head_dim
        shapes = {"wq": (d, h * (nope + rope)), "w_dkv": (d, r),
                  "w_kr": (d, rope), "w_uk": (r, h * nope),
                  "w_uv": (r, h * m.v_head_dim), "wo": (h * m.v_head_dim, d),
                  "kv_norm": (r,)}
    else:
        hd, kv = cfg.resolved_head_dim, cfg.n_kv_heads
        shapes = {"wq": (d, h * hd), "wk": (d, kv * hd), "wv": (d, kv * hd),
                  "wo": (h * hd, d)}
        if cfg.qk_norm:
            shapes["q_norm"] = (hd,)
            shapes["k_norm"] = (hd,)
    return {k: lead + v for k, v in shapes.items()}


def init_cache(cfg: ModelConfig, batch: int, capacity: int, dtype,
               device, lead: Tuple[int, ...] = ()) -> Params:
    if cfg.attn_kind == AttnKind.MLA:
        m = cfg.mla
        shapes = {"ckv": m.kv_lora_rank, "krope": m.qk_rope_head_dim}
        return {name: torch.zeros(lead + (batch, capacity, n), dtype=dtype,
                                  device=device)
                for name, n in shapes.items()}
    hd = cfg.resolved_head_dim
    shape = lead + (batch, capacity, cfg.n_kv_heads, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# core GQA math
# ---------------------------------------------------------------------------

def _heads(t: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    """(B, S, n * hd) -> (B, S, n, hd); a DTensor sharded over more parts
    than ``n`` divides is replicated along that dim first."""
    b, s, _ = t.shape
    return unshard_unless_divides(t, -1, n).reshape(b, s, n, hd)


def _gqa_scores_out(q, k, v, mask):
    """q: (B,S,H,hd), k/v: (B,T,Kv,hd); mask: broadcastable to (B,1,1,S,T)."""
    b, s, h, hd = q.shape
    kv = k.shape[2]
    g = h // kv
    q = q.reshape(b, s, kv, g, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", q, k).to(torch.float32)
    scores = scores * (hd ** -0.5) + mask
    p = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkh->bskgh", p, v)
    return out.reshape(b, s, h, hd)


def _causal_mask(s: int, t: int, device, offset: int = 0) -> torch.Tensor:
    """(1,1,1,s,t) additive mask; query i attends keys j <= i + offset."""
    qi = torch.arange(s, device=device)[:, None] + offset
    kj = torch.arange(t, device=device)[None, :]
    return _additive(kj <= qi)[None, None, None]


def _additive(visible: torch.Tensor) -> torch.Tensor:
    return torch.where(visible, 0.0, NEG_INF).to(torch.float32)


# Above this sequence length the full path switches to query-chunked
# attention: S*S score matrices never materialize.
FLASH_THRESHOLD = 2048
FLASH_CHUNK = 512


def _chunked_gqa(q, k, v, causal: bool, chunk: int = FLASH_CHUNK):
    """Memory-efficient causal attention: a loop over query chunks.

    q: (B,S,H,hd), k/v: (B,S,Kv,hd). Peak score memory = B*H*chunk*S."""
    b, s, h, hd = q.shape
    kv = k.shape[2]
    g = h // kv
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of chunk {chunk}")
    kj = torch.arange(s, device=q.device)[None, :]
    outs = []
    for off in range(0, s, chunk):
        qb = q[:, off:off + chunk].reshape(b, chunk, kv, g, hd)
        scores = torch.einsum("bckgh,btkh->bkgct", qb, k).to(torch.float32)
        scores = scores * (hd ** -0.5)
        if causal:
            qi = off + torch.arange(chunk, device=q.device)[:, None]
            scores = scores + _additive(kj <= qi)[None, None, None]
        p = torch.softmax(scores, dim=-1).to(v.dtype)
        outs.append(torch.einsum("bkgct,btkh->bckgh", p, v))
    return torch.cat(outs, dim=1).reshape(b, s, h, hd)


def _merge_heads(out: torch.Tensor) -> torch.Tensor:
    """(B, S, H, hd) -> (B, S, H * hd); on a DTensor the gradient is kept
    at the forward's placements, so the backward's split of the merged dim
    never meets a shard count that H does not divide."""
    b, s = out.shape[:2]
    return pin_grad(out.reshape(b, s, -1))


def _attend(q, k, v, mask, causal: bool = True):
    """The GQA attention core: ``_gqa_scores_out`` over ``mask``, or the
    query-chunked ``_chunked_gqa`` where ``mask`` is None.

    Plain tensors go straight to it. DTensors run it on each rank's local
    shards, where DTensor cannot flatten the sharded batch and head dims
    an einsum's product flattens: over local heads when the keys' sequence
    is whole (the heads split over "model" when the KV heads divide, else
    replicated), or, when the keys' sequence is sharded (the decode cache,
    "seq_kv"), context-parallel: each rank attends over its own slots and
    the softmax's max and sum and the output are all-reduced over the
    sequence's shards."""
    if not isinstance(q, DTensor) and not isinstance(k, DTensor):
        if mask is None:
            return _chunked_gqa(q, k, v, causal)
        return _gqa_scores_out(q, k, v, mask)
    mesh = (k if isinstance(k, DTensor) else q).device_mesh
    if isinstance(k, DTensor) and any(p.is_shard(1) for p in k.placements):
        return _attend_context_parallel(q, k, v, mask)
    heads = "model"
    spec = resolve_spec(("model",))
    if spec is None or k.shape[2] % _axis_size(mesh, spec[0]):
        heads = None
    qkv = ("data", None, heads, None)
    if mask is None:
        return on_local_shards(lambda q, k, v: (_chunked_gqa(q, k, v,
                                                             causal),),
                               (qkv, qkv, qkv), (0,), q, k, v)[0]
    m_log = (("data",) if mask.ndim and mask.shape[0] > 1 else (None,)) \
        + (None,) * (mask.ndim - 1) if mask.ndim else ()
    return on_local_shards(lambda q, k, v, m: (_gqa_scores_out(q, k, v, m),),
                           (qkv, qkv, qkv, m_log), (0,), q, k, v, mask)[0]


def _attend_context_parallel(q, k, v, mask):
    """One query position against a cache whose slots are sharded: each
    rank scores its own slots, the max and the sum of the softmax are
    all-reduced over the slots' shards, and so are the weighted values."""
    mesh = k.device_mesh
    seq_dims = [i for i, p in enumerate(k.placements) if p.is_shard(1)]
    bat_dims = [i for i, p in enumerate(k.placements) if p.is_shard(0)]
    rep = [Replicate()] * mesh.ndim

    def place(t, dims_to):
        pl = list(rep)
        for i, d in dims_to:
            pl[i] = Shard(d)
        if not isinstance(t, DTensor):
            t = replicated(t, mesh)
        return t.redistribute(mesh, pl).to_local()

    batch = [(i, 0) for i in bat_dims]
    ql = place(q, batch)
    kl = place(k, batch + [(i, 1) for i in seq_dims])
    vl = place(v, batch + [(i, 1) for i in seq_dims])
    if mask.ndim:                   # (B or 1, 1, 1, 1, C): its slots too
        mb = batch if mask.shape[0] > 1 else []
        ml = place(mask, mb + [(i, mask.ndim - 1) for i in seq_dims])
    else:                           # a scalar (cross-attention): no mask
        ml = place(mask, [])

    def reduce(t, op):
        for i in seq_dims:
            t = funcol.all_reduce(t, op, (mesh, i))
        return t

    b, s, h, hd = ql.shape
    kv = kl.shape[2]
    qr = ql.reshape(b, s, kv, h // kv, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", qr, kl).to(torch.float32)
    scores = scores * (hd ** -0.5) + ml
    top = reduce(scores.amax(dim=-1, keepdim=True), "max")
    e = torch.exp(scores - top)
    p = (e / reduce(e.sum(dim=-1, keepdim=True), "sum")).to(vl.dtype)
    out = reduce(torch.einsum("bkgst,btkh->bskgh", p, vl), "sum")
    out = out.reshape(b, s, h, hd)
    pl = list(rep)
    for i in bat_dims:
        pl[i] = Shard(0)
    return DTensor.from_local(out, mesh, pl, run_check=False)


def _is_scalar(i: Index) -> bool:
    return not torch.is_tensor(i) or i.ndim == 0


def _decode_mask(cur_index: Index, capacity: int, device) -> torch.Tensor:
    """keys at slots <= cur_index are visible.

    cur_index: scalar -> (1,1,1,1,C) mask; vector (B,) -> (B,1,1,1,C)."""
    kj = torch.arange(capacity, device=device)
    if _is_scalar(cur_index):
        return _additive(kj <= cur_index)[None, None, None, None, :]
    vis = kj[None, :] <= cur_index.to(device)[:, None]        # (B, C)
    return _additive(vis)[:, None, None, None, :]


def _write_cache(buf: torch.Tensor, new: torch.Tensor,
                 cur_index: Index) -> torch.Tensor:
    """Write one new row per batch lane at slot cur_index, in place.

    buf: (B, C, ...); new: (B, 1, ...); cur_index scalar or (B,) int. A
    scalar slot past the end is clamped to the last one, as the
    reference's ``dynamic_update_slice`` clamps it. A DTensor's slot dim
    may be sharded, and a slice of a sharded dim is no view to write
    through: there the new row is selected in at its slot, elementwise,
    and the whole buffer copied in place."""
    if isinstance(buf, DTensor):
        c = buf.shape[1]
        kj = torch.arange(c, device=buf.device)
        if _is_scalar(cur_index):
            hit = (kj == torch.clamp(torch.as_tensor(cur_index), 0, c - 1)
                   if torch.is_tensor(cur_index)
                   else kj == min(max(int(cur_index), 0), c - 1))
            hit = hit.reshape((1, c) + (1,) * (buf.ndim - 2))
        else:
            hit = (kj[None, :] == cur_index[:, None]).reshape(
                (buf.shape[0], c) + (1,) * (buf.ndim - 2))
        buf.copy_(torch.where(hit, new.to(buf.dtype), buf))
        return buf
    if _is_scalar(cur_index):
        slot = min(max(int(cur_index), 0), buf.shape[1] - 1)
        buf[:, slot] = new[:, 0].to(buf.dtype)
        return buf
    b = buf.shape[0]
    lanes = torch.arange(b, device=buf.device)
    buf[lanes, cur_index.to(buf.device, torch.long)] = new[:, 0].to(buf.dtype)
    return buf


# ---------------------------------------------------------------------------
# GQA forward
# ---------------------------------------------------------------------------

def attention_fwd(
    p: Params,
    cfg: ModelConfig,
    x: torch.Tensor,                      # (B, S, d)
    positions: torch.Tensor,              # (B, S) int
    cache: Optional[Params] = None,
    cur_index: Optional[Index] = None,    # decode mode when S==1 & cache
    causal: bool = True,
    kv_source: Optional[torch.Tensor] = None,  # cross-attention memory
) -> Tuple[torch.Tensor, Params]:
    if cfg.attn_kind == AttnKind.MLA and kv_source is None:
        return mla_fwd(p, cfg, x, positions, cache, cur_index)
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = _heads(x @ p["wq"], cfg.n_heads, hd)

    if kv_source is not None:
        # cross-attention; a cache, when given, holds the encoder's K/V
        if cache is not None:
            k, v = cache["k"], cache["v"]
        else:
            t = kv_source.shape[1]
            k = _heads(kv_source @ p["wk"], cfg.n_kv_heads, hd)
            v = _heads(kv_source @ p["wv"], cfg.n_kv_heads, hd)
        if cfg.qk_norm:
            q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        out = _attend(q, k, v, torch.zeros((), device=x.device))
        return _merge_heads(out) @ p["wo"], {"k": k, "v": v}

    k = _heads(x @ p["wk"], cfg.n_kv_heads, hd)
    v = _heads(x @ p["wv"], cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta, cfg.rotary_pct)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.rotary_pct)
    q = constrain(q, ("data", None, "model", None))
    k = constrain(k, ("data", None, "model", None))

    decode = cache is not None and cur_index is not None and s == 1
    if decode:
        cap = cache["k"].shape[1]
        ck = _write_cache(cache["k"], k, cur_index)
        cv = _write_cache(cache["v"], v, cur_index)
        ck = constrain(ck, ("data", "seq_kv", "model", None))
        cv = constrain(cv, ("data", "seq_kv", "model", None))
        out = _attend(q, ck, cv, _decode_mask(cur_index, cap, x.device))
        return _merge_heads(out) @ p["wo"], {"k": ck, "v": cv}

    if s >= FLASH_THRESHOLD:
        out = _attend(q, k, v, None, causal=causal)
    else:
        mask = (_causal_mask(s, s, x.device) if causal
                else torch.zeros((), device=x.device))
        out = _attend(q, k, v, mask)
    new_cache = {"k": k, "v": v}  # prefill artifact
    return _merge_heads(out) @ p["wo"], new_cache


# ---------------------------------------------------------------------------
# quantized-KV decode (the reference's serve_step_quantized data plane)
# ---------------------------------------------------------------------------
#
# Eager torch, as the reference's is eager jnp: each new token is
# quantized on write (asymmetric, per token and head over hd) and the whole
# cache is dequantized for the step. The decode_attn kernel reads another
# layout (K packed along tokens) and is not used here.

def init_quantized_cache(cfg: ModelConfig, batch: int, capacity: int,
                         device, bits: int = 4,
                         lead: Tuple[int, ...] = ()) -> Params:
    hd = cfg.resolved_head_dim
    shape_p = lead + (batch, capacity, cfg.n_kv_heads, hd // (8 // bits))
    shape_s = lead + (batch, capacity, cfg.n_kv_heads, 1)
    cache = {}
    for x in ("k", "v"):
        cache[f"{x}_packed"] = torch.zeros(shape_p, dtype=torch.uint8,
                                           device=device)
        for name in ("scale", "zero"):
            cache[f"{x}_{name}"] = torch.zeros(shape_s, dtype=torch.float32,
                                               device=device)
    return cache


def _quant_token(x: torch.Tensor, bits: int):
    """x: (B, 1, Kv, hd) -> packed (B, 1, Kv, hd/cpb) uint8, scale, zero
    (B, 1, Kv, 1) f32. Codes round half to even; torch shifts no uint32,
    so they are packed in int32 and stored as uint8."""
    cpb = 8 // bits
    xf = x.to(torch.float32)
    zero = xf.amin(dim=-1, keepdim=True)
    scale = (xf.amax(dim=-1, keepdim=True) - zero) / (2 ** bits - 1)
    safe = torch.where(scale > 0, scale, 1.0)
    q = torch.clamp(torch.round((xf - zero) / safe), 0, 2 ** bits - 1)
    q = q.to(torch.int32).reshape(*x.shape[:-1], x.shape[-1] // cpb, cpb)
    shifts = torch.arange(cpb, dtype=torch.int32, device=x.device) * bits
    packed = (q << shifts).sum(dim=-1).to(torch.uint8)
    return packed, scale, zero


def _dequant_cache(packed, scale, zero, bits: int, dtype):
    """codes * scale + zero, a multiply and an add (two roundings, as the
    reference's eager ops round them), in ``dtype``."""
    cpb = 8 // bits
    p = packed.to(torch.int32)[..., None]
    shifts = torch.arange(cpb, dtype=torch.int32, device=p.device) * bits
    codes = ((p >> shifts) & (2 ** bits - 1)).to(torch.float32)
    codes = codes.reshape(*packed.shape[:-1], packed.shape[-1] * cpb)
    return (codes * scale + zero).to(dtype)


def attention_fwd_quantized(p: Params, cfg: ModelConfig, x: torch.Tensor,
                            positions: torch.Tensor, cache: Params,
                            cur_index: Index) -> Tuple[torch.Tensor, Params]:
    """One-token GQA decode over a packed-uint8 KV cache, written in
    place."""
    b, s, _ = x.shape
    if s != 1:
        raise ValueError(f"quantized decode takes one token, not {s}")
    hd = cfg.resolved_head_dim
    bits = 8 // (hd // cache["k_packed"].shape[-1])   # from the packing
    q = _heads(x @ p["wq"], cfg.n_heads, hd)
    k = _heads(x @ p["wk"], cfg.n_kv_heads, hd)
    v = _heads(x @ p["wv"], cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta, cfg.rotary_pct)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.rotary_pct)

    for name, new in (("k", k), ("v", v)):
        for part, val in zip(("packed", "scale", "zero"),
                             _quant_token(new, bits)):
            _write_cache(cache[f"{name}_{part}"], val, cur_index)
    # keep the whole unpack chain sequence-sharded, as the reference does
    spec = ("data", "seq_kv", "model", None)
    kd = _dequant_cache(constrain(cache["k_packed"], spec),
                        constrain(cache["k_scale"], spec),
                        constrain(cache["k_zero"], spec), bits, x.dtype)
    vd = _dequant_cache(constrain(cache["v_packed"], spec),
                        constrain(cache["v_scale"], spec),
                        constrain(cache["v_zero"], spec), bits, x.dtype)
    kd = constrain(kd, spec)
    vd = constrain(vd, spec)
    mask = _decode_mask(cur_index, kd.shape[1], x.device)
    out = _attend(q, kd, vd, mask)
    return _merge_heads(out) @ p["wo"], cache


# ---------------------------------------------------------------------------
# MLA forward
# ---------------------------------------------------------------------------

def mla_fwd(
    p: Params,
    cfg: ModelConfig,
    x: torch.Tensor,
    positions: torch.Tensor,
    cache: Optional[Params] = None,
    cur_index: Optional[Index] = None,
) -> Tuple[torch.Tensor, Params]:
    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.n_heads
    nope, rope_d, vd, r = (m.qk_nope_head_dim, m.qk_rope_head_dim,
                           m.v_head_dim, m.kv_lora_rank)
    scale = (nope + rope_d) ** -0.5

    q = _heads(x @ p["wq"], h, nope + rope_d)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)

    ckv_new = rmsnorm(x @ p["w_dkv"], p["kv_norm"], cfg.norm_eps)  # (B,S,r)
    kr_new = apply_rope((x @ p["w_kr"])[:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0, :]              # (B,S,rope)

    w_uk = unshard_unless_divides(p["w_uk"], 1, h).reshape(r, h, nope)
    w_uv = unshard_unless_divides(p["w_uv"], 1, h).reshape(r, h, vd)

    decode = cache is not None and cur_index is not None and s == 1
    if decode:
        cap = cache["ckv"].shape[1]
        ckv = _write_cache(cache["ckv"], ckv_new, cur_index)
        krope = _write_cache(cache["krope"], kr_new, cur_index)
        # absorbed form: W_uk folded into q, W_uv applied to the weighted
        # latent sum
        q_abs = torch.einsum("bshn,rhn->bshr", q_nope, w_uk)      # (B,1,H,r)
        sc = (torch.einsum("bshr,btr->bhst", q_abs, ckv)
              + torch.einsum("bshd,btd->bhst", q_rope, krope))
        sc = (sc.to(torch.float32) * scale
              + _decode_mask(cur_index, cap, x.device)[:, :, 0])
        pr = torch.softmax(sc, dim=-1).to(x.dtype)
        lat = torch.einsum("bhst,btr->bshr", pr, ckv)             # (B,1,H,r)
        out = torch.einsum("bshr,rhv->bshv", lat, w_uv)
        return out.reshape(b, 1, -1) @ p["wo"], {"ckv": ckv, "krope": krope}

    # full (train / prefill): the decompressed form
    k_nope = torch.einsum("bsr,rhn->bshn", ckv_new, w_uk)
    v = torch.einsum("bsr,rhv->bshv", ckv_new, w_uv)
    out = _mla_attend(q_nope, q_rope, k_nope, kr_new, v, scale)
    new_cache = {"ckv": ckv_new, "krope": kr_new}
    return _merge_heads(out) @ p["wo"], new_cache


def _mla_core(q_nope, q_rope, k_nope, k_rope, v, scale):
    """Causal MLA attention of the decompressed form: query-chunked from
    ``FLASH_THRESHOLD`` tokens on."""
    s = q_nope.shape[1]
    if s >= FLASH_THRESHOLD:
        return _chunked_mla(q_nope, q_rope, k_nope, k_rope, v, scale)
    sc = (torch.einsum("bshn,bthn->bhst", q_nope, k_nope)
          + torch.einsum("bshd,btd->bhst", q_rope, k_rope))
    sc = (sc.to(torch.float32) * scale
          + _causal_mask(s, s, q_nope.device)[:, :, 0])
    pr = torch.softmax(sc, dim=-1).to(v.dtype)
    return torch.einsum("bhst,bthv->bshv", pr, v)


def _mla_attend(q_nope, q_rope, k_nope, k_rope, v, scale):
    """``_mla_core``; DTensors on each rank's local shards, as
    ``_attend`` runs GQA's: the batch over "data", the heads over "model"
    where they divide it (the shared rope key replicated over "model")."""
    if not isinstance(q_nope, DTensor):
        return _mla_core(q_nope, q_rope, k_nope, k_rope, v, scale)
    spec = resolve_spec(("model",))
    heads = "model"
    if spec is None or q_nope.shape[2] % _axis_size(q_nope.device_mesh,
                                                     spec[0]):
        heads = None
    bshd = ("data", None, heads, None)
    return on_local_shards(
        lambda *a: (_mla_core(*a, scale),),
        (bshd, bshd, bshd, ("data", None, None), bshd), (0,),
        q_nope, q_rope, k_nope, k_rope, v)[0]


def _chunked_mla(q_nope, q_rope, k_nope, k_rope, v, scale,
                 chunk: int = FLASH_CHUNK):
    """Query-chunked causal MLA attention. q_nope: (B,S,H,n)."""
    b, s, h, _ = q_nope.shape
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of chunk {chunk}")
    kj = torch.arange(s, device=q_nope.device)[None, :]
    outs = []
    for off in range(0, s, chunk):
        sl = slice(off, off + chunk)
        sc = (torch.einsum("bchn,bthn->bhct", q_nope[:, sl], k_nope)
              + torch.einsum("bchd,btd->bhct", q_rope[:, sl], k_rope)
              ).to(torch.float32) * scale
        qi = off + torch.arange(chunk, device=q_nope.device)[:, None]
        sc = sc + _additive(kj <= qi)[None, None]
        pr = torch.softmax(sc, dim=-1).to(v.dtype)
        outs.append(torch.einsum("bhct,bthv->bchv", pr, v))
    return torch.cat(outs, dim=1)
