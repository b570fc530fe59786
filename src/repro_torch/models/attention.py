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
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from repro_torch.configs.base import AttnKind, ModelConfig
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
    reference's ``dynamic_update_slice`` clamps it."""
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
    q = (x @ p["wq"]).reshape(b, s, cfg.n_heads, hd)

    if kv_source is not None:
        # cross-attention; a cache, when given, holds the encoder's K/V
        if cache is not None:
            k, v = cache["k"], cache["v"]
        else:
            t = kv_source.shape[1]
            k = (kv_source @ p["wk"]).reshape(b, t, cfg.n_kv_heads, hd)
            v = (kv_source @ p["wv"]).reshape(b, t, cfg.n_kv_heads, hd)
        if cfg.qk_norm:
            q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        out = _gqa_scores_out(q, k, v, torch.zeros((), device=x.device))
        return out.reshape(b, s, -1) @ p["wo"], {"k": k, "v": v}

    k = (x @ p["wk"]).reshape(b, s, cfg.n_kv_heads, hd)
    v = (x @ p["wv"]).reshape(b, s, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta, cfg.rotary_pct)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.rotary_pct)

    decode = cache is not None and cur_index is not None and s == 1
    if decode:
        cap = cache["k"].shape[1]
        ck = _write_cache(cache["k"], k, cur_index)
        cv = _write_cache(cache["v"], v, cur_index)
        out = _gqa_scores_out(q, ck, cv, _decode_mask(cur_index, cap,
                                                      x.device))
        return out.reshape(b, 1, -1) @ p["wo"], {"k": ck, "v": cv}

    if s >= FLASH_THRESHOLD:
        out = _chunked_gqa(q, k, v, causal)
    else:
        mask = (_causal_mask(s, s, x.device) if causal
                else torch.zeros((), device=x.device))
        out = _gqa_scores_out(q, k, v, mask)
    new_cache = {"k": k, "v": v}  # prefill artifact
    return out.reshape(b, s, -1) @ p["wo"], new_cache


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
    q = (x @ p["wq"]).reshape(b, 1, cfg.n_heads, hd)
    k = (x @ p["wk"]).reshape(b, 1, cfg.n_kv_heads, hd)
    v = (x @ p["wv"]).reshape(b, 1, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta, cfg.rotary_pct)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.rotary_pct)

    for name, new in (("k", k), ("v", v)):
        for part, val in zip(("packed", "scale", "zero"),
                             _quant_token(new, bits)):
            _write_cache(cache[f"{name}_{part}"], val, cur_index)
    kd, vd = (_dequant_cache(cache[f"{n}_packed"], cache[f"{n}_scale"],
                             cache[f"{n}_zero"], bits, x.dtype)
              for n in ("k", "v"))
    mask = _decode_mask(cur_index, kd.shape[1], x.device)
    out = _gqa_scores_out(q, kd, vd, mask)
    return out.reshape(b, 1, -1) @ p["wo"], cache


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

    q = (x @ p["wq"]).reshape(b, s, h, nope + rope_d)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)

    ckv_new = rmsnorm(x @ p["w_dkv"], p["kv_norm"], cfg.norm_eps)  # (B,S,r)
    kr_new = apply_rope((x @ p["w_kr"])[:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0, :]              # (B,S,rope)

    w_uk = p["w_uk"].reshape(r, h, nope)
    w_uv = p["w_uv"].reshape(r, h, vd)

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
    if s >= FLASH_THRESHOLD:
        out = _chunked_mla(q_nope, q_rope, k_nope, kr_new, v, scale)
    else:
        sc = (torch.einsum("bshn,bthn->bhst", q_nope, k_nope)
              + torch.einsum("bshd,btd->bhst", q_rope, kr_new))
        sc = (sc.to(torch.float32) * scale
              + _causal_mask(s, s, x.device)[:, :, 0])
        pr = torch.softmax(sc, dim=-1).to(x.dtype)
        out = torch.einsum("bhst,bthv->bshv", pr, v)
    new_cache = {"ckv": ckv_new, "krope": kr_new}
    return out.reshape(b, s, -1) @ p["wo"], new_cache


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
