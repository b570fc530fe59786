"""Dense grouped-query attention (with qk-norm and partial rope).

Counterpart of the GQA half of ``repro.models.attention``. Two entry modes,
chosen by shape as in the reference:
  * full   — S tokens, causal mask; returns the S-token K/V it produced;
  * decode — S == 1 with a cache and ``cur_index``: writes the new K/V row
    at ``cur_index`` (scalar, or one slot per batch lane) and attends over
    the whole fixed-capacity cache with the visibility mask.

Cache layout: {"k": (B, C, n_kv, hd), "v": (B, C, n_kv, hd)}.

The reference's arrays are immutable and its decode returns a new cache;
here the decode write goes into the given cache tensors in place (the
returned dict holds the same tensors), which saves a copy of the cache on
every step. Attention itself is plain matmul and softmax, as the reference's
``_gqa_scores_out`` is plain jnp and no Pallas kernel.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import Params, apply_rope, rmsnorm

NEG_INF = -1e30

Index = Union[int, torch.Tensor]


def init_cache(cfg: ModelConfig, batch: int, capacity: int, dtype,
               device, lead: Tuple[int, ...] = ()) -> Params:
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
) -> Tuple[torch.Tensor, Params]:
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = (x @ p["wq"]).reshape(b, s, cfg.n_heads, hd)
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
