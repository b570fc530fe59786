"""Decoder-only LM with dense GQA attention and a gated MLP.

Counterpart of ``repro.models.transformer`` for the dense family (the
adaptcache-8b / Llama-3.1-8B shape and the other dense GQA configs). The
parameter and cache trees keep the reference's layout, so a JAX param
pytree carries across leaf for leaf (``convert.params_from_numpy``):

  params: {"embed": (V, d), "final_norm": (d,), "lm_head": (d, V),
           "prefix": [], "stack": [block]}  — block leaves stacked on a
           leading layer-group axis G = n_layers
  cache : {"prefix": [], "stack": [{"self": {"k": (G,B,C,Kv,hd), "v": ...}}]}

The reference scans over the stacked groups with ``lax.scan``; here a
Python loop walks them, indexing views of the stacked tensors. Prefill and
decode write K/V into the cache in place.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import AttnKind, FFNKind, LayerKind, ModelConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models.layers import Params, _dtype, mlp_fwd, rmsnorm

# the families whose layers this slice does not port yet (ROADMAP §A8)
_LATER = "ported by ROADMAP §A8 (the other model families)"


def check_supported(cfg: ModelConfig) -> None:
    """Raise for the model families the port does not have yet."""
    if cfg.attn_kind != AttnKind.GQA:
        raise NotImplementedError(f"{cfg.name}: MLA attention is {_LATER}")
    if cfg.ffn_kind == FFNKind.MOE or cfg.moe is not None:
        raise NotImplementedError(f"{cfg.name}: MoE FFN is {_LATER}")
    if any(k != LayerKind.ATTN for k in cfg.layer_kinds()):
        raise NotImplementedError(f"{cfg.name}: Mamba layers are {_LATER}")
    if cfg.is_encoder_decoder:
        raise NotImplementedError(f"{cfg.name}: encoder-decoder is {_LATER}")
    if cfg.n_patches:
        raise NotImplementedError(f"{cfg.name}: vision patches are {_LATER}")


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def param_shapes(cfg: ModelConfig) -> Params:
    """The parameter tree with shape tuples for leaves (no allocation)."""
    check_supported(cfg)
    d, hd, g = cfg.d_model, cfg.resolved_head_dim, cfg.n_layers
    attn = {"wq": (g, d, cfg.n_heads * hd), "wk": (g, d, cfg.n_kv_heads * hd),
            "wv": (g, d, cfg.n_kv_heads * hd), "wo": (g, cfg.n_heads * hd, d)}
    if cfg.qk_norm:
        attn["q_norm"] = (g, hd)
        attn["k_norm"] = (g, hd)
    block: Params = {"ln1": (g, d), "attn": attn}
    if cfg.ffn_kind != FFNKind.NONE:
        block["ln2"] = (g, d)
        block["ffn"] = {"wi_gate": (g, d, cfg.d_ff), "wi_up": (g, d, cfg.d_ff),
                        "wo": (g, cfg.d_ff, d)}
    p: Params = {"embed": (cfg.vocab_size, d), "final_norm": (d,)}
    if not cfg.tie_embeddings:
        p["lm_head"] = (d, cfg.vocab_size)
    p["prefix"] = []
    p["stack"] = [block]
    return p


def _map_leaves(fn, tree, path: Tuple[str, ...] = ()):
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_leaves(fn, v, path + (str(i),))
                for i, v in enumerate(tree)]
    return fn(path, tree)


def _leaves(tree) -> List[Any]:
    out: List[Any] = []
    _map_leaves(lambda _, leaf: out.append(leaf), tree)
    return out


def _is_norm(name: str) -> bool:
    return name.startswith("ln") or name.endswith("_norm")


def init_params(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """Random init on ``gen``'s device, with the reference's scheme:
    norms are ones, the embedding N(0, 0.02), every matrix N(0, 1/d_in)."""
    dtype = _dtype(cfg.param_dtype)

    def init(path, shape):
        name = path[-1]
        if _is_norm(name):
            return torch.ones(shape, dtype=dtype, device=gen.device)
        scale = 0.02 if name == "embed" else shape[-2] ** -0.5
        w = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=gen.device)
        return (w * scale).to(dtype)

    return _map_leaves(init, param_shapes(cfg))


def _group(tree, g: int):
    """Views of one layer group's slice of stacked leaves."""
    return _map_leaves(lambda _, leaf: leaf[g], tree)


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, capacity: int, device,
               kv_bits: int = 16) -> Params:
    """Zeroed decode cache mirroring the param stack layout."""
    check_supported(cfg)
    if kv_bits < 16:
        raise NotImplementedError(
            "the packed-uint8 decode cache is ported with the decode_attn "
            "kernel (ROADMAP §B3)")
    kv = attn_lib.init_cache(cfg, batch, capacity, _dtype(cfg.dtype), device,
                             lead=(cfg.n_layers,))
    return {"prefix": [], "stack": [{"self": kv}]}


# ---------------------------------------------------------------------------
# block application
# ---------------------------------------------------------------------------

def _apply_block(bp: Params, cfg: ModelConfig, x, positions,
                 cache_j: Optional[Params], cur_index, decode: bool):
    """One layer. Decode writes its K/V row into ``cache_j`` in place;
    prefill (a cache but no decode) copies its S rows into slots [0, S)."""
    h = rmsnorm(x, bp["ln1"], cfg.norm_eps)
    cj = None if cache_j is None else cache_j["self"]
    if decode:
        out, _ = attn_lib.attention_fwd(bp["attn"], cfg, h, positions,
                                        cache=cj, cur_index=cur_index)
    else:
        out, kv = attn_lib.attention_fwd(bp["attn"], cfg, h, positions)
        if cj is not None:
            s = kv["k"].shape[1]
            cj["k"][:, :s] = kv["k"].to(cj["k"].dtype)
            cj["v"][:, :s] = kv["v"].to(cj["v"].dtype)
    x = x + out
    if cfg.ffn_kind != FFNKind.NONE:
        h = rmsnorm(x, bp["ln2"], cfg.norm_eps)
        x = x + mlp_fwd(bp["ffn"], h)
    return x


def _run_stack(params: Params, cfg: ModelConfig, x, positions,
               cache: Optional[Params], cur_index, decode: bool):
    period = len(params["stack"])
    n_groups = cfg.n_layers // period
    for g in range(n_groups):
        for j in range(period):
            cj = None if cache is None else _group(cache["stack"][j], g)
            x = _apply_block(_group(params["stack"][j], g), cfg, x,
                             positions, cj, cur_index, decode)
    return x


# ---------------------------------------------------------------------------
# embeddings and heads
# ---------------------------------------------------------------------------

def embed_inputs(params: Params, cfg: ModelConfig,
                 batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    return params["embed"][batch["tokens"]].to(_dtype(cfg.dtype))


def lm_logits(params: Params, cfg: ModelConfig, x: torch.Tensor
              ) -> torch.Tensor:
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"].t() if cfg.tie_embeddings else params["lm_head"]
    return x @ head


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------

@torch.no_grad()
def prefill(params: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            capacity: int) -> Tuple[torch.Tensor, Params]:
    """Process the full prompt; return (last-position logits, decode cache).

    K/V of the S prompt tokens land in zeroed capacity-C buffers at slots
    [0, S) (C >= S)."""
    x = embed_inputs(params, cfg, batch)
    b, s, _ = x.shape
    if s > capacity:
        raise ValueError(f"prompt of {s} tokens exceeds capacity {capacity}")
    positions = torch.arange(s, device=x.device).expand(b, s)
    cache = init_cache(cfg, b, capacity, x.device)
    x = _run_stack(params, cfg, x, positions, cache, None, decode=False)
    return lm_logits(params, cfg, x[:, -1:, :]), cache


@torch.no_grad()
def decode_step(params: Params, cfg: ModelConfig, cache: Params,
                cur_index, tokens: torch.Tensor, position=None
                ) -> Tuple[torch.Tensor, Params]:
    """One-token decode. tokens: (B, 1) int.

    cur_index: cache WRITE SLOT — scalar (aligned batch) or (B,) per-lane
    (continuous batching / ragged sessions). position: optional RoPE
    position of the new token (defaults to cur_index); differs from the
    slot when the cache holds a token-dropped entry. The cache is updated
    in place and returned."""
    x = params["embed"][tokens].to(_dtype(cfg.dtype))
    b = tokens.shape[0]
    pos = cur_index if position is None else position
    if attn_lib._is_scalar(pos):
        positions = torch.full((b, 1), int(pos), dtype=torch.long,
                               device=x.device)
    else:
        positions = pos.to(x.device, torch.long)[:, None]
    x = _run_stack(params, cfg, x, positions, cache, cur_index, decode=True)
    return lm_logits(params, cfg, x), cache
