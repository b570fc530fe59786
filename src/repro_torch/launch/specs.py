"""Input specs + sharding rules for every (architecture x shape) cell.

Counterpart of ``repro.launch.specs``. ``input_specs(cfg, model, shape,
mesh)`` returns ``meta`` tensors standing in for every model input (the
reference's ShapeDtypeStructs: shape and dtype, no allocation), and the
sharding helpers map params / optimizer state / caches / batches onto the
production mesh via path-pattern rules with divisibility guards (a mesh
axis is dropped from a dim that it does not divide — e.g. kv_heads=8 on a
16-way model axis replicates KV, Megatron-style).

The rules are pure Python over the mesh's axis names and sizes: ``mesh``
is a DeviceMesh or a ``sharding.MeshShape``, and each rule gives a
``sharding.NamedSharding`` whose ``spec`` is a ``PartitionSpec`` (one
entry per dim) and whose ``placements`` place a DTensor.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch.sharding import (
    NamedSharding, PartitionSpec as P, mesh_shape,
)
from repro_torch.models import Model
from repro_torch.training import tree as tree_lib

DATA = "data"
MODEL = "model"


def logical_axes(mesh) -> Dict[str, Any]:
    if "pod" in mesh_shape(mesh).axis_names:
        return {DATA: ("pod", "data"), MODEL: "model"}
    return {DATA: "data", MODEL: "model"}


def _axis_size(mesh, ax) -> int:
    if ax is None:
        return 1
    shape = mesh_shape(mesh).shape
    if isinstance(ax, (tuple, list)):
        n = 1
        for a in ax:
            n *= shape[a]
        return n
    return shape[ax]


def _guard(mesh, shape, spec) -> P:
    """Drop axes that don't divide their dim."""
    fixed = []
    for dim, ax in zip(shape, spec):
        if ax is not None and dim % _axis_size(mesh, ax) == 0 \
                and dim >= _axis_size(mesh, ax):
            fixed.append(ax)
        else:
            fixed.append(None)
    return P(*fixed)


def sharding(mesh, shape, *logical) -> NamedSharding:
    amap = logical_axes(mesh)
    spec = [amap.get(ax) if isinstance(ax, str) else ax for ax in logical]
    return NamedSharding(mesh, _guard(mesh, shape, spec))


# ---------------------------------------------------------------------------
# parameter sharding rules (path-pattern -> logical spec, leading-G aware)
# ---------------------------------------------------------------------------

# Patterns matched against "/"-joined tree paths of the LAST dims (the
# stacked group axis, if present, is detected by ndim mismatch and gets None).
_PARAM_RULES = [
    (r"embed$",                 (MODEL, DATA)),       # (V, d) vocab-parallel
    (r"lm_head$",               (DATA, MODEL)),
    (r"patch_proj$",            (DATA, MODEL)),
    # attention
    (r"attn/wq$|cross/wq$",     (DATA, MODEL)),
    (r"attn/wk$|cross/wk$",     (DATA, MODEL)),
    (r"attn/wv$|cross/wv$",     (DATA, MODEL)),
    (r"attn/wo$|cross/wo$",     (MODEL, DATA)),
    # MLA
    (r"attn/w_dkv$",            (DATA, None)),
    (r"attn/w_kr$",             (DATA, None)),
    (r"attn/w_uk$",             (None, MODEL)),
    (r"attn/w_uv$",             (None, MODEL)),
    # mlp
    (r"wi_gate$|wi_up$",        (DATA, MODEL)),
    (r"ffn/wo$|shared/wo$",     (MODEL, DATA)),
    # moe
    (r"router$",                (DATA, None)),
    (r"experts/wi_gate$|experts/wi_up$", (MODEL, DATA, None)),
    (r"experts/wo$",            (MODEL, None, DATA)),
    # mamba
    (r"mamba/in_proj$",         (DATA, MODEL)),
    (r"mamba/conv_w$",          (None, MODEL)),
    (r"mamba/conv_b$",          (MODEL,)),
    (r"mamba/x_proj$",          (MODEL, None)),
    (r"mamba/dt_proj$",         (None, MODEL)),
    (r"mamba/dt_bias$",         (MODEL,)),
    (r"mamba/a_log$",           (MODEL, None)),
    (r"mamba/d_skip$",          (MODEL,)),
    (r"mamba/out_proj$",        (MODEL, DATA)),
]


def _path_str(path) -> str:
    """A ``training.tree`` path (dict keys, list indices and named-tuple
    fields, each a string) joined with "/"."""
    return "/".join(str(p) for p in path)


def _spec_for_param(path_s: str, ndim: int) -> Tuple[Optional[str], ...]:
    for pat, spec in _PARAM_RULES:
        if re.search(pat, path_s):
            if ndim > len(spec):           # stacked group axis in front
                return (None,) * (ndim - len(spec)) + tuple(spec)
            if ndim < len(spec):
                return tuple(spec[-ndim:])
            return tuple(spec)
    return (None,) * ndim                  # norms, biases: replicate


def _map_with_path(fn, tree) -> Any:
    return tree_lib.unflatten(tree, [fn(path, leaf) for path, leaf in
                                     tree_lib.flatten_with_paths(tree)])


def param_shardings(params_shapes: Any, mesh, mode: str = "train") -> Any:
    """mode="train": FSDP x TP — weights sharded over (data, model); the
    per-layer all-gathers are amortized against optimizer-state sharding.
    mode="serve": TP only — weights replicated over data (inference holds
    no optimizer state, so FSDP would only add per-step weight all-gathers)."""
    amap = logical_axes(mesh)

    def one(path, leaf):
        ps = _path_str(path)
        spec = _spec_for_param(ps, len(leaf.shape))
        if mode == "serve":
            spec = tuple(None if ax == DATA else ax for ax in spec)
        mspec = [amap.get(ax) if isinstance(ax, str) else ax for ax in spec]
        return NamedSharding(mesh, _guard(mesh, leaf.shape, mspec))

    return _map_with_path(one, params_shapes)


def train_state_shardings(state_shapes, mesh):
    """Params rules apply to m/v (paths mirror params under opt/m, opt/v);
    Q8Tensor leaves ((nblocks, 64) + scales) shard their block dim on data."""
    amap = logical_axes(mesh)

    def one(path, leaf):
        ps = _path_str(path)
        if ps == "0" or ps.endswith("step"):
            return NamedSharding(mesh, P())
        if re.search(r"/(q|scale)$", ps):          # Q8Tensor leaves
            # blockwise state preserves the param's leading dims: mirror
            # the param rule (last dim becomes (blocks, 64) -> rule axis
            # stays on the block-count dim, packing dim unsharded), so
            # optimizer decode/encode stay shard-local.
            core = re.sub(r"/(q|scale)$", "", ps)
            pspec = _spec_for_param(core, max(1, len(leaf.shape) - 1))
            spec = tuple(pspec) + (None,)
            mspec = [amap.get(ax) if isinstance(ax, str) else ax
                     for ax in spec]
            return NamedSharding(mesh, _guard(mesh, leaf.shape, mspec))
        # strip the TrainState/AdamWState prefixes to match param rules
        core = re.sub(r"^(params|opt|m|v|\d+)(/|$)", "", ps)
        while re.match(r"^(params|opt|m|v|\d+)(/|$)", core):
            core = re.sub(r"^(params|opt|m|v|\d+)(/|$)", "", core)
        spec = _spec_for_param(core or ps, len(leaf.shape))
        mspec = [amap.get(ax) if isinstance(ax, str) else ax for ax in spec]
        return NamedSharding(mesh, _guard(mesh, leaf.shape, mspec))

    return _map_with_path(one, state_shapes)


# ---------------------------------------------------------------------------
# batch / cache specs per shape cell
# ---------------------------------------------------------------------------

def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def train_batch_specs(cfg: ModelConfig, shape: ShapeConfig, mesh
                      ) -> Tuple[Dict, Dict]:
    b, s = shape.global_batch, shape.seq_len
    specs: Dict[str, torch.Tensor] = {}
    shards: Dict[str, NamedSharding] = {}

    text_len = s - cfg.n_patches if cfg.n_patches else s
    specs["tokens"] = _meta((b, text_len), torch.int32)
    shards["tokens"] = sharding(mesh, (b, text_len), DATA, None)
    specs["labels"] = _meta((b, s), torch.int32)
    shards["labels"] = sharding(mesh, (b, s), DATA, None)
    if cfg.n_patches:
        sh = (b, cfg.n_patches, cfg.d_model)
        specs["patch_embeds"] = _meta(sh, torch.float32)
        shards["patch_embeds"] = sharding(mesh, sh, DATA, None, None)
    if cfg.is_encoder_decoder:
        sh = (b, cfg.n_frames, cfg.d_model)
        specs["frames"] = _meta(sh, torch.float32)
        shards["frames"] = sharding(mesh, sh, DATA, None, None)
    return specs, shards


_CACHE_RULES_DECODE = [
    # Decode KV is sharded along the SEQUENCE axis over "model"
    # (context-parallel flash-decode): attention over the sharded KV
    # reduces via tiny partial-softmax all-reduces instead of re-gathering
    # kv-head-sharded caches (kv_heads rarely divides |model|).
    (r"self/k$|self/v$|cross/k$|cross/v$", lambda: (DATA, MODEL, None, None)),
    (r"self/[kv]_(packed|scale|zero)$",    lambda: (DATA, MODEL, None, None)),
    (r"self/ckv$|self/krope$",             lambda: (DATA, MODEL, None)),
    (r"mamba/ssm$",                        lambda: (DATA, MODEL, None)),
    (r"mamba/conv$",                       lambda: (DATA, None, MODEL)),
]

_CACHE_RULES_LONG = [
    # batch=1: context parallelism — KV sequence over the whole mesh
    (r"self/k$|self/v$|cross/k$|cross/v$",
     lambda: (None, ("data", "model"), None, None)),
    (r"self/ckv$|self/krope$",             lambda: (None, ("data", "model"), None)),
    (r"mamba/ssm$",                        lambda: (None, MODEL, None)),
    (r"mamba/conv$",                       lambda: (None, None, MODEL)),
]


def cache_shardings(cache_shapes: Any, mesh, long_context: bool) -> Any:
    amap = logical_axes(mesh)
    rules = _CACHE_RULES_LONG if long_context else _CACHE_RULES_DECODE

    def one(path, leaf):
        ps = _path_str(path)
        spec: Tuple = ()
        for pat, builder in rules:
            if re.search(pat, ps):
                spec = builder()
                break
        if len(leaf.shape) > len(spec):
            spec = (None,) * (len(leaf.shape) - len(spec)) + tuple(spec)
        mspec = [amap.get(ax) if isinstance(ax, str) else ax for ax in spec]
        return NamedSharding(mesh, _guard(mesh, leaf.shape, mspec))

    return _map_with_path(one, cache_shapes)


def decode_specs(cfg: ModelConfig, model: Model, shape: ShapeConfig,
                 mesh, kv_bits: int = 16):
    """(input metas, input shardings) for decode_step(params, cache, idx,
    toks)."""
    b, s = shape.global_batch, shape.seq_len
    enc_len = cfg.n_frames if cfg.is_encoder_decoder else 0
    cache_shapes = model.init_cache(batch=b, capacity=s, device="meta",
                                    enc_len=enc_len, kv_bits=kv_bits)
    cache_sh = cache_shardings(cache_shapes, mesh,
                               long_context=(shape.name == "long_500k"))
    toks = _meta((b, 1), torch.int32)
    toks_sh = sharding(mesh, (b, 1), DATA, None)
    idx = _meta((), torch.int32)
    idx_sh = NamedSharding(mesh, P())
    return (cache_shapes, idx, toks), (cache_sh, idx_sh, toks_sh)


def prefill_batch_specs(cfg: ModelConfig, shape: ShapeConfig, mesh):
    return train_batch_specs(cfg, shape, mesh)   # same inputs minus labels


def input_specs(cfg: ModelConfig, model: Model, shape: ShapeConfig,
                mesh) -> Tuple[Tuple, Tuple]:
    """Unified entry: meta stand-ins + shardings for the cell's step
    function (train_step / prefill / decode_step)."""
    if shape.kind == "train":
        specs, shards = train_batch_specs(cfg, shape, mesh)
        return (specs,), (shards,)
    if shape.kind == "prefill":
        specs, shards = prefill_batch_specs(cfg, shape, mesh)
        specs.pop("labels")
        shards.pop("labels")
        return (specs,), (shards,)
    return decode_specs(cfg, model, shape, mesh)
