"""The LM backbone: GQA or MLA attention, or Mamba-1 blocks, each with a
gated MLP or a mixture-of-experts FFN; an encoder-decoder form and
vision patches.

Counterpart of ``repro.models.transformer`` for every family of the
registry: dense GQA (adaptcache-8b, the Llama-3.1-8B shape, and the other
dense configs), MoE (olmoe; deepseek-v2-lite, with MLA and a dense first
layer), pure SSM (falcon-mamba), the Mamba/attention hybrid with MoE
(jamba), the encoder-decoder (seamless-m4t: a bidirectional encoder over
stub frame embeddings, decoder blocks with cross-attention) and the VLM
(internvl2: stub patch embeddings projected and prepended to the
tokens). The parameter and cache trees keep the reference's layout, so a
JAX param pytree carries across leaf for leaf (``convert.params_from_numpy``):

  params: {"embed": (V, d), "final_norm": (d,), "lm_head": (d, V),
           "prefix": [block, ...], "stack": [block, ...],
           "enc_stack": enc block, "enc_norm": (d,), "patch_proj": (d, d)}
           — the prefix holds the layers whose structure differs from the
           repeating pattern (deepseek's dense first layer), unstacked; the
           stack one block per position of the layer pattern, its leaves
           stacked on a leading layer-group axis G. An attention block is
           {"ln1", "attn"[, "ln_cross", "cross"][, "ln2", "ffn" or
           "ffn_moe"]}, a mamba block {"ln1", "mamba"[, "ln2", "ffn" or
           "ffn_moe"]}. The encoder-decoder's ``enc_stack`` is one dict
           {"ln1", "attn", "ln2", "ffn"} with leaves stacked on the encoder
           layers; ``patch_proj`` is there when the config has patches.
  cache : {"prefix": [{"self": {"ckv": (B,C,r), "krope": (B,C,rope)}}, ...],
           "stack": [{"self": {"k": (G,B,C,Kv,hd), "v"} or {"ckv", "krope"}
           or the packed quantized form (``kv_bits`` < 16, GQA only)}
           or {"mamba": {"conv": (G,B,c-1,d_in), "ssm": (G,B,d_in,n)}}]};
           an encoder-decoder's blocks also hold "cross": {"k", "v"} of
           (G,B,T_enc,Kv,hd), written whole by the prefill.

The reference scans over the stacked groups with ``lax.scan``; here a
Python loop walks them, indexing views of the stacked tensors, after the
prefix layers. Prefill and decode write the cache in place.

Training (``forward_train``, ``loss_fn``) splits each stacked leaf once a
step with ``unbind``: indexing ``leaf[g]`` a layer would, in backward, add a
zero tensor of the whole stack into the gradient once a layer, where
``unbind``'s backward stacks the layers' gradients once. Remat wraps each
layer group in ``torch.utils.checkpoint`` (the reference: ``jax.checkpoint``
on the scanned group body), which changes memory, not the numbers; the
encoder runs without it, as the reference's encoder scan does. The MoE
layers' load-balance losses are summed over the layers in order, and
training's MoE drops slots past each expert's capacity, as the
reference's does; prefill and decode are dropless.

Under a mesh (``launch.sharding.use_mesh``) the same code runs on
DTensors: ``constrain`` at the reference's sites redistributes the
activations, the MoE layers take ``moe_fwd_ep``, the embedding lookup is
vocab-parallel on local shards (``_embed``), and prefill and decode write
their DTensor caches elementwise (``_write_rows``,
``attention._write_cache``). With no mesh, or on plain tensors, each of
these is the plain code.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import AttnKind, FFNKind, LayerKind, ModelConfig
from repro_torch.launch import sharding as shlib
from repro_torch.launch.sharding import constrain
from repro_torch.models import attention as attn_lib
from repro_torch.models import mamba as mamba_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models.layers import Params, _dtype, mlp_fwd, rmsnorm

def _prefix_count(cfg: ModelConfig) -> int:
    """Layers whose tree structure differs from the stacked groups'."""
    if cfg.moe is not None and cfg.moe.first_k_dense > 0:
        return cfg.moe.first_k_dense
    return 0


def _pattern(cfg: ModelConfig) -> Tuple[Tuple[LayerKind, ...], int]:
    """(the layer kinds of one stacked group, the number of groups): the
    groups cover the layers after the prefix."""
    npre = _prefix_count(cfg)
    period = len(cfg.block_group()[0])
    n_scan = cfg.n_layers - npre
    if n_scan % period:
        raise ValueError(f"{cfg.name}: {n_scan} layers after the prefix are "
                         f"not whole groups of {period}")
    return cfg.layer_kinds()[npre:npre + period], n_scan // period


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def _block_shapes(cfg: ModelConfig, layer: int,
                  lead: Tuple[int, ...]) -> Params:
    """Layer ``layer``'s parameter shapes, ``lead`` in front of each."""
    d = cfg.d_model
    if cfg.layer_kinds()[layer] == LayerKind.MAMBA:
        blk: Params = {"ln1": lead + (d,),
                       "mamba": mamba_lib.param_shapes(cfg, lead)}
    else:
        blk = {"ln1": lead + (d,), "attn": attn_lib.param_shapes(cfg, lead)}
    if cfg.is_encoder_decoder:
        blk["ln_cross"] = lead + (d,)
        blk["cross"] = attn_lib.param_shapes(cfg, lead, cross=True)
    if cfg.ffn_kind != FFNKind.NONE:
        blk["ln2"] = lead + (d,)
        if cfg.uses_moe_at(layer):
            blk["ffn_moe"] = moe_lib.param_shapes(cfg, lead)
        else:
            ff = cfg.d_ff
            if cfg.moe is not None and layer < cfg.moe.first_k_dense:
                ff = cfg.moe.dense_d_ff or cfg.d_ff
            blk["ffn"] = _mlp_shapes(d, ff, lead)
    return blk


def _mlp_shapes(d: int, ff: int, lead: Tuple[int, ...]) -> Params:
    return {"wi_gate": lead + (d, ff), "wi_up": lead + (d, ff),
            "wo": lead + (ff, d)}


def param_shapes(cfg: ModelConfig) -> Params:
    """The parameter tree with shape tuples for leaves (no allocation).
    Each stacked position takes the structure of its first group's layer,
    as the reference's vmapped init does; every group must agree."""
    npre = _prefix_count(cfg)
    pattern, g = _pattern(cfg)
    period = len(pattern)
    for i in range(npre, cfg.n_layers):
        j = npre + (i - npre) % period
        if cfg.uses_moe_at(i) != cfg.uses_moe_at(j):
            raise ValueError(f"{cfg.name}: layer {i} and layer {j} share a "
                             "stacked position but not its FFN kind")
    d = cfg.d_model
    p: Params = {"embed": (cfg.vocab_size, d), "final_norm": (d,)}
    if not cfg.tie_embeddings:
        p["lm_head"] = (d, cfg.vocab_size)
    p["prefix"] = [_block_shapes(cfg, i, ()) for i in range(npre)]
    p["stack"] = [_block_shapes(cfg, npre + j, (g,)) for j in range(period)]
    if cfg.is_encoder_decoder:
        lead = (cfg.n_enc_layers,)
        p["enc_stack"] = {"ln1": lead + (d,),
                          "attn": attn_lib.param_shapes(cfg, lead, cross=True),
                          "ln2": lead + (d,),
                          "ffn": _mlp_shapes(d, cfg.d_ff, lead)}
        p["enc_norm"] = (d,)
    if cfg.n_patches:
        p["patch_proj"] = (d, d)
    return p


def param_dtype(cfg: ModelConfig, name: str) -> torch.dtype:
    """The dtype of leaf ``name``: the config's param dtype, except the
    mamba leaves the reference keeps in f32."""
    if name in mamba_lib.F32_LEAVES:
        return torch.float32
    return _dtype(cfg.param_dtype)


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
    norms are ones, the embedding N(0, 0.02), every attention, MLP, router
    and expert matrix N(0, 1/d_in); mamba leaves as
    ``mamba.init_mamba_leaf``. The experts' stacks are drawn one matrix at
    a time, so no f32 copy of a whole stack exists."""
    dtype = _dtype(cfg.param_dtype)

    def init(path, shape):
        name = path[-1]
        if "mamba" in path:
            return mamba_lib.init_mamba_leaf(gen, cfg, name, shape, dtype)
        if _is_norm(name):
            return torch.ones(shape, dtype=dtype, device=gen.device)
        scale = 0.02 if name == "embed" else shape[-2] ** -0.5
        if "experts" in path:
            out = torch.empty(shape, dtype=dtype, device=gen.device)
            for mat in out.view((-1,) + tuple(shape[-2:])):
                mat.copy_(torch.randn(mat.shape, generator=gen,
                                      device=gen.device) * scale)
            return out
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
               enc_len: int = 0, kv_bits: int = 16) -> Params:
    """Zeroed decode cache mirroring the param stack layout.

    An encoder-decoder's blocks get a cross cache of ``enc_len`` rows.
    ``kv_bits`` < 16 builds the packed-uint8 quantized cache for GQA
    attention layers; MLA latents and SSM states stay full precision, as
    in the reference."""
    dtype = _dtype(cfg.dtype)
    pattern, g = _pattern(cfg)
    kinds = cfg.layer_kinds()

    def block(kind: LayerKind, lead: Tuple[int, ...]) -> Params:
        if kind == LayerKind.MAMBA:
            c = {"mamba": mamba_lib.init_mamba_cache(cfg, batch, dtype,
                                                     device, lead=lead)}
        elif kv_bits < 16 and cfg.attn_kind == AttnKind.GQA:
            c = {"self": attn_lib.init_quantized_cache(
                cfg, batch, capacity, device, bits=kv_bits, lead=lead)}
        else:
            c = {"self": attn_lib.init_cache(cfg, batch, capacity, dtype,
                                             device, lead=lead)}
        if cfg.is_encoder_decoder:
            shape = lead + (batch, enc_len, cfg.n_kv_heads,
                            cfg.resolved_head_dim)
            c["cross"] = {name: torch.zeros(shape, dtype=dtype, device=device)
                          for name in ("k", "v")}
        return c

    return {"prefix": [block(kinds[i], ()) for i in range(_prefix_count(cfg))],
            "stack": [block(kind, (g,)) for kind in pattern]}


# ---------------------------------------------------------------------------
# block application
# ---------------------------------------------------------------------------

def _apply_block(bp: Params, cfg: ModelConfig, kind: LayerKind, x,
                 positions, cache_j: Optional[Params], cur_index, enc_out,
                 decode: bool, moe_dropless: bool = False):
    """One layer; returns (x, the MoE balance loss or None). Decode updates
    ``cache_j`` in place (an attention layer writes its cache row, or its
    packed quantized row, a mamba layer its conv window and state);
    prefill (a cache but no decode) copies its S cache rows into slots
    [0, S), or a mamba layer's final conv window and state. A block with
    cross-attention attends over ``enc_out``'s K/V, which the prefill
    writes whole into the cross cache, or, in decode, over the cached
    ones. The MoE FFN is dropless under decode or ``moe_dropless``; a
    decode without a mesh takes its fixed-shape form where
    ``moe.decode_form`` allows, whose balance loss is None."""
    h = rmsnorm(x, bp["ln1"], cfg.norm_eps)
    if kind == LayerKind.MAMBA:
        cm = None if cache_j is None else cache_j["mamba"]
        if decode:
            out, _ = mamba_lib.mamba_fwd(bp["mamba"], cfg, h, cache=cm,
                                         decode=True)
        else:
            out, new = mamba_lib.mamba_fwd(bp["mamba"], cfg, h)
            if cm is not None:
                cm["conv"].copy_(new["conv"])
                cm["ssm"].copy_(new["ssm"])
    else:
        cj = None if cache_j is None else cache_j["self"]
        if decode and cj is not None and "k_packed" in cj:
            out, _ = attn_lib.attention_fwd_quantized(
                bp["attn"], cfg, h, positions, cj, cur_index)
        elif decode:
            out, _ = attn_lib.attention_fwd(bp["attn"], cfg, h, positions,
                                            cache=cj, cur_index=cur_index)
        else:
            out, rows = attn_lib.attention_fwd(bp["attn"], cfg, h, positions)
            if cj is not None:
                for name, val in rows.items():
                    _write_rows(cj[name], val)
    x = x + out
    x = constrain(x, ("data", None, None))

    cc = None if cache_j is None else cache_j.get("cross")
    if "cross" in bp and (enc_out is not None or cc is not None):
        h = rmsnorm(x, bp["ln_cross"], cfg.norm_eps)
        cached = decode and cc is not None
        # with the cache's K/V, kv_source only selects cross-attention
        src = enc_out if enc_out is not None else x.new_zeros(
            (x.shape[0], 1, cfg.d_model))
        out, kv = attn_lib.attention_fwd(bp["cross"], cfg, h, positions,
                                         cache=cc if cached else None,
                                         kv_source=src)
        if cc is not None and not cached:
            for name, val in kv.items():
                cc[name].copy_(val)
        x = x + out

    aux = None
    if cfg.ffn_kind != FFNKind.NONE:
        h = rmsnorm(x, bp["ln2"], cfg.norm_eps)
        if "ffn_moe" in bp and shlib._rules() is not None:
            out, aux = moe_lib.moe_fwd_ep(bp["ffn_moe"], cfg, h,
                                          dropless=moe_dropless or decode)
        elif "ffn_moe" in bp:
            out, aux = moe_lib.moe_fwd(bp["ffn_moe"], cfg, h,
                                       dropless=moe_dropless or decode,
                                       decode=decode)
        else:
            out = mlp_fwd(bp["ffn"], h)
        x = x + out
        x = constrain(x, ("data", None, None))
    return x, aux


def _write_rows(buf: torch.Tensor, val: torch.Tensor) -> None:
    """Slots [0, S) of the (B, C, ...) cache ``buf`` take the prefill's
    (B, S, ...) rows ``val``, in place. A DTensor's slot dim may be
    sharded, and a slice of a sharded dim is no view to write through:
    there the rows are selected in, elementwise, and the whole buffer
    copied in place."""
    s, c = val.shape[1], buf.shape[1]
    val = val.to(buf.dtype)
    if not isinstance(buf, DTensor):
        buf[:, :s] = val
    elif s == c:
        buf.copy_(val)
    else:
        pad = torch.zeros((val.shape[0], c - s) + tuple(val.shape[2:]),
                          dtype=buf.dtype, device=buf.device)
        hit = (torch.arange(c, device=buf.device) < s).reshape(
            (1, c) + (1,) * (buf.ndim - 2))
        buf.copy_(torch.where(hit, torch.cat([val, pad], dim=1), buf))


def _with_aux(total: torch.Tensor, aux: Optional[torch.Tensor]):
    return total if aux is None else total + aux


def _run_prefix(params: Params, cfg: ModelConfig, x, positions,
                cache: Optional[Params], cur_index, enc_out, decode: bool,
                moe_dropless: bool):
    """The unstacked prefix layers; returns (x, their MoE balance losses
    summed)."""
    kinds = cfg.layer_kinds()
    aux = x.new_zeros((), dtype=torch.float32)
    for i, bp in enumerate(params["prefix"]):
        cj = None if cache is None else cache["prefix"][i]
        x, a = _apply_block(bp, cfg, kinds[i], x, positions, cj, cur_index,
                            enc_out, decode, moe_dropless)
        aux = _with_aux(aux, a)
    return x, aux


def _run_stack(params: Params, cfg: ModelConfig, x, positions,
               cache: Optional[Params], cur_index, enc_out, decode: bool,
               moe_dropless: bool = False):
    """The prefix layers, then the stacked groups; returns (x, the MoE
    balance losses summed over the layers)."""
    x, aux = _run_prefix(params, cfg, x, positions, cache, cur_index,
                         enc_out, decode, moe_dropless)
    pattern, n_groups = _pattern(cfg)
    for g in range(n_groups):
        for j, kind in enumerate(pattern):
            cj = None if cache is None else _group(cache["stack"][j], g)
            x, a = _apply_block(_group(params["stack"][j], g), cfg, kind, x,
                                positions, cj, cur_index, enc_out, decode,
                                moe_dropless)
            aux = _with_aux(aux, a)
    return x, aux


def _unbind(tree, n: int) -> List[Params]:
    """The ``n`` layer groups of stacked leaves, each leaf split once."""
    parts = _map_leaves(lambda _, leaf: leaf.unbind(0), tree)
    return [_map_leaves(lambda _, p: p[g], parts) for g in range(n)]


def _train_stack(params: Params, cfg: ModelConfig, x, positions,
                 remat: bool, moe_dropless: bool = False, enc_out=None):
    """The layer stack for training: no cache, each stacked leaf split
    once (``_unbind``), each group under ``checkpoint`` with ``remat``
    (the prefix layers outside it, as the reference's are outside its
    scan); cross-attention blocks attend over ``enc_out``. Returns (x, the
    MoE balance losses summed over the layers)."""
    x, aux = _run_prefix(params, cfg, x, positions, None, None, enc_out,
                         False, moe_dropless)
    pattern, n_groups = _pattern(cfg)
    groups = list(zip(*(_unbind(params["stack"][j], n_groups)
                        for j in range(len(pattern)))))

    def group(x, aux, g: int):
        for bp, kind in zip(groups[g], pattern):
            x, a = _apply_block(bp, cfg, kind, x, positions, None, None,
                                enc_out, False, moe_dropless)
            aux = _with_aux(aux, a)
        return x, aux

    for g in range(n_groups):
        x, aux = (checkpoint(group, x, aux, g, use_reentrant=False) if remat
                  else group(x, aux, g))
    return x, aux


# ---------------------------------------------------------------------------
# encoder (encoder-decoder configs; its input is stub frame embeddings)
# ---------------------------------------------------------------------------

def encode(params: Params, cfg: ModelConfig, frames: torch.Tensor
           ) -> torch.Tensor:
    """frames: (B, T, d_model) precomputed frontend embeddings (a stub).
    Each layer: bidirectional self-attention in the cross form (no RoPE,
    no mask), then the MLP; the encoder's final norm last."""
    x = frames.to(_dtype(cfg.dtype))
    zeros = torch.zeros(x.shape[:2], dtype=torch.long, device=x.device)
    for bp in _unbind(params["enc_stack"], cfg.n_enc_layers):
        h = rmsnorm(x, bp["ln1"], cfg.norm_eps)
        out, _ = attn_lib.attention_fwd(bp["attn"], cfg, h, zeros,
                                        kv_source=h)
        x = x + out
        x = x + mlp_fwd(bp["ffn"], rmsnorm(x, bp["ln2"], cfg.norm_eps))
    return rmsnorm(x, params["enc_norm"], cfg.norm_eps)


def _encode_batch(params: Params, cfg: ModelConfig,
                  batch: Dict[str, torch.Tensor]) -> Optional[torch.Tensor]:
    """The encoder's output over ``batch["frames"]`` for an
    encoder-decoder config (a batch without frames raises KeyError, as the
    reference's does), else None."""
    if not cfg.is_encoder_decoder:
        return None
    return encode(params, cfg, batch["frames"])


# ---------------------------------------------------------------------------
# embeddings and heads
# ---------------------------------------------------------------------------

def _embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """The rows of ``table`` at ``tokens``.

    A DTensor table is looked up vocab-parallel on local shards (DTensor's
    own rules for an index and for ``F.embedding`` fail on a sharded
    vocab): each rank keeps its rows of the vocab, gathers the rest of
    their columns, takes the tokens that fall in its rows (zeros for the
    others) and returns a partial sum over the vocab's shards, which the
    next constraint all-reduces."""
    if not isinstance(table, DTensor):
        return table[tokens]
    mesh = table.device_mesh
    vocab = [i for i, p in enumerate(table.placements) if p.is_shard(0)]
    if not isinstance(tokens, DTensor):
        tokens = shlib.replicated(tokens, mesh)
    t_pl = [Shard(0) if i in vocab else Replicate() for i in range(mesh.ndim)]
    k_pl = [Replicate() if i in vocab or not p.is_shard(0) else p
            for i, p in enumerate(tokens.placements)]
    split = shlib.split_dims_of(t_pl, k_pl)
    rows = shlib.local_shard(table, mesh, t_pl, split)
    toks = tokens.redistribute(mesh, k_pl).to_local()
    chunk = 0                           # this rank's block of the vocab
    coord = mesh.get_coordinate()
    for i in vocab:
        chunk = chunk * mesh.size(i) + coord[i]
    lo = chunk * rows.shape[0]
    hit = (toks >= lo) & (toks < lo + rows.shape[0])
    out = torch.where(hit[..., None], rows[torch.where(hit, toks - lo, 0)],
                      0)
    pl = [Partial() if i in vocab else k_pl[i] for i in range(mesh.ndim)]
    return DTensor.from_local(out, mesh, pl, run_check=False)


def embed_inputs(params: Params, cfg: ModelConfig,
                 batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Token embeddings; with patches in the config and in ``batch``, the
    projected patch embeddings (B, n_patches, d) go in front of them."""
    dtype = _dtype(cfg.dtype)
    tok = _embed(params["embed"], batch["tokens"]).to(dtype)
    if cfg.n_patches and "patch_embeds" in batch:
        patches = batch["patch_embeds"].to(dtype) @ params["patch_proj"]
        tok = torch.cat([patches, tok], dim=1)
    return constrain(tok, ("data", None, None))


def _head_matrix(params: Params, cfg: ModelConfig) -> torch.Tensor:
    return params["embed"].t() if cfg.tie_embeddings else params["lm_head"]


def lm_logits(params: Params, cfg: ModelConfig, x: torch.Tensor
              ) -> torch.Tensor:
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return constrain(x @ _head_matrix(params, cfg), ("data", None, "model"))


def _positions(x: torch.Tensor) -> torch.Tensor:
    b, s, _ = x.shape
    return torch.arange(s, device=x.device).expand(b, s)


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------

def forward_train(params: Params, cfg: ModelConfig,
                  batch: Dict[str, torch.Tensor], remat: bool = False,
                  moe_dropless: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Teacher-forced logits over the full sequence. Returns (logits, aux),
    aux the MoE layers' balance losses summed (0 without MoE)."""
    x = embed_inputs(params, cfg, batch)
    x, aux = _train_stack(params, cfg, x, _positions(x), remat, moe_dropless,
                          enc_out=_encode_batch(params, cfg, batch))
    return lm_logits(params, cfg, x), aux


def chunked_ce_loss(params: Params, cfg: ModelConfig, x: torch.Tensor,
                    labels: torch.Tensor, chunk: int = 512,
                    ignore_index: int = -1) -> torch.Tensor:
    """Cross-entropy over the vocab without one (B, S, V) logits tensor:
    the (B, S, d) final hiddens are walked in sequence chunks, each giving
    one (B, chunk, V) logits block reduced to (nll_sum, count). Under
    autograd each chunk's logits stay saved for the backward, as the
    reference's scan keeps its residuals."""
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    head = _head_matrix(params, cfg)
    s = x.shape[1]
    chunk = min(chunk, s)
    if s % chunk:
        pad = chunk - s % chunk
        x = F.pad(x, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=ignore_index)
        s = s + pad
    nll_sum = x.new_zeros((), dtype=torch.float32)
    cnt = torch.zeros((), dtype=torch.long, device=x.device)
    for off in range(0, s, chunk):
        logits = (x[:, off:off + chunk] @ head).to(torch.float32)
        logits = constrain(logits, ("data", None, "model"))
        lab = labels[:, off:off + chunk]
        mask = lab != ignore_index
        safe = torch.where(mask, lab, 0).long()
        logz = torch.logsumexp(logits, dim=-1)
        gold = _gold(logits, safe)
        nll = torch.where(mask, logz - gold, 0.0)
        nll_sum = nll_sum + nll.sum()
        cnt = cnt + mask.sum()
    return nll_sum / torch.clamp(cnt, min=1)


def _gold(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Each position's logit at its label. On a DTensor the vocab dim may
    be sharded: the label's column is selected elementwise and summed over
    the vocab (a partial sum over its shards, the same value), where a
    gather along a sharded dim has no working DTensor rule."""
    if not isinstance(logits, DTensor):
        return logits.gather(-1, labels[..., None])[..., 0]
    vocab = torch.arange(logits.shape[-1], device=logits.device)
    return torch.where(vocab == labels[..., None], logits, 0.0).sum(-1)


def loss_fn(params: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            aux_weight: float = 0.01, remat: bool = False,
            loss_chunk: int = 512) -> torch.Tensor:
    x = embed_inputs(params, cfg, batch)
    x, aux = _train_stack(params, cfg, x, _positions(x), remat,
                          enc_out=_encode_batch(params, cfg, batch))
    loss = chunked_ce_loss(params, cfg, x, batch["labels"], chunk=loss_chunk)
    return loss + aux_weight * aux


def _distribute_cache(cache: Params) -> Params:
    """A prefill's zeroed cache as DTensors on the active mesh: the batch
    dim over "data" where it divides, the rest replicated (the stacked
    leaves' batch dim follows their layer-group dim)."""
    mesh = shlib._rules()["mesh"]

    def place(bdim):
        def one(_, leaf):
            logical = [None] * leaf.ndim
            logical[bdim] = "data"
            spec = shlib.guarded_spec(mesh, leaf.shape,
                                      shlib.resolve_spec(logical))
            return shlib.distribute(leaf, shlib.NamedSharding(mesh, spec))
        return one

    return {"prefix": _map_leaves(place(0), cache["prefix"]),
            "stack": _map_leaves(place(1), cache["stack"])}


@torch.no_grad()
def prefill(params: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            capacity: int, moe_dropless: bool = True
            ) -> Tuple[torch.Tensor, Params]:
    """Process the full prompt; return (last-position logits, decode cache).

    The S prompt tokens' cache rows (K/V, or MLA's latent) land in zeroed
    capacity-C buffers at slots [0, S) (C >= S; S counts the patches in
    front of the tokens); mamba layers keep their final conv window and
    state; an encoder-decoder's cross cache holds the encoder's K/V
    whole."""
    x = embed_inputs(params, cfg, batch)
    b, s, _ = x.shape
    if s > capacity:
        raise ValueError(f"prompt of {s} tokens exceeds capacity {capacity}")
    enc_out = _encode_batch(params, cfg, batch)
    cache = init_cache(cfg, b, capacity, x.device,
                       enc_len=0 if enc_out is None else enc_out.shape[1])
    if isinstance(x, DTensor):
        cache = _distribute_cache(cache)
    x, _ = _run_stack(params, cfg, x, _positions(x), cache, None, enc_out,
                      decode=False, moe_dropless=moe_dropless)
    return lm_logits(params, cfg, x[:, -1:, :]), cache


@torch.no_grad()
def decode_step(params: Params, cfg: ModelConfig, cache: Params,
                cur_index, tokens: torch.Tensor, position=None
                ) -> Tuple[torch.Tensor, Params]:
    """One-token decode. tokens: (B, 1) int.

    cur_index: cache WRITE SLOT — scalar (aligned batch) or (B,) per-lane
    (continuous batching / ragged sessions). position: optional RoPE
    position of the new token (defaults to cur_index); differs from the
    slot when the cache holds a token-dropped entry. Index tensors given
    on the host (a batcher's tick) are moved to the model's device here,
    once. The cache is updated in place and returned."""
    dev = params["embed"].device
    tokens, cur_index, position = (
        v.to(dev) if torch.is_tensor(v) and not isinstance(v, DTensor)
        else v for v in (tokens, cur_index, position))
    x = _embed(params["embed"], tokens).to(_dtype(cfg.dtype))
    b = tokens.shape[0]
    pos = cur_index if position is None else position
    if isinstance(pos, DTensor) and pos.ndim == 0:
        positions = pos.to(torch.long).reshape(1, 1).expand(b, 1)
    elif attn_lib._is_scalar(pos):
        positions = torch.full((b, 1), int(pos), dtype=torch.long,
                               device=x.device)
    else:
        positions = pos.to(x.device, torch.long)[:, None]
    x, _ = _run_stack(params, cfg, x, positions, cache, cur_index, None,
                      decode=True)
    return lm_logits(params, cfg, x), cache
