"""ModelRunner: bridges the storage-layer KVData format and the model's
decode-cache tree, and runs prefill / greedy generation.

Counterpart of ``repro.serving.runner``.

KVData layout (batch squeezed, numpy, storage-friendly):
  GQA :  {"k": (L_attn, T, Kv*hd), "v": (L_attn, T, Kv*hd)}
  MLA :  {"ckv": (L_attn, T, r), "krope": (L_attn, T, rope_d)}
  SSM :  {"ssm": (L_m, d_in, n), "conv": (L_m, c-1, d_in)}   (+ attention
         arrays for hybrids)
  always: {"positions": (T_kept,)} after token dropping.

The runner computes on the device its params live on. Its decode caches
come from its ``CachePool`` (``models/decode_graph.py``): made once a
(lanes, capacity), kept for the runner's life and, on CUDA, each with its
decode step captured as a CUDA graph.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from repro_torch.configs.base import AttnKind, LayerKind, ModelConfig
from repro_torch.core.compression.base import KVData
from repro_torch.models import Model
from repro_torch.models.decode_graph import CachePool
from repro_torch.models.transformer import _prefix_count
from repro_torch.runtime import trace


def _layer_cache_refs(cache, cfg: ModelConfig):
    """Yield (layer_idx, kind, (section, position, group)) for every
    layer's block cache: ``cache[section][position]`` holds its leaves,
    indexed at ``group`` on the stacked axis, or, for an unstacked prefix
    layer, ``group`` None."""
    npre = _prefix_count(cfg)
    period = len(cfg.block_group()[0])
    for i, kind in enumerate(cfg.layer_kinds()):
        if i < npre:
            yield i, kind, ("prefix", i, None)
        else:
            g, j = divmod(i - npre, period)
            yield i, kind, ("stack", j, g)


def _at(leaf: torch.Tensor, g) -> torch.Tensor:
    """A layer's cache leaf (batch leading): group ``g`` of a stacked
    leaf, or a prefix layer's own leaf (``g`` None)."""
    return leaf if g is None else leaf[g]


def _attn_names(cfg: ModelConfig) -> Tuple[str, str]:
    """The KVData arrays of an attention layer's cache."""
    return ("ckv", "krope") if cfg.attn_kind == AttnKind.MLA else ("k", "v")


def _host(xs: List[torch.Tensor]) -> np.ndarray:
    """Per-layer device arrays as one f32 numpy stack: one device-to-host
    copy per array, not one per layer."""
    x = torch.stack(xs).to(torch.float32)
    if trace.ON:
        trace.count("d2h_bytes", x.nbytes)
    return x.cpu().numpy()


def cache_to_kvdata(cache, cfg: ModelConfig, n_tokens: int) -> KVData:
    """Extract a storable KVData from a (batch=1) cache tree."""
    names = _attn_names(cfg)
    attn = {name: [] for name in names}
    ssms, convs = [], []
    for _, kind, (sect, j, g) in _layer_cache_refs(cache, cfg):
        blk = cache[sect][j]
        if kind == LayerKind.MAMBA:
            ssms.append(_at(blk["mamba"]["ssm"], g)[0])
            convs.append(_at(blk["mamba"]["conv"], g)[0])
        else:
            for name in names:
                rows = _at(blk["self"][name], g)[0, :n_tokens]
                attn[name].append(rows.reshape(n_tokens, -1))
    out: KVData = {}
    if attn[names[0]]:
        out.update((name, _host(xs)) for name, xs in attn.items())
    if ssms:
        out["ssm"], out["conv"] = _host(ssms), _host(convs)
    out["positions"] = np.arange(n_tokens, dtype=np.int32)
    return out


def write_kvdata(cache, kv: KVData, cfg: ModelConfig, lane: int,
                 device) -> int:
    """Write a KVData entry into batch lane ``lane`` of a cache tree, in
    place: an attention layer's rows into slots [0, n_kept), a mamba
    layer's state and conv window whole (the reference's ``put_full``).
    Returns n_kept."""
    with trace.span("lane.write") as sp:
        n_kept = _write_kvdata(cache, kv, cfg, lane, device)
        if sp:
            state = sum(kv[n].nbytes for n in ("ssm", "conv") if n in kv)
            nbytes = state + sum(kv[n].nbytes for n in _attn_names(cfg)
                                 if n in kv)
            sp.attrs.update(lane=lane, bytes=nbytes)
            trace.count("h2d_bytes", nbytes)
            if state:
                trace.count("state_h2d_bytes", state)
        return n_kept


def _write_kvdata(cache, kv: KVData, cfg: ModelConfig, lane: int,
                  device) -> int:
    names = _attn_names(cfg)
    n_kept = int(kv["positions"].shape[0]) if "positions" in kv else (
        kv[names[0]].shape[1] if names[0] in kv else 0)
    dev = {name: torch.from_numpy(np.ascontiguousarray(kv[name])).to(device)
           for name in names + ("ssm", "conv") if name in kv}
    ai = mi = 0
    for _, kind, (sect, j, g) in _layer_cache_refs(cache, cfg):
        blk = cache[sect][j]
        if kind == LayerKind.MAMBA:
            _at(blk["mamba"]["ssm"], g)[lane] = dev["ssm"][mi]
            _at(blk["mamba"]["conv"], g)[lane] = dev["conv"][mi]
            mi += 1
        else:
            for name in names:
                dst = _at(blk["self"][name], g)[lane, :n_kept]
                dst.copy_(dev[name][ai].reshape(dst.shape))
            ai += 1
    return n_kept


def kvdata_to_cache(kv: KVData, cfg: ModelConfig, model: Model,
                    capacity: int, device="cuda") -> Tuple[dict, int]:
    """Build a capacity-C batch=1 cache tree on ``device`` from stored
    KVData.

    Returns (cache, n_kept) — kept rows occupy slots [0, n_kept). The
    writes go in place into the zeroed cache (the reference fills a numpy
    copy and converts it back to device arrays)."""
    cache = model.init_cache(batch=1, capacity=capacity, device=device)
    return cache, write_kvdata(cache, kv, cfg, 0, device)


@dataclasses.dataclass
class ModelRunner:
    model: Model
    params: dict
    capacity: int = 1024
    pool: CachePool = dataclasses.field(init=False, repr=False,
                                        compare=False)

    def __post_init__(self):
        self.pool = CachePool(self.model)

    @property
    def device(self) -> torch.device:
        return self.params["embed"].device

    # -- prefill -> storable entry -------------------------------------------
    def prefill_entry(self, ctx_tokens: np.ndarray) -> KVData:
        t = len(ctx_tokens)
        tokens = torch.as_tensor(np.asarray(ctx_tokens, np.int64),
                                 device=self.device)[None]
        _, cache = self.model.prefill(self.params, {"tokens": tokens},
                                      capacity=self.capacity)
        return cache_to_kvdata(cache, self.model.cfg, t)

    # -- generation ------------------------------------------------------------
    def generate_from_kvdata(self, kv: KVData, orig_len: int,
                             question: np.ndarray, max_new: int) -> List[int]:
        """Greedy answer over a stored entry, in a one-lane cache lent by
        the pool (the entry written into it as ``kvdata_to_cache`` would
        write it into a fresh one)."""
        with self.pool.lease(self.params, 1, self.capacity) as cache:
            n_kept = write_kvdata(cache, kv, self.model.cfg, 0, self.device)
            toks = list(np.asarray(question, np.int64))
            out: List[int] = []
            slot, pos = n_kept, orig_len
            logits = None
            for step in range(len(toks) + max_new):
                if step < len(toks):
                    nxt = int(toks[step])
                else:
                    nxt = int(torch.argmax(logits[0, -1]))
                    out.append(nxt)
                if slot >= self.capacity:
                    break
                logits, cache = self.model.decode_step(
                    self.params, cache, slot,
                    torch.tensor([[nxt]], dtype=torch.long), pos)
                slot += 1
                pos += 1
        return out

    def generate_uncompressed(self, ctx_tokens: np.ndarray,
                              question: np.ndarray, max_new: int
                              ) -> Tuple[List[int], KVData]:
        kv = self.prefill_entry(ctx_tokens)
        ans = self.generate_from_kvdata(kv, len(ctx_tokens), question, max_new)
        return ans, kv
