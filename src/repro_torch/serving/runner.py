"""ModelRunner: bridges the storage-layer KVData format and the model's
decode-cache tree, and runs prefill / greedy generation.

Counterpart of ``repro.serving.runner`` for the dense GQA models the port
has (the MLA and SSM KVData arrays come with those families, ROADMAP §A8).

KVData layout (batch squeezed, numpy, storage-friendly):
  GQA :  {"k": (L_attn, T, Kv*hd), "v": (L_attn, T, Kv*hd)}
  always: {"positions": (T_kept,)} after token dropping.

The runner computes on the device its params live on.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.compression.base import KVData
from repro_torch.models import Model


def _layer_cache_refs(cache, cfg: ModelConfig):
    """Yield (layer_idx, kind, (section, position, group)) for every
    layer's block cache: ``cache[section][position]`` holds its leaves,
    indexed at ``group`` on the stacked axis. (Unstacked prefix layers
    come with the MoE family, ROADMAP §A8.)"""
    period = len(cfg.block_group()[0])
    for i, kind in enumerate(cfg.layer_kinds()):
        g, j = divmod(i, period)
        yield i, kind, ("stack", j, g)


def cache_to_kvdata(cache, cfg: ModelConfig, n_tokens: int) -> KVData:
    """Extract a storable KVData from a (batch=1) cache tree."""
    ks, vs = [], []
    for _, _, (sect, j, g) in _layer_cache_refs(cache, cfg):
        blk = cache[sect][j]["self"]
        ks.append(blk["k"][g, 0, :n_tokens].reshape(n_tokens, -1))
        vs.append(blk["v"][g, 0, :n_tokens].reshape(n_tokens, -1))
    # one device-to-host copy per array, not one per layer
    return {"k": torch.stack(ks).to(torch.float32).cpu().numpy(),
            "v": torch.stack(vs).to(torch.float32).cpu().numpy(),
            "positions": np.arange(n_tokens, dtype=np.int32)}


def kvdata_to_cache(kv: KVData, cfg: ModelConfig, model: Model,
                    capacity: int, device="cuda") -> Tuple[dict, int]:
    """Build a capacity-C batch=1 cache tree on ``device`` from stored
    KVData.

    Returns (cache, n_kept) — kept rows occupy slots [0, n_kept)."""
    n_kept = int(kv["positions"].shape[0]) if "positions" in kv else (
        kv["k"].shape[1])
    cache = model.init_cache(batch=1, capacity=capacity, device=device)
    hd = cfg.resolved_head_dim
    k_all = torch.from_numpy(np.ascontiguousarray(kv["k"])).to(device)
    v_all = torch.from_numpy(np.ascontiguousarray(kv["v"])).to(device)
    for ai, (_, _, (sect, j, g)) in enumerate(_layer_cache_refs(cache, cfg)):
        blk = cache[sect][j]["self"]
        # in-place writes into the zeroed cache (the reference fills a
        # numpy copy and converts it back to device arrays)
        blk["k"][g, 0, :n_kept] = k_all[ai].reshape(n_kept, -1, hd)
        blk["v"][g, 0, :n_kept] = v_all[ai].reshape(n_kept, -1, hd)
    return cache, n_kept


@dataclasses.dataclass
class ModelRunner:
    model: Model
    params: dict
    capacity: int = 1024

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
        cache, n_kept = kvdata_to_cache(kv, self.model.cfg, self.model,
                                        self.capacity, self.device)
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
                torch.tensor([[nxt]], dtype=torch.long, device=self.device),
                pos)
            slot += 1
            pos += 1
        return out

    def generate_uncompressed(self, ctx_tokens: np.ndarray,
                              question: np.ndarray, max_new: int
                              ) -> Tuple[List[int], KVData]:
        kv = self.prefill_entry(ctx_tokens)
        ans = self.generate_from_kvdata(kv, len(ctx_tokens), question, max_new)
        return ans, kv
