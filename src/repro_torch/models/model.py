"""Public model API: ``build_model(cfg)`` -> Model (init / loss / prefill /
decode)."""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer
from repro_torch.models.layers import Params
from repro_torch.runtime import trace


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    def init(self, seed: int = 0, device="cuda") -> Params:
        """Seeded random parameters on ``device`` (CUDA unless asked)."""
        gen = torch.Generator(device=resolve_device(device)).manual_seed(seed)
        return transformer.init_params(gen, self.cfg)

    def init_shapes(self) -> Params:
        """The parameters as ``meta`` tensors: shapes and dtypes, no
        allocation (the dry run's path)."""
        return transformer._map_leaves(
            lambda path, shape: torch.empty(
                shape, dtype=transformer.param_dtype(self.cfg, path[-1]),
                device="meta"),
            transformer.param_shapes(self.cfg))

    def forward(self, params, batch, remat: bool = False):
        logits, _aux = transformer.forward_train(params, self.cfg, batch,
                                                 remat=remat)
        return logits

    def loss(self, params, batch, remat: bool = False):
        return transformer.loss_fn(params, self.cfg, batch, remat=remat)

    def prefill(self, params, batch, capacity: int):
        with trace.span("model.prefill") as sp:
            if sp:
                sp.attrs["tokens"] = int(batch["tokens"].shape[-1])
            return transformer.prefill(params, self.cfg, batch, capacity)

    def decode_step(self, params, cache, cur_index, tokens, position=None):
        """One decode step: a replay of the cache's CUDA graph where it
        has one that takes this call (``models/decode_graph.py``), else
        ``transformer.decode_step`` eagerly."""
        graph = getattr(cache, "graph", None)
        if graph is not None and graph.takes(params, cur_index, tokens,
                                             position):
            return graph.step(cur_index, tokens, position), cache
        trace.count("decode.eager_steps")
        return transformer.decode_step(params, self.cfg, cache, cur_index,
                                       tokens, position)

    def init_cache(self, batch: int, capacity: int, device="cuda",
                   enc_len: int = 0, kv_bits: int = 16):
        return transformer.init_cache(self.cfg, batch, capacity,
                                      resolve_device(device),
                                      enc_len=enc_len, kv_bits=kv_bits)

    def param_count(self, params: Optional[Params] = None) -> int:
        if params is not None:
            return sum(t.numel() for t in transformer._leaves(params))
        return sum(math.prod(s) for s in
                   transformer._leaves(transformer.param_shapes(self.cfg)))

    def active_param_count(self) -> int:
        """Params touched per token, counted from shapes without allocating:
        all of them but, in each MoE layer, the held experts a token does
        not reach: of its k picks over the E routed experts, k · H / E land
        on the H held here on average (k of E when all are held)."""
        total = self.param_count()
        cfg = self.cfg
        if cfg.moe is None:
            return total
        m = cfg.moe
        n_moe_layers = sum(1 for i in range(cfg.n_layers)
                           if cfg.uses_moe_at(i))
        per_expert = 3 * cfg.d_model * m.expert_d_ff
        unreached = m.held - m.top_k * m.held / m.n_routed_experts
        return int(round(total - n_moe_layers * unreached * per_expert))


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
