"""Public model API: ``build_model(cfg)`` -> Model (init / prefill / decode)."""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer
from repro_torch.models.layers import Params


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    def __post_init__(self):
        transformer.check_supported(self.cfg)

    def init(self, seed: int = 0, device="cuda") -> Params:
        """Seeded random parameters on ``device`` (CUDA unless asked)."""
        gen = torch.Generator(device=resolve_device(device)).manual_seed(seed)
        return transformer.init_params(gen, self.cfg)

    def prefill(self, params, batch, capacity: int):
        return transformer.prefill(params, self.cfg, batch, capacity)

    def decode_step(self, params, cache, cur_index, tokens, position=None):
        return transformer.decode_step(params, self.cfg, cache, cur_index,
                                       tokens, position)

    def init_cache(self, batch: int, capacity: int, device="cuda",
                   kv_bits: int = 16):
        return transformer.init_cache(self.cfg, batch, capacity,
                                      resolve_device(device), kv_bits)

    def param_count(self, params: Optional[Params] = None) -> int:
        if params is not None:
            return sum(t.numel() for t in transformer._leaves(params))
        return sum(math.prod(s) for s in
                   transformer._leaves(transformer.param_shapes(self.cfg)))

    def active_param_count(self) -> int:
        """Params touched per token, counted from shapes without allocating
        (dense models: all of them)."""
        return self.param_count()


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
