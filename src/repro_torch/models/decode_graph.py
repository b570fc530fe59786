"""Decode caches that outlive a request, and the CUDA graph of the decode
step that each one carries.

``CachePool`` lends decode caches keyed on (lanes, capacity), one user at
a time; ``serving.runner.ModelRunner`` owns one, so its caches live and
die with the engine. A cache is made once (``transformer.init_cache``,
zeroed) and written in place from then on. A lane write
(``serving.runner.write_kvdata``) fills an attention layer's rows [0, n)
and a Mamba layer's state whole, and leaves the rows from n on as an
earlier request left them. Those rows make no difference: the decode mask
adds -1e30 to their scores, which then read -1e30 exactly whatever the
row held, so their softmax weight is exactly 0. A request served from a
reused cache gets the tokens and logits that a fresh cache gives.

On CUDA, with plain tensors and no mesh, a new pooled cache gets its
``DecodeGraph`` at once, on the fresh cache before any lane is written:
``transformer.decode_step`` over this cache and the params it was lent
with, warmed up on a side stream and captured into one CUDA graph, the
cache zeroed again after. ``Model.decode_step`` replays it for every step
over that cache with those params: the step's indices are copied into the
graph's static inputs, one replay runs the whole step, and the logits
come back as a fresh tensor (the graph's own output is overwritten by the
next replay). Every other decode step runs eagerly: on the CPU, on
DTensors or under a mesh, over a quantized cache (``kv_bits``) or a cache
the caller made itself, with other params, or with indices of another
form. The step's MoE layers take ``moe_fwd``'s decode form, which reads
nothing back to the host, so the step can be captured at all; a pooled
cache of more lanes than that form takes (``moe.decode_form``) gets no
graph and runs eagerly.
"""
from __future__ import annotations

import contextlib
import numbers
from typing import Dict, Iterator, List, Optional, Tuple, Union

import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ModelConfig
from repro_torch.launch import sharding as shlib
from repro_torch.models import moe, transformer
from repro_torch.models.layers import Params
from repro_torch.runtime import trace

#: eager steps on a side stream before the capture: they make cuBLAS's
#: handles and workspaces, which a capture may not create
WARMUP_STEPS = 2

Index = Union[int, torch.Tensor, None]


class PooledCache(dict):
    """A decode cache tree lent by a ``CachePool``: ``key`` is its
    (lanes, capacity), ``graph`` its captured decode step or None."""

    def __init__(self, tree: Params, key: Tuple[int, int]):
        super().__init__(tree)
        self.key = key
        self.graph: Optional[DecodeGraph] = None


def _per_lane(v: Index, lanes: int) -> bool:
    """An index the graph takes: an int (every lane) or a plain tensor of
    one a lane."""
    if isinstance(v, numbers.Integral):
        return True
    return (torch.is_tensor(v) and not isinstance(v, DTensor)
            and tuple(v.shape) == (lanes,))


def _load(dst: torch.Tensor, v: Union[int, torch.Tensor]) -> None:
    if torch.is_tensor(v):
        dst.copy_(v)
    else:
        dst.fill_(int(v))


class DecodeGraph:
    """One pooled cache's decode step as a CUDA graph (module doc)."""

    def __init__(self, cfg: ModelConfig, params: Params, cache: PooledCache):
        lanes, self.capacity = cache.key
        dev = params["embed"].device
        self.params = params
        self.write = torch.zeros(lanes, dtype=torch.long, device=dev)
        self.pos = torch.zeros(lanes, dtype=torch.long, device=dev)
        self.tokens = torch.zeros((lanes, 1), dtype=torch.long, device=dev)

        def step() -> torch.Tensor:
            return transformer.decode_step(params, cfg, cache, self.write,
                                           self.tokens, self.pos)[0]

        with trace.paused():
            main = torch.cuda.current_stream(dev)
            side = torch.cuda.Stream(dev)
            side.wait_stream(main)
            with torch.cuda.stream(side):
                for _ in range(WARMUP_STEPS):
                    step()
            main.wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph,
                                  capture_error_mode="thread_local"):
                self.logits = step()
        # what the step's MoE layers count, which a replay runs no Python
        # to count
        n_moe = sum(map(cfg.uses_moe_at, range(cfg.n_layers)))
        self.counts = ({} if n_moe == 0 else
                       {name: n * n_moe for name, n in
                        moe.decode_slot_counts(cfg, lanes).items()})
        # the warm-up wrote slot 0 and stepped every Mamba state
        for leaf in transformer._leaves(cache):
            leaf.zero_()
        trace.count("decode.graph_captures")

    def takes(self, params: Params, cur_index: Index, tokens: torch.Tensor,
              position: Index) -> bool:
        """Whether a ``decode_step`` call is the captured one: the same
        params, no mesh, (lanes, 1) tokens and per-lane indices."""
        lanes = self.write.shape[0]
        return (params is self.params and shlib._rules() is None
                and torch.is_tensor(tokens) and not isinstance(tokens, DTensor)
                and tuple(tokens.shape) == (lanes, 1)
                and _per_lane(cur_index, lanes)
                and (position is None or _per_lane(position, lanes)))

    def step(self, cur_index: Index, tokens: torch.Tensor,
             position: Index) -> torch.Tensor:
        """One replay: the indices into the static inputs (an int write
        slot clamped to the cache, as the eager step clamps it), the
        graph, and a fresh copy of its logits."""
        if isinstance(cur_index, numbers.Integral):
            _load(self.write, min(max(int(cur_index), 0), self.capacity - 1))
        else:
            _load(self.write, cur_index)
        _load(self.pos, cur_index if position is None else position)
        self.tokens.copy_(tokens)
        self.graph.replay()
        if trace.ON:
            trace.count("decode.graph_replays")
            for name, n in self.counts.items():
                trace.count(name, n)
        return self.logits.clone()


class CachePool:
    """Decode caches keyed on (lanes, capacity), each lent to one user at
    a time and kept for the next (module doc)."""

    def __init__(self, model):
        self.model = model
        self._free: Dict[Tuple[int, int], List[PooledCache]] = {}

    def acquire(self, params: Params, lanes: int, capacity: int
                ) -> PooledCache:
        """A free cache of this shape, or a new one (with its graph where
        the step can be captured). Give it back with ``release``."""
        free = self._free.get((lanes, capacity))
        if free:
            return free.pop()
        dev = params["embed"].device
        cache = PooledCache(self.model.init_cache(
            batch=lanes, capacity=capacity, device=dev), (lanes, capacity))
        cfg = self.model.cfg
        if (dev.type == "cuda" and shlib._rules() is None
                and (cfg.moe is None or moe.decode_form(cfg, lanes))
                and not any(isinstance(leaf, DTensor)
                            for leaf in transformer._leaves(params))):
            cache.graph = DecodeGraph(cfg, params, cache)
        return cache

    def release(self, cache: PooledCache) -> None:
        self._free.setdefault(cache.key, []).append(cache)

    @contextlib.contextmanager
    def lease(self, params: Params, lanes: int, capacity: int
              ) -> Iterator[PooledCache]:
        cache = self.acquire(params, lanes, capacity)
        try:
            yield cache
        finally:
            self.release(cache)
