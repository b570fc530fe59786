"""Seeded random weights, made by the benchmark on the serving device.

One flat buffer in the served dtype holds every leaf of the port's
parameter tree; it is filled by a few large ``torch.randn`` calls on a
``torch.Generator`` of that device, then each leaf is scaled in place:
norms are ones, the embedding N(0, 0.02), every other matrix N(0, 1/d_in).
The program and the plain reference read the same tensors."""
from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import torch

CHUNK = 1 << 28          # elements a randn call


def _leaves(tree, path=()) -> List[Tuple[Tuple[str, ...], Any]]:
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _leaves(v, path + (k,))]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in _leaves(v, path + (str(i),))]
    return [(path, tree)]


def _rebuild(tree, leaves: Dict[Tuple[str, ...], torch.Tensor], path=()):
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_rebuild(v, leaves, path + (str(i),)) for i, v in enumerate(tree)]
    return leaves[path]


def _is_norm(name: str) -> bool:
    return name.startswith("ln") or name.endswith("_norm")


def make_params(cfg, seed: int, device: torch.device,
                dtype: torch.dtype = torch.bfloat16) -> Dict:
    """The port's parameter tree for ``cfg`` (shapes from the port's
    ``param_shapes``), as views of one seeded buffer on ``device``."""
    from repro_torch.models.transformer import param_shapes

    shapes = param_shapes(cfg)
    leaves = _leaves(shapes)
    total = sum(math.prod(s) for _, s in leaves)
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    buf = torch.empty(total, dtype=dtype, device=device)
    for lo in range(0, total, CHUNK):
        hi = min(total, lo + CHUNK)
        torch.randn(hi - lo, generator=gen, dtype=dtype, device=device,
                    out=buf[lo:hi])
    out, off = {}, 0
    for path, shape in leaves:
        n = math.prod(shape)
        t = buf[off:off + n].view(shape)
        off += n
        name = path[-1]
        if _is_norm(name):
            t.fill_(1.0)
        else:
            t.mul_(0.02 if name == "embed" else shape[-2] ** -0.5)
        out[path] = t
    return _rebuild(shapes, out)

