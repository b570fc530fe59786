"""Seeded random weights, made by the benchmark on the serving device.

One flat buffer in the served dtype holds every leaf of the port's
parameter tree; it is filled by a few large ``torch.randn`` calls on a
``torch.Generator`` of that device, then each leaf is set in place from
its own slot: norms are ones, the embedding N(0, 0.02), every other
matrix N(0, 1/d_in). A Mamba layer's leaves follow Mamba's published
init: ``conv_w`` and ``conv_b`` U(-1/sqrt(d_conv), 1/sqrt(d_conv)), as
``nn.Conv1d`` draws them, ``dt_bias`` the inverse softplus of a dt
log-uniform in [1e-3, 1e-1] (each uniform the normal CDF of the slot's
draw, so nothing more is drawn), ``a_log = log(1..N)``
and ``d_skip`` ones, these two in f32 where the port's tree keeps them
so (``transformer.param_dtype``). The program and the plain reference
read the same tensors."""
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


DT_MIN, DT_MAX = 1e-3, 1e-1


def _mamba_leaf(cfg, name: str, t: torch.Tensor, want: torch.dtype
                ) -> torch.Tensor:
    """A Mamba leaf other than its projections, from its buffer slot ``t``
    (N(0, 1) draws), in the dtype ``want``."""
    if name in ("conv_w", "conv_b"):
        u = torch.special.ndtr(t.to(torch.float32))
        return t.copy_((2 * u - 1) * cfg.ssm.d_conv ** -0.5)
    if name == "dt_bias":
        u = torch.special.ndtr(t.to(torch.float32))
        dt = torch.exp(u * (math.log(DT_MAX) - math.log(DT_MIN))
                       + math.log(DT_MIN))
        return t.copy_(dt + torch.log(-torch.expm1(-dt)))
    if name == "a_log":
        n = torch.arange(1, t.shape[-1] + 1, dtype=torch.float32,
                         device=t.device)
        return torch.log(n).expand(t.shape).to(want).contiguous()
    if name == "d_skip":
        return torch.ones(t.shape, dtype=want, device=t.device)
    raise ValueError(f"no initialisation for the Mamba leaf {name!r}")


def make_params(cfg, seed: int, device: torch.device,
                dtype: torch.dtype = torch.bfloat16) -> Dict:
    """The port's parameter tree for ``cfg`` (shapes from the port's
    ``param_shapes``), as views of one seeded buffer on ``device``."""
    from repro_torch.models.transformer import param_dtype, param_shapes

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
        # a stacked leaf leads with its layer groups
        per_layer = len(shape) - (path[0] == "stack")
        if _is_norm(name):
            t.fill_(1.0)
        elif "mamba" in path and (per_layer < 2
                                  or name in ("a_log", "conv_w")):
            want = torch.float32 if param_dtype(cfg, name) == torch.float32 \
                else dtype
            t = _mamba_leaf(cfg, name, t, want)
        elif per_layer < 2:
            raise ValueError(f"no initialisation for the leaf {path}")
        else:
            t.mul_(0.02 if name == "embed" else shape[-2] ** -0.5)
        out[path] = t
    return _rebuild(shapes, out)

