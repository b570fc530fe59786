"""A step's cost, counted at dispatch: the port's counterpart of
``repro.launch.hlo_cost``.

The reference walks a compiled XLA module's HLO (trip counts, fusions,
collectives). The port runs eagerly, so it has no HLO: it runs the step
once under a ``TorchDispatchMode`` and counts every aten op that reaches
the dispatcher on one rank, on local shapes (a DTensor op is let through
to DTensor, which runs it on the rank's local shards and issues its
collectives as ``_c10d_functional`` ops; those local ops are what is
counted; the FakeTensors DTensor runs an op on once to infer its output
shape are not). A loop in Python is unrolled as it runs, so no trip count is
needed. ``shape_bytes``, the HLO parser and ``collective_bytes_from_hlo``
have no counterpart.

  * flops: the matmul family only (mm, addmm, bmm, baddbmm; einsum and
    matmul reach the dispatcher as these): 2 * |result| * contracted
    extent, as the reference counts its dots; elementwise FLOPs are
    ignored;
  * mem_bytes: the bytes of every input and output of every op that is
    not a view. Every eager op is a fusion boundary, so this counts what
    an unfused step moves, more than a fused one would;
  * collective_bytes: the result bytes of each collective, weighted by
    the ring-transfer factors (all-reduce 2x), with ``collective_detail``
    by kind and ``collectives`` the per-op records that ``diagnose``
    ranks (kind, shape, where in the port's code it was issued).

``live_peak_bytes`` is a different figure from the reference's
``temp_size_in_bytes``: the most bytes of storages alive at once on the
rank while the step ran, counting the storages of the step's inputs and
of every op output, read every ``POLL`` ops.
"""
from __future__ import annotations

import dataclasses
import traceback
from typing import Any, Dict, List

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode

COLLECTIVE_FACTOR = {
    "all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
    "all-to-all": 1.0, "collective-permute": 1.0,
}

_aten = torch.ops.aten
_MATMUL = {_aten.mm.default, _aten.addmm.default, _aten.bmm.default,
           _aten.baddbmm.default}

# _c10d_functional op names -> the reference's collective kinds
_COLLECTIVES = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute", "broadcast_": "collective-permute",
}
_FREE = {"wait_tensor", "detach", "lift_fresh", "_local_scalar_dense"}

POLL = 32            # ops between two reads of the live storages


@dataclasses.dataclass
class StepCost:
    flops: float = 0.0
    mem_bytes: float = 0.0
    collective_bytes: float = 0.0
    collective_detail: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {k: 0.0 for k in COLLECTIVE_FACTOR})
    collectives: List[Dict[str, Any]] = dataclasses.field(
        default_factory=list)
    live_peak_bytes: float = 0.0
    n_ops: int = 0


def _tensors(tree) -> List[torch.Tensor]:
    out: List[torch.Tensor] = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            for y in x:
                walk(y)
        elif isinstance(x, dict):
            for y in x.values():
                walk(y)
    walk(tree)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def matmul_flops(func, args, out) -> float:
    """2 * |result| * contracted extent of a matmul-family op (0 for any
    other op)."""
    if func not in _MATMUL:
        return 0.0
    a = args[1] if func in (_aten.addmm.default, _aten.baddbmm.default) \
        else args[0]
    return 2.0 * out.numel() * a.shape[-1]


def _where() -> str:
    """The innermost frames of the port's own code on the stack."""
    frames = [f for f in traceback.extract_stack()
              if "repro_torch" in f.filename
              and not f.filename.endswith("step_cost.py")]
    return " < ".join(f"{f.filename.rsplit('/', 1)[-1][:-3]}.{f.name}:"
                      f"{f.lineno}" for f in reversed(frames[-3:]))


class StepCounter(TorchDispatchMode):
    """Counts the cost of the ops run under it (see the module's
    docstring); ``cost`` holds the totals."""

    def __init__(self, inputs: Any = None):
        super().__init__()
        self.cost = StepCost()
        self._live: Dict[int, tuple] = {}
        for t in _tensors(inputs):
            self._track(t.to_local() if isinstance(t, DTensor) else t)
        self._poll()

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        self._live.setdefault(st._cdata, (st, st.nbytes()))

    def _poll(self) -> None:
        # a storage only this counter still holds is dead
        self._live = {k: v for k, v in self._live.items()
                      if torch._C._storage_Use_Count(k) > 1}
        total = sum(n for _, n in self._live.values())
        self.cost.live_peak_bytes = max(self.cost.live_peak_bytes, total)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented       # DTensor runs it on local shards
        out = func(*args, **kwargs)
        if any(isinstance(t, FakeTensor)
               for t in _tensors((args, kwargs, out))):
            return out                  # DTensor's shape inference
        c = self.cost
        c.n_ops += 1
        name = func._opname
        ns = func.namespace
        if ns in ("_c10d_functional", "_c10d_functional_autograd") \
                and name in _COLLECTIVES:
            kind = _COLLECTIVES[name]
            res = _tensors(out)
            b = sum(_nbytes(t) for t in res) * COLLECTIVE_FACTOR[kind]
            c.collective_bytes += b
            c.collective_detail[kind] += b
            c.collectives.append({
                "kind": kind, "bytes": b,
                "shape": [list(t.shape) for t in res],
                "dtype": str(res[0].dtype).removeprefix("torch.")
                if res else "", "where": _where()})
        c.flops += matmul_flops(func, args, out)
        if not func.is_view and name not in _FREE:
            outs = _tensors(out)
            c.mem_bytes += sum(_nbytes(t) for t in _tensors((args, kwargs)))
            c.mem_bytes += sum(_nbytes(t) for t in outs)
            for t in outs:
                self._track(t)
        if c.n_ops % POLL == 0:
            self._poll()
        return out

    def __exit__(self, *exc):
        self._poll()
        self._live = {}
        return super().__exit__(*exc)


def count_step(fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` once under a ``StepCounter``; returns
    (its result, the ``StepCost``)."""
    counter = StepCounter(inputs=(args, kwargs))
    with counter:
        out = fn(*args, **kwargs)
    return out, counter.cost
