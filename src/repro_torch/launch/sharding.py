"""Logical activation/parameter sharding rules, on DeviceMesh and DTensor.

Counterpart of ``repro.launch.sharding``. The model code calls
``constrain(x, logical_spec)`` on key activations. When a mesh is active
(set by the launcher through ``use_mesh``) and ``x`` is a DTensor, this
``redistribute``s it to the placements the spec resolves to (the
counterpart of ``with_sharding_constraint``); with no mesh, or on a plain
tensor, it returns ``x`` itself, so model code never has to know whether
it is distributed.

Logical axis names used by the model code:
  "data"  — batch / fsdp axis  (multi-pod: ("pod", "data"))
  "model" — tensor-parallel axis
  "seq"   — context-parallel axis for long-KV decode (mapped to "data")

A spec is a ``PartitionSpec``: one entry per tensor dim, each a mesh axis
name, None, or a tuple of names. ``placements`` turns it into a
DeviceMesh's placements; the spec rules themselves (here and in
``specs.py``) need only the mesh's axis names and sizes, so they run on a
``MeshShape`` with no process group.

Under ``use_mesh`` a plain tensor that meets a DTensor in one op counts as
replicated (``implicit_replication``): the positions, masks and constants
the model makes on the fly, as GSPMD replicates an unsharded operand.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import (
    DTensor, Partial, Replicate, Shard, distribute_tensor,
)
from torch.distributed.tensor.experimental import implicit_replication

_state = threading.local()


class PartitionSpec(tuple):
    """One entry per tensor dim: a mesh axis name, None (replicated), or a
    tuple of mesh axis names (the dim split over all of them, in order)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes, with no devices behind them."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.sizes:
            n *= s
        return n


def mesh_shape(mesh) -> MeshShape:
    """The ``MeshShape`` of a DeviceMesh (or of a ``MeshShape``)."""
    if isinstance(mesh, MeshShape):
        return mesh
    return MeshShape(tuple(mesh.mesh_dim_names), tuple(mesh.shape))


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (a DeviceMesh, or a ``MeshShape`` for the rules
    alone)."""
    mesh: Any
    spec: PartitionSpec

    @property
    def placements(self):
        return placements(self.mesh, self.spec)


def placements(mesh, spec: Sequence) -> Tuple[Any, ...]:
    """DeviceMesh placements of ``spec``: ``Shard(dim)`` on each mesh dim
    that splits tensor dim ``dim`` (a dim split over ("pod", "data") is
    ``Shard(dim)`` on both, in mesh order), ``Replicate()`` elsewhere."""
    names = mesh_shape(mesh).axis_names
    out = [Replicate()] * len(names)
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        for name in (tuple(ax) if isinstance(ax, (tuple, list)) else (ax,)):
            out[names.index(name)] = Shard(dim)
    return tuple(out)


def _rules() -> Optional[Dict[str, Any]]:
    return getattr(_state, "rules", None)


@contextlib.contextmanager
def use_mesh(mesh, logical_to_mesh: Optional[Dict[str, Any]] = None):
    """Activate a mesh + logical-axis mapping for model-internal constraints.

    logical_to_mesh maps logical names ("data"/"model"/"seq") to mesh axis
    names or tuples of them, e.g. {"data": ("pod", "data"), "model": "model"}.
    """
    if logical_to_mesh is None:
        logical_to_mesh = default_logical_map(mesh)
    prev = getattr(_state, "rules", None)
    _state.rules = {"mesh": mesh, "map": logical_to_mesh}
    try:
        with implicit_replication():
            yield
    finally:
        _state.rules = prev


def default_logical_map(mesh) -> Dict[str, Any]:
    names = mesh_shape(mesh).axis_names
    if "pod" in names:
        return {"data": ("pod", "data"), "model": "model", "seq": ("pod", "data")}
    return {"data": "data", "model": "model", "seq": "data"}


_MISSING = object()


def resolve_spec(logical: Sequence[Optional[str]]) -> Optional[PartitionSpec]:
    """None if any logical axis is absent from the active map (skip constraint)."""
    rules = _rules()
    if rules is None:
        return None
    m = rules["map"]
    out = []
    for ax in logical:
        if ax is None:
            out.append(None)
        else:
            got = m.get(ax, _MISSING)
            if got is _MISSING:
                return None
            out.append(got)
    return P(*out)


def guarded_spec(mesh, shape, spec: Sequence) -> PartitionSpec:
    """``spec`` with the axes dropped whose mesh size does not divide their
    dim (e.g. kv_heads < |model|), and with each mesh axis kept on its
    first dim only (a mesh axis may shard at most one dim)."""
    fixed, used = [], set()
    for dim, ax in zip(shape, spec):
        size = _axis_size(mesh, ax)
        names = (tuple(ax) if isinstance(ax, (tuple, list))
                 else (ax,)) if ax is not None else ()
        ok = (ax is not None and dim % size == 0 and dim >= size
              and not any(n in used for n in names))
        fixed.append(ax if ok else None)
        if ok:
            used.update(names)
    return P(*fixed)


def constrain(x: torch.Tensor, logical: Sequence[Optional[str]]
              ) -> torch.Tensor:
    """Redistribute a DTensor to the spec's placements if a mesh is active
    (else identity)."""
    rules = _rules()
    if rules is None or not isinstance(x, DTensor):
        return x
    spec = resolve_spec(logical)
    if spec is None:
        return x
    mesh = rules["mesh"]
    return x.redistribute(mesh, placements(mesh,
                                           guarded_spec(mesh, x.shape, spec)))


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


def named_sharding(mesh, *logical: Optional[str],
                   logical_to_mesh: Optional[Dict[str, Any]] = None
                   ) -> NamedSharding:
    """Build a NamedSharding from logical axis names (launcher-side helper)."""
    m = logical_to_mesh or default_logical_map(mesh)
    return NamedSharding(mesh, P(*[m.get(ax) if ax else None
                                   for ax in logical]))


def distribute(x: torch.Tensor, sharding: NamedSharding) -> DTensor:
    """``x`` (the whole tensor, on every rank) as a DTensor of
    ``sharding``: each rank keeps its own shard, with no communication."""
    return distribute_tensor(x, sharding.mesh, sharding.placements,
                             src_data_rank=None)


def replicated(x: torch.Tensor, mesh) -> DTensor:
    """A plain tensor (the whole tensor on every rank) as a replicated
    DTensor; differentiable, so it may sit inside an autograd graph."""
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def local_shard(x: torch.Tensor, mesh, target, split_dims) -> torch.Tensor:
    """``x``'s local shard at placements ``target``, for a computation on
    local shards that is split over the mesh dims ``split_dims`` (those
    where some operand is sharded). On a mesh dim of ``split_dims`` where
    ``x`` is replicated each rank's gradient of it is a part of the whole
    (it saw its own part of the other operands), so the backward sums the
    parts there (a ``Partial`` gradient). A plain ``x`` counts as
    replicated."""
    if not isinstance(x, DTensor):
        x = replicated(x, mesh)
    grad = [Partial() if i in split_dims and not p.is_shard() else p
            for i, p in enumerate(target)]
    return x.redistribute(mesh, target).to_local(grad_placements=grad)


def split_dims_of(*placements) -> set:
    """The mesh dims on which any of these placements is a ``Shard``."""
    return {i for pl in placements for i, p in enumerate(pl)
            if p.is_shard()}


def reduce_partial(x: torch.Tensor) -> torch.Tensor:
    """``x`` with its partial sums reduced (a ``Partial`` placement made
    ``Replicate``): where the next op would otherwise have DTensor move an
    operand to ``Partial``, which not every torch release can. A plain
    tensor, or one with nothing partial, is returned as it is."""
    if not isinstance(x, DTensor) or not any(p.is_partial()
                                             for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, [
        Replicate() if p.is_partial() else p for p in x.placements])


def pin_grad(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself, whose gradient the backward redistributes to ``x``'s
    placements before it flows on (a plain tensor is returned as it is)."""
    if not isinstance(x, DTensor):
        return x
    return DTensor.from_local(x.to_local(), x.device_mesh, x.placements,
                              run_check=False)


def unshard_unless_divides(x: torch.Tensor, dim: int, n: int
                           ) -> torch.Tensor:
    """``x`` with dim ``dim`` replicated unless its shard count divides
    ``n``: before a reshape splits that dim into ``n`` parts (heads), which
    DTensor cannot do to an unevenly sharded dim, where GSPMD reshards. A
    plain tensor is returned as it is."""
    if not isinstance(x, DTensor):
        return x
    dim = dim % x.ndim
    shards = [i for i, p in enumerate(x.placements) if p.is_shard(dim)]
    count = 1
    for i in shards:
        count *= x.device_mesh.size(i)
    if n % count == 0:
        return x
    pl = list(x.placements)
    for i in shards:
        pl[i] = Replicate()
    return x.redistribute(x.device_mesh, pl)


def on_local_shards(fn: Callable, logical_in: Sequence[Sequence],
                    out_like: Sequence[int], *args):
    """``fn`` over each rank's local shards, for code that takes plain
    tensors (the hand-written kernels, which read raw pointers).

    With no active mesh, or no DTensor among ``args``, this is ``fn(*args)``.
    Otherwise each argument is redistributed to its logical spec in
    ``logical_in`` (guarded as ``constrain`` guards it; a plain tensor
    counts as replicated), ``fn`` runs on the local shards, and output
    ``i`` becomes a DTensor placed as argument ``out_like[i]`` (of the same
    global shape), or replicated where ``out_like[i]`` is None. ``fn`` must
    be independent across the sharded dims, as a per-channel scan is."""
    rules = _rules()
    if rules is None or not any(isinstance(a, DTensor) for a in args):
        return fn(*args)
    mesh = rules["mesh"]
    where = [placements(mesh, guarded_spec(mesh, a.shape,
                                           resolve_spec(logical)))
             for a, logical in zip(args, logical_in, strict=True)]
    split = split_dims_of(*where)
    local = [local_shard(a, mesh, w, split) for a, w in zip(args, where)]
    outs = fn(*local)
    rep = [Replicate()] * mesh.ndim
    return tuple(DTensor.from_local(o, mesh, rep if i is None else where[i],
                                    run_check=False)
                 for o, i in zip(outs, out_like, strict=True))
