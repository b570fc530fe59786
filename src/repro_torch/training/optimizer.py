"""AdamW with optional blockwise-int8 moment state, and the LR schedules.

Counterpart of ``repro.training.optimizer``, the same arithmetic in the same
order. The int8 state (per-64-block absmax scaling along the last dim) cuts
the moments' memory 4x against f32: full-width adaptcache-8b's f32 m and v
(64 GB) do not fit one 80 GB card beside its bf16 params and grads, its int8
m and v (17 GB) do. Quantization error is re-absorbed every step because the
moments are dequantized, updated and requantized with fresh scales.

Two differences from the reference, both for memory:
  * ``adamw_update`` writes the new params and moments into the given
    tensors and returns them (the reference's arrays are immutable and it
    returns new ones);
  * it walks each leaf in slices of at most ``SLICE_ELEMS`` elements along
    the leading dims, so its f32 temporaries stay small (a whole (32, 4096,
    14336) leaf would need 7.5 GB for each). The int8 blocks lie along the
    last dim, so a slice's codes and scales are those of the whole leaf, bit
    for bit: the reference's own "shard-local" argument.

On a mesh (DTensor leaves) each rank updates its own shard of each leaf:
the gradient is brought to the param's placements, the moments to the
same shard (the int8 codes' block dim standing in for the param's last
dim, which stays whole where its shards are not whole blocks), and the
global norm sums each rank's squares over the shards. A slice of a
sharded dim is no view to write through, so the update runs on the local
tensors and writes back what had to move.

Also the WSD (warmup-stable-decay) schedule used by MiniCPM, and a cosine one.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Tuple, Union

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate

from repro_torch.training import tree as tree_lib

Params = Any

BLOCK = 64
SLICE_ELEMS = 1 << 25        # elements of a leaf that one update slice takes


# ---------------------------------------------------------------------------
# blockwise int8 tensor codec
# ---------------------------------------------------------------------------

def _q8_shapes(shape) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """(codes, scales) shapes of a leaf of ``shape``."""
    lead = tuple(shape[:-1]) if len(shape) else ()
    last = shape[-1] if len(shape) else 1
    nb = -(-last // BLOCK)
    return lead + (nb, BLOCK), lead + (nb, 1)


def _q8_encode(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blockwise int8 along the LAST dim, leading dims preserved; codes
    round half to even."""
    last = x.shape[-1] if x.ndim else 1
    xr = x.reshape(x.shape if x.ndim else (1,))
    pad = (-last) % BLOCK
    if pad:
        xr = F.pad(xr, (0, pad))
    blocks = xr.reshape(*xr.shape[:-1], -1, BLOCK)
    scale = blocks.abs().amax(dim=-1, keepdim=True) / 127.0
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(blocks / safe), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def _q8_decode(q: torch.Tensor, scale: torch.Tensor, shape,
               dtype) -> torch.Tensor:
    x = q.to(torch.float32) * scale
    x = x.reshape(*x.shape[:-2], -1)          # merge block dims (local)
    last = shape[-1] if len(shape) else 1
    x = x[..., :last]
    return x.reshape(shape).to(dtype)


class Q8Tensor(NamedTuple):
    q: torch.Tensor
    scale: torch.Tensor


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: Union[Callable[[torch.Tensor], torch.Tensor], float] = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    int8_state: bool = False


class AdamWState(NamedTuple):
    step: torch.Tensor            # int32 scalar on the params' device
    m: Params
    v: Params


def _lr_at(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    if callable(cfg.lr):
        return cfg.lr(step)
    return torch.tensor(cfg.lr, dtype=torch.float32, device=step.device)


def adamw_init(cfg: AdamWConfig, params: Params) -> AdamWState:
    """Zero moments on each param's device: f32, or int8 codes with f32
    scales (the encoding of zeros: codes 0, scales 0)."""
    def zeros_like(p):
        if cfg.int8_state:
            qs, ss = _q8_shapes(p.shape)
            return Q8Tensor(
                torch.zeros(qs, dtype=torch.int8, device=p.device),
                torch.zeros(ss, dtype=torch.float32, device=p.device))
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    m = tree_lib.map_leaves(zeros_like, params)
    v = tree_lib.map_leaves(zeros_like, params)
    device = tree_lib.leaves(params)[0].device
    return AdamWState(torch.zeros((), dtype=torch.int32, device=device), m, v)


def _row_slices(t: torch.Tensor):
    """(start, stop) ranges of rows, ``t``'s leading dims merged, each at
    most ``SLICE_ELEMS`` elements; one range (None: all of ``t``) for a
    leaf of fewer than 2 dims."""
    if t.ndim < 2:
        return [None]
    rows = t.numel() // t.shape[-1]
    step = max(1, SLICE_ELEMS // max(t.shape[-1], 1))
    return [(r, min(r + step, rows)) for r in range(0, rows, step)]


def _rows(t: torch.Tensor, lead: int, rs):
    """Rows ``rs`` of ``t`` with its first ``lead`` dims merged: a view, so
    writes land in ``t``."""
    if rs is None:
        return t
    return t.view(-1, *t.shape[lead:])[rs[0]:rs[1]]


def _sq_sum(x: torch.Tensor) -> torch.Tensor:
    x = x.contiguous()
    leaf = 0
    for rs in _row_slices(x):
        part = _rows(x, x.ndim - 1, rs).to(torch.float32)
        leaf = leaf + torch.sum(torch.square(part))
    return leaf


def global_norm(tree: Params) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares; a DTensor leaf's squares
    summed on each rank's shard, then over the shards."""
    total = 0
    for x in tree_lib.leaves(tree):
        if isinstance(x, DTensor):
            x = x.redistribute(x.device_mesh, [
                Replicate() if p.is_partial() else p for p in x.placements])
            part = torch.as_tensor(_sq_sum(x.to_local()), dtype=torch.float32,
                                   device=x.to_local().device)
            total = total + DTensor.from_local(
                part, x.device_mesh,
                [Partial() if p.is_shard() else Replicate()
                 for p in x.placements], run_check=False).full_tensor()
        else:
            total = total + _sq_sum(x)
    return torch.sqrt(total)


def _plain(t):
    return t.full_tensor() if isinstance(t, DTensor) else t


def _work_placements(p: DTensor, int8: bool):
    """The placements an update of ``p`` runs at: ``p``'s own, but, for
    int8 moments, its last dim whole where its shards are not whole
    blocks. A Q8 leaf (lead + (blocks, 64 or 1)) at the same placements
    holds the local shard's blocks: its block dim has the param's last
    dim's index."""
    mesh, last = p.device_mesh, p.ndim - 1
    count = 1
    for i, pl in enumerate(p.placements):
        if pl.is_shard(last):
            count *= mesh.size(i)
    if not int8 or p.ndim == 0 or (p.shape[-1] // count) % BLOCK == 0:
        return list(p.placements)
    return [Replicate() if pl.is_shard(last) else pl for pl in p.placements]


def _local(t: DTensor, placements, write_back: list) -> torch.Tensor:
    """``t``'s local shard at ``placements``: its own storage when it is
    placed so, else a copy that ``write_back`` copies back."""
    placements = list(placements)
    if list(t.placements) == placements:
        return t.to_local()
    mesh = t.device_mesh
    loc = t.redistribute(mesh, placements).to_local()

    def back():
        t.to_local().copy_(DTensor.from_local(
            loc, mesh, placements, run_check=False).redistribute(
                mesh, t.placements).to_local())
    write_back.append(back)
    return loc


def adamw_update(cfg: AdamWConfig, grads: Params, state: AdamWState,
                 params: Params) -> Tuple[Params, AdamWState]:
    """One AdamW step. Writes the new params and moments into ``params``
    and ``state``'s tensors and returns them with the new step count."""
    step = state.step + 1
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = _plain(_lr_at(cfg, step))
    b1c = _plain(1 - cfg.b1 ** step.to(torch.float32))
    b2c = _plain(1 - cfg.b2 ** step.to(torch.float32))

    def upd(p, g, m, v):
        g = g.to(torch.float32) * clip
        if cfg.int8_state:
            m_f = _q8_decode(m.q, m.scale, p.shape, torch.float32)
            v_f = _q8_decode(v.q, v.scale, p.shape, torch.float32)
        else:
            m_f, v_f = m, v
        m_f = cfg.b1 * m_f + (1 - cfg.b1) * g
        v_f = cfg.b2 * v_f + (1 - cfg.b2) * g * g
        mh = m_f / b1c
        vh = v_f / b2c
        u = mh / (torch.sqrt(vh) + cfg.eps)
        if cfg.int8_state:
            # blockwise-quantized m has absolute error ~ block_max/254;
            # where v ~ 0 the Adam ratio amplifies it unboundedly — clip
            # the per-element update (standard 8-bit-optimizer stabilizer).
            u = torch.clamp(u, -3.0, 3.0)
        pf = p.to(torch.float32)
        p.copy_(pf - lr * (u + cfg.weight_decay * pf))
        if cfg.int8_state:
            for old, new in ((m, _q8_encode(m_f)), (v, _q8_encode(v_f))):
                old.q.copy_(new[0])
                old.scale.copy_(new[1])
        else:
            m.copy_(m_f)
            v.copy_(v_f)

    flat_p = tree_lib.leaves(params)
    flat_g = tree_lib.leaves_up_to(params, grads)
    flat_m = tree_lib.leaves_up_to(params, state.m)
    flat_v = tree_lib.leaves_up_to(params, state.v)
    with torch.no_grad():
        for p, g, m, v in zip(flat_p, flat_g, flat_m, flat_v):
            write_back: list = []
            if isinstance(p, DTensor):
                work = _work_placements(p, cfg.int8_state)
                g = g.redistribute(p.device_mesh, work).to_local()
                if cfg.int8_state:
                    m, v = (Q8Tensor(_local(s.q, work, write_back),
                                     _local(s.scale, work, write_back))
                            for s in (m, v))
                else:
                    m, v = (_local(s, work, write_back) for s in (m, v))
                p = _local(p, work, write_back)
            if not p.is_contiguous():
                raise ValueError("adamw_update writes params in place: "
                                 "each must be contiguous")
            lead, g = p.ndim - 1, g.contiguous()
            for rs in _row_slices(p):
                if cfg.int8_state:
                    mv = [Q8Tensor(_rows(s.q, lead, rs),
                                   _rows(s.scale, lead, rs)) for s in (m, v)]
                else:
                    mv = [_rows(s, lead, rs) for s in (m, v)]
                upd(_rows(p, lead, rs), _rows(g, lead, rs), *mv)
            for back in write_back:
                back()
    return params, AdamWState(step, state.m, state.v)


# ---------------------------------------------------------------------------
# LR schedules (functions of an integer step tensor)
# ---------------------------------------------------------------------------

def wsd_schedule(peak_lr: float, warmup: int, stable: int,
                 decay: int, floor: float = 0.1) -> Callable:
    """MiniCPM's Warmup-Stable-Decay schedule."""
    def lr(step: torch.Tensor) -> torch.Tensor:
        s = step.to(torch.float32)
        warm = peak_lr * s / max(warmup, 1)
        dec_frac = torch.clamp((s - warmup - stable) / max(decay, 1),
                               0.0, 1.0)
        dec = peak_lr * (1.0 - (1.0 - floor) * dec_frac)
        return torch.where(s < warmup, warm, dec)
    return lr


def cosine_schedule(peak_lr: float, warmup: int, total: int,
                    floor_frac: float = 0.1) -> Callable:
    def lr(step: torch.Tensor) -> torch.Tensor:
        s = step.to(torch.float32)
        warm = peak_lr * s / max(warmup, 1)
        t = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        # the f32 cosine correctly rounded, as XLA's is; torch's own f32
        # cos is a last bit off at some steps
        c = torch.cos((math.pi * t).to(torch.float64)).to(torch.float32)
        cos = floor_frac + (1 - floor_frac) * 0.5 * (1 + c)
        return torch.where(s < warmup, warm, peak_lr * cos)
    return lr
