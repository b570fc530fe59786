"""Train step: loss -> grads -> AdamW, with grad accumulation, remat, and
int8-compressed gradient reduction (error feedback).

Counterpart of ``repro.training.train_step``. ``make_train_step`` returns
an eager function of (state, batch); gradients come from autograd
(``torch.autograd.grad``), and accumulation is a loop over microbatches
where the reference runs ``lax.scan``. The step updates the state's tensors
in place (``optimizer.adamw_update``) and returns them.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.models import Model
from repro_torch.training import tree as tree_lib
from repro_torch.training.optimizer import (
    AdamWConfig, AdamWState, adamw_init, adamw_update, global_norm,
)


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState


def init_train_state(model: Model, seed: int, opt_cfg: AdamWConfig,
                     device="cuda") -> TrainState:
    """Seeded params (``Model.init``) and zero moments on ``device``
    (CUDA unless asked)."""
    params = model.init(seed, device)
    return TrainState(params, adamw_init(opt_cfg, params))


def init_train_state_shapes(model: Model, opt_cfg: AdamWConfig
                            ) -> TrainState:
    """The train state on the ``meta`` device: shapes and dtypes, no
    allocation (the dry run's path)."""
    params = model.init_shapes()
    return TrainState(params, adamw_init(opt_cfg, params))


def make_train_step(model: Model, opt_cfg: AdamWConfig,
                    accum_steps: int = 1, remat: bool = True):
    """batch leaves: (accum, per_step_batch, ...) when accum_steps > 1."""

    def value_and_grad(params, batch):
        # leaves that require grad, sharing the params' storage
        leaves = [p.detach().requires_grad_()
                  for p in tree_lib.leaves(params)]
        loss = model.loss(tree_lib.unflatten(params, leaves), batch,
                          remat=remat)
        # a leaf the batch does not reach (a VLM's patch projection on a
        # text batch) gets zeros, as ``jax.grad`` gives it
        grads = [torch.zeros_like(p) if g is None else g for p, g in
                 zip(leaves, torch.autograd.grad(loss, leaves,
                                                 allow_unused=True))]
        return loss.detach(), tree_lib.unflatten(params, grads)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        if accum_steps == 1:
            loss, grads = value_and_grad(state.params, batch)
        else:
            loss = 0
            grads = tree_lib.map_leaves(
                lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device), state.params)
            for i in range(accum_steps):
                mb = {k: v[i] for k, v in batch.items()}
                l, g = value_and_grad(state.params, mb)
                loss = loss + l
                for acc, gi in zip(tree_lib.leaves(grads),
                                   tree_lib.leaves(g)):
                    acc.add_(gi)
            loss = loss / accum_steps
            for acc in tree_lib.leaves(grads):
                acc.div_(accum_steps)

        new_params, new_opt = adamw_update(opt_cfg, grads, state.opt,
                                           state.params)
        metrics = {"loss": loss, "grad_norm": global_norm(grads)}
        return TrainState(new_params, new_opt), metrics

    return train_step


# ---------------------------------------------------------------------------
# int8 gradient compression (explicit collective variant)
# ---------------------------------------------------------------------------

def compressed_psum(x: torch.Tensor, group: Optional[Any] = None,
                    err: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize-to-int8 -> sum over the processes of ``group`` ->
    dequantize, with error feedback.

    Cuts per-gradient collective bytes 4x (f32) / 2x (bf16) at the cost of
    quantization noise that the error-feedback residual re-injects on the
    next step (standard EF-SGD construction). With no ``group`` there is
    one process and each reduction is the identity (the reference's
    1-device mesh); with one, the reductions are ``torch.distributed``
    all-reduces over it.
    """
    xf = x.to(torch.float32) + (0.0 if err is None else err)
    local = torch.max(torch.abs(xf)) / 127.0
    # all processes must quantize with ONE scale or the int sum is
    # meaningless; the scalar max is a negligible extra collective.
    scale = torch.where(local > 0, local, torch.full_like(local, 1e-12))
    if group is not None:
        dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    # xf - q * scale rounded once, as the reference's fused multiply-add
    # gives it: the product of an int8 and an f32 is exact in f64
    new_err = (xf.double() - q.double() * scale.double()).to(torch.float32)
    # an int8 sum can overflow past 127 processes; accumulate in int32.
    summed = q.to(torch.int32)
    if group is not None:
        dist.all_reduce(summed, op=dist.ReduceOp.SUM, group=group)
    return summed.to(torch.float32) * scale, new_err
