"""Training driver: smoke-scale on one device, the production mesh under
torchrun.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
        --smoke --steps 200 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt \
        [--resume] [--device cuda|cpu]

The same flags as ``repro.launch.train``, plus ``--device`` (CUDA unless
``--device cpu``). The driver trains under ``use_mesh`` of the (1, 1)
host mesh, as the reference does: its tensors are plain, so every
sharding constraint is an identity (an MoE layer takes ``moe_fwd_ep``).
``--production-mesh`` trains on the (16, 16) mesh of 256 cards, the state
and batches DTensors placed by ``launch.specs``:

    torchrun --nnodes 32 --nproc-per-node 8 ... -m repro_torch.launch.train \
        --arch qwen3-1.7b --production-mesh

It raises, naming the 256-rank world it needs, in any other world.

Fault tolerance: periodic async checkpoints (atomic, checksummed), resume
from LATEST (restore reshards onto the current mesh), straggler detection
on step times, and a final checkpoint on SIGTERM/SIGINT.
"""
from __future__ import annotations

import argparse
import os
import signal
import sys
import time

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.configs import get_config, ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.launch import sharding as shlib
from repro_torch.launch import specs as sp
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models import build_model
from repro_torch.runtime.fault_tolerance import RecoveryLog, StragglerDetector
from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.data import Pipeline, PipelineConfig
from repro_torch.training.optimizer import AdamWConfig, wsd_schedule
from repro_torch.training import tree as tree_lib
from repro_torch.training.train_step import (
    TrainState, init_train_state, init_train_state_shapes, make_train_step,
)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--data", default="recall", choices=["recall", "lm"])
    ap.add_argument("--production-mesh", action="store_true",
                    help="16x16 mesh of 256 cards, under torchrun "
                         "(raises in any other world)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (cuda unless 'cpu' is "
                         "asked for)")
    return ap


def _scalar(x: torch.Tensor) -> float:
    """A metric's value; a DTensor's (a partial sum, on a mesh) reduced
    first."""
    return float(x.full_tensor() if isinstance(x, DTensor) else x)


def train(argv=None) -> TrainState:
    """Run the driver; returns the final state (resumed and not stepped
    when the checkpoint is already at ``--steps``)."""
    args = _parser().parse_args(argv)
    device = resolve_device(args.device)
    if args.production_mesh:
        if "RANK" in os.environ and not dist.is_initialized():
            dist.init_process_group(               # torchrun's env://
                "nccl" if device.type == "cuda" else "gloo")
        mesh = make_production_mesh(device_type=device.type)
    else:
        mesh = make_host_mesh(device)

    cfg = get_config(args.arch, smoke=args.smoke)
    model = build_model(cfg)
    opt_cfg = AdamWConfig(
        lr=wsd_schedule(args.lr, args.steps // 10, args.steps // 2,
                        args.steps // 3))

    pipe = Pipeline(PipelineConfig(cfg.vocab_size, args.seq, args.batch,
                                   kind=args.data))
    log = RecoveryLog()
    stragglers = StragglerDetector()
    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None

    start_step = 0
    state = None
    state_sh = None
    if args.production_mesh:
        state_sh = sp.train_state_shardings(
            init_train_state_shapes(model, opt_cfg), mesh)
        batch_sh = sp.train_batch_specs(
            cfg, ShapeConfig("driver", args.seq, args.batch, "train"),
            mesh)[1]
    if args.resume and ckpt and ckpt.latest_step() is not None:
        state, extra = ckpt.restore(device=device, shardings=state_sh)
        pipe.restore(extra["pipeline"])
        start_step = extra["step"]
        log.record("resumed", step=start_step)
        print(f"resumed from step {start_step}")
    if state is None:
        state = init_train_state(model, 0, opt_cfg, device)
        if state_sh is not None:
            state = tree_lib.unflatten(state, [
                shlib.distribute(x, s) for x, s in
                zip(tree_lib.leaves(state), tree_lib.leaves(state_sh))])

    step_fn = make_train_step(model, opt_cfg, accum_steps=args.accum,
                              remat=True)

    stop = {"flag": False}

    def _sig(_s, _f):
        stop["flag"] = True
    old = {s: signal.signal(s, _sig) for s in (signal.SIGTERM, signal.SIGINT)}

    def save(step: int) -> None:
        ckpt.save(step, state, extra={"step": step, "pipeline": pipe.state()})

    try:
        for step in range(start_step, args.steps):
            t0 = time.perf_counter()  # simcheck: ignore[wallclock]
            batch = {k: torch.as_tensor(v, dtype=torch.long, device=device)
                     for k, v in pipe.next_batch().items()}
            if state_sh is not None:
                batch = {k: shlib.distribute(v, batch_sh[k])
                         for k, v in batch.items()}
            if args.accum > 1:
                batch = {k: v.reshape(args.accum, -1, *v.shape[1:])
                         for k, v in batch.items()}
            with shlib.use_mesh(mesh):
                state, metrics = step_fn(state, batch)
            loss = _scalar(metrics["loss"])         # waits for the step
            dt = time.perf_counter() - t0  # simcheck: ignore[wallclock]
            stragglers.record("host0", dt)
            if step % 10 == 0 or step == args.steps - 1:
                print(f"step {step:5d} loss {loss:.4f} "
                      f"gnorm {_scalar(metrics['grad_norm']):.3f} "
                      f"{dt*1e3:.0f}ms")
            if ckpt and (step + 1) % args.ckpt_every == 0:
                save(step + 1)
            if stop["flag"]:
                print("preemption signal — checkpointing and exiting")
                if ckpt:
                    save(step + 1)
                    ckpt.wait()
                log.record("preempted", step=step + 1)
                return state
        if ckpt:
            save(args.steps)
            ckpt.wait()
    finally:
        for s, handler in old.items():
            signal.signal(s, handler)
    return state


def main(argv=None) -> int:
    train(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
