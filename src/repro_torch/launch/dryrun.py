"""Multi-pod dry run: prove every (arch x shape x mesh) cell runs on the
production mesh, and extract its roofline terms.

Counterpart of ``repro.launch.dryrun``. The reference lowers and compiles
each cell's step on 512 forced host devices; the port runs it once, on a
``fake`` process group of 256 (or 512) ranks in this process, as rank 0:
the state and the inputs are DTensors placed by ``launch.specs``, whose
local shards are ``meta`` tensors (shapes and dtypes, no memory and no
data), and the step runs under ``launch.step_cost``'s counter. Every
collective DTensor issues is counted on the rank's local shapes; the fake
group moves nothing. Per cell:

    state/inputs = distribute(meta stand-ins, specs(arch, shape, mesh))
    out, cost    = count_step(step_fn, *inputs)     # one rank, local ops
    roofline     = analyze(cost, cfg, shape)        # H100 constants

The shards are meta tensors rather than FakeTensors because DTensor's own
sharding propagation builds index tensors for some placements and reads
them back (``tolist``), which a FakeTensorMode refuses; a meta shard
leaves that work on the CPU. On the meta device the selective scan has no
kernel to run: ``models.mamba`` gives its shapes (``_MetaScan``).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b \
        --shape train_4k [--multi-pod] [--json out.json]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]
"""
from __future__ import annotations

import argparse
import json
import logging
import sys
import time
import traceback
from typing import Any, Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.configs import (
    ASSIGNED, AttnKind, SHAPES, get_config, get_shape, shape_applicable,
)
from repro_torch.launch import roofline as rl
from repro_torch.launch import sharding as shlib
from repro_torch.launch import specs as sp
from repro_torch.launch.mesh import HBM_BYTES, make_production_mesh
from repro_torch.launch.step_cost import count_step
from repro_torch.models import build_model
from repro_torch.models import transformer
from repro_torch.training import tree as tree_lib
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_step import (
    init_train_state_shapes, make_train_step,
)

# archs whose optimizer state must be int8 to fit a single pod
INT8_OPT_ARCHS = {"jamba-1.5-large-398b"}


def _opt_cfg(arch: str) -> AdamWConfig:
    return AdamWConfig(lr=1e-4, int8_state=arch in INT8_OPT_ARCHS)


def init_fake_world(n_ranks: int) -> None:
    """This process as rank 0 of a ``fake`` process group of ``n_ranks``
    (no other process, no network: its collectives move nothing)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() != n_ranks:
            raise RuntimeError(f"a world of {dist.get_world_size()} ranks "
                               f"is initialised, not {n_ranks}")
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n_ranks)


def mesh_name(mesh) -> str:
    return "x".join(str(n) for n in shlib.mesh_shape(mesh).sizes)


def build_cell(arch: str, shape_name: str, mesh, kv_bits: int = 16):
    """Returns (step_fn, in_specs, in_shardings, aux_info): the step, its
    inputs as meta stand-ins, their shardings on ``mesh``."""
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    model = build_model(cfg)
    n_params = model.param_count()
    n_active = model.active_param_count()
    logical = shlib.default_logical_map(mesh)
    aux = (cfg, model, shape, n_params, n_active)

    if shape.kind == "train":
        opt_cfg = _opt_cfg(arch)
        state_shapes = init_train_state_shapes(model, opt_cfg)
        state_sh = sp.train_state_shardings(state_shapes, mesh)
        batch_specs, batch_sh = sp.train_batch_specs(cfg, shape, mesh)
        raw_step = make_train_step(model, opt_cfg, accum_steps=1, remat=True)

        def step(state, batch):
            with shlib.use_mesh(mesh, logical):
                return raw_step(state, batch)

        return (step, (state_shapes, batch_specs), (state_sh, batch_sh),
                aux)

    params_shapes = model.init_shapes()
    params_sh = sp.param_shardings(params_shapes, mesh, mode="serve")

    if shape.kind == "prefill":
        batch_specs, batch_sh = sp.prefill_batch_specs(cfg, shape, mesh)
        batch_specs.pop("labels")
        batch_sh.pop("labels")

        def step(params, batch):
            with shlib.use_mesh(mesh, logical):
                # bounded expert buffers at 32k scale
                return transformer.prefill(params, cfg, batch,
                                           capacity=shape.seq_len,
                                           moe_dropless=False)

        return (step, (params_shapes, batch_specs), (params_sh, batch_sh),
                aux)

    # decode
    if cfg.attn_kind != AttnKind.GQA:
        kv_bits = 16            # the quantized decode is the GQA data plane
    (cache_shapes, idx_spec, tok_spec), (cache_sh, idx_sh, tok_sh) = \
        sp.decode_specs(cfg, model, shape, mesh, kv_bits=kv_bits)
    long_ctx = shape.name == "long_500k"
    logical_decode = dict(logical)
    logical_decode["seq_kv"] = ("data", "model") if long_ctx else "model"

    def step(params, cache, idx, toks):
        with shlib.use_mesh(mesh, logical_decode):
            return transformer.decode_step(params, cfg, cache, idx, toks)

    return (step, (params_shapes, cache_shapes, idx_spec, tok_spec),
            (params_sh, cache_sh, idx_sh, tok_sh), aux)


def place(specs: Any, shardings: Any) -> Any:
    """Each meta stand-in as a DTensor of its sharding, its local shard a
    meta tensor."""
    leaves = [shlib.distribute(torch.empty(x.shape, dtype=x.dtype,
                                           device="meta"), s)
              for x, s in zip(tree_lib.leaves(specs),
                              tree_lib.leaves(shardings), strict=True)]
    return tree_lib.unflatten(specs, leaves)


def local_bytes(tree: Any) -> int:
    """The bytes of the rank's local shards of a tree of DTensors."""
    return sum(t.to_local().numel() * t.element_size()
               for t in tree_lib.leaves(tree) if isinstance(t, DTensor))


def count_cell(arch: str, shape_name: str, mesh, kv_bits: int = 16):
    """Place the cell's inputs and run its step once under the counter;
    returns (cost, aux_info, args_bytes, build_s, step_s)."""
    t0 = time.perf_counter()  # simcheck: ignore[wallclock]
    step, in_specs, in_sh, aux = build_cell(arch, shape_name, mesh, kv_bits)
    args = tuple(place(s, sh) for s, sh in zip(in_specs, in_sh))
    args_bytes = float(local_bytes(args))
    t1 = time.perf_counter()  # simcheck: ignore[wallclock]
    _, cost = count_step(step, *args)
    t2 = time.perf_counter()  # simcheck: ignore[wallclock]
    return cost, aux, args_bytes, t1 - t0, t2 - t1


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             verbose: bool = True, kv_bits: int = 16,
             mesh: Optional[Any] = None) -> dict:
    """One cell on the production mesh (or on ``mesh``, a DeviceMesh over
    an initialised group)."""
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    ok, why = shape_applicable(cfg, shape)
    name = ("2x16x16" if multi_pod else "16x16") if mesh is None \
        else mesh_name(mesh)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": name,
                "status": "skipped", "reason": why}
    try:
        if mesh is None:
            init_fake_world(512 if multi_pod else 256)
            mesh = make_production_mesh(multi_pod=multi_pod,
                                        device_type="cpu")
        n_chips = mesh.size()
        cost, aux, args_bytes, build_s, step_s = count_cell(
            arch, shape_name, mesh, kv_bits)
        cfg, model, shape, n_params, n_active = aux
        eff_bits = kv_bits if shape.kind == "decode" else 16
        roof = rl.analyze(arch, shape, name, n_chips, cost, cfg, n_params,
                          n_active, kv_bits=eff_bits,
                          opt_bytes_per_param=(2.25 if arch in
                                               INT8_OPT_ARCHS else 8.0))
        peak = rl.analytic_peak_bytes(cfg, shape, n_params, n_chips,
                                      args_bytes)
        result = {
            "arch": arch, "shape": shape_name, "mesh": name,
            "status": "ok", "n_chips": n_chips,
            "n_params": n_params, "n_active_params": n_active,
            "build_s": build_s, "step_s": step_s,
            "memory_analysis": (f"args {args_bytes:.4g} B, live peak "
                                f"{cost.live_peak_bytes:.4g} B a rank"),
            "args_bytes_per_chip": args_bytes,
            "analytic_peak_bytes": peak,
            "eager_live_peak_bytes": cost.live_peak_bytes,
            "fits_hbm": bool(peak <= HBM_BYTES),
            "n_ops": cost.n_ops,
            **roof.to_dict(),
        }
        if verbose:
            print(f"[{arch} x {shape_name} x {name}] OK "
                  f"build={build_s:.1f}s step={step_s:.1f}s")
            print(f"  memory: {result['memory_analysis']}")
            print(f"  cost: flops/chip={roof.flops:.3e} "
                  f"hbm/chip={roof.hbm_bytes:.3e} "
                  f"coll/chip={roof.collective_bytes:.3e}")
            print(f"  roofline: compute={roof.t_compute*1e3:.2f}ms "
                  f"memory={roof.t_memory*1e3:.2f}ms "
                  f"collective={roof.t_collective*1e3:.2f}ms "
                  f"-> bottleneck={roof.bottleneck} "
                  f"useful_ratio={roof.useful_flops_ratio:.2f}")
        return result
    except Exception as e:
        if verbose:
            traceback.print_exc()
        return {"arch": arch, "shape": shape_name, "mesh": name,
                "status": "error", "error": f"{type(e).__name__}: {e}"}


def quiet() -> None:
    """Silence DTensor's advice on the fake group's collectives (a CPU
    group's all-to-all, sequential all-reduces)."""
    logging.getLogger("torch.distributed").setLevel(logging.ERROR)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--json", default=None)
    ap.add_argument("--kv-bits", type=int, default=16, choices=(2, 4, 8, 16),
                    help="decode cells: packed quantized-KV decode step")
    args = ap.parse_args(argv)
    quiet()

    cells = []
    if args.all:
        for arch in ASSIGNED:
            for shape in SHAPES:
                cells.append((arch, shape.name))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        cells.append((args.arch, args.shape))

    results = [run_cell(a, s, args.multi_pod, kv_bits=args.kv_bits)
               for a, s in cells]
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)
    bad = [r for r in results if r["status"] == "error"]
    print(f"\n{len(results)} cells: "
          f"{sum(r['status'] == 'ok' for r in results)} ok, "
          f"{sum(r['status'] == 'skipped' for r in results)} skipped, "
          f"{len(bad)} errors")
    for r in bad:
        print(f"  ERROR {r['arch']} x {r['shape']}: {r['error'][:200]}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
