"""The port under a mesh: 8 CPU ranks over gloo, one
``torch.multiprocessing.spawn`` for the whole file.

Counterparts of the reference's ``tests/test_sharding.py`` (the sharded
train step, the expert-parallel MoE) and ``tests/test_launch.py`` (the
elastic checkpoint restore), with the reference's own bounds:
  * smoke qwen3-1.7b's train step with its state sharded 4x2 by
    ``train_state_shardings`` equals the single-device step within 2e-3,
    and both equal the reference's jitted single-device loss on the same
    weights (carried across by ``params_from_numpy``); each leaf's
    gradient matches the single-device one;
  * AdamW on the shards updates the params as the plain AdamW does;
  * ``moe_fwd_ep`` on a 2x4 mesh equals ``moe_fwd`` and the reference's
    ``moe_fwd`` within 1e-4 relative, and its gradients match;
  * a train state checkpointed on (4, 2) restores bit for bit onto a
    (2, 2) mesh of 4 of the ranks, with its step;
  * smoke falcon-mamba's forward with params sharded 4x2 (its scan on each
    rank's local channels) equals the plain forward, and so do its
    gradients.
The reference's values are computed here, in the parent; the ranks import
no JAX.
"""
import json
import os
import pickle

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.device import cap_test_threads

cap_test_threads()

WORLD = 8
BATCH = (8, 16)
MOE_X = (4, 16)
LOSS_TOL = 2e-3          # the reference's sharded-vs-single bound
EP_TOL = 1e-4            # the reference's EP bound
MAMBA_TOL = 1e-5         # f32 sums over shards in another order
GRADS_TOL = 1e-5         # the same, for each leaf's gradient
ADAMW_TOL = 1e-6         # elementwise; the global norm sums shards in order


def _rank_main(rank: int, tmp: str) -> None:
    """One rank: the four checks; rank 0 writes the results."""
    torch.set_num_threads(1)
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
    from repro_torch.configs import get_config
    from repro_torch.launch import sharding as shlib
    from repro_torch.launch import specs as sp
    from repro_torch.models import build_model
    from repro_torch.models import moe as M
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.training import tree as tree_lib
    from repro_torch.training.checkpoint import CheckpointManager
    from repro_torch.training.optimizer import (
        AdamWConfig, adamw_init, adamw_update,
    )
    from repro_torch.training.train_step import (
        TrainState, init_train_state_shapes, make_train_step,
    )

    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(tmp, "store"), WORLD), rank=rank, world_size=WORLD)
    with open(os.path.join(tmp, "ref.pkl"), "rb") as f:
        ref = pickle.load(f)
    mesh42 = init_device_mesh("cpu", (4, 2), mesh_dim_names=("data", "model"))
    out = {}

    def place(tree, shards):
        return tree_lib.unflatten(tree, [
            shlib.distribute(x.clone(), s) for x, s in
            zip(tree_lib.leaves(tree), tree_lib.leaves(shards), strict=True)])

    # the sharded train step against the single-device one
    cfg = get_config("qwen3-1.7b", smoke=True)
    model = build_model(cfg)
    opt = AdamWConfig(lr=1e-3)
    params = params_from_numpy(ref["qwen_params"], cfg, "cpu")
    state0 = TrainState(params, adamw_init(opt, params))
    batch = {k: torch.from_numpy(v).long() for k, v in ref["batch"].items()}
    step = make_train_step(model, opt, remat=False)
    _, m0 = step(tree_lib.map_leaves(torch.clone, state0), batch)
    state_sh = sp.train_state_shardings(init_train_state_shapes(model, opt),
                                        mesh42)
    state = place(state0, state_sh)
    bsh = sp.sharding(mesh42, BATCH, "data", None)
    dbatch = {k: shlib.distribute(v, bsh) for k, v in batch.items()}
    with shlib.use_mesh(mesh42):
        _, m1 = step(place(state0, state_sh), dbatch)
    out["loss_single"] = float(m0["loss"])
    out["loss_sharded"] = float(m1["loss"].full_tensor())

    # the sharded backward: each leaf's gradient against the plain one
    def grads(ps, b):
        leaves = [x.detach().requires_grad_() for x in tree_lib.leaves(ps)]
        loss = model.loss(tree_lib.unflatten(ps, leaves), b)
        return torch.autograd.grad(loss, leaves)
    g0 = grads(params, batch)
    with shlib.use_mesh(mesh42):
        g1 = grads(place(params, sp.param_shardings(model.init_shapes(),
                                                    mesh42)), dbatch)
    out["grads_rel"] = max(
        float((a.full_tensor() - b).abs().max() / b.abs().max())
        for a, b in zip(g1, g0, strict=True))

    # AdamW on the shards (f32 and int8 moments) against the plain update,
    # from the same gradients
    out["adamw_rel"] = {}
    for int8 in (False, True):
        ocfg = AdamWConfig(lr=1e-3, int8_state=int8)
        plain = TrainState(tree_lib.map_leaves(torch.clone, params),
                           adamw_init(ocfg, params))
        sh = sp.train_state_shardings(init_train_state_shapes(model, ocfg),
                                      mesh42)
        dstate = place(plain, sh)
        gtree = tree_lib.unflatten(params, list(g0))
        dgrads = place(gtree, sh.params)
        want, _ = adamw_update(ocfg, gtree, plain.opt, plain.params)
        with shlib.use_mesh(mesh42):
            got, _ = adamw_update(ocfg, dgrads, dstate.opt, dstate.params)
        out["adamw_rel"][str(int8)] = max(
            float((a.full_tensor() - b).abs().max() / b.abs().max())
            for a, b in zip(tree_lib.leaves(got), tree_lib.leaves(want),
                            strict=True))

    # a checkpoint of the (4, 2) state restores onto (2, 2)
    ckdir = os.path.join(tmp, "ckpt")
    cm = CheckpointManager(ckdir, async_write=False)
    cm.save(1, state, extra={"step": 1})
    dist.barrier()
    mesh22 = DeviceMesh("cpu", [[0, 1], [2, 3]],
                        mesh_dim_names=("data", "model"))
    if rank < 4:
        sh22 = sp.train_state_shardings(init_train_state_shapes(model, opt),
                                        mesh22)
        restored, extra = CheckpointManager(ckdir).restore(shardings=sh22)
        leaves = tree_lib.leaves(restored)
        out["restore_equal"] = all(
            torch.equal(a.full_tensor(), b)
            for a, b in zip(leaves, tree_lib.leaves(state0), strict=True))
        out["restore_step"] = extra["step"]
        out["restore_ranks"] = leaves[3].device_mesh.size()
        out["restore_sharded"] = sum(
            any(p.is_shard() for p in a.placements) for a in leaves)

    # expert-parallel MoE on 2x4
    mcfg = get_config("olmoe-1b-7b", smoke=True)
    p = {"router": torch.from_numpy(ref["moe_params"]["router"]),
         "experts": {k: torch.from_numpy(v) for k, v in
                     ref["moe_params"]["experts"].items()}}
    x = torch.from_numpy(ref["moe_x"])
    plain, _ = M.moe_fwd(p, mcfg, x, dropless=True)
    mesh24 = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    xs = shlib.distribute(x, sp.sharding(mesh24, x.shape, "data", None, None))
    with shlib.use_mesh(mesh24):
        ep, _ = M.moe_fwd_ep(p, mcfg, xs, dropless=True)
    ep = ep.full_tensor()
    scale = float(plain.abs().max()) + 1e-9
    out["ep_vs_plain"] = float((ep - plain).abs().max()) / scale
    out["ep_vs_reference"] = float(
        (ep - torch.from_numpy(ref["moe_out"])).abs().max()) / scale
    out["plain_vs_reference"] = float(
        (plain - torch.from_numpy(ref["moe_out"])).abs().max()) / scale

    # the output's gradients (x, the router, the experts), through one
    # all-reduce over "model" (the balance loss is left out: EP's is the
    # mean of each data shard's loss, the reference's own definition, not
    # the plain loss over all tokens)
    w = torch.from_numpy(np.random.default_rng(1).standard_normal(
        x.shape).astype(np.float32))

    def moe_grads(fn, xx):
        leaves = [t.detach().requires_grad_() for t in
                  (xx, p["router"], *p["experts"].values())]
        q = {"router": leaves[1], "experts": dict(zip(p["experts"],
                                                      leaves[2:]))}
        o, _ = fn(q, mcfg, leaves[0], dropless=True)
        if isinstance(o, torch.distributed.tensor.DTensor):
            o = o.full_tensor()
        return torch.autograd.grad((o * w).sum(), leaves)
    e0 = moe_grads(M.moe_fwd, x)
    with shlib.use_mesh(mesh24):
        e1 = moe_grads(M.moe_fwd_ep, xs)
    out["ep_grads_rel"] = max(
        float(((a.full_tensor() if hasattr(a, "full_tensor") else a) - b)
              .abs().max() / b.abs().max())
        for a, b in zip(e1, e0, strict=True))

    # the Mamba layers' scan on local channel shards
    fcfg = get_config("falcon-mamba-7b", smoke=True)
    fmodel = build_model(fcfg)
    fparams = fmodel.init(0, "cpu")
    tokens = batch["tokens"] % fcfg.vocab_size
    want = fmodel.forward(fparams, {"tokens": tokens})
    fsh = sp.param_shardings(fmodel.init_shapes(), mesh42)
    with shlib.use_mesh(mesh42):
        got = fmodel.forward(place(fparams, fsh), {
            "tokens": shlib.distribute(tokens, bsh)}).full_tensor()
    out["mamba_rel"] = float((got - want).abs().max()) / float(
        want.abs().max())

    # and its gradients: the scan's operands replicated over a mesh dim
    # (B and C over "model", A over "data") get their shards' parts summed
    def fgrads(ps, b):
        leaves = [x.detach().requires_grad_() for x in tree_lib.leaves(ps)]
        loss = fmodel.loss(tree_lib.unflatten(ps, leaves), b)
        return torch.autograd.grad(loss, leaves)
    fbatch = {"tokens": tokens, "labels": batch["labels"] % fcfg.vocab_size}
    fg0 = fgrads(fparams, fbatch)
    with shlib.use_mesh(mesh42):
        fg1 = fgrads(place(fparams, fsh), {
            k: shlib.distribute(v, bsh) for k, v in fbatch.items()})
    out["mamba_grads_rel"] = max(
        float((a.full_tensor() - b).abs().max() / b.abs().max())
        for a, b in zip(fg1, fg0, strict=True))

    if rank == 0:
        with open(os.path.join(tmp, "out.json"), "w") as f:
            json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as ref_config
    from repro.models import build_model as ref_build
    from repro.models import moe as ref_moe
    from repro.training.optimizer import AdamWConfig as RefAdamW
    from repro.training.train_step import (
        init_train_state as ref_init, make_train_step as ref_step,
    )

    tmp = str(tmp_path_factory.mktemp("dist"))
    cfg = ref_config("qwen3-1.7b", smoke=True)
    model = ref_build(cfg)
    rng = np.random.default_rng(0)
    batch = {k: rng.integers(0, cfg.vocab_size, BATCH).astype(np.int32)
             for k in ("tokens", "labels")}
    opt = RefAdamW(lr=1e-3)
    state = ref_init(model, jax.random.key(0), opt)
    _, m = jax.jit(ref_step(model, opt, remat=False))(
        state, {k: jnp.asarray(v) for k, v in batch.items()})
    mcfg = ref_config("olmoe-1b-7b", smoke=True)
    p = ref_moe.init_moe(jax.random.key(0), mcfg, jnp.float32)
    x = (rng.standard_normal(MOE_X + (mcfg.d_model,)) * 0.5).astype(
        np.float32)
    moe_out, _ = ref_moe.moe_fwd(p, mcfg, jnp.asarray(x), dropless=True)
    ref = {"qwen_params": jax.tree.map(np.asarray, state.params),
           "batch": batch, "loss": float(m["loss"]),
           "moe_params": jax.tree.map(np.asarray, p), "moe_x": x,
           "moe_out": np.asarray(moe_out)}
    with open(os.path.join(tmp, "ref.pkl"), "wb") as f:
        pickle.dump(ref, f)
    mp.spawn(_rank_main, args=(tmp,), nprocs=WORLD, join=True)
    with open(os.path.join(tmp, "out.json")) as f:
        out = json.load(f)
    out["loss_reference"] = ref["loss"]
    return out


def test_sharded_train_step_matches_single_device_and_reference(results):
    r = results
    assert abs(r["loss_single"] - r["loss_sharded"]) < LOSS_TOL, r
    assert abs(r["loss_single"] - r["loss_reference"]) < LOSS_TOL, r
    assert abs(r["loss_sharded"] - r["loss_reference"]) < LOSS_TOL, r


def test_sharded_gradients_match_single_device(results):
    """The sharded backward (FSDP x TP params): every leaf's gradient
    matches the single-device one (f32, sums in another order)."""
    assert results["grads_rel"] < GRADS_TOL, results


def test_sharded_adamw_matches_plain_update(results):
    """AdamW on each rank's shards (f32 and int8 moments) updates the
    params as the plain update does from the same gradients."""
    for int8, rel in results["adamw_rel"].items():
        assert rel < ADAMW_TOL, (int8, results)


def test_ep_moe_matches_plain_and_reference(results):
    r = results
    assert r["ep_vs_plain"] < EP_TOL, r
    assert r["ep_vs_reference"] < EP_TOL, r
    assert r["plain_vs_reference"] < EP_TOL, r


def test_ep_moe_gradients_match_plain(results):
    assert results["ep_grads_rel"] < GRADS_TOL, results


def test_checkpoint_on_4x2_restores_onto_2x2(results):
    r = results
    assert r["restore_equal"] and r["restore_step"] == 1, r
    assert r["restore_ranks"] == 4 and r["restore_sharded"] > 0, r


def test_sharded_mamba_forward_matches_plain(results):
    assert results["mamba_rel"] < MAMBA_TOL, results


def test_sharded_mamba_gradients_match_plain(results):
    assert results["mamba_grads_rel"] < GRADS_TOL, results
