"""Port parity: the training path of ``repro_torch`` (optimizer, schedules,
data, loss and gradients, train step, checkpoints, fault tolerance, the
train driver) against the JAX package, on the same numpy inputs, with the
reference's weights carried across by ``params_from_numpy``.

Tolerances:
  * the int8 codec, the schedules, the data pipeline and
    ``compressed_psum`` are bit-equal;
  * one ``adamw_update`` from identical (params, grads, state) agrees
    within rtol 1e-6 / atol 1e-7 in f32, its int8 codes equal;
  * the loss within 1e-5 relative and every gradient leaf within rtol 1e-4
    and an atol of 1e-4 times the leaf's largest reference value (f32);
    in bf16 the loss within twice the reference's own bf16-against-f32
    gap, the rule the bf16 logits tests follow;
  * a 10-step f32 loss trajectory (5 steps for falcon-mamba) within 1e-3
    relative per step (Adam's m / (sqrt(v) + eps) amplifies last-bit
    differences where v ~ 0), the first grad norm within 1e-4.

falcon-mamba trains through the plain selective scan on the CPU, which
autograd differentiates as ``jax.grad`` differentiates the reference's
``lax.scan``.
"""
import contextlib
import dataclasses
import glob
import io
import json
import os
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import build_model as jbuild
from repro.training import optimizer as jopt
from repro.training import train_step as jts
from repro.training.data import Pipeline as JPipeline
from repro.training.data import PipelineConfig as JPipelineConfig
from repro_torch.configs import get_config as tget
from repro_torch.device import cap_test_threads
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import build_model as tbuild
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.layers import cross_entropy_loss
from repro_torch.runtime.fault_tolerance import (
    HeartbeatMonitor, StragglerDetector, elastic_plan,
)
from repro_torch.training import optimizer as topt
from repro_torch.training import tree as tree_lib
from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.data import Pipeline, PipelineConfig
from repro_torch.training.train_step import (
    TrainState, compressed_psum, init_train_state, make_train_step,
)

cap_test_threads()

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["adaptcache-8b", "smollm-135m", "falcon-mamba-7b"]
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
BF16_SLACK = 2.0


def _tt(a) -> torch.Tensor:
    """A torch copy of a JAX or numpy array (bf16 through its bits)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def _jax_flat(tree) -> dict:
    """path ("stack/0/attn/wq") -> leaf of a JAX tree."""
    def name(k):
        for attr in ("key", "idx", "name"):
            if hasattr(k, attr):
                return str(getattr(k, attr))
        return str(k)
    return {"/".join(name(k) for k in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _batch(b: dict, device="cpu") -> dict:
    return {k: torch.as_tensor(v, dtype=torch.long, device=device)
            for k, v in b.items()}


def _pair(arch: str, dtype: str = "float32"):
    cfg = jget(arch, smoke=True)
    jm = jbuild(cfg)
    jp = jm.init(jax.random.key(0))
    tcfg = tget(arch, smoke=True)
    if dtype != "float32":
        cfg = dataclasses.replace(cfg, dtype=dtype, param_dtype=dtype)
        tcfg = dataclasses.replace(tcfg, dtype=dtype, param_dtype=dtype)
        jm = jbuild(cfg)
        jp = jax.tree.map(lambda a, sd: a.astype(sd.dtype), jp,
                          jax.eval_shape(jm.init, jax.random.key(0)))
    tm = tbuild(tcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return cfg, jm, jp, tm, tp


@pytest.fixture(scope="module")
def pairs():
    return {arch: _pair(arch) for arch in ARCHS}


@pytest.fixture(scope="module")
def batch():
    return JPipeline(JPipelineConfig(512, 64, 4, kind="recall",
                                     seed=3)).next_batch()


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

def _codec_input(case: str) -> np.ndarray:
    rng = np.random.RandomState(0)
    x = {"multiple": rng.randn(3, 2, 128), "ragged": rng.randn(2, 3, 100),
         "scalar": np.array(rng.randn()), "zero_blocks": rng.randn(4, 192),
         "vector": rng.randn(70)}[case].astype(np.float32)
    if case == "zero_blocks":
        x[1] = 0.0
        x[2, 64:128] = 0.0
    return x


@pytest.mark.parametrize("case", ["multiple", "ragged", "scalar",
                                  "zero_blocks", "vector"])
def test_q8_codec_bit_equal(case):
    x = _codec_input(case)
    jq, js = jopt._q8_encode(jnp.asarray(x))
    tq, ts = topt._q8_encode(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tuple(tq.shape) == topt._q8_shapes(x.shape)[0]
    assert tuple(ts.shape) == topt._q8_shapes(x.shape)[1]
    back = topt._q8_decode(tq, ts, x.shape, torch.float32)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jopt._q8_decode(jq, js, x.shape,
                                                 jnp.float32)))
    if x.ndim >= 2:
        # leading-dim slices encode to the whole leaf's codes and scales
        rows = torch.from_numpy(x).reshape(-1, x.shape[-1])
        parts = [topt._q8_encode(rows[i:i + 1]) for i in range(len(rows))]
        np.testing.assert_array_equal(
            torch.cat([p[0] for p in parts]).numpy(),
            tq.reshape(len(rows), *tq.shape[-2:]).numpy())
        np.testing.assert_array_equal(
            torch.cat([p[1] for p in parts]).numpy(),
            ts.reshape(len(rows), *ts.shape[-2:]).numpy())


def _opt_tree(rng, scale: float):
    return {"w": (rng.randn(4, 130) * scale).astype(np.float32),
            "n": (rng.randn(64) * scale).astype(np.float32),
            "stack": [(rng.randn(2, 3, 64) * scale).astype(np.float32)],
            "s": np.float32(rng.randn() * scale)}


def _to_port(jtree, like):
    """A JAX tree (dict keys sorted) as torch tensors in ``like``'s
    structure and order."""
    flat = _jax_flat(jtree)
    paths = [p for p, _ in tree_lib.flatten_with_paths(like)]
    return tree_lib.unflatten(like, [_tt(flat["/".join(p)]) for p in paths])


def _moments_to_port(jtree, like, int8: bool):
    if not int8:
        return _to_port(jtree, like)
    flat = _jax_flat(jtree)
    paths = ["/".join(p) for p, _ in tree_lib.flatten_with_paths(like)]
    return tree_lib.unflatten(like, [
        topt.Q8Tensor(_tt(flat[p + "/q"]), _tt(flat[p + "/scale"]))
        for p in paths])


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("gscale", [1e-2, 10.0], ids=["unclipped",
                                                      "clipped"])
def test_adamw_update_matches_reference(int8, gscale, monkeypatch):
    """Three reference steps build a state; one more step from it in each
    package, on the same (params, grads, state). Slices of 100 elements
    make the port walk the leaves in pieces."""
    monkeypatch.setattr(topt, "SLICE_ELEMS", 100)
    rng = np.random.RandomState(1)
    params = _opt_tree(rng, 0.5)
    jcfg = jopt.AdamWConfig(lr=jopt.wsd_schedule(3e-3, 2, 5, 5),
                            int8_state=int8)
    tcfg = topt.AdamWConfig(lr=topt.wsd_schedule(3e-3, 2, 5, 5),
                            int8_state=int8)
    jp = jax.tree.map(jnp.asarray, params)
    js = jopt.adamw_init(jcfg, jp)
    for _ in range(3):
        jp, js = jopt.adamw_update(
            jcfg, jax.tree.map(jnp.asarray, _opt_tree(rng, gscale)), js, jp)
    like = _opt_tree(np.random.RandomState(0), 1.0)
    tp = _to_port(jp, like)
    ts = topt.AdamWState(torch.tensor(int(js.step), dtype=torch.int32),
                         _moments_to_port(js.m, like, int8),
                         _moments_to_port(js.v, like, int8))
    grads = _opt_tree(rng, gscale)
    jp, js = jopt.adamw_update(jcfg, jax.tree.map(jnp.asarray, grads),
                               js, jp)
    tp2, ts2 = topt.adamw_update(tcfg, _to_port(grads, like), ts, tp)
    assert tp2 is tp and int(ts2.step) == int(js.step) == 4
    jflat = _jax_flat(jp)
    for path, leaf in tree_lib.flatten_with_paths(tp):
        np.testing.assert_allclose(leaf.numpy(), np.asarray(
            jflat["/".join(path)]), rtol=1e-6, atol=1e-7)
    for name in ("m", "v"):
        want = _jax_flat(getattr(js, name))
        got = dict(("/".join(p), x) for p, x in
                   tree_lib.flatten_with_paths(getattr(ts2, name)))
        assert sorted(got) == sorted(want)
        for k, x in got.items():
            if int8 and k.endswith("/q"):
                np.testing.assert_array_equal(x.numpy(), np.asarray(want[k]))
            else:
                np.testing.assert_allclose(x.numpy(), np.asarray(want[k]),
                                           rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_adamw_init_matches_reference(int8, pairs):
    cfg, jm, jp, tm, tp = pairs["adaptcache-8b"]
    js = jopt.adamw_init(jopt.AdamWConfig(int8_state=int8), jp)
    ts = topt.adamw_init(topt.AdamWConfig(int8_state=int8), tp)
    assert ts.step.dtype == torch.int32 and int(ts.step) == 0
    for name in ("m", "v"):
        want = _jax_flat(getattr(js, name))
        got = {"/".join(p): x for p, x in
               tree_lib.flatten_with_paths(getattr(ts, name))}
        assert sorted(got) == sorted(want)
        for k, x in got.items():
            assert x.dtype == {"int8": torch.int8, "float32":
                               torch.float32}[str(want[k].dtype)]
            np.testing.assert_array_equal(x.numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("kind", ["wsd", "cosine"])
def test_schedules_equal_reference(kind):
    if kind == "wsd":
        jf, tf = (m.wsd_schedule(3e-3, 15, 75, 50) for m in (jopt, topt))
    else:
        jf, tf = (m.cosine_schedule(3e-3, 15, 150) for m in (jopt, topt))
    want = np.array([jf(jnp.int32(s)) for s in range(201)], np.float32)
    got = np.array([tf(torch.tensor(s, dtype=torch.int32))
                    for s in range(201)], np.float32)
    np.testing.assert_array_equal(got, want)


def test_schedules():
    """The reference's own schedule properties."""
    wsd = topt.wsd_schedule(1.0, 10, 50, 40)
    at = lambda f, s: float(f(torch.tensor(s, dtype=torch.int32)))
    assert at(wsd, 0) == 0.0
    assert at(wsd, 10) == pytest.approx(1.0)
    assert at(wsd, 40) == pytest.approx(1.0)      # stable
    assert at(wsd, 100) == pytest.approx(0.1)     # decayed
    cos = topt.cosine_schedule(1.0, 10, 100)
    assert at(cos, 10) == pytest.approx(1.0)
    assert at(cos, 100) == pytest.approx(0.1, abs=1e-3)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["recall", "lm"])
def test_data_pipeline_bit_equal(kind):
    for host in (0, 1):
        jcfg = JPipelineConfig(512, 96, 4, kind=kind, seed=7)
        tcfg = PipelineConfig(512, 96, 4, kind=kind, seed=7)
        j, t = JPipeline(jcfg, host, 2), Pipeline(tcfg, host, 2)
        for _ in range(3):
            jb, tb = j.next_batch(), t.next_batch()
            for k in ("tokens", "labels"):
                assert tb[k].dtype == jb[k].dtype
                np.testing.assert_array_equal(tb[k], jb[k])
        st = t.state()
        nxt = t.next_batch()
        again = Pipeline(tcfg, host, 2)
        again.restore(st)
        np.testing.assert_array_equal(again.next_batch()["tokens"],
                                      nxt["tokens"])
        np.testing.assert_array_equal(j.next_batch()["labels"],
                                      nxt["labels"])


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------

def _port_loss_and_grads(tm, tp, batch, remat):
    leaves = [p.detach().requires_grad_() for p in tree_lib.leaves(tp)]
    loss = tm.loss(tree_lib.unflatten(tp, leaves), _batch(batch),
                   remat=remat)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), dict(zip(
        ("/".join(p) for p, _ in tree_lib.flatten_with_paths(tp)), grads))


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match(pairs, batch, arch, remat):
    """smollm-135m ties its embedding to the head: its embed gradient sums
    both uses."""
    cfg, jm, jp, tm, tp = pairs[arch]
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, jb, remat=remat)))(jp)
    tl, tg = _port_loss_and_grads(tm, tp, batch, remat)
    assert float(tl) == pytest.approx(float(jl), rel=LOSS_RTOL)
    want = _jax_flat(jg)
    assert sorted(tg) == sorted(want)
    for k, g in tg.items():
        w = np.asarray(want[k])
        assert g.shape == w.shape and g.dtype == torch.float32, k
        np.testing.assert_allclose(g.numpy(), w, rtol=GRAD_TOL,
                                   atol=GRAD_TOL * np.abs(w).max(),
                                   err_msg=k)


def test_forward_and_chunked_loss(pairs, batch):
    """Model.forward's logits match the reference's; the chunked loss
    (chunk 16 over 64 tokens, and 40: a padded last chunk) equals the
    plain cross-entropy of those logits."""
    cfg, jm, jp, tm, tp = pairs["adaptcache-8b"]
    jlogits = jm.forward(jp, {"tokens": jnp.asarray(batch["tokens"])})
    tb = _batch(batch)
    with torch.no_grad():
        logits = tm.forward(tp, tb)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   rtol=1e-4, atol=1e-4)
        plain = cross_entropy_loss(logits, tb["labels"])
        from repro.models.layers import cross_entropy_loss as jce
        assert float(plain) == pytest.approx(
            float(jce(jlogits, jnp.asarray(batch["labels"]))), rel=LOSS_RTOL)
        from repro_torch.models import transformer
        for chunk in (16, 40):
            x, _ = transformer._train_stack(
                tp, tm.cfg, transformer.embed_inputs(tp, tm.cfg, tb),
                transformer._positions(logits), remat=False)
            got = transformer.chunked_ce_loss(tp, tm.cfg, x, tb["labels"],
                                              chunk=chunk)
            assert float(got) == pytest.approx(float(plain), rel=LOSS_RTOL)


def test_bf16_loss_within_reference_gap(batch):
    """smoke adaptcache-8b in bf16 (the f32 reference weights cast): the
    port's loss differs from the reference's f32 loss by at most twice the
    reference's own bf16 loss's difference from it."""
    cfg, jm, jp, _, _ = _pair("adaptcache-8b")
    _, jm16, jp16, tm16, tp16 = _pair("adaptcache-8b", "bfloat16")
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want = float(jm.loss(jp, jb))
    ref_gap = abs(float(jm16.loss(jp16, jb)) - want) / want
    with torch.no_grad():
        got = tm16.loss(tp16, _batch(batch), remat=True)
    assert tp16["embed"].dtype == torch.bfloat16
    port_gap = abs(float(got) - want) / want
    assert 0.0 < ref_gap < 0.05, ref_gap
    assert port_gap <= BF16_SLACK * ref_gap, (port_gap, ref_gap)


def _trajectory_matches(pair, steps: int):
    """``steps`` f32 steps of each package's train step from the same init
    and batches (recall pipeline, the serve driver's WSD schedule, remat as
    the train step defaults to)."""
    cfg, jm, jp, tm, tp = pair
    jcfg = jopt.AdamWConfig(lr=jopt.wsd_schedule(3e-3, 15, 75, 50))
    tcfg = tserve.smoke_opt_config(150)
    jstate = jts.TrainState(jp, jopt.adamw_init(jcfg, jp))
    jstep = jax.jit(jts.make_train_step(jm, jcfg))
    tstate = TrainState(tree_lib.map_leaves(torch.clone, tp),
                        topt.adamw_init(tcfg, tp))
    tstep = make_train_step(tm, tcfg)
    pipe = JPipeline(JPipelineConfig(cfg.vocab_size, 96, 4, kind="recall"))
    for i in range(steps):
        b = pipe.next_batch()
        jstate, jmet = jstep(jstate, {k: jnp.asarray(v)
                                      for k, v in b.items()})
        tstate, tmet = tstep(tstate, _batch(b))
        assert float(tmet["loss"]) == pytest.approx(float(jmet["loss"]),
                                                    rel=1e-3), i
        if i == 0:
            assert float(tmet["grad_norm"]) == pytest.approx(
                float(jmet["grad_norm"]), rel=1e-4)


def test_loss_trajectory_matches(pairs):
    _trajectory_matches(pairs["adaptcache-8b"], 10)


def test_mamba_loss_trajectory_matches(pairs):
    _trajectory_matches(pairs["falcon-mamba-7b"], 5)


# ---------------------------------------------------------------------------
# the reference's own training properties, on the port
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def smollm():
    cfg = tget("smollm-135m", smoke=True)
    return cfg, tbuild(cfg)


def _run(model, state, opt, steps: int, seq: int = 96, batch: int = 8,
         kind: str = "lm"):
    step = make_train_step(model, opt)
    pipe = Pipeline(PipelineConfig(model.cfg.vocab_size, seq, batch,
                                   kind=kind))
    losses = []
    for _ in range(steps):
        state, m = step(state, _batch(pipe.next_batch()))
        losses.append(float(m["loss"]))
    return state, losses


def test_loss_decreases(smollm):
    cfg, model = smollm
    opt = topt.AdamWConfig(lr=topt.wsd_schedule(3e-3, 5, 30, 20))
    _, losses = _run(model, init_train_state(model, 0, opt, "cpu"), opt, 40)
    assert losses[-1] < 0.5 * losses[0]


def test_int8_state_learns_like_f32(smollm):
    cfg, model = smollm
    losses = {}
    for int8 in (False, True):
        opt = topt.AdamWConfig(lr=2e-3, int8_state=int8)
        _, losses[int8] = _run(model, init_train_state(model, 0, opt, "cpu"),
                               opt, 25)
    assert losses[False][-1] < 0.7 * losses[False][0]
    assert losses[True][-1] < 0.7 * losses[True][0]
    assert losses[True][-1] < max(1.5 * losses[False][-1],
                                  losses[False][-1] + 0.5)


def test_grad_accumulation_equivalence(smollm):
    cfg, model = smollm
    opt = topt.AdamWConfig(lr=1e-3)
    pipe = Pipeline(PipelineConfig(cfg.vocab_size, 64, 8, kind="lm"))
    b = _batch(pipe.next_batch())
    s1 = init_train_state(model, 0, opt, "cpu")
    s2 = init_train_state(model, 0, opt, "cpu")
    s1, m1 = make_train_step(model, opt, accum_steps=1, remat=False)(s1, b)
    b2 = {k: v.reshape(2, 4, *v.shape[1:]) for k, v in b.items()}
    s2, m2 = make_train_step(model, opt, accum_steps=2, remat=False)(s2, b2)
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 5e-2
    for a, c in zip(tree_lib.leaves(s1.params), tree_lib.leaves(s2.params)):
        np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=2e-2,
                                   atol=2e-3)


def _bf16_int8_state():
    cfg = dataclasses.replace(tget("adaptcache-8b", smoke=True),
                              dtype="bfloat16", param_dtype="bfloat16")
    model = tbuild(cfg)
    opt = topt.AdamWConfig(lr=1e-3, int8_state=True)
    state = init_train_state(model, 0, opt, "cpu")
    pipe = Pipeline(PipelineConfig(cfg.vocab_size, 32, 2, kind="lm"))
    state, _ = make_train_step(model, opt)(state, _batch(pipe.next_batch()))
    return state


def test_checkpoint_roundtrip_and_gc(tmp_path):
    """bf16 params, int8 codes, f32 scales and the int32 step come back
    bit-exact, with their dtypes, on the device asked for."""
    state = _bf16_int8_state()
    cm = CheckpointManager(str(tmp_path), keep=2, async_write=False)
    for s in (10, 20, 30):
        cm.save(s, state, extra={"step": s})
    assert cm.latest_step() == 30
    restored, extra = cm.restore(device="cpu")
    assert extra["step"] == 30
    assert isinstance(restored, TrainState)
    assert isinstance(tree_lib.leaves_up_to(restored.params,
                                            restored.opt.m)[0], topt.Q8Tensor)
    a, b = tree_lib.leaves(state), tree_lib.leaves(restored)
    assert len(a) == len(b)
    assert {x.dtype for x in a} == {torch.bfloat16, torch.int8,
                                    torch.float32, torch.int32}
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and y.device.type == "cpu"
        assert torch.equal(x.view(torch.int16) if x.dtype == torch.bfloat16
                           else x,
                           y.view(torch.int16) if y.dtype == torch.bfloat16
                           else y)
    kept = [d for d in os.listdir(tmp_path) if d.startswith("step_")]
    assert sorted(kept) == ["step_20", "step_30"]    # keep=2 GC


def test_checkpoint_async_snapshot(tmp_path):
    """An async save copies the state when called: a step taken while the
    writer runs does not reach the checkpoint."""
    state = _bf16_int8_state()
    before = [x.clone() for x in tree_lib.leaves(state)]
    cm = CheckpointManager(str(tmp_path))
    cm.save(1, state)
    for x in tree_lib.leaves(state.params):
        x.add_(1)
    cm.wait()
    restored, _ = cm.restore(device="cpu")
    for x, y in zip(before, tree_lib.leaves(restored)):
        assert torch.equal(x, y)


def test_checkpoint_crc_detection(tmp_path, smollm):
    cfg, model = smollm
    state = init_train_state(model, 0, topt.AdamWConfig(lr=1e-3), "cpu")
    cm = CheckpointManager(str(tmp_path), async_write=False)
    cm.save(1, state)
    man = glob.glob(str(tmp_path / "step_1" / "manifest.json"))[0]
    j = json.load(open(man))
    first = next(iter(j["leaves"]))
    j["leaves"][first]["crc32"] ^= 1
    json.dump(j, open(man, "w"))
    with pytest.raises(IOError):
        cm.restore(device="cpu")


def test_fault_tolerance_primitives():
    t = [0.0]
    deaths = []
    hb = HeartbeatMonitor(deadline_s=10, on_death=deaths.append,
                          clock=lambda: t[0])
    hb.register("w0")
    hb.register("w1")
    t[0] = 5
    hb.beat("w0")
    t[0] = 12
    assert hb.sweep() == ["w1"] and deaths == ["w1"]
    assert hb.alive_workers() == ["w0"]
    hb.beat("w1")                      # rejoin
    assert "w1" in hb.alive_workers()

    sd = StragglerDetector(threshold=2.0, min_samples=4)
    for _ in range(8):
        sd.record("fast", 1.0)
        sd.record("slow", 3.5)
    assert sd.stragglers() == ["slow"]

    assert elastic_plan(512, 16, pods=2) == (2, 16, 16)
    assert elastic_plan(192, 16) == (12, 16)
    with pytest.raises(ValueError):
        elastic_plan(8, 16)


def test_compressed_psum_matches_reference(tmp_path):
    """Bit-equal to the reference's on a 1-device mesh, with and without an
    error-feedback residual; reduced + residual reconstructs x. Through a
    one-process gloo group, the all-reduce path gives the same bits."""
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P

    mesh = jax.make_mesh((1,), ("d",))
    rng = np.random.RandomState(0)
    x = rng.randn(64).astype(np.float32)
    err0 = (rng.randn(64) * 1e-3).astype(np.float32)
    for err in (None, err0):
        def f(x, e):
            return jts.compressed_psum(x, "d", e)
        jred, jerr = jax.jit(shard_map(
            f, mesh=mesh, in_specs=(P(), P()), out_specs=(P(), P())))(
                jnp.asarray(x), None if err is None else jnp.asarray(err))
        red, new_err = compressed_psum(
            torch.from_numpy(x), err=None if err is None
            else torch.from_numpy(err))
        np.testing.assert_array_equal(red.numpy(), np.asarray(jred))
        np.testing.assert_array_equal(new_err.numpy(), np.asarray(jerr))
        base = x if err is None else x + err
        np.testing.assert_allclose(red.numpy() + new_err.numpy(), base,
                                   rtol=1e-6, atol=1e-6)
        assert float(np.abs(red.numpy() - base).max()) > 0

    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        red_g, err_g = compressed_psum(torch.from_numpy(x),
                                       group=dist.group.WORLD)
    finally:
        dist.destroy_process_group()
    red, new_err = compressed_psum(torch.from_numpy(x))
    assert torch.equal(red_g, red) and torch.equal(err_g, new_err)


# ---------------------------------------------------------------------------
# refusals, devices and drivers
# ---------------------------------------------------------------------------

def test_training_mamba_entry_points():
    """Every training entry takes a Mamba config on the CPU: the model's
    forward and loss, the train step (whose first step changes every
    leaf) and the serve driver's ``train_smoke_model``."""
    cfg = tget("falcon-mamba-7b", smoke=True)
    model = tbuild(cfg)
    opt = topt.AdamWConfig()
    state = init_train_state(model, 0, opt, "cpu")
    b = _batch(Pipeline(PipelineConfig(cfg.vocab_size, 16, 2,
                                       kind="lm")).next_batch())
    assert model.forward(state.params, b).shape == (2, 16, cfg.vocab_size)
    assert torch.isfinite(model.loss(state.params, b))
    before = [t.clone() for t in tree_lib.leaves(state.params)]
    state, m = make_train_step(model, opt)(state, b)
    assert all(torch.isfinite(v) for v in m.values())
    assert all(not torch.equal(x, y) for x, y in
               zip(before, tree_lib.leaves(state.params)))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        m2, params = tserve.train_smoke_model(cfg, 1, seq=64, batch=2,
                                              device="cpu")
    assert "smoke model trained 1 steps" in buf.getvalue()
    assert m2.param_count(params) == model.param_count(state.params)


def test_train_driver_trains_mamba(tmp_path):
    """The train driver takes falcon-mamba's smoke config on the CPU and
    checkpoints it."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        state = ttrain.train(["--arch", "falcon-mamba-7b", "--smoke",
                              "--steps", "2", "--ckpt-every", "2",
                              "--batch", "2", "--seq", "64", "--ckpt-dir",
                              str(tmp_path), "--device", "cpu"])
    assert "step     0 loss" in buf.getvalue()
    assert int(state.opt.step) == 2
    assert sorted(os.listdir(tmp_path)) == ["LATEST", "step_2"]
    assert all(torch.isfinite(t).all() for t in tree_lib.leaves(state))


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "deepseek-v2-lite-16b",
                                  "jamba-1.5-large-398b"])
def test_train_driver_trains_moe_and_mla(tmp_path, arch):
    """The train driver takes the MoE smoke configs (deepseek's with MLA
    and its dense prefix layer, jamba's Mamba and attention layers) on the
    CPU and checkpoints them."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        state = ttrain.train(["--arch", arch, "--smoke", "--steps", "2",
                              "--ckpt-every", "2", "--batch", "2", "--seq",
                              "64", "--ckpt-dir", str(tmp_path), "--device",
                              "cpu"])
    assert "step     0 loss" in buf.getvalue()
    assert int(state.opt.step) == 2
    assert sorted(os.listdir(tmp_path)) == ["LATEST", "step_2"]
    assert all(torch.isfinite(t).all() for t in tree_lib.leaves(state))


def test_entry_points_default_to_cuda(tmp_path, smollm):
    cfg, model = smollm
    opt = topt.AdamWConfig()
    state = init_train_state(model, 0, opt, "cpu")
    assert tree_lib.leaves(state)[0].device.type == "cpu"
    cm = CheckpointManager(str(tmp_path), async_write=False)
    cm.save(1, state)
    if torch.cuda.is_available():
        return
    for call in (lambda: init_train_state(model, 0, opt),
                 lambda: cm.restore(),
                 lambda: tserve.train_smoke_model(cfg, 1),
                 lambda: ttrain.main(["--arch", "smollm-135m", "--smoke",
                                      "--steps", "1"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def _flags(path: Path):
    return set(re.findall(r"add_argument\(\s*\n?\s*\"(--[a-z0-9-]+)\"",
                          path.read_text()))


def test_train_driver_flags_and_resume(tmp_path):
    """The port's flags are the reference's plus --device; a CPU run
    checkpoints, and a second run resumes from it with the saved leaves."""
    ref = _flags(ROOT / "src/repro/launch/train.py")
    assert _flags(ROOT / "src/repro_torch/launch/train.py") == ref | {
        "--device"}
    args = ["--arch", "adaptcache-8b", "--smoke", "--steps", "6",
            "--ckpt-every", "3", "--batch", "2", "--seq", "64",
            "--ckpt-dir", str(tmp_path), "--device", "cpu"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        first = ttrain.train(args)
        again = ttrain.train(args + ["--resume"])
    text = buf.getvalue()
    assert "step     0 loss" in text and "resumed from step 6" in text
    assert sorted(os.listdir(tmp_path)) == ["LATEST", "step_3", "step_6"]
    for x, y in zip(tree_lib.leaves(first), tree_lib.leaves(again)):
        assert torch.equal(x, y)
    assert int(again.opt.step) == 6
    # one process is no 256-rank world: the production mesh raises
    with pytest.raises(RuntimeError, match="256 ranks"):
        ttrain.main(args + ["--production-mesh"])
