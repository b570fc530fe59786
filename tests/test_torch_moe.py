"""Port parity: the MoE FFN of ``repro_torch`` (``models/moe.py``) and the
MoE families it serves (olmoe-1b-7b; jamba-1.5-large-398b, whose Mamba and
attention layers carry MoE every second layer) against the JAX package, on
shared weights at smoke size (d_model 64, 8 experts top-2, expert width 32).

Tolerances, in f32: the router's weights and ``moe_fwd``'s output and
balance loss within rtol = atol = 1e-5, its routing indices and the slots it
drops equal; the models' loss within 1e-5 relative and every gradient leaf
within rtol 1e-4 and an atol of 1e-4 times the leaf's largest reference
value (``test_torch_training.py``'s rule); the engine's ``summarize`` dict
and answers equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import build_model as jbuild
from repro.models import moe as jmoe
from repro.serving.runner import ModelRunner as JRunner
from repro.training.data import Pipeline as JPipeline
from repro.training.data import PipelineConfig as JPipelineConfig
from repro_torch.configs import get_config as tget
from repro_torch.device import cap_test_threads
from repro_torch.models import build_model as tbuild
from repro_torch.models import moe as tmoe
from repro_torch.models.convert import params_from_numpy
from repro_torch.runtime import trace
from repro_torch.serving.runner import ModelRunner as TRunner
from repro_torch.training import tree as tree_lib
from test_torch_models import FULL_PARAMS
from test_torch_serving import MODEL_FLOAT_KEYS, summaries_equal

cap_test_threads()

MOE_TOL = dict(rtol=1e-5, atol=1e-5)
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4


def _torch_tree(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _ref_dispatch(idx, cap: int):
    """The reference's sort-based dispatch (``repro.models.moe.moe_fwd``'s
    lines, which it keeps inside the function): the sorted order and which
    sorted slots stay within their expert's capacity."""
    flat_e = jnp.asarray(idx).reshape(-1)
    order = jnp.argsort(flat_e, stable=True)
    se = flat_e[order]
    first = jnp.searchsorted(se, se, side="left")
    pos = jnp.arange(flat_e.size) - first
    return np.asarray(order), np.asarray(pos < cap)


@pytest.mark.parametrize("case", ["random", "ties"])
def test_router_topk_matches(case):
    """Indices equal, weights within 1e-5. ``ties`` rounds the logits to
    halves, so rows hold equal probabilities, which both packages must
    order by expert index."""
    logits = np.random.RandomState(0).randn(24, 8).astype(np.float32) * 2
    if case == "ties":
        logits = np.round(logits) / 2
        assert any(len(set(row)) < len(row) for row in logits)
    jw, ji = jmoe.router_topk(jnp.asarray(logits), 2)
    tw, ti = tmoe.router_topk(torch.from_numpy(logits), 2)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), **MOE_TOL)


def _moe_layer(arch: str, seed: int = 0):
    """One MoE layer's params (the reference's init) with a router skewed
    towards expert 0, and inputs that share one direction: every token
    ranks expert 0 first, so capacity mode overflows it."""
    cfg = jget(arch, smoke=True)
    p = jmoe.init_moe(jax.random.key(seed), cfg, jnp.float32)
    rng = np.random.RandomState(seed)
    u = rng.randn(cfg.d_model).astype(np.float32)
    u /= np.linalg.norm(u)
    router = np.array(p["router"])
    router[:, 0] += 3.0 * u
    p["router"] = jnp.asarray(router)
    x = (rng.randn(2, 12, cfg.d_model) + 3.0 * u).astype(np.float32)
    return cfg, p, x


@pytest.mark.parametrize("dropless", [True, False],
                         ids=["dropless", "capacity"])
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "deepseek-v2-lite-16b"],
                         ids=["routed", "shared"])
def test_moe_fwd_matches(arch, dropless):
    """deepseek's smoke config adds one shared expert. At batch 2 x 12,
    k 2 over 8 experts, capacity mode keeps ceil(24·2/8 · 1.25) = 8 slots
    an expert and drops the rest of expert 0's."""
    cfg, jp, x = _moe_layer(arch)
    tcfg = tget(arch, smoke=True)
    assert ("shared" in jp) == (arch == "deepseek-v2-lite-16b")
    jout, jaux = jmoe.moe_fwd(jp, cfg, jnp.asarray(x), dropless=dropless)
    tp = _torch_tree(jp)
    tout, taux = tmoe.moe_fwd(tp, tcfg, torch.from_numpy(x),
                              dropless=dropless)
    # routing: the same experts for every token, the same slots dropped
    t, k, e = 24, cfg.moe.top_k, cfg.moe.n_routed_experts
    xf = x.reshape(t, -1)
    _, jidx = jmoe.router_topk(jnp.asarray(xf) @ jp["router"], k)
    _, tidx = tmoe.router_topk(torch.from_numpy(xf) @ tp["router"], k)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    cap = tmoe.capacity(t, k, e, dropless=dropless)
    assert cap == (t if dropless else 8)
    jorder, jkeep = _ref_dispatch(jidx, cap)
    torder, tkeep = tmoe.dispatch(tidx, cap)
    np.testing.assert_array_equal(torder.numpy(), jorder)
    np.testing.assert_array_equal(tkeep.numpy(), jkeep)
    dropped = int((~tkeep).sum())
    assert dropped == 0 if dropless else dropped > 0
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **MOE_TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **MOE_TOL)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "deepseek-v2-lite-16b"],
                         ids=["routed", "shared"])
def test_moe_decode_form_matches(arch):
    """The decode form (a step of 4 lanes, one token each, so T·k = 8 is
    the experts held: every slot on its expert's gathered weights, no
    host read) against the run-based form and the reference's dropless
    ``moe_fwd``, within the same tolerance; it returns no balance loss."""
    cfg, jp, x = _moe_layer(arch)
    x = np.ascontiguousarray(x.reshape(24, 1, -1)[:4])
    tcfg = tget(arch, smoke=True)
    tp = _torch_tree(jp)
    jout, _ = jmoe.moe_fwd(jp, cfg, jnp.asarray(x), dropless=True)
    runs, _ = tmoe.moe_fwd(tp, tcfg, torch.from_numpy(x), dropless=True)
    dec, aux = tmoe.moe_fwd(tp, tcfg, torch.from_numpy(x), dropless=True,
                            decode=True)
    assert aux is None and dec.shape == runs.shape
    np.testing.assert_allclose(dec.numpy(), np.asarray(jout), **MOE_TOL)
    np.testing.assert_allclose(dec.numpy(), runs.numpy(), **MOE_TOL)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "deepseek-v2-lite-16b"],
                         ids=["routed", "shared"])
def test_a_decode_past_the_held_experts_keeps_the_run_based_form(arch):
    """A decode step of 24 lanes (T·k = 48 over 8 experts) would gather
    more expert weights than the run-based form reads: it takes that form,
    bit for bit, with its balance loss and its one host read."""
    _, jp, x = _moe_layer(arch)
    x = torch.from_numpy(np.ascontiguousarray(x.reshape(24, 1, -1)))
    tcfg = tget(arch, smoke=True)
    tp = _torch_tree(jp)
    assert not tmoe.decode_form(tcfg, 24) and tmoe.decode_form(tcfg, 4)
    runs, raux = tmoe.moe_fwd(tp, tcfg, x, dropless=True)
    trace.enable()
    try:
        dec, aux = tmoe.moe_fwd(tp, tcfg, x, dropless=True, decode=True)
        rec = trace.take()
    finally:
        trace.disable()
    assert torch.equal(dec, runs) and torch.equal(aux, raux)
    assert rec.counters["host_reads"] == 1


# ---------------------------------------------------------------------------
# the MoE models: loss with the balance loss, and gradients
# ---------------------------------------------------------------------------

def _pair(arch: str):
    cfg = jget(arch, smoke=True)
    jm = jbuild(cfg)
    jp = jm.init(jax.random.key(0))
    tm = tbuild(tget(arch, smoke=True))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tm.cfg, "cpu")
    return cfg, jm, jp, tm, tp


def _jax_flat(tree) -> dict:
    def name(k):
        for attr in ("key", "idx"):
            if hasattr(k, attr):
                return str(getattr(k, attr))
        return str(k)
    return {"/".join(name(k) for k in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def loss_and_grads_match(arch: str, remat: bool) -> None:
    """The port's ``Model.loss`` (capacity-mode MoE, balance loss weighted
    0.01) and its autograd gradients against ``jax.value_and_grad`` of the
    reference's, on one recall batch (4 x 64)."""
    cfg, jm, jp, tm, tp = _pair(arch)
    batch = JPipeline(JPipelineConfig(cfg.vocab_size, 64, 4, kind="recall",
                                      seed=3)).next_batch()
    jl, jg = jax.jit(jax.value_and_grad(lambda p: jm.loss(
        p, {k: jnp.asarray(v) for k, v in batch.items()}, remat=remat)))(jp)
    leaves = [x.detach().requires_grad_() for x in tree_lib.leaves(tp)]
    tl = tm.loss(tree_lib.unflatten(tp, leaves),
                 {k: torch.as_tensor(v, dtype=torch.long)
                  for k, v in batch.items()}, remat=remat)
    grads = torch.autograd.grad(tl, leaves)
    assert float(tl.detach()) == pytest.approx(float(jl), rel=LOSS_RTOL)
    want = _jax_flat(jg)
    got = dict(zip(("/".join(p) for p, _ in tree_lib.flatten_with_paths(tp)),
                   grads))
    assert sorted(got) == sorted(want)
    for key, g in got.items():
        w = np.asarray(want[key])
        np.testing.assert_allclose(g.numpy(), w, rtol=GRAD_TOL,
                                   atol=GRAD_TOL * np.abs(w).max(),
                                   err_msg=key)


@pytest.mark.parametrize("arch,remat", [("olmoe-1b-7b", False),
                                        ("olmoe-1b-7b", True),
                                        ("jamba-1.5-large-398b", False)],
                         ids=["olmoe", "olmoe-remat", "jamba"])
def test_loss_and_grads_match(arch, remat):
    loss_and_grads_match(arch, remat)


# ---------------------------------------------------------------------------
# serving olmoe through the engine
# ---------------------------------------------------------------------------

def test_engine_summary_equal_olmoe(tmp_path):
    """``summaries_equal`` (``test_torch_serving.py``) with the fixed KIVI
    policy at rate 0.16: inserts quantize K per channel and V per row,
    hits dequantize both."""
    cfg, jm, jp, tm, tp = _pair("olmoe-1b-7b")
    summaries_equal(JRunner(jm, jp, capacity=256),
                    TRunner(tm, tp, capacity=256), "olmoe-1b-7b",
                    FULL_PARAMS["olmoe-1b-7b"][1], ("kivi", 0.16), {},
                    tmp_path, MODEL_FLOAT_KEYS)
