"""The runner's pool of decode caches and the CUDA graph of the decode step
(``repro_torch/models/decode_graph.py``), on the smoke OLMoE and
DeepSeek-V2-Lite models and on the smoke hybrid in AI21-Jamba2-Mini's
published form (Mamba, attention and MoE layers, 4 of 8 experts held).

On the CPU: a pooled cache is lent to one user at a time and kept for the
next; a request served from a reused cache gives the logits of a fresh
cache bit for bit (the rows an earlier request left are masked to weight
0); the engine's calls share one cache; a prefill still reads its MoE
counts to the host and a decode step does not. The tests marked ``cuda``
run the graph on the card and skip elsewhere: replayed logits against the
eager step's, one capture for three ``process`` calls with every step
replayed, a step's logits untouched by the next, and the reuse check on
the card. This file imports no JAX:

    PYTHONPATH=src python -m pytest -q tests/test_torch_decode_graph.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.device import cap_test_threads
from repro_torch.models import build_model, moe, transformer
from repro_torch.runtime import trace
from repro_torch.serving.baselines import build_engine
from repro_torch.serving.runner import (
    ModelRunner, kvdata_to_cache, write_kvdata,
)
from repro_torch.serving.workload import Request, make_contexts

cap_test_threads()

CAPACITY = 160
DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]


def _hybrid():
    cfg = get_config("jamba-1.5-large-398b", smoke=True)
    return dataclasses.replace(
        cfg, rotary_pct=0.0,
        moe=dataclasses.replace(cfg.moe, moe_offset=1, renormalize=False,
                                n_held_experts=4),
        ssm=dataclasses.replace(cfg.ssm, inner_norms=True))


CONFIGS = {"olmoe": lambda: get_config("olmoe-1b-7b", smoke=True),
           "deepseek": lambda: get_config("deepseek-v2-lite-16b", smoke=True),
           "hybrid": _hybrid}


@pytest.fixture(autouse=True)
def tracer_off():
    trace.disable()
    trace.take()
    yield
    trace.disable()
    trace.take()


def _device(name: str) -> torch.device:
    if name == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device(name)


def _runner(arch: str, device: torch.device) -> ModelRunner:
    model = build_model(CONFIGS[arch]())
    return ModelRunner(model, model.init(0, device), capacity=CAPACITY)


def _entries(runner: ModelRunner, lens):
    rng = np.random.RandomState(7)
    return [runner.prefill_entry(rng.randint(1, runner.model.cfg.vocab_size,
                                             n)) for n in lens]


def _steps(runner: ModelRunner, cache, kv, question, n_steps: int = 3):
    """Write ``kv`` into lane 0 and take ``n_steps`` teacher-forced decode
    steps over it; the logits of each."""
    n = write_kvdata(cache, kv, runner.model.cfg, 0, runner.device)
    t0 = int(kv["positions"][-1]) + 1
    out = []
    for i in range(n_steps):
        tok = torch.tensor([[int(question[i % len(question)])]])
        logits, cache = runner.model.decode_step(runner.params, cache, n + i,
                                                 tok, t0 + i)
        out.append(logits)
    return out


def _hit_rig(arch: str, device: torch.device, tmp_path):
    runner = _runner(arch, device)
    cfg = runner.model.cfg
    ctx = make_contexts(np.random.RandomState(3), cfg.vocab_size, 1,
                        min_len=100, max_len=120, n_probes=2,
                        tasks=("qa",))[0]
    rig = build_engine(runner, [ctx], cfg, runner.model.active_param_count(),
                       policy=("none", 1.0), ssd_root=str(tmp_path),
                       n_lanes=1)
    rig.controller.insert(ctx.key, runner.prefill_entry(ctx.tokens),
                          ctx.task_type, now=0.0)
    return rig, ctx


def test_the_pool_lends_a_cache_to_one_user_at_a_time():
    runner = _runner("olmoe", torch.device("cpu"))
    pool, p = runner.pool, runner.params
    a = pool.acquire(p, 1, CAPACITY)
    b = pool.acquire(p, 1, CAPACITY)
    assert a is not b and a.key == b.key == (1, CAPACITY)
    assert a.graph is None            # the CPU steps eagerly
    pool.release(a)
    assert pool.acquire(p, 1, CAPACITY) is a
    assert pool.acquire(p, 2, CAPACITY).key == (2, CAPACITY)
    with pool.lease(p, 1, CAPACITY) as c:
        assert c is not a and c is not b
    assert pool.acquire(p, 1, CAPACITY) is c


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("arch", sorted(CONFIGS))
def test_a_reused_pooled_cache_serves_as_a_fresh_one(arch, device):
    """A long entry, then a short one into the same pooled cache: the short
    one's steps give the logits that a fresh cache gives, bit for bit,
    and so the same greedy answer."""
    runner = _runner(arch, _device(device))
    long_kv, short_kv = _entries(runner, (140, 60))
    q = np.array([11, 12, 13])
    with runner.pool.lease(runner.params, 1, CAPACITY) as cache:
        _steps(runner, cache, long_kv, q)
        reused = _steps(runner, cache, short_kv, q)
    fresh_cache, _ = kvdata_to_cache(short_kv, runner.model.cfg,
                                     runner.model, CAPACITY, runner.device)
    fresh = _steps(runner, fresh_cache, short_kv, q)
    for a, b in zip(reused, fresh):
        assert torch.equal(a, b)
    ans = runner.generate_from_kvdata(short_kv, 60, q, 4)
    assert runner.generate_from_kvdata(long_kv, 140, q, 4)
    assert runner.generate_from_kvdata(short_kv, 60, q, 4) == ans


def test_engine_calls_share_one_pooled_cache(tmp_path):
    rig, ctx = _hit_rig("hybrid", torch.device("cpu"), tmp_path)
    pool = rig.engine.runner.pool
    for i in range(3):
        (res,) = rig.engine.process([Request(
            i, ctx.key, ctx.probes[i % 2], float(i), ctx.task_type,
            max_new_tokens=1)], skip_quality=True)
        assert res.answer and res.hit_tier == "dram"
    # the engine's lanes and the runner's one-lane generation share a key
    assert [len(v) for v in pool._free.values()] == [1]


def test_prefill_reads_its_moe_counts_and_a_decode_step_does_not():
    """Prefill keeps the run-based MoE (one host read a MoE layer); a
    decode step takes the fixed-shape form (none)."""
    runner = _runner("hybrid", torch.device("cpu"))
    cfg = runner.model.cfg
    n_moe = sum(cfg.uses_moe_at(i) for i in range(cfg.n_layers))
    trace.enable()
    kv = _entries(runner, (50,))[0]
    rec = trace.take()
    assert rec.counters["host_reads"] == n_moe
    assert sum(s.name == "moe.host_read" for s in rec.spans) == n_moe
    cache, n = kvdata_to_cache(kv, cfg, runner.model, CAPACITY, "cpu")
    runner.model.decode_step(runner.params, cache, n, torch.tensor([[3]]))
    rec = trace.take()
    assert "host_reads" not in rec.counters
    assert not any(s.name == "moe.host_read" for s in rec.spans)
    assert sum(s.name == "moe.route" for s in rec.spans) == n_moe
    assert rec.counters["decode.eager_steps"] == 1
    # its slots counted on the host: all T·k routed; the held ones not,
    # since the chip holds 4 of 8 experts
    assert rec.counters["moe.routed_slots"] == n_moe * cfg.moe.top_k
    assert "moe.held_slots" not in rec.counters


def test_a_decode_of_more_slots_than_experts_held_reads_its_counts():
    """Three lanes of the hybrid route T·k = 6 slots over the 4 experts it
    holds: past the decode form, so the step keeps the run-based form,
    one host read a MoE layer, and a pooled cache of three lanes would
    get no graph (``moe.decode_form``)."""
    runner = _runner("hybrid", torch.device("cpu"))
    cfg = runner.model.cfg
    n_moe = sum(cfg.uses_moe_at(i) for i in range(cfg.n_layers))
    assert moe.decode_form(cfg, 2) and not moe.decode_form(cfg, 3)
    kv = _entries(runner, (50,))[0]
    with runner.pool.lease(runner.params, 3, CAPACITY) as cache:
        n = write_kvdata(cache, kv, cfg, 0, runner.device)
        trace.enable()
        runner.model.decode_step(runner.params, cache, torch.full((3,), n),
                                 torch.tensor([[3], [4], [5]]))
        rec = trace.take()
    assert rec.counters["host_reads"] == n_moe
    assert sum(s.name == "moe.host_read" for s in rec.spans) == n_moe
    assert rec.counters["moe.routed_slots"] == n_moe * 3 * cfg.moe.top_k


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("arch", sorted(CONFIGS))
def test_replayed_logits_equal_the_eager_step(arch):
    """The graph's steps against ``transformer.decode_step`` run eagerly
    over a fresh cache: the same kernels, so the same logits."""
    runner = _runner(arch, _device("cuda"))
    kv = _entries(runner, (90,))[0]
    q = np.array([7, 8, 9, 10])
    with runner.pool.lease(runner.params, 1, CAPACITY) as cache:
        assert cache.graph is not None
        replayed = _steps(runner, cache, kv, q, n_steps=4)
    cache, n = kvdata_to_cache(kv, runner.model.cfg, runner.model, CAPACITY,
                               runner.device)
    eager = []
    for i in range(4):
        logits, cache = transformer.decode_step(
            runner.params, runner.model.cfg, cache, n + i,
            torch.tensor([[int(q[i])]], device=runner.device), 90 + i)
        eager.append(logits)
    for a, b in zip(replayed, eager):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
        assert torch.equal(a.argmax(-1), b.argmax(-1))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", sorted(CONFIGS))
def test_three_process_calls_capture_once_and_replay_every_step(
        arch, tmp_path):
    rig, ctx = _hit_rig(arch, _device("cuda"), tmp_path)
    trace.enable()
    for i in range(3):
        (res,) = rig.engine.process([Request(
            i, ctx.key, ctx.probes[i % 2], float(i), ctx.task_type,
            max_new_tokens=1)], skip_quality=True)
        assert res.answer
    rec = trace.take()
    c = rec.counters
    steps = sum(s.name == "model.step" for s in rec.spans)
    assert steps >= 3
    assert c["decode.graph_captures"] == 1
    assert c["decode.graph_replays"] == steps == c["host_reads"]
    assert "decode.eager_steps" not in c
    cfg = rig.engine.runner.model.cfg
    n_moe = sum(cfg.uses_moe_at(i) for i in range(cfg.n_layers))
    assert c["moe.routed_slots"] == steps * n_moe * cfg.moe.top_k
    # held slots are counted only where the chip holds every expert
    assert c.get("moe.held_slots") == (
        c["moe.routed_slots"] if cfg.moe.held == cfg.moe.n_routed_experts
        else None)
    # a replay runs no Python below Model.decode_step
    assert not any(s.name in ("moe.route", "mamba.step") for s in rec.spans)


@pytest.mark.cuda
def test_a_steps_logits_survive_the_next_step():
    runner = _runner("hybrid", _device("cuda"))
    kv = _entries(runner, (70,))[0]
    with runner.pool.lease(runner.params, 1, CAPACITY) as cache:
        first, second = _steps(runner, cache, kv, np.array([4, 5]),
                               n_steps=2)
        kept = first.clone()
        third = _steps(runner, cache, kv, np.array([6]), n_steps=1)[0]
    assert torch.equal(first, kept)
    assert not torch.equal(first, second)
    assert first.data_ptr() != second.data_ptr() != third.data_ptr()


@pytest.mark.cuda
@pytest.mark.parametrize("arch", sorted(CONFIGS))
def test_two_lanes_replay_the_eager_step(arch):
    """Two lanes holding entries of different lengths, stepped with
    per-lane write slots and positions as the batcher steps them: the
    replays against ``transformer.decode_step`` run eagerly over a fresh
    cache holding the same entries."""
    runner = _runner(arch, _device("cuda"))
    cfg = runner.model.cfg
    kvs = _entries(runner, (90, 50))
    toks = torch.tensor([[7], [8]])

    def two_steps(cache, step):
        n = torch.tensor([write_kvdata(cache, kv, cfg, lane, runner.device)
                          for lane, kv in enumerate(kvs)])
        pos = torch.tensor([int(kv["positions"][-1]) + 1 for kv in kvs])
        return [step(cache, n + i, toks + i, pos + i) for i in range(2)]

    with runner.pool.lease(runner.params, 2, CAPACITY) as cache:
        assert cache.graph is not None
        trace.enable()
        replayed = two_steps(cache, lambda c, w, t, p: runner.model
                             .decode_step(runner.params, c, w, t, p)[0])
        c = trace.take().counters
    assert c["decode.graph_replays"] == 2 and "decode.eager_steps" not in c
    fresh = runner.model.init_cache(batch=2, capacity=CAPACITY,
                                    device=runner.device)
    eager = two_steps(fresh, lambda c, w, t, p: transformer.decode_step(
        runner.params, cfg, c, w, t, p)[0])
    for a, b in zip(replayed, eager):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
        assert torch.equal(a.argmax(-1), b.argmax(-1))


@pytest.mark.cuda
def test_a_pool_past_the_decode_form_makes_no_graph():
    """The hybrid holds 4 experts and routes 2 a token: two lanes take the
    decode form and get a graph, three do not and step eagerly."""
    runner = _runner("hybrid", _device("cuda"))
    kv = _entries(runner, (60,))[0]
    assert runner.pool.acquire(runner.params, 2, CAPACITY).graph is not None
    with runner.pool.lease(runner.params, 3, CAPACITY) as cache:
        assert cache.graph is None
        n = write_kvdata(cache, kv, runner.model.cfg, 0, runner.device)
        trace.enable()
        logits, _ = runner.model.decode_step(
            runner.params, cache, torch.full((3,), n),
            torch.tensor([[3], [4], [5]]))
        c = trace.take().counters
    assert bool(torch.isfinite(logits).all())
    assert c["decode.eager_steps"] == 1 and "decode.graph_replays" not in c
