"""The port's tracer (``repro_torch.runtime.trace``): off it records and
costs nothing, on it gives one DRAM hit's span tree with its counters, its
spans land on a ``torch.profiler`` trace's clock, and the simulated
results are the same either way."""
import contextlib
import io
import json
import time

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.device import cap_test_threads
from repro_torch.launch import serve as tserve
from repro_torch.models import build_model
from repro_torch.runtime import trace
from repro_torch.serving.baselines import build_engine
from repro_torch.serving.runner import ModelRunner
from repro_torch.serving.workload import Request, make_contexts
from repro_torch.storage.tier import SSDTier

cap_test_threads()

ARCH = "olmoe-1b-7b"


@pytest.fixture(autouse=True)
def tracer_off():
    trace.disable()
    trace.take()
    yield
    trace.disable()
    trace.take()


def hit_rig(tmp_path, n_requests: int = 1):
    """A smoke OLMoE engine with one document in DRAM and requests that
    hit it, one answer token each."""
    cfg = get_config(ARCH, smoke=True)
    full = get_config(ARCH)
    model = build_model(cfg)
    runner = ModelRunner(model, model.init(0, "cpu"), capacity=256)
    ctx = make_contexts(np.random.RandomState(0), cfg.vocab_size, 1,
                        min_len=96, max_len=128, n_probes=2,
                        tasks=("qa",))[0]
    rig = build_engine(runner, [ctx], full,
                       build_model(full).active_param_count(), n_lanes=1,
                       ssd_root=str(tmp_path / "ssd"))
    rig.controller.insert(ctx.key, runner.prefill_entry(ctx.tokens),
                          ctx.task_type, now=0.0)
    reqs = [Request(i, ctx.key, ctx.probes[i % 2], float(i), ctx.task_type,
                    max_new_tokens=1) for i in range(n_requests)]
    return rig, ctx, reqs


def children(spans, idx):
    return [s.name for s in spans if s.parent == idx]


def test_off_records_nothing_and_touches_no_clock_or_profiler(
        tmp_path, monkeypatch):
    rig, _, reqs = hit_rig(tmp_path)

    def boom(*a, **k):
        raise AssertionError("called with the tracer off")

    class NoClock:
        perf_counter_ns = time_ns = staticmethod(boom)

    monkeypatch.setattr(trace, "time", NoClock)
    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(torch.cuda, "synchronize", boom)
    (res,) = rig.engine.process(reqs, skip_quality=True)
    assert res.hit_tier == "dram" and res.wall_first_token_s is None
    rec = trace.take()
    assert rec.spans == [] and rec.counters == {} and rec.by_request == {}


def test_off_puts_no_range_on_a_profile(tmp_path):
    rig, _, reqs = hit_rig(tmp_path)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        rig.engine.process(reqs, skip_quality=True)
    names = {e.name for e in prof.events()}
    assert not names & (set(trace.SPANS) | {"serve.request", "moe_dispatch"})


def test_span_tree_and_counters_of_a_dram_hit(tmp_path):
    rig, ctx, reqs = hit_rig(tmp_path)
    trace.enable()
    (res,) = rig.engine.process(reqs, skip_quality=True)
    rec = trace.take()
    trace.disable()
    assert res.hit_tier == "dram" and res.method in ("streaming_llm", "none")
    spans = rec.spans
    (root,) = [i for i, s in enumerate(spans) if s.parent is None]
    assert spans[root].name == "serve.request" and spans[root].req == 0
    assert res.wall_first_token_s == pytest.approx(spans[root].dur_s)
    assert res.wall_first_token_s > 0
    top = children(spans, root)
    assert top[:2] == ["serve.fetch", "lane.write"]
    assert set(top[2:]) == {"model.step"}
    fetch = top.index("serve.fetch")
    fetch = [i for i, s in enumerate(spans) if s.parent == root][fetch]
    assert set(children(spans, fetch)) == {"tier.get", "codec.decompress",
                                           "policy.rescore"}
    steps = [i for i, s in enumerate(spans) if s.name == "model.step"]
    n_moe = sum(get_config(ARCH, smoke=True).uses_moe_at(i)
                for i in range(get_config(ARCH, smoke=True).n_layers))
    for i in steps:
        routes = [j for j, s in enumerate(spans)
                  if s.parent == i and s.name == "moe.route"]
        assert len(routes) == n_moe
        # a decode step's MoE reads nothing back to the host
        for j in routes:
            assert children(spans, j) == []
        assert spans[i].attrs["lanes"] == [0]
    assert all(s.req == 0 and s.t1_ns >= s.t0_ns > 0 for s in spans)
    stored = rig.controller.tiers["dram"]._store[ctx.key]
    kv_bytes = stored.arrays["k"].nbytes + stored.arrays["v"].nbytes
    assert rec.counters["h2d_bytes"] == kv_bytes
    assert rec.by_request[0]["h2d_bytes"] == kv_bytes
    lane = next(s for s in spans if s.name == "lane.write")
    assert lane.attrs == {"lane": 0, "bytes": kv_bytes}
    # one read a step: its tokens; the MoE's slots are counted on the host
    assert rec.counters["host_reads"] == len(steps)
    k = get_config(ARCH, smoke=True).moe.top_k
    assert rec.counters["moe.routed_slots"] == len(steps) * n_moe * k
    assert rec.counters["moe.held_slots"] == rec.counters["moe.routed_slots"]
    # the CPU runs every step eagerly
    assert rec.counters["decode.eager_steps"] == len(steps)
    assert "decode.graph_replays" not in rec.counters
    assert rec.counters["policy.estimates"] > 0


class Stamped(torch.profiler.record_function):
    """``record_function`` that notes the tracer's clock around its own
    enter and exit: the profiler's cost of an annotation, which its
    duration includes and the tracer's span does not."""
    log = []

    def __enter__(self):
        t = time.perf_counter_ns()
        out = super().__enter__()
        self.stamps = [self.name, t, time.perf_counter_ns(), 0, 0]
        Stamped.log.append(self.stamps)
        return out

    def __exit__(self, *exc):
        self.stamps[3] = time.perf_counter_ns()
        super().__exit__(*exc)
        self.stamps[4] = time.perf_counter_ns()


def profiled_pass(rig, req, path):
    """One request under a CPU profile with the tracer on: the tracer's
    spans, the profile's chrome trace and the annotations' own costs."""
    Stamped.log = []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        trace.take()
        rig.engine.process([req], skip_quality=True)
    rec = trace.take()
    prof.export_chrome_trace(str(path))
    return rec, json.loads(path.read_text()), Stamped.log


def misplaced(rec, doc, log):
    """The spans whose annotation's duration is off the tracer's by more
    than 5 % or 50 µs beyond the profiler's own enter and exit time, or
    whose start the anchor misplaces by more than 1 ms."""
    base = int(doc["baseTimeNanoseconds"])
    ann, mine, cost = {}, {}, {}
    for e in doc["traceEvents"]:
        if e.get("cat") == "user_annotation" and e["name"] in trace.SPANS:
            ann.setdefault(e["name"], []).append(e)
    for s in rec.spans:
        if s.name in trace.SPANS:
            mine.setdefault(s.name, []).append(s)
    for name, a, b, c, d in log:
        cost.setdefault(name, []).append(((b - a) + (d - c)) / 1e3)
    # a hit runs no prefill, so no MoE layer reads its counts to the host
    assert set(mine) == set(ann) == set(cost) >= {
        "serve.fetch", "tier.get", "codec.decompress", "policy.rescore",
        "lane.write", "model.step", "moe.route"}
    assert "moe.host_read" not in mine
    bad = []
    for name, spans in mine.items():
        events = sorted(ann[name], key=lambda e: e["ts"])
        assert len(events) == len(spans) == len(cost[name]), name
        for s, e, own_us in zip(sorted(spans, key=lambda s: s.t0_ns), events,
                                cost[name]):
            off_us = e["dur"] - (s.t1_ns - s.t0_ns) / 1e3
            ts_us = (rec.wall_ns(s.t0_ns) - base) / 1e3
            if abs(off_us) > max(50.0, 0.05 * e["dur"]) + own_us \
                    or abs(ts_us - e["ts"]) > 1000.0:
                bad.append((name, e["dur"], off_us, own_us, e["ts"] - ts_us))
    return bad


def test_spans_on_the_profiler_clock(tmp_path, monkeypatch):
    """Each program span is a ``user_annotation`` of a CPU profile, within
    5 % or 50 µs of the tracer's duration beyond what the profiler's own
    enter and exit of it took (tens of µs on a loaded CPU, which the
    annotation counts and the span does not), and the anchor places its
    start within 1 ms of the annotation's."""
    monkeypatch.setattr(torch.profiler, "record_function", Stamped)
    rig, _, reqs = hit_rig(tmp_path, n_requests=2)
    trace.enable()
    profiled_pass(rig, reqs[0], tmp_path / "warm.json")
    bad = misplaced(*profiled_pass(rig, reqs[1], tmp_path / "pass.json"))
    trace.disable()
    assert bad == []


def test_simulated_results_identical_on_and_off(tmp_path):
    out = []
    for on in (False, True):
        rig, _, reqs = hit_rig(tmp_path / str(on), n_requests=3)
        if on:
            trace.enable()
        out.append(rig.engine.process(reqs, skip_quality=True))
        trace.disable()
    off, on = out
    assert off == on
    assert [r.wall_first_token_s for r in off] == [None] * 3
    assert all(r.wall_first_token_s > 0 for r in on)
    for a, b in zip(off, on):
        assert (a.ttft_s, a.load_s, a.decode_s, a.finish_s, a.answer) == \
            (b.ttft_s, b.load_s, b.decode_s, b.finish_s, b.answer)


def test_ssd_get_span(tmp_path):
    from repro_torch.core.compression.base import CompressedEntry
    tier = SSDTier(root=str(tmp_path))
    tier.put("a", CompressedEntry("none", 1.0,
                                  {"k": np.ones((2, 8, 4), np.float32)}, {}))
    trace.enable()
    entry = tier.get("a")
    rec = trace.take()
    (s,) = rec.spans
    assert s.name == "tier.get" and s.attrs["tier"] == "ssd"
    assert s.attrs["bytes"] == tier.entry_info("a")["disk_bytes"]
    assert np.array_equal(entry.arrays["k"], np.ones((2, 8, 4), np.float32))


def test_a_span_site_costs_under_a_microsecond_off():
    def site():
        with trace.span("model.step") as sp:
            if sp:
                sp.attrs["x"] = 1

    n = 20000
    best = float("inf")
    for _ in range(7):
        t0 = time.perf_counter()
        for _ in range(n):
            site()
        best = min(best, (time.perf_counter() - t0) / n)
    assert best < 1e-6, best


def test_serve_driver_writes_a_chrome_trace(tmp_path):
    path = tmp_path / "spans.json"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = tserve.main(["--device", "cpu", "--train-steps", "0",
                          "--duration", "4", "--rate", "1",
                          "--contexts-per-task", "1", "--lanes", "2",
                          "--trace", str(path)])
    assert rc == 0 and not trace.ON
    text = buf.getvalue()
    assert "=== serving summary ===" in text
    assert "wall_first_token_p50_s" in text and "h2d_bytes" in text
    doc = json.loads(path.read_text())
    names = {e["name"] for e in doc["traceEvents"]}
    assert {"serve.request", "serve.fetch", "model.step"} <= names
    assert all(e["ph"] == "X" and e["dur"] >= 0 for e in doc["traceEvents"])
