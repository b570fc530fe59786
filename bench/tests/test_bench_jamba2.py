"""AI21-Jamba2-Mini through the port, in its published form, held against
the plain reference on the CPU: the adapter (``adapters/jamba.py``) reads
the configuration as published; at smoke size (``data/configs/
jamba2-smoke.json``: one period of 8 layers, experts on the odd layers,
the top-k weights not renormalised, inner norms, no RoPE, 4 of 8 experts
held) the port's prefill, its decode through the cache and its held
share of an expert layer agree with the reference in f32, and the
float8 control does not; the smoke cell runs end to end with its
readers; and the two readers this configuration brings read a fixed
``Run.program``.

Every tolerance below is a relative norm error, ||port - reference|| /
||reference||, of 1e-4: f32 against f32, the same products summed in
another order (the port's conv and scan, its batched experts and its
attention against the reference's loops), through 8 layers, read
2e-7 to 4e-6; 1e-4 leaves room above that, and float8 operands read
1e-2 or more."""
import dataclasses
import json
import math
import types

import numpy as np
import pytest
import torch

from repro_torch.device import cap_test_threads
from repro_torch.runtime import trace

from bench.adapters import jamba
from bench.reference.model import PlainLM, layer_kinds
from bench.spec import BENCH_DIR, ROOT, Spec
from bench.tests.smoke import DATA, run_cell
from bench.weights import make_params

cap_test_threads()

TOL = 1e-4
CELL = "jamba2-smoke.doc_reuse"
GLOBALS = ("embed", "final_norm", "lm_head")
NEW_METRICS = ("mamba_step_ms", "state_mb_per_req")


def _hf() -> dict:
    return json.loads((DATA / "configs" / "jamba2-smoke.json").read_text())


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


def _setup(seed: int = 7):
    """The port's config, seeded f32 weights (the inner norms' weights
    drawn about 1, so that a norm's weight is read), the reference and
    the port's model."""
    from repro_torch.models import Model

    hf = _hf()
    cfg = jamba.port_config(hf)
    p = make_params(cfg, seed, torch.device("cpu"), dtype=torch.float32)
    g = torch.Generator().manual_seed(seed)
    for blk in p["stack"]:
        for name in ("dt_norm", "b_norm", "c_norm"):
            if "mamba" in blk:
                w = blk["mamba"][name]
                w.copy_(1 + 0.5 * torch.randn(w.shape, generator=g))
    lm = PlainLM(hf, lambda i: jamba.layer_weights(p, cfg, i),
                 {k: p[k] for k in GLOBALS})
    return hf, cfg, p, lm, Model(cfg)


def _tokens(n: int, seed: int = 0) -> torch.Tensor:
    return torch.as_tensor(np.random.RandomState(seed).randint(8, 500, n),
                           dtype=torch.long)


# ---------------------------------------------------------------------------
# the adapter
# ---------------------------------------------------------------------------

def test_the_adapter_reads_the_published_form():
    from repro_torch.models import Model

    hf = json.loads((BENCH_DIR / "configs"
                     / "jamba2-mini-52b.json").read_text())
    cfg = jamba.port_config(hf)
    m = cfg.moe
    assert (m.n_routed_experts, m.held, m.top_k) == (16, 8, 2)
    assert (m.moe_offset, m.moe_every, m.renormalize) == (1, 2, False)
    assert cfg.ssm.inner_norms and cfg.rotary_pct == 0.0
    assert (cfg.d_inner, cfg.resolved_dt_rank, cfg.resolved_head_dim) == (
        8192, 256, 128)
    assert [k.value for k in cfg.layer_kinds()] == [
        "attn" if mixer == "attention" else "mamba"
        for mixer, _ in layer_kinds(hf)]
    assert [cfg.uses_moe_at(i) for i in range(32)] == [
        ffn == "experts" for _, ffn in layer_kinds(hf)]
    assert [cfg.uses_moe_at(i) for i in range(4)] == [False, True] * 2
    # 29.0e9 parameters held, 58 GB in bf16; the entry's fixed state
    assert Model(cfg).param_count() == 29_021_745_024
    assert cfg.state_bytes() == 17_432_576
    assert cfg.kv_bytes_per_token() * 2 == 32_768
    # the published form: each departure is a key the source lacks
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next(c for c in spec["configs"] if c["name"] == "jamba2-mini-52b")
    assert entry["reduced"] == ["num_experts"]
    assert hf["num_experts_published"] == 16 and "deployment" in hf


def test_the_adapter_refuses_what_the_port_does_not_run():
    with pytest.raises(ValueError):
        jamba.port_config(dict(_hf(), num_experts=9))
    with pytest.raises(ValueError):
        jamba.port_config(dict(_hf(), mamba_proj_bias=True))
    # absent keys read as the published form
    cfg = jamba.port_config(dict(_hf(), norm_topk_prob=True,
                                 mamba_inner_norms=False, rope_theta=1e4))
    assert cfg.moe.renormalize and not cfg.ssm.inner_norms
    assert cfg.rotary_pct == 1.0


# ---------------------------------------------------------------------------
# the port against the reference, f32
# ---------------------------------------------------------------------------

def test_prefill_matches_the_reference():
    """Logits, attention rows and Mamba states of a prefill."""
    from repro_torch.serving.runner import ModelRunner

    _, cfg, p, lm, model = _setup()
    toks = _tokens(70)
    ref = lm.prefill(toks)
    kv = ModelRunner(model, p, capacity=96).prefill_entry(toks.numpy())
    assert set(ref) == set(kv) - {"positions"} == {"k", "v", "ssm", "conv"}
    for name, r in ref.items():
        got = torch.from_numpy(kv[name]).reshape(r.shape)
        for i in range(r.shape[0]):          # each layer's own
            assert _rel(got[i], r[i]) < TOL, (name, i)
    logits, _ = model.prefill(p, {"tokens": toks[None]}, capacity=96)
    assert _rel(logits[0, -1], lm.all_logits(toks)[-1]) < TOL


def test_decode_through_the_cache_matches_the_full_forward():
    """Prefill, then three tokens decoded through the port's cache, each
    step's logits against the reference's full pass over the prompt and
    the tokens so far."""
    from repro_torch.serving.runner import ModelRunner, kvdata_to_cache

    _, cfg, p, lm, model = _setup(seed=11)
    toks, new = _tokens(64, 1), [5, 301, 77]
    kv = ModelRunner(model, p, capacity=96).prefill_entry(toks.numpy())
    cache, n = kvdata_to_cache(kv, cfg, model, 96, "cpu")
    full = lm.all_logits(torch.cat([toks, torch.tensor(new)]))
    for i, tok in enumerate(new):
        lg, cache = model.decode_step(p, cache, n + i, torch.tensor([[tok]]))
        assert _rel(lg[0, -1], full[64 + i]) < TOL, i
    # and from the stored rows and states, as a hit continues
    assert _rel(lm.continue_from(lm.prefill(toks), torch.tensor(new), 64),
                full[-1]) < TOL


def test_held_halves_add_up_to_the_uncut_layer():
    """Two port expert layers holding complementary halves of the 8
    experts, the router whole on each, add up to the uncut port layer and
    to the uncut reference layer; the reference given one half agrees
    with the port's half."""
    from repro_torch.models import moe as moe_lib

    hf, cfg, p, _, _ = _setup()
    g = torch.Generator().manual_seed(5)
    d, e, ff = cfg.d_model, 8, cfg.moe.expert_d_ff
    router = p["stack"][1]["ffn_moe"]["router"][0]
    experts = {k: torch.randn(e, *shape, generator=g) * shape[0] ** -0.5
               for k, shape in (("wi_gate", (d, ff)), ("wi_up", (d, ff)),
                                ("wo", (ff, d)))}
    whole_cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, n_held_experts=0))
    x = torch.randn(1, 30, d, generator=g)
    whole, _ = moe_lib.moe_fwd({"router": router, "experts": experts},
                               whole_cfg, x, dropless=True)
    ref = PlainLM(dict(hf, num_experts=8), None, {})
    names = {"wi_gate": "experts_gate", "wi_up": "experts_up",
             "wo": "experts_down"}
    ref_whole = ref.ffn(dict(router=router, **{names[k]: v for k, v
                                               in experts.items()}), x[0])
    parts = []
    for lo, hi in ((0, 4), (4, 8)):
        order = list(range(lo, hi)) + [j for j in range(e)
                                       if not lo <= j < hi]
        mine = {k: v[lo:hi] for k, v in experts.items()}
        part, _ = moe_lib.moe_fwd({"router": router[:, order],
                                   "experts": mine}, cfg, x, dropless=True)
        ref_part = PlainLM(hf, None, {}).ffn(dict(
            router=router[:, order], **{names[k]: v for k, v
                                        in mine.items()}), x[0])
        assert _rel(part[0], ref_part) < TOL
        parts.append(part)
    assert _rel(parts[0] + parts[1], whole) < TOL
    assert _rel(parts[0] + parts[1], ref_whole[None]) < TOL
    assert _rel(parts[0], whole) > 0.1


def test_the_float8_control_fails_the_tolerance():
    """The reference on float8 operands, read as a program would be:
    its prefill rows, states and logits are off the f32 reference by far
    more than the tolerance."""
    hf, cfg, p, lm, _ = _setup()
    low = PlainLM(hf, lambda i: jamba.layer_weights(p, cfg, i),
                  {k: p[k] for k in GLOBALS}, lowp=True)
    toks = _tokens(70)
    ref, got = lm.prefill(toks), low.prefill(toks)
    worst = max(_rel(got[k][i], ref[k][i]) for k in ref
                for i in range(ref[k].shape[0]))
    assert worst > 10 * TOL
    assert _rel(low.all_logits(toks)[-1], lm.all_logits(toks)[-1]) > TOL


# ---------------------------------------------------------------------------
# the smoke cell and its readers
# ---------------------------------------------------------------------------

def _spec(tmp_path) -> Spec:
    """The smoke benchmark with this configuration's cell and readers."""
    bench = json.loads((DATA / "bench.json").read_text())
    bench["configs"].append({"name": "jamba2-smoke", "source": "test",
                             "file": "configs/jamba2-smoke.json",
                             "reduced": ["num_experts"], "why": "test"})
    bench["workloads"].append({"name": CELL, "config": "jamba2-smoke",
                               "traffic": "doc_reuse", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"].append(CELL)
    for name, unit, src, layer in (
            ("mamba_step_ms", "ms", "program_span", "model"),
            ("state_mb_per_req", "MB", "program_counter", "engine")):
        bench["per_layer"].append({
            "name": name, "unit": unit, "better": "lower",
            "source": src, "layer": layer, "moves": "ttft_p50_s",
            "workloads": [CELL]})
    (tmp_path / "bench.json").write_text(json.dumps(bench))
    return Spec(tmp_path / "bench.json", data_dir=DATA, root=DATA)


def test_the_cell_runs_end_to_end(tmp_path):
    rc, last, out, err = run_cell(CELL, seed=2 ** 31 + 11,
                                  sp=_spec(tmp_path))
    assert rc == 0 and last is not None
    assert last["correct"] is True, err
    assert last["failed"] == 0 and last["attempted"] == 12
    stats = json.loads(next(line.split(" ", 1)[1] for line in
                            out.splitlines() if line.startswith("stats ")))
    assert sum(stats["hits"].values()) == 12


def test_the_traced_run_reads_the_state_and_the_mamba_step(tmp_path):
    rc, last, _, err = run_cell(CELL, seed=5, trace=1, sp=_spec(tmp_path))
    assert rc == 0 and last["correct"] is True, err
    got = last["metrics"]
    assert got["mamba_step_ms"]["value"] > 0
    # a hit copies 7 layers' (128, 16) and (3, 128) f32 arrays
    state_mb = 7 * 128 * (16 + 3) * 4 / 1e6
    assert 0 < got["state_mb_per_req"]["value"] <= state_mb * (1 + 1e-9)
    assert not trace.ON


def test_the_control_is_not_correct(tmp_path):
    rc, last, _, err = run_cell(CELL, seed=6, sp=_spec(tmp_path),
                                extra=("--control", "1"))
    assert rc == 0 and last["correct"] is False, err
    assert any(c["value"] > c["limit"] for c in last["checks"].values())


def _run(program, reqs=(0, 1, 2), ok=(True, True, True)):
    return types.SimpleNamespace(
        program=program, span_reqs=set(reqs),
        records=[{"ok": v} for v in ok])


def _records(spans, counters):
    return trace.Records(spans=spans, counters=counters, by_request={},
                         anchor_ns=(0, 0))


def _span(name, ms, req, parent=None):
    return trace.Span(name, 0, int(ms * 1e6), parent, req, {})


def test_the_readers_read_a_fixed_program():
    from bench import metrics

    step, state = (metrics.load(BENCH_DIR / "metrics", n) for n in NEW_METRICS)
    spans = [_span("model.step", 50.0, 0), _span("mamba.step", 1.5, 0, 0),
             _span("mamba.step", 2.5, 0, 0), _span("model.step", 40.0, 1),
             _span("mamba.step", 2.0, 1, 3),
             # a request inside the profiled stretch is left out
             _span("model.step", 90.0, 7), _span("mamba.step", 9.0, 7, 5)]
    prog = _records(spans, {"state_h2d_bytes": 3 * 17_432_576,
                            "h2d_bytes": 10 ** 9})
    assert math.isclose(step(_run(prog)), (1.5 + 2.5 + 2.0) / 2)
    assert math.isclose(state(_run(prog)), 17.432576)
    # failed requests are not served
    assert math.isclose(state(_run(prog, ok=(True, False, True))),
                        1.5 * 17.432576)
    # a program without the span or the counter, or no program: nothing
    bare = _records([_span("model.step", 50.0, 0)], {"h2d_bytes": 5})
    for reader in (step, state):
        assert reader(_run(bare)) is None
        assert reader(_run(None)) is None
    assert state(_run(prog, ok=(False, False, False))) is None
