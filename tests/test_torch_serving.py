"""Port parity: runner, continuous batcher, engine and serve driver of
``repro_torch`` against the JAX package, on shared weights.

Float results (KVData, logits) agree within rtol = atol = 1e-4 in f32 (the
frameworks sum matmuls in another order); tokens, simulated times and the
``summarize`` dict are equal, except in paged mode ``composed_quality_mean``,
which carries a model float (rel 1e-6).
"""
import contextlib
import io
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import build_model as jbuild
from repro.serving.baselines import build_engine as jbuild_engine
from repro.serving.engine import summarize as jsummarize
from repro.serving.runner import ModelRunner as JRunner
from repro.serving.scheduler import ContinuousBatcher as JBatcher
from repro.serving.timemodel import A100, TimeModel
from repro.serving.workload import Request, make_contexts, poisson_requests
from repro_torch.configs import get_config as tget
from repro_torch.device import cap_test_threads
from repro_torch.launch import serve as tserve
from repro_torch.models import build_model as tbuild
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving.baselines import build_engine as tbuild_engine
from repro_torch.serving.engine import summarize as tsummarize
from repro_torch.serving.runner import ModelRunner as TRunner
from repro_torch.serving.runner import kvdata_to_cache
from repro_torch.serving.scheduler import ContinuousBatcher as TBatcher

cap_test_threads()

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def runners():
    cfg = jget("adaptcache-8b", smoke=True)
    jm = jbuild(cfg)
    jp = jm.init(jax.random.key(0))
    tcfg = tget("adaptcache-8b", smoke=True)
    tm = tbuild(tcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return cfg, JRunner(jm, jp, capacity=256), TRunner(tm, tp, capacity=256)


def test_prefill_entry_and_generation_match(runners):
    cfg, jr, tr = runners
    toks = np.random.RandomState(1).randint(0, cfg.vocab_size, 40)
    jkv, tkv = jr.prefill_entry(toks), tr.prefill_entry(toks)
    assert sorted(jkv) == sorted(tkv)
    for k in ("k", "v"):
        assert tkv[k].shape == jkv[k].shape == (cfg.n_layers, 40,
                                                cfg.n_kv_heads * 16)
        assert tkv[k].dtype == jkv[k].dtype == np.float32
        np.testing.assert_allclose(tkv[k], jkv[k], **TOL)
    np.testing.assert_array_equal(tkv["positions"], jkv["positions"])
    q = np.array([5, 6, 7])
    jans, _ = jr.generate_uncompressed(toks, q, 8)
    tans, _ = tr.generate_uncompressed(toks, q, 8)
    assert tans == jans and len(tans) == 8
    # generation from a token-dropped entry: slots and positions diverge
    kept = {k: v[:, 10:] for k, v in jkv.items() if k != "positions"}
    kept["positions"] = np.arange(10, 40, dtype=np.int32)
    assert (tr.generate_from_kvdata(kept, 40, q, 6)
            == jr.generate_from_kvdata(kept, 40, q, 6))
    cache, n = kvdata_to_cache(jkv, tr.model.cfg, tr.model, 64, "cpu")
    assert n == 40
    np.testing.assert_array_equal(
        cache["stack"][0]["self"]["k"][:, 0, :40].reshape(2, 40, -1).numpy(),
        jkv["k"])


def test_batcher_ticks_match(runners):
    """Same admissions into both batchers: identical tokens and an
    identical simulated dt on every tick."""
    cfg, jr, tr = runners
    tm = TimeModel(jget("adaptcache-8b"), A100, 8_030_000_000)
    jb = JBatcher(jr.model, jr.params, tm, n_slots=3, capacity=64)
    tb = TBatcher(tr.model, tr.params, tm, tr.pool, n_slots=3, capacity=64)
    rng = np.random.RandomState(4)
    kvs = [jr.prefill_entry(rng.randint(0, cfg.vocab_size, n))
           for n in (20, 33)]
    reqs = [Request(i, f"c{i}", rng.randint(0, cfg.vocab_size, 3), 0.0,
                    "qa", 5) for i in range(3)]
    now, done_j, done_t = 0.0, [], []
    for step in range(14):
        if step in (0, 2):                      # staggered admissions
            lane = 0 if step == 0 else 2
            kv = kvs[step // 2]
            n = kv["k"].shape[1]
            for b in (jb, tb):
                b.admit(lane, reqs[lane], kv, n, now)
        if step == 6:                           # lane 1 joins late
            for b in (jb, tb):
                b.admit(1, reqs[1], kvs[0], 20, now)
        assert tb.next_dt() == jb.next_dt()
        dj, dt_j = jb.tick(now)
        dt, dt_t = tb.tick(now)
        assert dt_t == dt_j
        done_j += [(r.req_id, r.tokens, r.ttft_s, r.finish_s) for r in dj]
        done_t += [(r.req_id, r.tokens, r.ttft_s, r.finish_s) for r in dt]
        now += dt_j
    assert done_t == done_j and len(done_j) == 3


PAGED_FUSED = dict(page_tokens=32, chunk_tokens=16, fused_compute=True,
                   fused_residual_frac=0.37)
# keys that carry a model float: composed_quality_mean scores each entry
# (each page run, in paged mode) through redundancy_feature, an SVD of the
# f32 K values (core/estimator.py), which the two frameworks round
# differently
MODEL_FLOAT_KEYS = ("composed_quality_mean",)


def summaries_equal(jr, tr, arch: str, n_active: int, policy, engine_kw,
                    tmp_path, float_keys=()) -> dict:
    """One context, 8 s of Poisson requests, served by both packages'
    ``build_engine`` on the runners' shared weights: answers equal, hits,
    and the ``summarize`` dicts equal, the ``float_keys`` within rel 1e-6.
    Returns the port's summary."""
    out = []
    for runner, build, summ, sub in ((jr, jbuild_engine, jsummarize, "j"),
                                     (tr, tbuild_engine, tsummarize, "t")):
        rng = np.random.RandomState(0)
        contexts = make_contexts(rng, runner.model.cfg.vocab_size, 1,
                                 min_len=64, max_len=128, n_probes=1)
        reqs = poisson_requests(rng, contexts, rate_hz=1.0, duration_s=8)
        full = jget(arch) if sub == "j" else tget(arch)
        rig = build(runner, contexts, full, n_active,
                    policy=policy, dram_entries=1.5, ssd_entries=4.0,
                    ssd_root=str(tmp_path / sub), **engine_kw)
        res = rig.engine.process(reqs)
        out.append((summ(res, selector_stats=rig.controller.selector.stats),
                    [r.answer for r in res]))
    (js, jans), (ts, tans) = out
    assert tans == jans
    assert ts["n"] == len(jans) and ts["hit_rate"] > 0
    assert sorted(ts) == sorted(js)
    ts, js = dict(ts), dict(js)
    for key in float_keys:
        assert ts.pop(key) == pytest.approx(js.pop(key), rel=1e-6), key
    assert ts == js
    return ts


@pytest.mark.parametrize("policy,engine_kw", [
    (("kivi", 0.16), {}), ("adaptive", {}), (("kivi", 0.16), PAGED_FUSED)],
    ids=["policy0", "adaptive", "kivi_paged_fused"])
def test_engine_summary_equal(runners, policy, engine_kw, tmp_path):
    cfg, jr, tr = runners
    ts = summaries_equal(jr, tr, "adaptcache-8b", 8_030_000_000, policy,
                         engine_kw, tmp_path,
                         MODEL_FLOAT_KEYS if engine_kw else ())
    if engine_kw:                        # paged, chunked, fused pricing
        assert ts["partial_hit_rate"] > 0 and ts["pages_hit_mean"] > 0


def _flags(path: Path):
    return set(re.findall(r"add_argument\(\s*\n?\s*\"(--[a-z0-9-]+)\"",
                          path.read_text()))


def test_serve_driver_flags_and_run():
    """The port's flags are the reference's plus --device and --trace,
    with the same --train-steps default (150); a CPU run trains the smoke
    model, prints its loss, then serves."""
    ref = _flags(ROOT / "src/repro/launch/serve.py")
    port = _flags(ROOT / "src/repro_torch/launch/serve.py")
    assert port == ref | {"--device", "--trace"}
    default = r"\"--train-steps\", type=int, default=(\d+)"
    assert (re.findall(default, (ROOT / "src/repro_torch/launch/serve.py")
                       .read_text())
            == re.findall(default, (ROOT / "src/repro/launch/serve.py")
                          .read_text()) == ["150"])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = tserve.main(["--device", "cpu", "--train-steps", "2",
                          "--duration", "6", "--rate", "1",
                          "--contexts-per-task", "1", "--policy",
                          "kivi:0.16", "--lanes", "1"])
    assert rc == 0
    text = buf.getvalue()
    assert re.search(r"smoke model trained 2 steps, final loss \d+\.\d+",
                     text)
    assert "=== serving summary ===" in text and "hit_rate" in text
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tserve.main(["--duration", "1"])


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "deepseek-v2-lite-16b",
                                  "jamba-1.5-large-398b", "internvl2-1b"])
def test_serve_driver_runs_moe_and_mla(arch):
    """The serve driver trains the MoE smoke models (capacity dropping and
    the balance loss in the loss), then serves them through the KIVI
    policy on the CPU; jamba, which no card holds at full width, too; and
    internvl2, as a text-only decoder, since the data pipeline and the
    runner pass no patches (as the reference's do)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = tserve.main(["--device", "cpu", "--arch", arch,
                          "--train-steps", "2", "--duration", "6", "--rate",
                          "1", "--contexts-per-task", "1", "--policy",
                          "kivi:0.16", "--lanes", "1"])
    assert rc == 0
    text = buf.getvalue()
    assert re.search(r"smoke model trained 2 steps, final loss \d+\.\d+",
                     text)
    assert "=== serving summary ===" in text and "hit_rate" in text


def test_serve_driver_cannot_serve_seamless():
    """Neither serve driver serves the encoder-decoder: the smoke
    training's batches carry no ``frames``, so the first step's loss
    raises a KeyError in both (ROADMAP C). The reference runs one step
    (0 crashes it, ROADMAP C)."""
    from repro.launch import serve as jserve
    flags = ["--arch", "seamless-m4t-large-v2", "--train-steps", "1",
             "--duration", "1", "--contexts-per-task", "1"]
    with pytest.raises(KeyError, match="frames"):
        jserve.main(flags)
    with pytest.raises(KeyError, match="frames"):
        tserve.main(["--device", "cpu"] + flags)


def test_train_steps_0_serves_the_seeded_init():
    """The reference's ``train_smoke_model`` with 0 steps reads the metrics
    of a step it never took (an UnboundLocalError, ROADMAP C); the port's
    returns the seeded init, which the serve driver then serves."""
    from repro.launch import serve as jserve
    with pytest.raises(UnboundLocalError):
        jserve.train_smoke_model(jget("adaptcache-8b", smoke=True), 0)
    cfg = tget("adaptcache-8b", smoke=True)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        model, params = tserve.train_smoke_model(cfg, 0, device="cpu")
    assert "serving from the seeded init" in buf.getvalue()
    init = model.init(0, "cpu")
    assert torch.equal(params["embed"], init["embed"])
    assert torch.equal(params["stack"][0]["ffn"]["wo"],
                       init["stack"][0]["ffn"]["wo"])
