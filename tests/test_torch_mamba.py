"""Port parity: the Mamba family (falcon-mamba) of ``repro_torch`` against
the JAX package, on shared weights (JAX params carried across through
numpy) at smoke size: 2 layers, d_model 64, d_inner 128, d_state 8.

Tolerances, in f32: the layer and the model's logits within rtol = atol =
1e-4 (XLA's CPU matmuls and torch's sum in another order); the runner's
KVData state within 1e-5; greedy tokens, KIVI bytes, simulated times and
the ``summarize`` dict equal.
"""
import contextlib
import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.core.compression import KIVICompression as JKIVI
from repro.models import build_model as jbuild
from repro.models import mamba as jmamba
from repro.serving.baselines import build_engine as jbuild_engine
from repro.serving.engine import summarize as jsummarize
from repro.serving.runner import ModelRunner as JRunner
from repro.serving.scheduler import ContinuousBatcher as JBatcher
from repro.serving.timemodel import A100, TimeModel
from repro.serving.workload import Request, make_contexts, poisson_requests
from repro_torch.configs import get_config as tget
from repro_torch.core.compression import KIVICompression as TKIVI
from repro_torch.launch import serve as tserve
from repro_torch.models import build_model as tbuild
from repro_torch.models import mamba as tmamba
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving.baselines import build_engine as tbuild_engine
from repro_torch.serving.engine import summarize as tsummarize
from repro_torch.serving.runner import ModelRunner as TRunner
from repro_torch.serving.runner import kvdata_to_cache
from repro_torch.serving.scheduler import ContinuousBatcher as TBatcher
from test_torch_models import BF16_SLACK, bf16_gap

ARCH = "falcon-mamba-7b"
FULL_PARAMS = 7_006_326_784        # the reference's active_param_count
TOL = dict(rtol=1e-4, atol=1e-4)
STATE_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def pair():
    cfg = jget(ARCH, smoke=True)
    jm = jbuild(cfg)
    jp = jm.init(jax.random.key(0))
    tm = tbuild(tget(ARCH, smoke=True))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tm.cfg, "cpu")
    return cfg, jm, jp, tm, tp


@pytest.fixture(scope="module")
def runners(pair):
    cfg, jm, jp, tm, tp = pair
    return cfg, JRunner(jm, jp, capacity=256), TRunner(tm, tp, capacity=256)


def _close(got: torch.Tensor, want, tol=TOL) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               **tol)


@pytest.mark.parametrize("mode", ["prefill", "prefill_cache", "decode"])
def test_mamba_fwd_matches_reference(pair, mode):
    """One layer: a prefill from zeros, a prefill that continues a
    non-zero cache (its conv window and its state h0), and a decode step,
    which updates the port's cache in place."""
    cfg, _, jp, _, tp = pair
    jlayer = jax.tree.map(lambda a: a[1], jp["stack"][0]["mamba"])
    tlayer = {k: v[1] for k, v in tp["stack"][0]["mamba"].items()}
    rng = np.random.RandomState(7)
    seq = 1 if mode == "decode" else 24
    x = rng.randn(2, seq, cfg.d_model).astype(np.float32) * 0.3
    cache = None
    if mode != "prefill":
        cache = {"conv": rng.randn(2, cfg.ssm.d_conv - 1, cfg.d_inner)
                 .astype(np.float32) * 0.3,
                 "ssm": rng.randn(2, cfg.d_inner, cfg.ssm.d_state)
                 .astype(np.float32) * 0.3}
    decode = mode == "decode"
    jout, jc = jmamba.mamba_fwd(
        jlayer, cfg, jnp.asarray(x),
        cache=None if cache is None else jax.tree.map(jnp.asarray, cache),
        decode=decode)
    tcache = (None if cache is None
              else {k: torch.from_numpy(v.copy()) for k, v in cache.items()})
    tout, tc = tmamba.mamba_fwd(tlayer, cfg, torch.from_numpy(x),
                                cache=tcache, decode=decode)
    _close(tout, jout)
    for name in ("conv", "ssm"):
        _close(tc[name], jc[name])
        if decode:                                   # updated in place
            assert tc[name] is tcache[name]


def test_bf16_prefill_logits_within_reference_gap():
    """bf16 parity at the smoke depth (2 layers): the port's bf16 prefill
    logits differ from the reference's f32 logits by at most 2 times the
    reference's own bf16-against-f32 difference, both relative to the
    largest f32 logit (``test_torch_models.bf16_gap``; a_log and d_skip
    stay f32 in both packages)."""
    toks = np.random.RandomState(1).randint(0, 512, (2, 24))
    ref_gap, port_gap = bf16_gap(ARCH, toks)
    assert 0.0 < ref_gap < 0.1, ref_gap
    assert port_gap <= BF16_SLACK * ref_gap, (port_gap, ref_gap)


def test_model_prefill_decode_and_greedy_tokens(pair, runners):
    cfg, jm, jp, tm, tp = pair
    toks = np.random.RandomState(1).randint(0, cfg.vocab_size, (2, 24))
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, capacity=32)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, capacity=32)
    _close(tl, jl)
    for name in ("conv", "ssm"):
        _close(tc["stack"][0]["mamba"][name], jc["stack"][0]["mamba"][name])
    nxt = np.random.RandomState(2).randint(0, cfg.vocab_size, (2, 1))
    jl, jc = jm.decode_step(jp, jc, jnp.int32(24), jnp.asarray(nxt))
    tl, tc = tm.decode_step(tp, tc, 24, torch.from_numpy(nxt))
    _close(tl, jl)
    _close(tc["stack"][0]["mamba"]["ssm"], jc["stack"][0]["mamba"]["ssm"])
    _, jr, tr = runners
    q = np.array([5, 6, 7])
    jans, _ = jr.generate_uncompressed(toks[0], q, 8)
    tans, _ = tr.generate_uncompressed(toks[0], q, 8)
    assert tans == jans and len(tans) == 8


def test_runner_state_kvdata_and_generation(runners):
    cfg, jr, tr = runners
    toks = np.random.RandomState(3).randint(0, cfg.vocab_size, 40)
    jkv, tkv = jr.prefill_entry(toks), tr.prefill_entry(toks)
    assert sorted(tkv) == sorted(jkv) == ["conv", "positions", "ssm"]
    shapes = {"ssm": (cfg.n_layers, cfg.d_inner, cfg.ssm.d_state),
              "conv": (cfg.n_layers, cfg.ssm.d_conv - 1, cfg.d_inner)}
    for name, shape in shapes.items():
        assert tkv[name].shape == jkv[name].shape == shape
        assert tkv[name].dtype == jkv[name].dtype == np.float32
        np.testing.assert_allclose(tkv[name], jkv[name], **STATE_TOL)
    np.testing.assert_array_equal(tkv["positions"], jkv["positions"])
    q = np.array([9, 4])
    assert (tr.generate_from_kvdata(jkv, 40, q, 6)
            == jr.generate_from_kvdata(jkv, 40, q, 6))
    cache, n = kvdata_to_cache(jkv, cfg, tr.model, 64, "cpu")
    assert n == 40
    blk = cache["stack"][0]["mamba"]
    np.testing.assert_array_equal(blk["ssm"][:, 0].numpy(), jkv["ssm"])
    np.testing.assert_array_equal(blk["conv"][:, 0].numpy(), jkv["conv"])


@pytest.mark.parametrize("bits", [8, 4, 2])
def test_kivi_on_state_bit_equal(runners, bits):
    """The state arrays' KIVI codes (V-style grouping: group 16 on the
    conv window's 128 channels, the 8 states of the ssm rows) and their
    round trip equal the reference's jitted ops bit for bit."""
    cfg, jr, _ = runners
    kv = jr.prefill_entry(np.random.RandomState(4).randint(
        0, cfg.vocab_size, 33))
    je = JKIVI().compress(kv, 0.0, bits=bits)
    te = TKIVI(device="cpu").compress(kv, 0.0, bits=bits)
    assert sorted(te.arrays) == sorted(je.arrays)
    for key, a in je.arrays.items():
        assert te.arrays[key].dtype == a.dtype, key
        np.testing.assert_array_equal(te.arrays[key], a, err_msg=key)
    assert te.rate == je.rate
    jback, tback = JKIVI().decompress(je), TKIVI(device="cpu").decompress(te)
    for name in ("ssm", "conv"):
        np.testing.assert_array_equal(tback[name], np.asarray(jback[name]))


def test_batcher_writes_state_lanes_whole(runners):
    """Same admissions into both batchers (a lane re-admitted over a
    finished one's state): identical tokens and simulated dt each tick."""
    cfg, jr, tr = runners
    tm = TimeModel(jget(ARCH), A100, FULL_PARAMS)
    jb = JBatcher(jr.model, jr.params, tm, n_slots=2, capacity=64)
    tb = TBatcher(tr.model, tr.params, tm, n_slots=2, capacity=64)
    rng = np.random.RandomState(5)
    kvs = [jr.prefill_entry(rng.randint(0, cfg.vocab_size, n))
           for n in (20, 31)]
    reqs = [Request(i, f"c{i}", rng.randint(0, cfg.vocab_size, 3), 0.0,
                    "qa", 4) for i in range(3)]
    now, done_j, done_t = 0.0, [], []
    for step in range(16):
        for lane, at, i in ((0, 0, 0), (1, 2, 1), (0, 8, 2)):
            if step == at:
                for b in (jb, tb):
                    b.admit(lane, reqs[i], kvs[i % 2], 20 + 11 * (i % 2),
                            now)
        assert tb.next_dt() == jb.next_dt()
        dj, dt_j = jb.tick(now)
        dt, dt_t = tb.tick(now)
        assert dt_t == dt_j
        done_j += [(r.req_id, r.tokens, r.ttft_s, r.finish_s) for r in dj]
        done_t += [(r.req_id, r.tokens, r.ttft_s, r.finish_s) for r in dt]
        now += dt_j
    assert done_t == done_j and len(done_j) == 3


def test_engine_summary_equal_with_zero_sized_state_tiers(runners,
                                                          tmp_path):
    """``build_engine`` sizes tiers from ``kv_bytes_per_token``, which
    counts attention layers only, so the reference's tiers hold 1.5 and
    6 bytes on this model and no request hits; the port reproduces it."""
    cfg, jr, tr = runners
    out = []
    for runner, build, summ, sub in ((jr, jbuild_engine, jsummarize, "j"),
                                     (tr, tbuild_engine, tsummarize, "t")):
        rng = np.random.RandomState(0)
        contexts = make_contexts(rng, cfg.vocab_size, 1, min_len=64,
                                 max_len=128, n_probes=1)
        reqs = poisson_requests(rng, contexts, rate_hz=1.0, duration_s=8)
        rig = build(runner, contexts, jget(ARCH), FULL_PARAMS,
                    policy=("kivi", 0.16), dram_entries=1.5,
                    ssd_entries=6.0, ssd_root=str(tmp_path / sub))
        res = rig.engine.process(reqs)
        out.append((summ(res, selector_stats=rig.controller.selector.stats),
                    [r.answer for r in res], rig.controller.stats()))
    (js, jans, jctrl), (ts, tans, tctrl) = out
    assert tans == jans and all(tans)
    assert ts["n"] == len(jans) and ts["hit_rate"] == 0.0
    assert ts == js
    assert tctrl == jctrl


def test_serve_driver_falcon_mamba_on_cpu():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = tserve.main(["--arch", ARCH, "--device", "cpu", "--duration",
                          "6", "--rate", "1", "--contexts-per-task", "1",
                          "--policy", "kivi:0.16", "--lanes", "1"])
    assert rc == 0
    text = buf.getvalue()
    assert "=== serving summary ===" in text and "hit_rate" in text


def test_param_counts_match_reference():
    for smoke in (True, False):
        assert (tbuild(tget(ARCH, smoke=smoke)).active_param_count()
                == jbuild(jget(ARCH, smoke=smoke)).active_param_count())
    assert tbuild(tget(ARCH)).param_count() == FULL_PARAMS


def test_init_scheme_and_leaf_dtypes(pair):
    """The reference's init scheme, seeded; under bf16 params ``a_log``
    and ``d_skip`` stay f32, in the seeded init and in the carried-across
    weights alike."""
    cfg, _, jp, _, _ = pair
    bf16 = dataclasses.replace(tget(ARCH, smoke=True),
                               param_dtype="bfloat16")
    m = tbuild(bf16)
    p, p2 = m.init(0, "cpu"), m.init(0, "cpu")
    mb = p["stack"][0]["mamba"]
    assert torch.equal(mb["in_proj"], p2["stack"][0]["mamba"]["in_proj"])
    n = cfg.ssm.d_state
    assert mb["a_log"].dtype == mb["d_skip"].dtype == torch.float32
    assert mb["in_proj"].dtype == mb["dt_bias"].dtype == torch.bfloat16
    torch.testing.assert_close(mb["a_log"][0, 0],
                               torch.log(torch.arange(1.0, n + 1)))
    assert torch.equal(mb["d_skip"], torch.ones(cfg.n_layers, cfg.d_inner))
    assert torch.equal(mb["conv_b"], torch.zeros(cfg.n_layers, cfg.d_inner,
                                                 dtype=torch.bfloat16))
    dt = torch.nn.functional.softplus(mb["dt_bias"].float())
    assert float(dt.min()) >= 0.0009 and float(dt.max()) <= 0.101
    for name, d_in in (("in_proj", cfg.d_model), ("out_proj", cfg.d_inner),
                       ("conv_w", 1)):
        std = float(mb[name].float().std()) * (d_in if name != "conv_w"
                                               else cfg.ssm.d_conv) ** 0.5
        assert 0.8 < std < 1.2, name
    carried = params_from_numpy(jax.tree.map(np.asarray, jp), bf16, "cpu")
    cm = carried["stack"][0]["mamba"]
    assert cm["a_log"].dtype == torch.float32
    assert cm["out_proj"].dtype == torch.bfloat16
