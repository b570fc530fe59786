"""The harness takes a Mamba/attention/MoE hybrid by layer kind: Jamba's
layout at smoke size (``data/configs/jamba-smoke.json``, AI21-Jamba2-Mini's
keys at tiny widths) through a test-local adapter (``bench/tests/jamba.py``
in place of ``adapters.load``'s lookup), with no file of the harness
edited: seeded weights, the reference's layer kinds, held experts and
inner norms, the checks on stored Mamba states, the FLOP count of a held
share, and faults in the states. The reference against the port in f32,
the decode FLOPs against the port's counter, the cell end to end and its
control are the OLMoE and DeepSeek-V2 tests' third case."""
import json

import numpy as np
import pytest
import torch

from repro_torch.core.compression import default_registry
from repro_torch.device import cap_test_threads

from bench import counts
from bench.reference import kivi
from bench.reference.check import _count_diff
from bench.reference.model import PlainLM, layer_kinds
from bench.tests import jamba
from bench.tests.smoke import DATA, run_cell
from bench.weights import make_params

cap_test_threads()

CELL = "jamba-smoke.doc_reuse"
GLOBALS = ("embed", "final_norm", "lm_head")


def _hf() -> dict:
    return json.loads((DATA / "configs" / "jamba-smoke.json").read_text())


def _setup(hf=None, seed=7, dtype=torch.float32):
    hf = hf or _hf()
    cfg = jamba.port_config(hf)
    p = make_params(cfg, seed, torch.device("cpu"), dtype=dtype)
    lm = PlainLM(hf, lambda i: jamba.layer_weights(p, cfg, i),
                 {k: p[k] for k in GLOBALS})
    return hf, cfg, p, lm


def test_layer_kinds_follow_the_periods():
    hf = _hf()
    cfg = jamba.port_config(hf)
    kinds = layer_kinds(hf)
    assert [m == "mamba" for m, _ in kinds] == [
        k.value == "mamba" for k in cfg.layer_kinds()]
    assert [f == "experts" for _, f in kinds] == [
        cfg.uses_moe_at(i) for i in range(8)]
    # the published Jamba2-Mini: attention at 4 and 12 of 16, experts on
    # the odd layers
    mini = dict(hf, num_hidden_layers=16, expert_layer_offset=1)
    kinds = layer_kinds(mini)
    assert [i for i, (m, _) in enumerate(kinds) if m == "attention"] == [4, 12]
    assert [i for i, (_, f) in enumerate(kinds) if f == "experts"] == list(
        range(1, 16, 2))
    # without the keys every layer attends, as for OLMoE and DeepSeek-V2
    ds = json.loads((DATA / "configs" / "deepseek-smoke.json").read_text())
    assert layer_kinds(ds) == [("attention", "dense")] + [
        ("attention", "experts")] * 2


def test_mamba_leaves_follow_the_published_init():
    cfg = jamba.port_config(_hf())
    p = make_params(cfg, 2 ** 31 + 3, torch.device("cpu"),
                    dtype=torch.bfloat16)
    m = p["stack"][0]["mamba"]
    assert m["a_log"].dtype == m["d_skip"].dtype == torch.float32
    assert torch.equal(m["a_log"][0, 5], torch.log(torch.arange(1., 17.)))
    assert torch.equal(m["d_skip"], torch.ones_like(m["d_skip"]))
    dt = torch.nn.functional.softplus(m["dt_bias"].float())
    assert dt.min() > 0.99e-3 and dt.max() < 1.01e-1      # bf16 rounding
    assert dt.log().std() > 0.5                            # log-uniform
    assert m["conv_b"].dtype == torch.bfloat16
    for name in ("conv_w", "conv_b"):     # U(+-1/sqrt(4)): std 0.289
        c = m[name].float()
        assert c.abs().max() <= 0.5 and 0.25 < c.std() < 0.33
    q = make_params(cfg, 2 ** 31 + 3, torch.device("cpu"),
                    dtype=torch.bfloat16)
    assert torch.equal(q["stack"][0]["mamba"]["dt_bias"], m["dt_bias"])


def test_held_experts_add_up_to_the_layer():
    """Two chips of an expert-parallel deployment, each holding half the
    experts with the router whole: their parts add up to the whole
    layer."""
    hf, cfg, p, lm = _setup()
    w = jamba.layer_weights(p, cfg, 0)
    assert "router" in w
    h = torch.randn(40, 64, generator=torch.Generator().manual_seed(1))
    full = lm.ffn(w, h)
    names = ("experts_gate", "experts_up", "experts_down")
    first = dict(w, **{k: w[k][:4] for k in names})
    order = list(range(4, 8)) + list(range(4))
    second = dict(w, router=w["router"][:, order],
                  **{k: w[k][4:] for k in names})
    parts = lm.ffn(first, h) + lm.ffn(second, h)
    assert torch.allclose(parts, full, rtol=1e-5, atol=1e-6)
    assert not torch.allclose(lm.ffn(first, h), full, atol=1e-3)


def test_inner_norms_are_switched_by_their_key():
    """With Jamba's RMS norms on dt, B and C (unit weights) a Mamba layer
    hardly moves when ``x_proj`` is scaled, as a norm's output is; without
    them it does."""
    hf, cfg, p, _ = _setup()
    w = jamba.layer_weights(p, cfg, 0)
    ones = {k: torch.ones(n) for k, n in (("dt_norm", 8), ("b_norm", 16),
                                           ("c_norm", 16))}
    h = torch.randn(12, 64, generator=torch.Generator().manual_seed(2))
    scaled = dict(w, x_proj=w["x_proj"] * 3)
    on = PlainLM(dict(hf, mamba_inner_norms=True), None, {})
    off = PlainLM(hf, None, {})
    a, _ = on.mamba(dict(w, **ones), h, None)
    b, _ = on.mamba(dict(scaled, **ones), h, None)
    assert torch.allclose(a, b, rtol=1e-4, atol=1e-5)
    a, _ = off.mamba(w, h, None)
    b, _ = off.mamba(scaled, h, None)
    assert not torch.allclose(a, b, rtol=1e-2, atol=1e-3)


@pytest.mark.parametrize("method", ["none", "kivi", "streaming_llm",
                                    "drop_kivi"])
def test_plain_compression_of_a_hybrid_entry(method):
    """Token dropping passes the Mamba states whole, KIVI quantizes them:
    the plain forms read every stored array as the port wrote it."""
    rng = np.random.RandomState(3)
    kv = {"k": rng.randn(1, 90, 32).astype(np.float32),
          "v": rng.randn(1, 90, 32).astype(np.float32),
          "ssm": rng.randn(7, 128, 16).astype(np.float32),
          "conv": rng.randn(7, 3, 128).astype(np.float32),
          "positions": np.arange(90, dtype=np.int32)}
    m = default_registry("cpu")[method]
    for rate in m.rates(kv):
        entry = m.compress(kv, rate)
        want = kivi.expected_arrays(method, kv, entry.meta, "cpu")
        assert _count_diff(entry.arrays, want) == 0, rate
        got, pos = kivi.entry_kv(method, entry.arrays, entry.meta, "cpu")
        port = m.decompress(entry)
        assert set(got) == {"k", "v", "ssm", "conv"}
        for name in got:
            assert torch.allclose(got[name], torch.from_numpy(
                np.asarray(port[name], np.float32)), rtol=0, atol=1e-6), name
        assert list(pos) == list(port.get("positions", np.arange(90)))
        if method in ("none", "streaming_llm"):
            assert torch.equal(got["ssm"], torch.from_numpy(kv["ssm"]))


def test_held_experts_scale_the_expert_work():
    hf = _hf()
    half = dict(hf, num_experts=4, **{counts.PUBLISHED_EXPERTS: 8})
    d, ff, k = 64, 32, 2
    expert_layers = 4
    diff = counts.decode_flops(hf, 9) - counts.decode_flops(half, 9)
    assert diff == pytest.approx(2 * expert_layers * k * 3 * d * ff / 2)


def _state_unwritten(monkeypatch):
    """The lane copy writes the attention rows and leaves every Mamba
    layer's state as the lane held it."""
    from repro_torch.serving import runner, scheduler

    def rows_only(cache, kv, cfg, lane, device):
        return runner.write_kvdata(cache, {k: v for k, v in kv.items()
                                           if k != "ssm"} | {
            "ssm": np.zeros_like(kv["ssm"])}, cfg, lane, device)
    monkeypatch.setattr(scheduler, "write_kvdata", rows_only)


def _state_changed(monkeypatch):
    """A stored entry's Mamba state changed between a tier's put and its
    get (the smoke cell's hits come from both tiers)."""
    from repro_torch.core.compression.base import CompressedEntry
    from repro_torch.storage.tier import DRAMTier, SSDTier

    def changing(get):
        def changed(self, key):
            e = get(self, key)
            arrays = {k: np.array(v, copy=True) for k, v in e.arrays.items()}
            name = next(k for k in arrays if k.startswith("ssm"))
            arrays[name].flat[7] += 1
            return CompressedEntry(e.method, e.rate, arrays, e.meta)
        return changed
    for tier in (DRAMTier, SSDTier):
        monkeypatch.setattr(tier, "get", changing(tier.get))


@pytest.mark.parametrize("fault", [_state_unwritten, _state_changed])
def test_a_state_fault_is_not_correct(fault, monkeypatch):
    jamba.install(monkeypatch)
    fault(monkeypatch)
    rc, last, out, err = run_cell(CELL, seed=9)
    assert rc == 0 and last is not None
    assert last["correct"] is False, err
