"""The plain reference against ``repro_torch`` at smoke size, in f32: the
rows and states a prefill stores and the logits after a cache written
from an entry; the plain KIVI against the port's compression methods."""
import json

import numpy as np
import pytest
import torch

from repro_torch.core.compression import default_registry
from repro_torch.device import cap_test_threads
from repro_torch.models import Model
from repro_torch.serving.runner import ModelRunner, kvdata_to_cache

from bench.reference import kivi
from bench.reference.check import _count_diff
from bench.reference.model import PlainLM
from bench.rig import port_config
from bench.tests import jamba
from bench.tests.smoke import DATA
from bench.weights import make_params

cap_test_threads()


def _setup(name, seed=7):
    hf = json.loads((DATA / "configs" / f"{name}.json").read_text())
    adapter, cfg = port_config(hf, name)
    p = make_params(cfg, seed, torch.device("cpu"), dtype=torch.float32)
    lm = PlainLM(hf, lambda i: adapter.layer_weights(p, cfg, i),
                 {k: p[k] for k in ("embed", "final_norm", "lm_head")})
    return hf, cfg, p, lm


@pytest.mark.parametrize("name", ["olmoe-smoke", "deepseek-smoke",
                                  "jamba-smoke"])
def test_reference_matches_port_in_f32(name, monkeypatch):
    """Prefill rows (and a hybrid's Mamba states), then a two-token
    question decoded through the cache. Both sides run f32 and differ
    only in the order of sums (the port's fused or batched products, its
    scan through the kernel's plain form; the reference's plain products
    and token loop): a few ulp of values of order 1 to 4, so 1e-5
    absolute and relative. Continuing from the stored rows and states is
    running the whole sequence, to the same tolerance."""
    jamba.install(monkeypatch)
    hf, cfg, p, lm = _setup(name)
    runner = ModelRunner(Model(cfg), p, capacity=200)
    toks = np.random.RandomState(0).randint(8, 500, 150).astype(np.int32)
    kv = runner.prefill_entry(toks)
    rows = lm.prefill(torch.as_tensor(toks, dtype=torch.long))
    assert set(rows) == set(kv) - {"positions"}
    for k, v in rows.items():
        assert torch.allclose(torch.from_numpy(kv[k]), v, rtol=1e-5,
                              atol=1e-5), k
    q = np.array([6, 9], np.int32)
    cache, n = kvdata_to_cache(kv, cfg, runner.model, 200, "cpu")
    slot, pos = n, len(toks)
    for t in q:
        lg, cache = runner.model.decode_step(p, cache, slot,
                                             torch.tensor([[int(t)]]), pos)
        slot, pos = slot + 1, pos + 1
    ref = lm.continue_from(rows, torch.as_tensor(q, dtype=torch.long),
                           len(toks))
    assert torch.allclose(lg[0, -1], ref, rtol=1e-5, atol=1e-5)
    whole = lm.all_logits(torch.as_tensor(np.concatenate([toks, q]),
                                          dtype=torch.long))[-1]
    assert torch.allclose(whole, ref, rtol=1e-5, atol=1e-5)


def test_control_differs_from_reference():
    hf, cfg, p, _ = _setup("olmoe-smoke")
    lm8 = PlainLM(hf, lambda i: __import__("bench.adapters.olmoe", fromlist=[
        "x"]).layer_weights(p, cfg, i),
        {k: p[k] for k in ("embed", "final_norm", "lm_head")}, lowp=True)
    _, _, _, lm = _setup("olmoe-smoke")
    toks = torch.arange(8, 72)
    a, b = lm.prefill(toks)["k"], lm8.prefill(toks)["k"]
    rel = float((a - b).norm() / a.norm())
    assert 1e-3 < rel < 0.5


@pytest.mark.parametrize("method", ["none", "kivi", "streaming_llm",
                                    "drop_kivi"])
def test_plain_compression_matches_port(method):
    rng = np.random.RandomState(1)
    kv = {"k": rng.randn(2, 90, 32).astype(np.float32),
          "v": rng.randn(2, 90, 32).astype(np.float32),
          "positions": np.arange(90, dtype=np.int32)}
    m = default_registry("cpu")[method]
    for rate in m.rates(kv):
        entry = m.compress(kv, rate)
        want = kivi.expected_arrays(method, kv, entry.meta, "cpu")
        assert _count_diff(entry.arrays, want) == 0, rate
        got, pos = kivi.entry_kv(method, entry.arrays, entry.meta, "cpu")
        port = m.decompress(entry)
        for name in ("k", "v"):
            assert torch.allclose(got[name], torch.from_numpy(
                np.asarray(port[name], np.float32)), rtol=0, atol=1e-6)
        assert list(pos) == list(port.get("positions", np.arange(90)))


def test_a_changed_code_counts():
    rng = np.random.RandomState(2)
    kv = {"k": rng.randn(2, 64, 16).astype(np.float32),
          "v": rng.randn(2, 64, 16).astype(np.float32)}
    m = default_registry("cpu")["kivi"]
    entry = m.compress(kv, m.rates(kv)[1])
    bad = dict(entry.arrays)
    bad["v.packed"] = bad["v.packed"].copy()
    bad["v.packed"][0, 0] ^= 1
    want = kivi.expected_arrays("kivi", kv, entry.meta, "cpu")
    assert _count_diff(bad, want) == 1
    low = kivi.kivi_payload(kv, entry.meta, "cpu", arith=torch.bfloat16)
    assert _count_diff({k: entry.arrays[k] for k in low}, low) > 0
