"""The port's expert layer told which experts it holds, experts at an
offset, the top-k weights left as the softmax gives them, Jamba's inner
norms, tiers sized with an entry's fixed Mamba state, and the spans and
counters of a hybrid's decode; and the defaults leave every other
model's outputs as they were, bit for bit (``data/default_pins.json``,
taken from the tree before these options existed). Regenerate the pins
only with a change that means to move them:

    PYTHONPATH=src python -m tests.test_torch_hybrid
"""
import dataclasses
import hashlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import REGISTRY, get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.device import cap_test_threads
from repro_torch.models import build_model, moe as moe_lib
from repro_torch.models import transformer
from repro_torch.runtime import trace
from repro_torch.serving.baselines import build_engine
from repro_torch.serving.runner import ModelRunner, kvdata_to_cache
from repro_torch.serving.workload import Request, make_contexts

cap_test_threads()

PINS = Path(__file__).resolve().parent / "data" / "default_pins.json"
PINNED = ["olmoe-1b-7b", "deepseek-v2-lite-16b", "jamba-1.5-large-398b",
          "falcon-mamba-7b"]


def _published_jamba(held: int = 4) -> ModelConfig:
    """The jamba smoke model in AI21-Jamba2-Mini's published form: experts
    on the odd layers, no renormalising, inner norms, no RoPE, ``held``
    of 8 experts."""
    cfg = get_config("jamba-1.5-large-398b", smoke=True)
    return dataclasses.replace(
        cfg, rotary_pct=0.0,
        moe=dataclasses.replace(cfg.moe, moe_offset=1, renormalize=False,
                                n_held_experts=held),
        ssm=dataclasses.replace(cfg.ssm, inner_norms=True))


@pytest.fixture(autouse=True)
def tracer_off():
    trace.disable()
    trace.take()
    yield
    trace.disable()
    trace.take()


# ---------------------------------------------------------------------------
# the defaults hold still
# ---------------------------------------------------------------------------

def _digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        t = torch.as_tensor(t).detach().contiguous().reshape(-1)
        h.update(str((t.dtype, tuple(t.shape))).encode())
        h.update(t.view(torch.uint8).numpy().tobytes() if t.numel() else b"")
    return h.hexdigest()


def _outputs(name: str) -> dict:
    """A smoke model's prefill logits and stored entry, two decode steps'
    logits through the cache, and one training step's logits, balance
    loss and gradients."""
    cfg = get_config(name, smoke=True)
    model = build_model(cfg)
    params = model.init(0, "cpu")
    toks = np.random.RandomState(0).randint(1, cfg.vocab_size, 48)
    batch = {"tokens": torch.as_tensor(toks[None], dtype=torch.long)}
    logits, _ = model.prefill(params, batch, capacity=64)
    kv = ModelRunner(model, params, capacity=64).prefill_entry(toks)
    cache, n = kvdata_to_cache(kv, cfg, model, 64, "cpu")
    steps = []
    for i, tok in enumerate((5, 9)):
        lg, cache = model.decode_step(params, cache, n + i,
                                      torch.tensor([[tok]]))
        steps.append(lg)
    out = {"prefill": _digest([logits] + [torch.from_numpy(kv[k])
                                          for k in sorted(kv)]),
           "decode": _digest(steps)}
    for leaf in transformer._leaves(params):
        leaf.requires_grad_(True)
    lg, aux = transformer.forward_train(params, cfg, batch)
    loss = transformer.loss_fn(params, cfg, dict(
        batch, labels=torch.roll(batch["tokens"], -1, dims=1)))
    loss.backward()
    out["train"] = _digest([lg, aux, loss] + [
        torch.zeros(0) if leaf.grad is None else leaf.grad
        for leaf in transformer._leaves(params)])
    return out


def pins() -> dict:
    threads = torch.get_num_threads()
    torch.set_num_threads(1)          # one reduction order on any host
    try:
        out = {name: _outputs(name) for name in PINNED}
    finally:
        torch.set_num_threads(threads)
    out["active_params"] = {name: build_model(cfg).active_param_count()
                            for name, cfg in sorted(REGISTRY.items())}
    return out


def test_defaults_leave_other_models_bit_identical():
    """Held count equal to the routed count, no offset, renormalising
    and no inner norms: every output as before, bit for bit."""
    want = json.loads(PINS.read_text())
    got = json.loads(json.dumps(pins()))
    assert got == want


# ---------------------------------------------------------------------------
# the expert layer
# ---------------------------------------------------------------------------

def test_uses_moe_at_honours_the_offset():
    cfg = _published_jamba()
    assert [cfg.uses_moe_at(i) for i in range(8)] == [False, True] * 4
    params = transformer.param_shapes(cfg)
    assert ["ffn_moe" in blk for blk in params["stack"]] == [False, True] * 4
    base = get_config("jamba-1.5-large-398b", smoke=True)
    assert [base.uses_moe_at(i) for i in range(8)] == [True, False] * 4
    ds = get_config("deepseek-v2-lite-16b", smoke=True)
    assert [ds.uses_moe_at(i) for i in range(3)] == [False, True, True]


def test_router_topk_renormalises_only_when_asked():
    logits = torch.randn(5, 8, generator=torch.Generator().manual_seed(0))
    w, idx = moe_lib.router_topk(logits, 2)
    raw, raw_idx = moe_lib.router_topk(logits, 2, renormalize=False)
    assert torch.equal(idx, raw_idx)
    probs = torch.softmax(logits, dim=-1)
    assert torch.equal(raw, probs.gather(1, idx))
    assert torch.allclose(w.sum(-1), torch.ones(5))
    assert torch.allclose(w, raw / raw.sum(-1, keepdim=True))


def _moe_layer(cfg: ModelConfig, held_lo: int, held_hi: int, full: dict):
    """A port expert layer that holds experts [held_lo, held_hi) of
    ``full``: its router's columns put them first, as a chip sees its own
    experts."""
    e = cfg.moe.n_routed_experts
    order = list(range(held_lo, held_hi)) + [
        j for j in range(e) if not held_lo <= j < held_hi]
    part = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, n_held_experts=held_hi - held_lo))
    p = {"router": full["router"][:, order],
         "experts": {k: v[held_lo:held_hi]
                     for k, v in full["experts"].items()}}
    return part, p


@pytest.mark.parametrize("decode", [False, True], ids=["runs", "decode"])
@pytest.mark.parametrize("renormalize", [False, True])
def test_held_halves_add_up_to_the_whole_layer(renormalize, decode):
    """Two chips of an expert-parallel deployment, each holding half the
    experts with the router whole: their moe_fwd outputs add up to the
    layer that holds all of them; one half alone does not. In the decode
    form (one token a lane) each half's slots routed to the other half
    take a clamped expert's weights and add nothing, and the whole layer
    agrees with the run-based form."""
    cfg = _published_jamba(held=0)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, renormalize=renormalize))
    g = torch.Generator().manual_seed(3)
    d, e, ff = cfg.d_model, cfg.moe.n_routed_experts, cfg.moe.expert_d_ff
    full = {"router": torch.randn(d, e, generator=g) * d ** -0.5,
            "experts": {"wi_gate": torch.randn(e, d, ff, generator=g) * 0.1,
                        "wi_up": torch.randn(e, d, ff, generator=g) * 0.1,
                        "wo": torch.randn(e, ff, d, generator=g) * 0.1}}
    # a decode step of 2 lanes: T·k = 4, the experts each half holds
    x = torch.randn(2, 1, d, generator=g) if decode else \
        torch.randn(2, 24, d, generator=g)
    whole, _ = moe_lib.moe_fwd(full, cfg, x, dropless=True, decode=decode)
    halves = []
    for lo, hi in ((0, e // 2), (e // 2, e)):
        part, p = _moe_layer(cfg, lo, hi, full)
        halves.append(moe_lib.moe_fwd(p, part, x, dropless=True,
                                      decode=decode)[0])
    # f32 sums of the same products in another order
    assert torch.allclose(halves[0] + halves[1], whole, rtol=1e-5, atol=1e-6)
    assert not torch.allclose(halves[0], whole, atol=1e-3)
    if decode:
        runs, _ = moe_lib.moe_fwd(full, cfg, x, dropless=True)
        assert torch.allclose(whole, runs, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("decode", [False, True], ids=["runs", "decode"])
def test_a_chip_whose_tokens_all_go_elsewhere_adds_nothing(decode):
    # the decode form takes a step of at most as many slots as experts
    # held: one token's two, over two held experts
    held = 2 if decode else 1
    cfg = _published_jamba(held=held)
    d, e, ff = cfg.d_model, cfg.moe.n_routed_experts, cfg.moe.expert_d_ff
    router = torch.zeros(d, e)
    router[:, 5] = 1.0
    router[:, 6] = 0.5
    p = {"router": router,
         "experts": {"wi_gate": torch.ones(held, d, ff),
                     "wi_up": torch.ones(held, d, ff),
                     "wo": torch.ones(held, ff, d)}}
    x = torch.ones(1, 1, d) if decode else torch.ones(1, 3, d)
    out, _ = moe_lib.moe_fwd(p, cfg, x, dropless=True, decode=decode)
    assert torch.equal(out, torch.zeros_like(out))


def test_mesh_paths_refuse_a_share_of_the_experts(monkeypatch):
    cfg = _published_jamba(held=4)
    x = torch.zeros(1, 2, cfg.d_model)
    monkeypatch.setattr(moe_lib.shlib, "_rules", lambda: {"mesh": None})
    with pytest.raises(ValueError, match="holds 4 of 8"):
        moe_lib.moe_fwd_ep({}, cfg, x)
    with pytest.raises(ValueError, match="holds 4 of 8"):
        moe_lib._moe_fwd_mesh({}, cfg, x, 1.25, True)


def test_held_experts_set_the_stacks_and_the_active_count():
    cfg = _published_jamba(held=4)
    moe = transformer.param_shapes(cfg)["stack"][1]["ffn_moe"]
    assert moe["router"] == (1, cfg.d_model, 8)
    assert moe["experts"]["wi_gate"] == (1, 4, cfg.d_model, 32)
    whole = _published_jamba(held=0)
    per_expert = 3 * cfg.d_model * 32
    # 4 of 8 held: a token's 2 picks reach 1 held expert on average
    assert build_model(cfg).active_param_count() == (
        build_model(cfg).param_count() - 4 * 3 * per_expert)
    assert build_model(whole).active_param_count() == (
        build_model(whole).param_count() - 4 * 6 * per_expert)


def test_inner_norms_add_their_leaves_as_ones_and_act():
    cfg = _published_jamba()
    m = transformer.param_shapes(cfg)["stack"][0]["mamba"]
    assert (m["dt_norm"], m["b_norm"], m["c_norm"]) == ((1, 4), (1, 8),
                                                        (1, 8))
    params = build_model(cfg).init(0, "cpu")
    mp = params["stack"][0]["mamba"]
    assert all(torch.equal(mp[k], torch.ones_like(mp[k]))
               for k in ("dt_norm", "b_norm", "c_norm"))
    from repro_torch.models import mamba as mamba_lib
    one = {k: v[0] for k, v in mp.items()}
    x = torch.randn(1, 6, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    on, _ = mamba_lib.mamba_fwd(one, cfg, x)
    off_cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(
        cfg.ssm, inner_norms=False))
    off, _ = mamba_lib.mamba_fwd(one, off_cfg, x)
    assert not torch.allclose(on, off, atol=1e-4)
    scaled = dict(one, b_norm=one["b_norm"] * 2)
    twice, _ = mamba_lib.mamba_fwd(scaled, cfg, x)
    assert not torch.allclose(on, twice, atol=1e-4)


# ---------------------------------------------------------------------------
# tiers sized with the state
# ---------------------------------------------------------------------------

def _tier_caps(cfg: ModelConfig, contexts, tmp_path):
    model = build_model(cfg)
    runner = ModelRunner(model, model.init(0, "cpu"), capacity=64)
    rig = build_engine(runner, contexts, cfg, model.active_param_count(),
                       policy=("none", 1.0), dram_entries=2.0,
                       ssd_entries=4.0, ssd_root=str(tmp_path), n_lanes=1)
    tiers = rig.controller.tiers
    return tiers["dram"].spec.capacity_bytes, tiers["ssd"].spec.capacity_bytes


def test_tiers_count_the_fixed_state(tmp_path):
    """A mean uncompressed entry is its f32 rows and its f32 state: a
    hybrid's and a pure SSM's tiers hold the state; an attention-only
    model's tiers are sized as before (rows alone)."""
    contexts = make_contexts(np.random.RandomState(0), 512, 2, min_len=20,
                             max_len=40, n_probes=1)
    avg = float(np.mean([len(c.tokens) for c in contexts]))
    for name in ("jamba-1.5-large-398b", "falcon-mamba-7b", "olmoe-1b-7b",
                 "deepseek-v2-lite-16b"):
        cfg = get_config(name, smoke=True)
        n_mamba = sum(k.value == "mamba" for k in cfg.layer_kinds())
        state = n_mamba * cfg.d_inner * (cfg.ssm.d_state + cfg.ssm.d_conv
                                         - 1) * 4 if n_mamba else 0
        assert cfg.state_bytes() == state
        entry = max(1.0, avg * cfg.kv_bytes_per_token() * 2.0 + state)
        assert _tier_caps(cfg, contexts, tmp_path / name) == (
            int(2.0 * entry), int(4.0 * entry)), name
        if not n_mamba:       # the rows alone, as the tiers were sized
            assert entry == max(1.0, avg * cfg.kv_bytes_per_token() * 2.0)
    # the published widths: 28 Mamba layers of (8192, 16) and (3, 8192)
    mini = dataclasses.replace(
        get_config("jamba-1.5-large-398b"), n_layers=32, d_model=4096)
    assert mini.state_bytes() == 17_432_576
    assert mini.kv_bytes_per_token() == 16_384


def test_a_pure_ssm_state_is_now_held(tmp_path):
    """falcon-mamba's entries have no rows: with the state counted its
    tiers hold them and a reused document hits."""
    cfg = get_config("falcon-mamba-7b", smoke=True)
    model = build_model(cfg)
    runner = ModelRunner(model, model.init(0, "cpu"), capacity=96)
    ctx = make_contexts(np.random.RandomState(1), cfg.vocab_size, 1,
                        min_len=40, max_len=60, n_probes=2)[0]
    rig = build_engine(runner, [ctx], get_config("falcon-mamba-7b"),
                       model.active_param_count(), policy=("kivi", 0.16),
                       dram_entries=1.5, ssd_entries=6.0,
                       ssd_root=str(tmp_path), n_lanes=1)
    reqs = [Request(i, ctx.key, ctx.probes[i % 2], float(i), ctx.task_type,
                    max_new_tokens=1) for i in range(3)]
    res = rig.engine.process(reqs, skip_quality=True)
    assert all(r.answer for r in res)
    assert [r.hit_tier for r in res][1:] == ["dram", "dram"]


# ---------------------------------------------------------------------------
# spans and counters of a hybrid
# ---------------------------------------------------------------------------

def _hybrid_serve(tmp_path):
    cfg = _published_jamba(held=4)
    model = build_model(cfg)
    runner = ModelRunner(model, model.init(0, "cpu"), capacity=128)
    ctx = make_contexts(np.random.RandomState(2), cfg.vocab_size, 1,
                        min_len=60, max_len=80, n_probes=2,
                        tasks=("qa",))[0]
    rig = build_engine(runner, [ctx], cfg, model.active_param_count(),
                       policy=("none", 1.0), ssd_root=str(tmp_path),
                       n_lanes=1)
    kv = runner.prefill_entry(ctx.tokens)
    rig.controller.insert(ctx.key, kv, ctx.task_type, now=0.0)
    reqs = [Request(0, ctx.key, ctx.probes[0], 0.0, ctx.task_type,
                    max_new_tokens=1)]
    return rig, reqs, kv, cfg


def test_a_hybrid_serve_traces_its_state_and_experts(tmp_path):
    rig, reqs, kv, cfg = _hybrid_serve(tmp_path)
    trace.enable()
    (res,) = rig.engine.process(reqs, skip_quality=True)
    rec = trace.take()
    trace.disable()
    assert res.hit_tier == "dram" and res.answer
    steps = [i for i, s in enumerate(rec.spans) if s.name == "model.step"]
    mamba = [s for s in rec.spans if s.name == "mamba.step"]
    n_mamba = sum(k.value == "mamba" for k in cfg.layer_kinds())
    # every decode step runs each Mamba layer's step once
    assert steps and len(mamba) == n_mamba * len(steps)

    def step_of(s):
        p = s.parent
        while p is not None and rec.spans[p].name != "model.step":
            p = rec.spans[p].parent
        return p
    assert all(step_of(s) in steps for s in mamba)
    c = rec.counters
    assert c["state_h2d_bytes"] == kv["ssm"].nbytes + kv["conv"].nbytes
    assert c["state_h2d_bytes"] < c["h2d_bytes"]
    # a hit's decode steps read no routing back: the chip holds 4 of 8
    # experts, so which slots it held is not counted (a prefill's read
    # counts it)
    assert "moe.held_slots" not in c
    # one layer's picks: k a token, every MoE layer
    n_moe = sum(cfg.uses_moe_at(i) for i in range(cfg.n_layers))
    assert c["moe.routed_slots"] == len(steps) * n_moe * cfg.moe.top_k


def test_a_hybrid_serve_with_the_tracer_off_records_none(tmp_path):
    rig, reqs, _, _ = _hybrid_serve(tmp_path)
    (res,) = rig.engine.process(reqs, skip_quality=True)
    assert res.answer
    rec = trace.take()
    assert rec.spans == [] and rec.counters == {}


def test_an_attention_model_counts_no_state(tmp_path):
    cfg = get_config("olmoe-1b-7b", smoke=True)
    model = build_model(cfg)
    runner = ModelRunner(model, model.init(0, "cpu"), capacity=128)
    ctx = make_contexts(np.random.RandomState(2), cfg.vocab_size, 1,
                        min_len=60, max_len=80, n_probes=1,
                        tasks=("qa",))[0]
    rig = build_engine(runner, [ctx], cfg, model.active_param_count(),
                       policy=("none", 1.0), ssd_root=str(tmp_path),
                       n_lanes=1)
    rig.controller.insert(ctx.key, runner.prefill_entry(ctx.tokens),
                          ctx.task_type, now=0.0)
    trace.enable()
    rig.engine.process([Request(0, ctx.key, ctx.probes[0], 0.0, ctx.task_type,
                                max_new_tokens=1)], skip_quality=True)
    rec = trace.take()
    assert "state_h2d_bytes" not in rec.counters
    assert not any(s.name == "mamba.step" for s in rec.spans)
    assert rec.counters["moe.held_slots"] == rec.counters["moe.routed_slots"]


if __name__ == "__main__":
    PINS.write_text(json.dumps(pins(), indent=1, sort_keys=True) + "\n")
