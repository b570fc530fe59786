"""Port parity: the dense GQA model of ``repro_torch`` against the JAX
package, on the same weights (JAX params carried across through numpy).

Tolerance: logits agree within rtol = atol = 1e-4 in f32. The two
frameworks compute the same math but XLA's CPU matmuls and torch's sum in
another order (and XLA fuses multiply-adds), so the last bits differ. In
bf16 the bound comes from the reference itself (``bf16_gap``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import attention as jattn
from repro.models import build_model as jbuild
from repro_torch.configs import get_config as tget
from repro_torch.models import attention as tattn
from repro_torch.models import build_model as tbuild
from repro_torch.models.convert import params_from_numpy

TOL = dict(rtol=1e-4, atol=1e-4)
DENSE = ["adaptcache-8b", "qwen3-1.7b", "stablelm-3b", "smollm-135m",
         "minicpm-2b"]
BF16_SLACK = 2.0    # the port's bf16 error, in units of the reference's own


def _pair(arch: str, seed: int = 0):
    cfg = jget(arch, smoke=True)
    jm = jbuild(cfg)
    jp = jm.init(jax.random.key(seed))
    tcfg = tget(arch, smoke=True)
    tm = tbuild(tcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return cfg, jm, jp, tm, tp


@pytest.fixture(scope="module")
def smoke8b():
    return _pair("adaptcache-8b")


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               **TOL)


def bf16_gap(arch: str, toks: np.ndarray, seed: int = 0):
    """Prefill logits of the smoke model ``arch`` on shared weights, as
    max |logits - f32 reference logits| over max |f32 reference logits|:
    (the reference in bf16, the port in bf16). The bf16 weights are the
    f32 reference weights cast to each leaf's bf16-config dtype, carried
    across through ``params_from_numpy``."""
    cfg = jget(arch, smoke=True)
    jm = jbuild(cfg)
    jp = jm.init(jax.random.key(seed))
    cfg16 = dataclasses.replace(cfg, dtype="bfloat16",
                                param_dtype="bfloat16")
    jm16 = jbuild(cfg16)
    jp16 = jax.tree.map(lambda a, sd: a.astype(sd.dtype), jp,
                        jax.eval_shape(jm16.init, jax.random.key(seed)))
    tcfg16 = dataclasses.replace(tget(arch, smoke=True), dtype="bfloat16",
                                 param_dtype="bfloat16")
    tm16 = tbuild(tcfg16)
    tp16 = params_from_numpy(jax.tree.map(np.asarray, jp16), tcfg16, "cpu")
    cap = toks.shape[1] + 8
    want = np.asarray(jm.prefill(jp, {"tokens": jnp.asarray(toks)},
                                 capacity=cap)[0], np.float32)
    ref16 = np.asarray(jm16.prefill(jp16, {"tokens": jnp.asarray(toks)},
                                    capacity=cap)[0], np.float32)
    port16 = tm16.prefill(tp16, {"tokens": torch.from_numpy(toks)},
                          capacity=cap)[0]
    assert port16.dtype == torch.bfloat16
    scale = np.abs(want).max()
    return (float(np.abs(ref16 - want).max() / scale),
            float(np.abs(port16.float().numpy() - want).max() / scale))


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_logits_and_cache_match(arch):
    """qk-norm (qwen3), partial rotary (stablelm) and the plain Llama shape
    all go through the same prefill."""
    cfg, jm, jp, tm, tp = _pair(arch)
    toks = np.random.RandomState(1).randint(0, cfg.vocab_size, (2, 24))
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, capacity=32)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, capacity=32)
    _close(tl, jl)
    for name in ("k", "v"):
        _close(tc["stack"][0]["self"][name], jc["stack"][0]["self"][name])


def test_bf16_prefill_logits_within_reference_gap():
    """bf16 parity, smoke adaptcache-8b (2 layers): the port's bf16 prefill
    logits differ from the reference's f32 logits, relative to the largest
    f32 logit, by at most BF16_SLACK (2) times the reference's own bf16
    logits' difference from the same f32 logits. So the bf16 tolerance is
    the reference's own bf16 rounding error, not a number picked here."""
    toks = np.random.RandomState(1).randint(0, 512, (2, 24))
    ref_gap, port_gap = bf16_gap("adaptcache-8b", toks)
    assert 0.0 < ref_gap < 0.1, ref_gap
    assert port_gap <= BF16_SLACK * ref_gap, (port_gap, ref_gap)


def test_decode_logits_match_scalar_and_per_lane(smoke8b):
    cfg, jm, jp, tm, tp = smoke8b
    rng = np.random.RandomState(2)
    toks = rng.randint(0, cfg.vocab_size, (2, 20))
    _, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, capacity=32)
    _, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, capacity=32)
    nxt = rng.randint(0, cfg.vocab_size, (2, 1))
    # aligned lanes: one scalar write slot
    jl, jc = jm.decode_step(jp, jc, jnp.int32(20), jnp.asarray(nxt))
    tl, tc = tm.decode_step(tp, tc, 20, torch.from_numpy(nxt))
    _close(tl, jl)
    # ragged lanes: per-lane slots and RoPE positions
    slot, pos = np.array([21, 25]), np.array([21, 30])
    jl, jc = jm.decode_step(jp, jc, jnp.asarray(slot), jnp.asarray(nxt),
                            jnp.asarray(pos))
    tl, tc = tm.decode_step(tp, tc, torch.from_numpy(slot),
                            torch.from_numpy(nxt), torch.from_numpy(pos))
    _close(tl, jl)
    _close(tc["stack"][0]["self"]["k"], jc["stack"][0]["self"]["k"])


def test_chunked_attention_matches(smoke8b):
    """Prompts of 2048 tokens or more take the query-chunked path."""
    cfg, _, jp, _, tp = smoke8b
    s = jattn.FLASH_THRESHOLD
    assert tattn.FLASH_THRESHOLD == s
    x = np.random.RandomState(3).randn(1, s, cfg.d_model).astype(np.float32)
    pos = np.arange(s)[None]
    jlayer = jax.tree.map(lambda a: a[0], jp["stack"][0]["attn"])
    tlayer = {k: v[0] for k, v in tp["stack"][0]["attn"].items()}
    jo, jkv = jattn.attention_fwd(jlayer, cfg, jnp.asarray(x),
                                  jnp.asarray(pos))
    to, tkv = tattn.attention_fwd(tlayer, cfg, torch.from_numpy(x),
                                  torch.from_numpy(pos))
    _close(to, jo)
    _close(tkv["k"], jkv["k"])


def test_param_counts_and_shapes_match():
    """Counted from shapes without allocating, as the reference's
    ``jax.eval_shape`` does, at full width too."""
    for arch in DENSE:
        for smoke in (True, False):
            cfg = jget(arch, smoke=smoke)
            assert (tbuild(tget(arch, smoke=smoke)).active_param_count()
                    == jbuild(cfg).active_param_count()), (arch, smoke)
    assert tbuild(tget("adaptcache-8b")).param_count() > 8e9


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "olmoe-1b-7b",
                                  "jamba-1.5-large-398b",
                                  "seamless-m4t-large-v2", "internvl2-1b"])
def test_other_families_not_ported_yet(arch):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tbuild(tget(arch, smoke=True))


def test_init_is_seeded_and_defaults_to_cuda():
    m = tbuild(tget("adaptcache-8b", smoke=True))
    a, b, c = m.init(0, "cpu"), m.init(0, "cpu"), m.init(1, "cpu")
    assert torch.equal(a["stack"][0]["attn"]["wq"], b["stack"][0]["attn"]["wq"])
    assert not torch.equal(a["embed"], c["embed"])
    assert torch.equal(a["final_norm"], torch.ones(m.cfg.d_model))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            m.init(0)
