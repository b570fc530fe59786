"""Port parity: MLA attention (``models/attention.py`` ``mla_fwd``) and the
model that serves it, deepseek-v2-lite-16b (MLA, one dense prefix layer,
routed and shared experts), against the JAX package, on shared weights at
smoke size (d_model 64, 4 heads, latent rank 32, rope dim 8).

Tolerances, in f32: the layer's output and its cache rows within rtol =
atol = 1e-4 (XLA's CPU matmuls and torch's sum in another order); the
model's loss and gradients as ``test_torch_moe.py`` holds them; the
runner's KVData within 1e-4, greedy tokens and the engine's ``summarize``
dict equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import attention as jattn
from repro.serving.runner import ModelRunner as JRunner
from repro_torch.configs import get_config as tget
from repro_torch.device import cap_test_threads
from repro_torch.models import attention as tattn
from repro_torch.serving.runner import ModelRunner as TRunner
from repro_torch.serving.runner import kvdata_to_cache
from test_torch_models import FULL_PARAMS
from test_torch_moe import _pair, _torch_tree, loss_and_grads_match
from test_torch_serving import summaries_equal

cap_test_threads()

ARCH = "deepseek-v2-lite-16b"
TOL = dict(rtol=1e-4, atol=1e-4)


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               **TOL)


@pytest.fixture(scope="module")
def layer():
    cfg = jget(ARCH, smoke=True)
    jp = jattn.init_attention(jax.random.key(1), cfg, jnp.float32)
    assert sorted(jp) == sorted(tattn.param_shapes(tget(ARCH, smoke=True)))
    return cfg, tget(ARCH, smoke=True), jp, _torch_tree(jp)


@pytest.mark.parametrize("s", [12, jattn.FLASH_THRESHOLD],
                         ids=["prefill", "chunked"])
def test_mla_prefill_matches(layer, s):
    """The decompressed form at S 12, and the query-chunked path it takes
    from S 2048 on (chunks of 512 over the whole sequence)."""
    cfg, tcfg, jp, tp = layer
    assert tattn.FLASH_THRESHOLD == jattn.FLASH_THRESHOLD
    b = 2 if s < jattn.FLASH_THRESHOLD else 1
    x = np.random.RandomState(3).randn(b, s, cfg.d_model).astype(np.float32)
    pos = np.broadcast_to(np.arange(s), (b, s))
    jo, jc = jattn.attention_fwd(jp, cfg, jnp.asarray(x), jnp.asarray(pos))
    to, tc = tattn.attention_fwd(tp, tcfg, torch.from_numpy(x),
                                 torch.from_numpy(pos.copy()))
    _close(to, jo)
    assert sorted(tc) == sorted(jc) == ["ckv", "krope"]
    for name in jc:
        _close(tc[name], jc[name])


def test_mla_decode_matches(layer):
    """The absorbed form: a 12-token prefill placed in a 16-slot cache,
    then one step at one slot for both lanes and one at per-lane slots and
    RoPE positions; the port writes its cache in place."""
    cfg, tcfg, jp, tp = layer
    rng = np.random.RandomState(4)
    x = rng.randn(2, 12, cfg.d_model).astype(np.float32)
    pos = np.broadcast_to(np.arange(12), (2, 12))
    _, rows = jattn.attention_fwd(jp, cfg, jnp.asarray(x), jnp.asarray(pos))
    jc = jattn.init_cache(cfg, 2, 16, jnp.float32)
    jc = {k: v.at[:, :12].set(rows[k]) for k, v in jc.items()}
    tc = {k: torch.from_numpy(np.array(v)) for k, v in jc.items()}
    for slot, p in ((12, 12), (np.array([13, 14]), np.array([13, 20]))):
        x1 = rng.randn(2, 1, cfg.d_model).astype(np.float32)
        p1 = np.broadcast_to(np.asarray(p).reshape(-1, 1), (2, 1)).copy()
        jo, jc = jattn.attention_fwd(jp, cfg, jnp.asarray(x1),
                                     jnp.asarray(p1), cache=jc,
                                     cur_index=jnp.asarray(slot))
        ti = slot if np.ndim(slot) == 0 else torch.from_numpy(slot)
        to, tc2 = tattn.attention_fwd(tp, tcfg, torch.from_numpy(x1),
                                      torch.from_numpy(p1), cache=tc,
                                      cur_index=ti)
        assert tc2["ckv"] is tc["ckv"]
        _close(to, jo)
        for name in ("ckv", "krope"):
            _close(tc[name], jc[name])


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_loss_and_grads_match(remat):
    """The dense prefix layer outside the remat groups, the MoE layers'
    balance loss in the loss."""
    loss_and_grads_match(ARCH, remat)


@pytest.fixture(scope="module")
def runners():
    cfg, jm, jp, tm, tp = _pair(ARCH)
    return cfg, JRunner(jm, jp, capacity=128), TRunner(tm, tp, capacity=128)


def test_prefill_entry_and_generation_match(runners):
    """The latent KVData (``ckv`` (L, T, r), ``krope`` (L, T, rope), the
    prefix layer first), greedy answers from it and from a token-dropped
    copy, and the cache it writes back (the prefix layer unstacked)."""
    cfg, jr, tr = runners
    toks = np.random.RandomState(1).randint(0, cfg.vocab_size, 40)
    jkv, tkv = jr.prefill_entry(toks), tr.prefill_entry(toks)
    assert sorted(tkv) == sorted(jkv) == ["ckv", "krope", "positions"]
    for name, width in (("ckv", cfg.mla.kv_lora_rank),
                        ("krope", cfg.mla.qk_rope_head_dim)):
        assert tkv[name].shape == jkv[name].shape == (cfg.n_layers, 40,
                                                      width)
        assert tkv[name].dtype == np.float32
        np.testing.assert_allclose(tkv[name], jkv[name], **TOL)
    q = np.array([5, 6, 7])
    jans, _ = jr.generate_uncompressed(toks, q, 8)
    assert tr.generate_uncompressed(toks, q, 8)[0] == jans and len(jans) == 8
    kept = {k: v[:, 10:] for k, v in jkv.items() if k != "positions"}
    kept["positions"] = np.arange(10, 40, dtype=np.int32)
    assert (tr.generate_from_kvdata(kept, 40, q, 6)
            == jr.generate_from_kvdata(kept, 40, q, 6))
    cache, n = kvdata_to_cache(jkv, tr.model.cfg, tr.model, 64, "cpu")
    assert n == 40
    np.testing.assert_array_equal(
        cache["prefix"][0]["self"]["ckv"][0, :40].numpy(), jkv["ckv"][0])
    np.testing.assert_array_equal(
        cache["stack"][0]["self"]["krope"][:, 0, :40].numpy(),
        jkv["krope"][1:])


def test_engine_summary_equal_deepseek(runners, tmp_path):
    """``summaries_equal`` with the fixed KIVI policy at rate 0.16: the
    latent's arrays quantize per row only."""
    cfg, jr, tr = runners
    summaries_equal(jr, tr, ARCH, FULL_PARAMS[ARCH][1], ("kivi", 0.16), {},
                    tmp_path)
