"""Port parity: the packed-uint8 quantized decode cache (``kv_bits`` < 16:
``models/attention.py`` ``init_quantized_cache``, ``_quant_token``,
``_dequant_cache``, ``attention_fwd_quantized``) against the JAX package.

Tolerances: the packed codes, scales and zeros of a token, and the
dequantized cache, bit-equal to the reference's eager calls at 8, 4 and 2
bits (its jitted calls multiply by the reciprocal of 2^b - 1 and fuse the
dequantize's multiply-add, so they differ in the last bit: ROADMAP C); the
quantized decode's logits within rtol = atol = 1e-4 of the reference's on
smoke qwen3-1.7b (qk-norm), shared weights, in f32. The reference's own
test (``tests/test_models.py::test_quantized_decode_tracks_exact``) is
held on the port: 8 bits within 0.02 of the exact decode, the error
monotone in bits, the cache uint8 of width hd/2 at 4 bits.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro_torch.configs import get_config as tget
from repro_torch.device import cap_test_threads
from repro_torch.models import attention as tattn
from repro_torch.models import build_model as tbuild
from test_torch_models import _pair

cap_test_threads()

TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "qwen3-1.7b"
BITS = (8, 4, 2)
B, S = 2, 12


def _tokens(rng: np.random.RandomState, scale: float) -> np.ndarray:
    """(64, 1, 8, 128) f32 token rows at ``scale``, one of them constant
    (its scale is 0, so ``safe`` takes 1) and one over [0, 3] with values
    halfway between 2-bit codes (scale 1: 0.5, 1.5 and 2.5 round to even,
    0, 2, 2)."""
    x = (rng.randn(64, 1, 8, 128) * scale).astype(np.float32)
    x[0, 0, 0] = 1.5
    x[1, 0, 0] = np.tile([0.0, 0.5, 1.5, 2.5, 3.0, 1.0, 2.0, 0.0], 16)
    return x


@pytest.mark.parametrize("bits", BITS)
def test_quant_token_and_dequant_bit_equal(bits):
    rng = np.random.RandomState(bits)
    for scale in (1.0, 0.01, 100.0):
        x = _tokens(rng, scale)
        want = [np.asarray(a) for a in jattn._quant_token(jnp.asarray(x),
                                                          bits)]
        got = tattn._quant_token(torch.from_numpy(x), bits)
        assert got[0].dtype == torch.uint8
        assert got[0].shape == (64, 1, 8, 128 * bits // 8)
        for g, w, name in zip(got, want, ("packed", "scale", "zero")):
            np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
        back = np.asarray(jattn._dequant_cache(
            *(jnp.asarray(a) for a in want), bits, jnp.float32))
        got_back = tattn._dequant_cache(*got, bits, torch.float32)
        np.testing.assert_array_equal(got_back.numpy(), back)


@pytest.fixture(scope="module")
def decoded():
    """The reference's and the port's logits after decoding S tokens one by
    one into a quantized cache of each width and into the exact cache; the
    reference's steps jitted once a width."""
    cfg, jm, jp, tm, tp = _pair(ARCH, seed=1)
    toks = np.random.RandomState(2).randint(0, cfg.vocab_size, (B, S))
    jstep, out = jax.jit(jm.decode_step), {}
    for bits in BITS + (16,):
        jc = jm.init_cache(batch=B, capacity=S + 4, kv_bits=bits)
        tc = tm.init_cache(batch=B, capacity=S + 4, device="cpu",
                           kv_bits=bits)
        for t in range(S):
            jl, jc = jstep(jp, jc, jnp.int32(t), jnp.asarray(toks[:, t:t + 1]))
            tl, tc = tm.decode_step(tp, tc, t,
                                    torch.from_numpy(toks[:, t:t + 1]))
        out[bits] = (np.asarray(jl), tl.numpy())
    return out


@pytest.mark.parametrize("bits", BITS)
def test_quantized_decode_logits_match(decoded, bits):
    want, got = decoded[bits]
    np.testing.assert_allclose(got, want, **TOL)


def test_quantized_decode_tracks_exact(decoded):
    """The reference test's assertions, on the port: 8-bit packed KV
    reproduces the exact decode; lower widths degrade monotonically."""
    exact = decoded[16][1]
    errs = [float(np.abs(decoded[b][1] - exact).max()
                  / (np.abs(exact).max() + 1e-9)) for b in BITS]
    assert errs[0] < 0.02
    assert errs[0] <= errs[1] <= errs[2]


def test_init_cache_kv_bits_builds_the_packed_cache():
    """``Model.init_cache(kv_bits=4)`` gives GQA layers the packed cache:
    uint8 codes of width hd/2, f32 scales and zeros of width 1. MLA
    latents and Mamba states stay full precision, and an encoder-decoder's
    cross cache stays beside the packed one, as in the reference."""
    m = tbuild(tget(ARCH, smoke=True))
    hd = m.cfg.resolved_head_dim
    c = m.init_cache(batch=B, capacity=8, device="cpu", kv_bits=4)
    leaf = c["stack"][0]["self"]
    assert sorted(leaf) == ["k_packed", "k_scale", "k_zero", "v_packed",
                            "v_scale", "v_zero"]
    assert leaf["k_packed"].dtype == torch.uint8
    assert leaf["k_packed"].shape[-1] == hd // 2
    assert leaf["k_scale"].dtype == torch.float32
    assert leaf["k_scale"].shape[-1] == 1
    mla = tbuild(tget("deepseek-v2-lite-16b", smoke=True)).init_cache(
        batch=1, capacity=8, device="cpu", kv_bits=4)
    assert sorted(mla["stack"][0]["self"]) == ["ckv", "krope"]
    jamba = tbuild(tget("jamba-1.5-large-398b", smoke=True)).init_cache(
        batch=1, capacity=8, device="cpu", kv_bits=4)
    kinds = [sorted(blk) for blk in jamba["stack"]]
    assert ["mamba"] in kinds and ["self"] in kinds
    enc = tbuild(tget("seamless-m4t-large-v2", smoke=True)).init_cache(
        batch=1, capacity=8, device="cpu", enc_len=5, kv_bits=4)
    blk = enc["stack"][0]
    assert "k_packed" in blk["self"]
    assert blk["cross"]["k"].shape[2] == 5
