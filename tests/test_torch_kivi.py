"""Port parity: the KIVI codec of ``repro_torch`` against the JAX package.

The reference's serving path runs ``repro.kernels.kivi.ops`` under ``jit``
and the TPU kernel runs here in Pallas interpret mode; the port's plain
version (what CPU tensors run, and what the CUDA kernel is held to on the
card) must give the same bits as both: codes, scales, zeros and
dequantized values.
"""
import fractions

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.kivi import kernel as jkernel
from repro.kernels.kivi import ops as jops
from repro_torch.kernels.kivi import kernel as tkernel
from repro_torch.kernels.kivi import ops as tops
from repro_torch.kernels.kivi import ref as tref

GS = 32


def _kv_like(seed: int, bits: int, shape=(128, 256)) -> np.ndarray:
    """Random values at a spread of scales, plus a block of constant
    groups (scale 0) and a block whose codes sit on exact half-steps."""
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape) * rng.uniform(0.05, 8.0, size=(1, shape[1]))
    x[:GS, :GS] = 1.25
    i = np.arange(GS)
    steps = 2 * (2 ** bits - 1) + 1
    x[GS:2 * GS, :GS] = ((i[:, None] + i[None, :]) % steps) * 0.5
    return x.astype(np.float32)


def _eq(got: torch.Tensor, want) -> None:
    want = np.array(want)                  # a writable copy
    assert got.dtype == torch.from_numpy(want).dtype
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bits", [8, 4, 2])
@pytest.mark.parametrize("axis", [0, 1])
def test_quantize_bit_equal_to_reference(bits, axis):
    x = _kv_like(bits * 10 + axis, bits)
    got = tref.quantize_ref(torch.from_numpy(x), bits, GS, axis)
    assert (got.bits, got.group_size, got.axis, got.orig_dim) == (
        bits, GS, axis, x.shape[axis])

    served = jops.quantize(jnp.asarray(x), bits, GS, axis)      # jit, CPU
    xx = x.T if axis == 1 else x                 # ops.py's V-style transpose
    packed, scale, zero = jkernel.quantize_pallas(jnp.asarray(xx), bits, GS,
                                                  interpret=True)
    if axis == 1:
        packed, scale, zero = packed.T, scale.T, zero.T
    for want in ((served.packed, served.scale, served.zero),
                 (packed, scale, zero)):
        _eq(got.packed, want[0])
        _eq(got.scale, want[1])
        _eq(got.zero, want[2])
    assert tref.compressed_nbytes(got) == jops.compressed_nbytes(served)


@pytest.mark.parametrize("bits", [8, 4, 2])
@pytest.mark.parametrize("axis", [0, 1])
def test_dequantize_bit_equal_to_reference(bits, axis):
    x = _kv_like(bits * 10 + axis + 1, bits)
    served = jops.quantize(jnp.asarray(x), bits, GS, axis)
    qt = tref.Quantized(*(torch.from_numpy(np.array(a)) for a in
                          (served.packed, served.scale, served.zero)),
                        bits, GS, axis, x.shape[axis])
    got = tref.dequantize_ref(qt)
    _eq(got, jops.dequantize(served))
    if axis == 0:
        _eq(got, jkernel.dequantize_pallas(served.packed, served.scale,
                                           served.zero, bits, GS,
                                           interpret=True))
    assert tref.dequantize_ref(qt, torch.bfloat16).dtype == torch.bfloat16


def _round_f32_exact(v: fractions.Fraction) -> np.float32:
    """Round an exact rational to the nearest f32, ties to even."""
    f = np.float32(float(v))
    cands = {f, np.nextafter(f, np.float32(np.inf)),
             np.nextafter(f, np.float32(-np.inf))}
    best = min(cands, key=lambda c: (abs(fractions.Fraction(float(c)) - v),
                                     int(np.float32(c).view(np.uint32)) & 1))
    return np.float32(best)


def test_fma_emulation_rounds_once():
    """Where the f64 sum lands exactly on an f32 midpoint, rounding twice
    goes the wrong way; the plain version must round q*s+z once, as the
    reference's fused multiply-add (and the CUDA kernel's) does."""
    s = np.float32(16519105 * 2.0 ** -24)        # 65 * s = 2^6 + 2^-24
    q = np.array([65, 65, 3, 200], np.int32)
    s_ = np.array([s, s, 0.1, 0.37], np.float32)
    z = np.array([2.0 ** 30, -(2.0 ** 30 + 256), -1.7, 12.5], np.float32)
    got = tref._fma_f32(torch.from_numpy(q), torch.from_numpy(s_),
                        torch.from_numpy(z)).numpy()
    want = [_round_f32_exact(fractions.Fraction(int(a)) * fractions.Fraction(
        float(b)) + fractions.Fraction(float(c))) for a, b, c in zip(q, s_, z)]
    np.testing.assert_array_equal(got, np.array(want, np.float32))
    # the two crafted ties: one rounding gives the odd neighbour
    assert got[0] == np.float32(2.0 ** 30 + 128)
    assert got[1] == np.float32(-(2.0 ** 30 + 128))
    naive = (q.astype(np.float64) * s_ + z).astype(np.float32)
    assert naive[0] != got[0] and naive[1] != got[1]


def test_ops_dispatch_by_device():
    """CPU tensors take the plain version; the kernel wrapper takes only
    CUDA tensors and raises on anything else (no fallback)."""
    x = torch.from_numpy(_kv_like(3, 4, (64, 96)))
    k, v = tops.quantize_kv(x, x, 4, group_size=GS)
    assert (k.axis, v.axis, v.group_size) == (0, 1, GS)
    back = tops.dequantize(k)
    assert back.shape == x.shape and back.dtype == torch.float32
    err = (back - x).abs() - k.scale.repeat_interleave(GS, dim=0)
    assert float(err.max()) <= 1e-6           # within one step of the scale
    with pytest.raises(ValueError, match="CUDA"):
        tkernel.quantize(x, 4, GS, 0)
    with pytest.raises(ValueError):
        tops.quantize(x.to("meta"), 4, GS, 0)


@pytest.mark.cuda
def test_kernel_bit_equal_to_plain_on_card():
    """On the card: every bit width and grouping of the CUDA kernel equals
    the plain version (``chip_smoke.py`` repeats this at full width)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for bits in (8, 4, 2):
        for axis in (0, 1):
            x = torch.from_numpy(_kv_like(bits + axis, bits)).cuda()
            got = tops.quantize(x, bits, GS, axis)
            want = tref.quantize_ref(x, bits, GS, axis)
            for f in ("packed", "scale", "zero"):
                assert torch.equal(getattr(got, f), getattr(want, f)), f
            assert torch.equal(tops.dequantize(got), tref.dequantize_ref(want))
