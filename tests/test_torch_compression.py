"""Port parity: the compression methods of ``repro_torch`` against the JAX
package, on KVData whose grouped axes need padding."""
import numpy as np
import pytest
import torch

from repro.core.compression import default_registry as jregistry
from repro.core.compression.kivi import KIVICompression as JKIVI
from repro_torch.core.compression import default_registry as tregistry
from repro_torch.core.compression.kivi import KIVICompression as TKIVI
from repro_torch.device import cap_test_threads

cap_test_threads()


def _kv(seed: int, layers: int = 2, tokens: int = 37, feat: int = 38):
    """K of (L*T) = 74 rows pads to 128 for the 64-row K group; V's F = 38
    pads to 72 at 2 bits (group 36)."""
    rng = np.random.RandomState(seed)
    return {"k": (rng.randn(layers, tokens, feat) * 3).astype(np.float32),
            "v": rng.randn(layers, tokens, feat).astype(np.float32),
            "positions": np.arange(tokens, dtype=np.int32)}


def _same_entry(a, b):
    assert a.method == b.method and a.rate == b.rate and a.meta == b.meta
    assert sorted(a.arrays) == sorted(b.arrays)
    for k in a.arrays:
        assert a.arrays[k].dtype == b.arrays[k].dtype, k
        np.testing.assert_array_equal(a.arrays[k], b.arrays[k], err_msg=k)


def _same_kv(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("bits", [8, 4, 2])
def test_kivi_compress_decompress_bit_equal(bits):
    kv = _kv(bits)
    jm, tm = JKIVI(), TKIVI(device="cpu")
    je = jm.compress(kv, 0.0, bits=bits)
    te = tm.compress(kv, 0.0, bits=bits)
    _same_entry(je, te)
    assert te.arrays["k.packed"].shape[0] * (8 // bits) == 128   # padded
    _same_kv(jm.decompress(je), tm.decompress(te))
    assert (tm.estimate_quantized_nbytes(kv, bits)
            == jm.estimate_quantized_nbytes(kv, bits) == te.nbytes)


def test_kivi_rate_ladder_matches():
    kv = _kv(7)
    jm, tm = JKIVI(), TKIVI(device="cpu")
    assert tm.rates() == jm.rates() and tm.rates(kv) == jm.rates(kv)
    for rate in (0.3, 0.16, 0.1, 0.02):
        assert tm.estimate_nbytes(kv, rate) == jm.estimate_nbytes(kv, rate)
        _same_entry(jm.compress(kv, rate), tm.compress(kv, rate))


@pytest.mark.parametrize("name,rate", [("none", 1.0), ("streaming_llm", 0.5),
                                       ("streaming_llm", 0.25),
                                       ("drop_kivi", 0.1),
                                       ("drop_kivi", 0.03)])
def test_registry_methods_match(name, rate):
    kv = _kv(11, tokens=64, feat=32)
    jm, tm = jregistry()[name], tregistry(device="cpu")[name]
    assert tm.rates(kv) == jm.rates(kv)
    assert tm.estimate_nbytes(kv, rate) == jm.estimate_nbytes(kv, rate)
    je, te = jm.compress(kv, rate), tm.compress(kv, rate)
    _same_entry(je, te)
    _same_kv(jm.decompress(je), tm.decompress(te))


def test_kivi_defaults_to_cuda():
    """The KIVI arms run where the model runs, CUDA unless asked; asking
    for CUDA without a card raises instead of running on the CPU."""
    if torch.cuda.is_available():
        assert TKIVI().device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        TKIVI()
    with pytest.raises(RuntimeError, match="CUDA"):
        tregistry()
