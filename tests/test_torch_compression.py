"""Port parity: the compression methods of ``repro_torch`` against the JAX
package, on KVData whose grouped axes need padding."""
import tracemalloc

import numpy as np
import pytest
import torch

from repro.core.compression import default_registry as jregistry
from repro.core.compression.kivi import KIVICompression as JKIVI
from repro_torch.core.compression import default_registry as tregistry
from repro_torch.core.compression.kivi import KIVICompression as TKIVI
from repro_torch.core.executor import shape_proxy
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


def _layout(layout: str):
    """Entries the ``drop_kivi`` arm accepts: GQA k/v with and without
    ``positions``, an MLA latent, a ``t`` under ``n_sink + 1`` and an odd
    ``t``; ``-proxy`` is the executor's shape proxy of the same entry."""
    name, _, proxy = layout.partition("-")
    rng = np.random.RandomState(5)
    if name == "gqa":
        kv = _kv(11, tokens=64, feat=32)
    elif name == "gqa_nopos":
        kv = _kv(12, tokens=48, feat=24)
        del kv["positions"]
    elif name == "mla":
        kv = {"ckv": rng.randn(3, 40, 32).astype(np.float32),
              "krope": rng.randn(3, 40, 8).astype(np.float32)}
    elif name == "short":
        kv = _kv(13, tokens=3, feat=16)
    else:                                                   # odd
        kv = _kv(14, layers=3, tokens=37, feat=38)
    return shape_proxy(kv) if proxy else kv


_LAYOUTS = ("gqa", "gqa_nopos", "mla", "short", "odd")
_REGISTRY_CASES = (
    [pytest.param(n, r, "gqa", id=f"{n}-{r}")
     for n, r in [("none", 1.0), ("streaming_llm", 0.5),
                  ("streaming_llm", 0.25), ("drop_kivi", 0.1),
                  ("drop_kivi", 0.03)]]
    + [pytest.param("drop_kivi", r, f"{lay}{px}", id=f"drop_kivi-{r}-{lay}{px}")
       for lay in _LAYOUTS for px in ("", "-proxy") for r in (0.1, 0.03)
       if (lay, px) != ("gqa", "")])


@pytest.mark.parametrize("name,rate,layout", _REGISTRY_CASES)
def test_registry_methods_match(name, rate, layout):
    kv = _layout(layout)
    jm, tm = jregistry()[name], tregistry(device="cpu")[name]
    assert tm.rates(kv) == jm.rates(kv)
    assert tm.estimate_nbytes(kv, rate) == jm.estimate_nbytes(kv, rate)
    if name == "drop_kivi":
        for r in jm.rates(kv):
            assert tm.estimate_nbytes(kv, r) == jm.estimate_nbytes(kv, r)
    je, te = jm.compress(kv, rate), tm.compress(kv, rate)
    _same_entry(je, te)
    _same_kv(jm.decompress(je), tm.decompress(te))


def test_drop_kivi_estimates_copy_no_rows():
    """``rates`` and ``estimate_nbytes`` of ``drop_kivi`` read shapes only:
    on a 64 MiB shape proxy they allocate well under one kept copy, and
    give what compressing the dropped entry would."""
    kv = shape_proxy({"k": np.zeros((16, 256, 2048), np.float32),
                      "v": np.zeros((16, 256, 2048), np.float32),
                      "positions": np.zeros(256, np.int32)})
    m = tregistry(device="cpu")["drop_kivi"]
    want = [m.kivi.estimate_quantized_nbytes(
        m.stream.compress(kv, keep).arrays, bits) for keep, bits in m.grid]
    orig = sum(a.nbytes for a in kv.values())
    tracemalloc.start()
    try:
        ladder = m.rates(kv)
        got = [m.estimate_nbytes(kv, r) for r in ladder]
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    assert peak < 1 << 20, peak
    assert ladder == tuple(n / orig for n in want)
    assert got == want


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
