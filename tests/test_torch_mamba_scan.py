"""Port parity: the selective scan (mamba-1), ``repro_torch`` against the
JAX package.

The port's ``ops.selective_scan`` takes the plain version on CPU tensors.
It is held against the reference's sequential ``selective_scan_ref`` at
rtol = atol = 1e-5 (the same loop in f32; only the frameworks' rounding of
the sum over states differs), and against the Pallas kernel in interpret
mode, whose in-chunk associative scan reassociates the products, at the
reference's own kernel tolerance, rtol = atol = 1e-4. The ``cuda``-marked
test in ``test_torch_kernels_cuda.py`` holds the CUDA kernel to the plain
version on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mamba_scan import kernel as jkernel
from repro.kernels.mamba_scan import ref as jref
from repro_torch.kernels.mamba_scan import kernel as tkernel
from repro_torch.kernels.mamba_scan import ops as tops
from test_torch_kernels_cuda import SCAN_TOL, scan_inputs

REF_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape,h0_scale", [
    ((2, 33, 128, 8), 0.1), ((1, 64, 96, 16), 0.0), ((3, 5, 40, 4), 1.0),
    ((1, 1, 16, 16), 0.1)], ids=["ragged", "h0_zero", "batch3", "one_step"])
def test_plain_scan_matches_reference(shape, h0_scale):
    args = scan_inputs(sum(shape), *shape, h0_scale=h0_scale)
    y, h_t = tops.selective_scan(*map(torch.from_numpy, args))
    jy, jh = jref.selective_scan_ref(*map(jnp.asarray, args))
    b, s, d, n = shape
    assert y.shape == (b, s, d) and h_t.shape == (b, d, n)
    assert y.dtype == h_t.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **REF_TOL)
    np.testing.assert_allclose(h_t.numpy(), np.asarray(jh), **REF_TOL)


def test_plain_scan_matches_pallas_kernel_interpret():
    args = scan_inputs(3, 2, 64, 128, 16)
    y, h_t = tops.selective_scan(*map(torch.from_numpy, args))
    jy, jh = jkernel.selective_scan(*map(jnp.asarray, args), tc=16,
                                    dtile=128, interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **SCAN_TOL)
    np.testing.assert_allclose(h_t.numpy(), np.asarray(jh), **SCAN_TOL)


def test_scan_splits_at_any_step():
    """The state carries: scanning [0, k) and then [k, S) from its final
    state gives the whole scan's outputs (what a prefill on a cached
    state relies on)."""
    dt, x, bs, cs, a, h0 = map(torch.from_numpy, scan_inputs(4, 2, 50, 24, 8))
    y, h_t = tops.selective_scan(dt, x, bs, cs, a, h0)
    k = 17
    y1, h1 = tops.selective_scan(dt[:, :k], x[:, :k], bs[:, :k], cs[:, :k],
                                 a, h0)
    y2, h2 = tops.selective_scan(dt[:, k:], x[:, k:], bs[:, k:], cs[:, k:],
                                 a, h1)
    torch.testing.assert_close(torch.cat([y1, y2], dim=1), y, rtol=0, atol=0)
    torch.testing.assert_close(h2, h_t, rtol=0, atol=0)


def test_scan_refuses_what_it_cannot_take():
    launched = tkernel.LAUNCHES["selective_scan"]
    args = [torch.from_numpy(a) for a in scan_inputs(5, 1, 8, 16, 8)]
    with pytest.raises(ValueError):                   # neither CPU nor CUDA
        tops.selective_scan(*(a.to("meta") for a in args))
    with pytest.raises(ValueError, match="CUDA"):
        tkernel.selective_scan(*args)
    args = [torch.from_numpy(a) for a in scan_inputs(5, 1, 8, 16, 6)]
    with pytest.raises(ValueError, match="divide 32"):
        tkernel.selective_scan(*args)
    assert tkernel.LAUNCHES["selective_scan"] == launched
