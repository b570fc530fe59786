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

The plain backward (``ref.selective_scan_bwd_ref``, a reverse-time
recurrence) is held against ``jax.vjp`` of the reference's scan and against
torch autograd through the plain forward: each gradient within 1e-5 of its
largest magnitude (``BWD_TOL``; the same f32 arithmetic, summed in another
order over up to S·D terms).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mamba_scan import kernel as jkernel
from repro.kernels.mamba_scan import ref as jref
from repro_torch.device import cap_test_threads
from repro_torch.kernels.mamba_scan import kernel as tkernel
from repro_torch.kernels.mamba_scan import ops as tops
from repro_torch.kernels.mamba_scan import ref as tref
from test_torch_kernels_cuda import SCAN_TOL, scan_inputs

cap_test_threads()

REF_TOL = dict(rtol=1e-5, atol=1e-5)
BWD_TOL = 1e-5
GRADS = ("ddt", "dx", "dbs", "dcs", "da", "dh0")


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


# (B, S, D, N), h0's scale, whether hT has a gradient
BWD_CASES = {"ragged": ((2, 33, 24, 8), 1.0, True),
             "batch2_no_dhT": ((2, 40, 16, 16), 0.5, False),
             "one_step": ((1, 1, 8, 4), 0.1, True),
             "batch3_h0_zero": ((3, 17, 10, 2), 0.0, True)}


def _bwd_inputs(case: str):
    shape, h0_scale, with_dht = BWD_CASES[case]
    b, s, d, n = shape
    args = scan_inputs(sum(shape), *shape, h0_scale=h0_scale)
    rng = np.random.RandomState(sum(shape) + 1)
    dy = rng.randn(b, s, d).astype(np.float32)
    dht = rng.randn(b, d, n).astype(np.float32) if with_dht else None
    return args, dy, dht


def _assert_grads_close(got, want, case):
    for name, g, w in zip(GRADS, got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), w, rtol=BWD_TOL,
                                   atol=BWD_TOL * np.abs(w).max(),
                                   err_msg=f"{case} {name}")


@pytest.mark.parametrize("case", sorted(BWD_CASES))
def test_plain_backward_matches_reference_vjp(case):
    args, dy, dht = _bwd_inputs(case)
    got = tref.selective_scan_bwd_ref(
        *map(torch.from_numpy, args), torch.from_numpy(dy),
        None if dht is None else torch.from_numpy(dht))
    _, vjp = jax.vjp(jref.selective_scan_ref, *map(jnp.asarray, args))
    h_zero = np.zeros(args[5].shape, np.float32)
    want = vjp((jnp.asarray(dy), jnp.asarray(h_zero if dht is None
                                              else dht)))
    _assert_grads_close(got, want, case)


@pytest.mark.parametrize("case", ["ragged", "batch2_no_dhT"])
def test_plain_backward_matches_autograd(case):
    """Autograd through ``ops.selective_scan`` on CPU tensors (the plain
    loop, the port's CPU training path) gives the plain backward's
    gradients."""
    args, dy, dht = _bwd_inputs(case)
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    y, h_t = tops.selective_scan(*leaves)
    loss = (y * torch.from_numpy(dy)).sum()
    if dht is not None:
        loss = loss + (h_t * torch.from_numpy(dht)).sum()
    want = torch.autograd.grad(loss, leaves)
    got = tref.selective_scan_bwd_ref(
        *map(torch.from_numpy, args), torch.from_numpy(dy),
        None if dht is None else torch.from_numpy(dht))
    _assert_grads_close(got, [w.numpy() for w in want], case)


def test_backward_kernel_refuses_what_it_cannot_take():
    launched = dict(tkernel.LAUNCHES)
    args, dy, _ = _bwd_inputs("ragged")
    dt, x, bs, cs, a, _ = map(torch.from_numpy, args)
    ckpt = torch.zeros((2, 2, 24, 8))
    with pytest.raises(ValueError, match="CUDA"):
        tkernel.selective_scan_bwd(dt, x, bs, cs, a, ckpt,
                                   torch.from_numpy(dy))
    with pytest.raises(ValueError, match="divide 32"):
        tkernel.selective_scan_bwd(dt, x, bs[..., :6], cs[..., :6],
                                   a[:, :6], ckpt, torch.from_numpy(dy))
    assert tkernel.LAUNCHES == launched
