"""Port parity: chunk prefill over a KIVI-packed prefix, ``repro_torch``
against the JAX package.

The port's ``ops.chunk_prefill_planes`` takes the plain version on CPU
tensors; it is held against the reference's jitted ``ops`` (its jnp path on
the CPU) over bits, groups and valid prefix lengths, and against the
Pallas kernel in interpret mode on one case, at rtol 1e-4 / atol 2e-4 (the
reference's own kernel tolerance). The masking tests mirror the
reference's (``tests/test_kernels_fused_prefill.py``). The ``cuda``-marked
test holds the CUDA kernel to the plain version on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fused_prefill import kernel as jkernel
from repro.kernels.fused_prefill import ops as jops
from repro.kernels.fused_prefill import ref as jref
from repro.kernels.kivi import ref as jkivi
from repro_torch.kernels.fused_prefill import kernel as tkernel
from repro_torch.kernels.fused_prefill import ops as tops
from repro_torch.kernels.fused_prefill import ref as tref
from repro_torch.kernels.kivi import ref as tkivi
from test_torch_kernels_cuda import NAMES, TOL, chunk, lengths, packed_planes


def run_port(q, kc, vc, packs, cur, bits, kg, vg):
    return tops.chunk_prefill_planes(
        torch.as_tensor(q), *(packs[n] for n in NAMES),
        torch.as_tensor(kc), torch.as_tensor(vc), torch.as_tensor(cur),
        bits=bits, k_group=kg, v_group=vg)


@pytest.mark.parametrize("bits", [8, 4, 2])
@pytest.mark.parametrize("group", [32, 64])
@pytest.mark.parametrize("cur", ["full", "partial", "zero"])
def test_ops_match_reference(bits, group, cur):
    rng = np.random.RandomState(bits * 100 + group + 1)
    p, t, c, hd = 3, 192, 16, 64
    q, kc, vc = chunk(rng, p, c, hd)
    packs = packed_planes(rng, p, t, hd, bits, group, group)
    n = lengths(cur, p, t)
    got = run_port(q, kc, vc, packs, n, bits, group, group)
    want = jops.chunk_prefill_planes(
        jnp.asarray(q), *(jnp.asarray(packs[k].numpy()) for k in NAMES),
        jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(n), bits=bits,
        k_group=group, v_group=group)
    assert got.shape == (p, c, hd) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_quantized_and_dense_refs_match_reference():
    rng = np.random.RandomState(11)
    t, c, hd, bits = 128, 16, 64, 4
    q, kc, vc = (a[0] for a in chunk(rng, 1, c, hd))
    k = rng.randn(t, hd).astype(np.float32)
    v = rng.randn(t, hd).astype(np.float32)
    jk, jv = (jkivi.quantize_ref(jnp.asarray(a), bits, 32, ax)
              for a, ax in ((k, 0), (v, 1)))
    tk, tv = (tkivi.quantize_ref(torch.from_numpy(a), bits, 32, ax)
              for a, ax in ((k, 0), (v, 1)))
    tq, tkc, tvc = map(torch.from_numpy, (q, kc, vc))
    for n in (t, 40, 0):
        np.testing.assert_allclose(
            tref.chunk_prefill_quantized_ref(tq, tk, tv, tkc, tvc,
                                             n).numpy(),
            np.asarray(jref.chunk_prefill_quantized_ref(
                jnp.asarray(q), jk, jv, jnp.asarray(kc), jnp.asarray(vc),
                n)), **TOL)
        np.testing.assert_allclose(
            tref.chunk_prefill_ref(tq, *map(torch.from_numpy, (k, v)), tkc,
                                   tvc, n).numpy(),
            np.asarray(jref.chunk_prefill_ref(q, k, v, kc, vc, n)), **TOL)


def test_matches_pallas_kernel_interpret():
    rng = np.random.RandomState(12)
    p, t, c, hd, bits, g = 2, 256, 32, 128, 4, 64
    q, kc, vc = chunk(rng, p, c, hd)
    packs = packed_planes(rng, p, t, hd, bits, g, g)
    cur = np.asarray([[256], [0]], np.int32)
    got = run_port(q, kc, vc, packs, cur, bits, g, g)
    want = jkernel.fused_chunk_prefill(
        jnp.asarray(q), *(jnp.asarray(packs[n].numpy()) for n in NAMES),
        jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(cur), bits=bits,
        k_group=g, v_group=g, tb=128, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_masking_excludes_prefix_tail_and_chunk_future():
    """Prefix entries past cur_len and chunk entries after the query
    position must not affect the output."""
    rng = np.random.RandomState(13)
    p, t, c, hd, bits, g = 1, 256, 32, 128, 4, 64
    q, kc, vc = chunk(rng, p, c, hd)
    packs = packed_planes(rng, p, t, hd, bits, g, g)
    cur = np.asarray([[100]], np.int32)
    out1 = run_port(q, kc, vc, packs, cur, bits, g, g)
    bad = dict(packs, v_packed=packs["v_packed"].clone())
    bad["v_packed"][:, 200:] = 255
    out2 = run_port(q, kc, vc, bad, cur, bits, g, g)
    np.testing.assert_allclose(out1.numpy(), out2.numpy())
    kc3, vc3 = kc.copy(), vc.copy()
    kc3[:, -1] = 7.0
    vc3[:, -1] = 7.0
    out3 = run_port(q, kc3, vc3, packs, cur, bits, g, g)
    np.testing.assert_allclose(out1[:, :-1].numpy(), out3[:, :-1].numpy())
    assert not np.allclose(out1[:, -1].numpy(), out3[:, -1].numpy())


def test_ops_refuse_what_they_cannot_take():
    rng = np.random.RandomState(14)
    packs = packed_planes(rng, 1, 64, 32, 4, 32, 32)
    q = torch.zeros(1, 8, 32)
    cur = torch.tensor([[64]], dtype=torch.int32)
    with pytest.raises(ValueError):                 # V group 24 splits no hd
        tops.chunk_prefill_planes(q, *(packs[n] for n in NAMES), q, q, cur,
                                  bits=4, k_group=32, v_group=24)
    with pytest.raises(ValueError):
        tops.chunk_prefill_planes(q.to("meta"), *(packs[n] for n in NAMES),
                                  q, q, cur, bits=4, k_group=32, v_group=32)
    with pytest.raises(ValueError, match="CUDA"):
        tkernel.chunk_prefill(q, *(packs[n] for n in NAMES), q, q, cur,
                              bits=4, k_group=32, v_group=32)

