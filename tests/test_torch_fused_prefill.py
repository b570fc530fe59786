"""Port parity: chunk prefill over a KIVI-packed prefix, ``repro_torch``
against the JAX package.

The port's ``ops.chunk_prefill_planes`` takes the plain version on CPU
tensors; it is held against the reference's jitted ``ops`` (its jnp path on
the CPU) over bits, groups and valid prefix lengths, and against the
Pallas kernel in interpret mode on one case, at rtol 1e-4 / atol 2e-4 (the
reference's own kernel tolerance). The masking tests mirror the
reference's (``tests/test_kernels_fused_prefill.py``). The ``cuda``-marked
test holds the CUDA kernel to the plain version on the card.
``mma_rounding`` emulates the tensor-core kernel's arithmetic on the CPU,
to show that its two-part bf16 operands hold the tolerance.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fused_prefill import kernel as jkernel
from repro.kernels.fused_prefill import ops as jops
from repro.kernels.fused_prefill import ref as jref
from repro.kernels.kivi import ref as jkivi
from repro_torch.device import cap_test_threads
from repro_torch.kernels.fused_prefill import kernel as tkernel
from repro_torch.kernels.fused_prefill import ops as tops
from repro_torch.kernels.fused_prefill import ref as tref
from repro_torch.kernels.kivi import ref as tkivi
from test_torch_kernels_cuda import NAMES, TOL, chunk, lengths, packed_planes

cap_test_threads()


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



def mma_rounding(q, k, v, kc, vc, cur_len: int, parts: int = 2,
                 tile: int = 64):
    """The arithmetic of the tensor-core kernel (``fused_mma``) in torch,
    one plane: the prefix K and V dequantized in f32 (T, hd), then each
    value, q (scaled to base-2 scores) and P rounded to bf16 as two parts
    (hi = bf16(x), lo = bf16(x - hi)) or one, each product the sum hi hi +
    lo hi + hi lo in f32, over 64-token tiles with an online softmax in
    f32 on base-2 scores, prefix columns at or past ``cur_len`` scoring
    -1e30; the chunk's own keys in f32, causal, as one more tile. (C, hd)
    f32 out."""
    c, hd = q.shape

    def split(x):
        hi = x.to(torch.bfloat16).float()
        lo = (x - hi).to(torch.bfloat16).float()
        return hi, lo if parts == 2 else torch.zeros_like(x)

    def mul(a, b):
        (ah, al), (bh, bl) = split(a), split(b)
        return ah @ bh + al @ bh + ah @ bl

    qs = q * (hd ** -0.5 * math.log2(math.e))
    m = torch.full((c, 1), -1e30)
    l = torch.zeros((c, 1))
    acc = torch.zeros((c, hd))
    rows = torch.arange(c).reshape(c, 1)
    tiles = [(k[t0:t0 + tile], v[t0:t0 + tile],
              torch.arange(t0, t0 + tile).reshape(1, -1) < cur_len, True)
             for t0 in range(0, k.shape[0], tile)]
    tiles.append((kc, vc, torch.arange(c).reshape(1, -1) <= rows, False))
    for kt, vt, visible, packed in tiles:
        sc = mul(qs, kt.T) if packed else qs @ kt.T
        sc = torch.where(visible, sc, torch.full_like(sc, -1e30))
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        p = torch.exp2(sc - m_new)
        alpha = torch.exp2(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + (mul(p, vt) if packed else p @ vt)
        m = m_new
    return acc / l.clamp_min(1e-30)


@pytest.mark.parametrize("bits", [8, 4, 2])
@pytest.mark.parametrize("q_scale", [1.0, 8.0])
def test_two_part_operands_hold_the_tolerance(bits, q_scale):
    """The tensor-core kernel's rounding (dequantize, then two bf16 parts
    of every operand, three products), emulated, against the JAX
    package's ``chunk_prefill_ref`` on the same dequantized KIVI prefix
    (the port's codes, which equal the reference's jitted ones): it holds rtol
    1e-4 / atol 2e-4, q scaled by 8 (a peaked softmax) included. With one
    bf16 part it does not, which is why the kernel pays for the other
    two products."""
    rng = np.random.RandomState(40 + bits)
    p, t, c, hd, g = 2, 512, 32, 128, 64
    q, kc, vc = chunk(rng, p, c, hd)
    q = q * q_scale
    for i, n in enumerate((t, 300)):
        k, v = (rng.randn(t, hd).astype(np.float32) for _ in range(2))
        kd, vd = (tkivi.dequantize_ref(tkivi.quantize_ref(
            torch.from_numpy(a), bits, g, axis)) for a, axis in ((k, 0),
                                                                  (v, 1)))
        want = np.asarray(jref.chunk_prefill_ref(
            q[i], kd.numpy(), vd.numpy(), kc[i], vc[i], n))
        args = [torch.from_numpy(a[i]) for a in (q, kc, vc)]
        got = mma_rounding(args[0], kd, vd, *args[1:], n)
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        one = mma_rounding(args[0], kd, vd, *args[1:], n, parts=1)
        assert not np.allclose(one.numpy(), want, **TOL)
