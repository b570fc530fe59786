"""Port parity: decode attention over KIVI-packed KV, ``repro_torch`` against
the JAX package.

The port's ``ops.decode_attention_planes`` takes the plain version on CPU
tensors; it is held against the reference's jitted ``ops`` (its jnp path on
the CPU) over bits, groups and valid lengths, and against the Pallas kernel
in interpret mode on one case, at rtol 1e-4 / atol 2e-4 (the reference's
own kernel tolerance: the frameworks sum the products in another order).
The ``cuda``-marked test holds the CUDA kernel to the plain version on the
card and skips elsewhere.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attn import kernel as jkernel
from repro.kernels.decode_attn import ops as jops
from repro.kernels.decode_attn import ref as jref
from repro.kernels.kivi import ref as jkivi
from repro_torch.device import cap_test_threads
from repro_torch.kernels.decode_attn import kernel as tkernel
from repro_torch.kernels.decode_attn import ops as tops
from repro_torch.kernels.decode_attn import ref as tref
from repro_torch.kernels.kivi import ref as tkivi
from test_torch_kernels_cuda import NAMES, TOL, lengths, packed_planes

cap_test_threads()


def run_both(q, packs, cur, bits, kg, vg):
    got = tops.decode_attention_planes(
        torch.from_numpy(q), *(packs[n] for n in NAMES),
        torch.from_numpy(cur), bits=bits, k_group=kg, v_group=vg)
    want = jops.decode_attention_planes(
        jnp.asarray(q), *(jnp.asarray(packs[n].numpy()) for n in NAMES),
        jnp.asarray(cur), bits=bits, k_group=kg, v_group=vg)
    return got, np.asarray(want)


@pytest.mark.parametrize("bits", [8, 4, 2])
@pytest.mark.parametrize("group", [32, 64])
@pytest.mark.parametrize("cur", ["full", "partial", "zero"])
def test_ops_match_reference(bits, group, cur):
    rng = np.random.RandomState(bits * 100 + group)
    p, t, gq, hd = 3, 192, 4, 64
    q = rng.randn(p, gq, hd).astype(np.float32)
    packs = packed_planes(rng, p, t, hd, bits, group, group)
    n = lengths(cur, p, t)
    got, want = run_both(q, packs, n, bits, group, group)
    assert got.shape == (p, gq, hd) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_zero_length_is_uniform_mean():
    """cur_len = 0 masks every token with the finite -1e30: the result is
    the uniform mean of all T values, not zeros and not NaN."""
    rng = np.random.RandomState(5)
    p, t, hd, bits, g = 2, 128, 64, 4, 32
    q = rng.randn(p, 4, hd).astype(np.float32)
    packs = packed_planes(rng, p, t, hd, bits, g, g)
    got, want = run_both(q, packs, lengths("zero", p, t), bits, g, g)
    v = tref._dequant_cols(packs["v_packed"], packs["v_scale"],
                           packs["v_zero"], bits, g)
    mean = v.mean(dim=1, keepdim=True).expand(p, 4, hd)
    np.testing.assert_allclose(got.numpy(), mean.numpy(), **TOL)
    np.testing.assert_allclose(want, mean.numpy(), **TOL)


def test_quantized_and_dense_refs_match_reference():
    rng = np.random.RandomState(6)
    t, hd, bits = 128, 64, 2
    q = rng.randn(8, hd).astype(np.float32)
    k = rng.randn(t, hd).astype(np.float32)
    v = rng.randn(t, hd).astype(np.float32)
    jk, jv = (jkivi.quantize_ref(jnp.asarray(a), bits, 32, ax)
              for a, ax in ((k, 0), (v, 1)))
    tk, tv = (tkivi.quantize_ref(torch.from_numpy(a), bits, 32, ax)
              for a, ax in ((k, 0), (v, 1)))
    for n in (t, 50, 0):
        np.testing.assert_allclose(
            tref.decode_attention_quantized_ref(torch.from_numpy(q), tk, tv,
                                                n).numpy(),
            np.asarray(jref.decode_attention_quantized_ref(
                jnp.asarray(q), jk, jv, n)), **TOL)
        np.testing.assert_allclose(
            tref.decode_attention_dense_ref(*map(torch.from_numpy,
                                                 (q, k, v)), n).numpy(),
            np.asarray(jref.decode_attention_dense_ref(q, k, v, n)), **TOL)


def test_matches_pallas_kernel_interpret():
    rng = np.random.RandomState(7)
    p, t, gq, hd, bits, g = 2, 256, 8, 128, 4, 64
    q = rng.randn(p, gq, hd).astype(np.float32)
    packs = packed_planes(rng, p, t, hd, bits, g, g)
    cur = np.asarray([[256], [77]], np.int32)
    got = tops.decode_attention_planes(
        torch.from_numpy(q), *(packs[n] for n in NAMES),
        torch.from_numpy(cur), bits=bits, k_group=g, v_group=g)
    want = jkernel.fused_decode_attention(
        jnp.asarray(q), *(jnp.asarray(packs[n].numpy()) for n in NAMES),
        jnp.asarray(cur), bits=bits, k_group=g, v_group=g, tb=128,
        interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_masking_excludes_tail():
    """Entries past cur_len must not affect the output (the reference
    kernel test's corruption of the tail)."""
    rng = np.random.RandomState(8)
    p, t, hd, bits, g = 1, 256, 128, 4, 64
    q = torch.from_numpy(rng.randn(p, 8, hd).astype(np.float32))
    packs = packed_planes(rng, p, t, hd, bits, g, g)
    cur = torch.tensor([[100]], dtype=torch.int32)
    out1 = tops.decode_attention_planes(q, *(packs[n] for n in NAMES), cur,
                                        bits=bits, k_group=g, v_group=g)
    bad = dict(packs)
    bad["v_packed"] = packs["v_packed"].clone()
    bad["v_packed"][:, 200:] = 255
    bad["k_packed"] = packs["k_packed"].clone()
    bad["k_packed"][:, 200 // 2:] = 255
    out2 = tops.decode_attention_planes(q, *(bad[n] for n in NAMES), cur,
                                        bits=bits, k_group=g, v_group=g)
    torch.testing.assert_close(out1, out2, rtol=0, atol=0)


def test_ops_refuse_what_they_cannot_take():
    rng = np.random.RandomState(9)
    packs = packed_planes(rng, 1, 64, 32, 4, 32, 32)
    q = torch.zeros(1, 4, 32)
    cur = torch.tensor([[64]], dtype=torch.int32)
    with pytest.raises(ValueError):                 # 48 is no group of 64
        tops.decode_attention_planes(q, *(packs[n] for n in NAMES), cur,
                                     bits=4, k_group=48, v_group=32)
    with pytest.raises(ValueError):                 # not CPU, not CUDA
        tops.decode_attention_planes(q.to("meta"),
                                     *(packs[n] for n in NAMES), cur,
                                     bits=4, k_group=32, v_group=32)
    with pytest.raises(ValueError, match="CUDA"):   # the kernel: CUDA only
        tkernel.decode_attention(q, *(packs[n] for n in NAMES), cur,
                                 bits=4, k_group=32, v_group=32)



def ring_emulation(q, packs, cur, bits, kg, vg):
    """decode_ring's order of work in plain torch (f32): the tokens of a
    plane cut into splits of ``ring_split_len`` tokens, as the kernel cuts
    them; a split's 64-token tiles taken 8 tokens a warp, each of the eight
    warps keeping its own online softmax (m, l, acc) over its tokens of
    every tile; the warps' states merged into the split's, then the splits'
    into the output, each weighted by exp(m - M). A token past the split
    scores -inf, one at or past cur_len -1e30."""
    p, gq, hd = q.shape
    t = packs["v_packed"].shape[1]
    k = tref._dequant_rows(packs["k_packed"], packs["k_scale"],
                           packs["k_zero"], bits, kg, t)
    v = tref._dequant_cols(packs["v_packed"], packs["v_scale"],
                           packs["v_zero"], bits, vg)
    rb = tkernel.ring_rows(gq)
    sl = tkernel.ring_split_len(t, p * -(-gq // rb))

    def merge(states):
        m = torch.stack([s[0] for s in states])              # (n, Gq)
        big = m.max(dim=0).values
        w = torch.exp(m - big)
        return (big, (torch.stack([s[1] for s in states]) * w).sum(0),
                (torch.stack([s[2] for s in states]) * w[..., None]).sum(0))

    out = torch.empty(p, gq, hd)
    for pi in range(p):
        splits = []
        for s0 in range(0, t, sl):
            s1 = min(t, s0 + sl)
            warps = []
            for w in range(8):
                m = torch.full((gq,), tref.NEG_INF)
                l, acc = torch.zeros(gq), torch.zeros(gq, hd)
                for t0 in range(s0, s1, 64):
                    tok = torch.arange(t0 + 8 * w, t0 + 8 * w + 8)
                    idx = tok.clamp(max=t - 1)
                    s = (q[pi] @ k[pi, idx].T) * hd ** -0.5
                    x = torch.where(tok < int(cur[pi, 0]), s,
                                    torch.tensor(tref.NEG_INF))
                    x = torch.where(tok >= s1, torch.tensor(-float("inf")),
                                    x)
                    m_new = torch.maximum(m, x.max(dim=1).values)
                    pr = torch.exp(x - m_new[:, None])
                    alpha = torch.exp(m - m_new)
                    l = l * alpha + pr.sum(1)
                    acc = acc * alpha[:, None] + pr @ v[pi, idx]
                    m = m_new
                warps.append((m, l, acc))
            splits.append(merge(warps))
        _, l, acc = merge(splits)
        out[pi] = acc / l.clamp(min=1e-30)[:, None]
    return out


@pytest.mark.parametrize("ring_blocks", [tkernel.RING_BLOCKS, 8])
@pytest.mark.parametrize("bits", [8, 4, 2])
def test_ring_merge_rule_matches_pallas_kernel(bits, ring_blocks,
                                               monkeypatch):
    """The CUDA decode_ring's split and merge rule, emulated on the CPU,
    against the JAX package's kernel in interpret mode, at the module's
    RING_BLOCKS (five splits of one tile each here) and at 8 (two splits
    of three tiles and of two). Four planes: cur_len 0 (the uniform mean
    of all T values), at the first split's edge, and inside the last
    split, which ends in 48 of a tile's 64 tokens (T 304)."""
    monkeypatch.setattr(tkernel, "RING_BLOCKS", ring_blocks)
    rng = np.random.RandomState(20 + bits)
    p, t, gq, hd, g = 4, 304, 4, 64, 16
    q = rng.randn(p, gq, hd).astype(np.float32)
    packs = packed_planes(rng, p, t, hd, bits, g, g)
    sl = tkernel.ring_split_len(t, p)
    assert sl == (192 if ring_blocks == 8 else 64)
    cur = np.asarray([[0], [sl], [t - 5], [t - 100]], np.int32)
    got = ring_emulation(torch.from_numpy(q), packs, cur, bits, g, g)
    want = jkernel.fused_decode_attention(
        jnp.asarray(q), *(jnp.asarray(packs[n].numpy()) for n in NAMES),
        jnp.asarray(cur), bits=bits, k_group=g, v_group=g, tb=16,
        interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    mean = tref._dequant_cols(packs["v_packed"], packs["v_scale"],
                              packs["v_zero"], bits, g)[0].mean(0)
    np.testing.assert_allclose(got[0].numpy(),
                               mean.expand(gq, hd).numpy(), **TOL)
