"""Port parity: causal prefill attention in the GQA layout, ``repro_torch``
against the JAX package.

The port's ``ops.causal_attention`` takes the plain version on CPU
tensors; it is held against the reference's jitted ``ops`` (its jnp path on
the CPU) for f32 and bf16 inputs (computed in f32 in both), and against
the Pallas kernel in interpret mode on one case, at rtol 1e-4 / atol 2e-4.
The ``cuda``-marked test holds the CUDA kernel to the plain version on the
card. ``mma_rounding`` emulates the bf16 tensor-core kernel's arithmetic
on the CPU, to show why its P is split in two bf16 parts.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.prefill_attn import kernel as jkernel
from repro.kernels.prefill_attn import ops as jops
from repro.kernels.prefill_attn import ref as jref
from repro_torch.device import cap_test_threads
from repro_torch.kernels.prefill_attn import kernel as tkernel
from repro_torch.kernels.prefill_attn import ops as tops
from repro_torch.kernels.prefill_attn import ref as tref
from test_torch_kernels_cuda import TOL, qkv

cap_test_threads()


DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(2, 96, 4, 2, 64), (1, 70, 6, 1, 32),
                                   (1, 64, 4, 4, 16)])
def test_ops_match_reference(dtype, shape):
    tdt, jdt = DTYPES[dtype]
    q, k, v = qkv(sum(shape), *shape)
    got = tops.causal_attention(*(torch.from_numpy(a).to(tdt)
                                  for a in (q, k, v)))
    want = jops.causal_attention(*(jnp.asarray(a, jdt) for a in (q, k, v)))
    assert got.shape == shape[:3] + shape[4:] and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_plane_ref_matches_reference():
    q, k, v = (a[0].transpose(1, 0, 2) for a in qkv(20, 1, 48, 3, 3, 32))
    np.testing.assert_allclose(
        tref.causal_attention_ref(*map(torch.from_numpy, (q, k, v))).numpy(),
        np.asarray(jax.vmap(jref.causal_attention_ref)(q, k, v)), **TOL)


def test_matches_pallas_kernel_interpret():
    b, s, h, kv, hd = 1, 256, 2, 1, 128
    q, k, v = qkv(21, b, s, h, kv, hd)
    got = tops.causal_attention(*map(torch.from_numpy, (q, k, v)))
    planes = lambda a: jnp.repeat(jnp.asarray(a).transpose(0, 2, 1, 3),
                                  h // a.shape[2], axis=1).reshape(-1, s, hd)
    want = jkernel.flash_attention(planes(q), planes(k), planes(v), qb=128,
                                   kb=128, interpret=True)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(want).reshape(b, h, s, hd).transpose(
            0, 2, 1, 3), **TOL)


def test_causality():
    """A query row sees only keys at or before it: changing the last key
    and value moves only the last row."""
    q, k, v = map(torch.from_numpy, qkv(22, 1, 40, 2, 1, 16))
    out1 = tops.causal_attention(q, k, v)
    k2, v2 = k.clone(), v.clone()
    k2[:, -1], v2[:, -1] = 9.0, 9.0
    out2 = tops.causal_attention(q, k2, v2)
    torch.testing.assert_close(out1[:, :-1], out2[:, :-1], rtol=0, atol=0)
    assert not torch.allclose(out1[:, -1], out2[:, -1])


def test_ops_refuse_what_they_cannot_take():
    q, k, v = map(torch.from_numpy, qkv(23, 1, 32, 3, 2, 16))
    with pytest.raises(ValueError):                 # 3 heads over 2 KV heads
        tops.causal_attention(q, k, v)
    q, k, v = map(torch.from_numpy, qkv(23, 1, 32, 4, 2, 16))
    with pytest.raises(ValueError):
        tops.causal_attention(q.to("meta"), k.to("meta"), v.to("meta"))
    with pytest.raises(ValueError, match="CUDA"):
        tkernel.flash_attention(q, k, v)



def mma_rounding(q, k, v, parts: int = 2, keys: int = 64):
    """The arithmetic of the tensor-core kernel (``flash_fwd_mma``) in
    torch: bf16 q/k/v, key tiles of ``keys`` with an online softmax in f32
    on base-2 scores, and P rounded to bf16 before P V, as one part or as
    two (hi = bf16(p), lo = bf16(p - hi)), each product summed in f32.
    (B, S, H, hd) f32 out."""
    b, s, h, hd = q.shape
    g = h // k.shape[2]
    planes = lambda x: x.float().transpose(1, 2)
    qp = planes(q)
    kp, vp = (planes(x).repeat_interleave(g, dim=1) for x in (k, v))
    m = torch.full((b, h, s, 1), -1e30)
    l = torch.zeros((b, h, s, 1))
    acc = torch.zeros((b, h, s, hd))
    rows = torch.arange(s).reshape(s, 1)
    scale2 = hd ** -0.5 * math.log2(math.e)
    for t0 in range(0, s, keys):
        kt, vt = kp[:, :, t0:t0 + keys], vp[:, :, t0:t0 + keys]
        sc = (qp @ kt.transpose(-1, -2)) * scale2
        cols = torch.arange(t0, t0 + kt.shape[2]).reshape(1, -1)
        sc = torch.where(cols <= rows, sc, torch.full_like(sc, -1e30))
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        p = torch.exp2(sc - m_new)
        alpha = torch.exp2(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        hi = p.to(torch.bfloat16).float()
        pv = hi @ vt
        if parts == 2:
            pv = pv + (p - hi).to(torch.bfloat16).float() @ vt
        acc = acc * alpha + pv
        m = m_new
    return (acc / l.clamp_min(1e-30)).transpose(1, 2)


@pytest.mark.parametrize("shape", [(2, 96, 4, 2, 64), (1, 70, 6, 1, 32),
                                   (1, 64, 4, 4, 16)])
def test_two_part_p_holds_the_tolerance(shape):
    """The tensor-core kernel's rounding, emulated, against the JAX
    package's attention on the same bf16 inputs: with P in two bf16 parts
    it holds rtol 1e-4 / atol 2e-4; with P in one it does not, which is
    why the kernel pays for the second product."""
    q, k, v = (jnp.asarray(a, jnp.bfloat16)
               for a in qkv(sum(shape), *shape))
    want = np.asarray(jops.causal_attention(q, k, v))
    inputs = [torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)
              for x in (q, k, v)]
    np.testing.assert_allclose(mma_rounding(*inputs).numpy(), want, **TOL)
    one = mma_rounding(*inputs, parts=1).numpy()
    assert not np.allclose(one, want, **TOL)
