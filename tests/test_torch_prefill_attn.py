"""Port parity: causal prefill attention in the GQA layout, ``repro_torch``
against the JAX package.

The port's ``ops.causal_attention`` takes the plain version on CPU
tensors; it is held against the reference's jitted ``ops`` (its jnp path on
the CPU) for f32 and bf16 inputs (computed in f32 in both), and against
the Pallas kernel in interpret mode on one case, at rtol 1e-4 / atol 2e-4.
The ``cuda``-marked test holds the CUDA kernel to the plain version on the
card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.prefill_attn import kernel as jkernel
from repro.kernels.prefill_attn import ops as jops
from repro.kernels.prefill_attn import ref as jref
from repro_torch.kernels.prefill_attn import kernel as tkernel
from repro_torch.kernels.prefill_attn import ops as tops
from repro_torch.kernels.prefill_attn import ref as tref
from test_torch_kernels_cuda import TOL, qkv


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

