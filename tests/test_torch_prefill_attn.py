"""Port parity: causal prefill attention in the GQA layout, ``repro_torch``
against the JAX package.

The port's ``ops.causal_attention`` takes the plain version on CPU
tensors; it is held against the reference's jitted ``ops`` (its jnp path on
the CPU) for f32 and bf16 inputs (computed in f32 in both), and against
the Pallas kernel in interpret mode on one case, at rtol 1e-4 / atol 2e-4.
The ``cuda``-marked test holds the CUDA kernel to the plain version on the
card. ``mma_rounding`` emulates the tensor-core kernels' arithmetic on
the CPU, to show why the bf16 kernel splits P in two bf16 parts and the
f32 kernel every operand.
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



def split(x: torch.Tensor, parts: int):
    """x as ``parts`` bf16 parts (hi = bf16(x), then each next part the
    bf16 rounding of what the earlier ones left out), in f32."""
    out = []
    for _ in range(parts):
        out.append(x.to(torch.bfloat16).float())
        x = x - out[-1]
    return out


def mma_rounding(q, k, v, parts: int = 2, keys: int = 64,
                 f32: bool = False, score_parts: int = 3):
    """The arithmetic of the tensor-core kernels in torch: key tiles of
    ``keys`` with an online softmax in f32 on base-2 scores, each rounded
    operand kept as ``parts`` bf16 parts (1 or 2). Without ``f32``,
    ``flash_fwd_mma``'s: bf16 q/k/v, scores scaled after Q K^T, P rounded
    before P V, each part multiplied by V. With ``f32``,
    ``flash_fwd_mma_f32``'s: P V as hi hi + lo hi + hi lo of P's and V's
    parts; the scores from q (scaled first) and K in ``score_parts`` parts
    (the kernel's 3: hi hi + hi mid + mid hi + hi lo + mid mid + lo hi;
    2: hi hi + lo hi + hi lo; 1: hi hi). (B, S, H, hd) f32 out."""
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

    def mul(x, y, n):
        """x @ y from n-part operands, the products whose parts' indices
        add up to less than n (hi is part 0)."""
        xs, ys = split(x, n), split(y, n)
        return sum(xs[i] @ ys[j] for i in range(n) for j in range(n - i))

    for t0 in range(0, s, keys):
        kt, vt = kp[:, :, t0:t0 + keys], vp[:, :, t0:t0 + keys]
        sc = (mul(qp * scale2, kt.transpose(-1, -2), score_parts) if f32
              else (qp @ kt.transpose(-1, -2)) * scale2)
        cols = torch.arange(t0, t0 + kt.shape[2]).reshape(1, -1)
        sc = torch.where(cols <= rows, sc, torch.full_like(sc, -1e30))
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        p = torch.exp2(sc - m_new)
        alpha = torch.exp2(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        if f32:
            pv = mul(p, vt, parts)
        else:
            pv = sum(x @ vt for x in split(p, parts))
        acc = acc * alpha + pv
        m = m_new
    return (acc / l.clamp_min(1e-30)).transpose(1, 2)


SHAPES = [(2, 96, 4, 2, 64), (1, 70, 6, 1, 32), (1, 64, 4, 4, 16)]


@pytest.mark.parametrize("shape", SHAPES)
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


@pytest.mark.parametrize("q_scale", [1.0, 8.0])
@pytest.mark.parametrize("shape", SHAPES)
def test_split_operands_hold_the_tolerance(shape, q_scale):
    """The f32 tensor-core kernel's rounding (32-key tiles; the scores from
    three-part q and K, P V from two-part P and V), emulated, against the
    JAX package's attention on the same f32 inputs, q scaled by 8 (a
    peaked softmax) included: it holds rtol 1e-4 / atol 2e-4; with every
    operand in one bf16 part it does not, which is why the kernel pays for
    the parts' products."""
    q, k, v = qkv(sum(shape), *shape)
    q = q * np.float32(q_scale)
    want = np.asarray(jops.causal_attention(*map(jnp.asarray, (q, k, v))))
    inputs = [torch.from_numpy(x) for x in (q, k, v)]
    got = mma_rounding(*inputs, keys=32, f32=True).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    one = mma_rounding(*inputs, parts=1, keys=32, f32=True,
                       score_parts=1).numpy()
    assert not np.allclose(one, want, **TOL)


def test_three_part_scores_keep_the_tolerance():
    """Why the f32 kernel's scores take three parts: at S 1000, hd 64 and
    q scaled by 8 (a peaked softmax), scores from two-part q and K (three
    products) spend more than three quarters of atol 2e-4 beyond rtol 1e-4
    against the JAX package's attention (on an H100 the kernel in that
    form missed the tolerance at this shape), while three parts (six
    products) spend less than a quarter."""
    q, k, v = qkv(25, 1, 1000, 32, 8, 64)
    q = q * np.float32(8.0)
    want = np.asarray(jops.causal_attention(*map(jnp.asarray, (q, k, v))))
    inputs = [torch.from_numpy(x) for x in (q, k, v)]
    excess = {}
    for parts in (2, 3):
        got = mma_rounding(*inputs, keys=32, f32=True, score_parts=parts)
        excess[parts] = float((np.abs(got.numpy() - want)
                               - TOL["rtol"] * np.abs(want)).max())
    assert excess[2] > 0.75 * TOL["atol"], excess
    assert excess[3] < 0.25 * TOL["atol"], excess
