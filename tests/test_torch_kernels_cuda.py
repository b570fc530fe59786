"""The port's attention and selective-scan kernels against their plain
versions on the card.

Every test here is marked ``cuda`` and skips where there is no CUDA card.
This file imports no JAX, so on a machine with a card and without JAX it
runs on its own:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

It also holds the input makers that the CPU parity tests
(``test_torch_{decode_attn,fused_prefill,prefill_attn,mamba_scan}.py``)
share. The attention tolerance, rtol 1e-4 / atol 2e-4, is the reference's
own kernel tolerance (``tests/test_kernels_fused_prefill.py``), and so is
the scan's, rtol = atol = 1e-4 (``tests/test_kernels_mamba_scan.py``): the
kernels sum in another order than the plain versions, in f32 throughout.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.decode_attn import ops as decode_ops
from repro_torch.kernels.fused_prefill import ops as fused_ops
from repro_torch.kernels.kivi import ref as tkivi
from repro_torch.kernels.mamba_scan import ops as scan_ops
from repro_torch.kernels.prefill_attn import kernel as prefill_kernel
from repro_torch.kernels.prefill_attn import ops as prefill_ops

TOL = dict(rtol=1e-4, atol=2e-4)
SCAN_TOL = dict(rtol=1e-4, atol=1e-4)
NAMES = ("k_packed", "k_scale", "k_zero", "v_packed", "v_scale", "v_zero")


def packed_planes(rng, p, t, hd, bits, kg, vg):
    """KIVI-pack P random (T, hd) K and V planes in the kernel layout, as
    CPU tensors (the port's quantizer; its codes equal the reference's)."""
    k = torch.from_numpy(rng.randn(p * t, hd).astype(np.float32))
    v = torch.from_numpy(rng.randn(p * t, hd).astype(np.float32))
    kq = tkivi.quantize_ref(k, bits, kg, 0)
    vq = tkivi.quantize_ref(v, bits, vg, 1)
    return {"k_packed": kq.packed.reshape(p, t // (8 // bits), hd),
            "k_scale": kq.scale.reshape(p, t // kg, hd),
            "k_zero": kq.zero.reshape(p, t // kg, hd),
            "v_packed": vq.packed.reshape(p, t, -1),
            "v_scale": vq.scale.reshape(p, t, -1),
            "v_zero": vq.zero.reshape(p, t, -1)}


def lengths(kind: str, p: int, t: int) -> np.ndarray:
    n = {"full": [t] * p, "partial": [t // 2 + 7, 1, t - 3][:p] + [5] * p,
         "zero": [0] * p}[kind][:p]
    return np.asarray(n, np.int32).reshape(p, 1)


def qkv(seed, b, s, h, kv, hd):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, s, h, hd).astype(np.float32),
            rng.randn(b, s, kv, hd).astype(np.float32),
            rng.randn(b, s, kv, hd).astype(np.float32))


def chunk(rng, p, c, hd):
    return tuple(rng.randn(p, c, hd).astype(np.float32) for _ in range(3))


def scan_inputs(seed, b, s, d, n, h0_scale=0.1):
    """(dt, x, bs, cs, a, h0) f32 numpy, as the reference's kernel test
    makes them: dt = |N(0, 1)| / 10, a = -|N(0, 1)|."""
    rng = np.random.RandomState(seed)
    return (np.abs(rng.randn(b, s, d)).astype(np.float32) * 0.1,
            rng.randn(b, s, d).astype(np.float32),
            rng.randn(b, s, n).astype(np.float32),
            rng.randn(b, s, n).astype(np.float32),
            -np.abs(rng.randn(d, n)).astype(np.float32),
            rng.randn(b, d, n).astype(np.float32) * h0_scale)


@pytest.mark.cuda
def test_decode_attn_matches_plain():
    """On the card: the CUDA kernel against the plain version, over bits,
    groups, row counts and valid lengths (``chip_smoke.py`` repeats this
    at full width)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.RandomState(10)
    for bits in (8, 4, 2):
        for g, gq in ((32, 4), (64, 8), (64, 12)):
            p, t, hd = 3, 320, 128
            q = torch.from_numpy(rng.randn(p, gq, hd).astype(np.float32))
            packs = packed_planes(rng, p, t, hd, bits, g, g)
            for kind in ("full", "partial", "zero"):
                cur = torch.from_numpy(lengths(kind, p, t))
                want = decode_ops.decode_attention_planes(
                    q, *(packs[n] for n in NAMES), cur, bits=bits,
                    k_group=g, v_group=g)
                got = decode_ops.decode_attention_planes(
                    q.cuda(), *(packs[n].cuda() for n in NAMES), cur.cuda(),
                    bits=bits, k_group=g, v_group=g)
                torch.testing.assert_close(got.cpu(), want, **TOL)


@pytest.mark.cuda
def test_fused_prefill_matches_plain():
    """On the card: the CUDA kernel against the plain version over bits,
    groups, chunk sizes (ragged tiles included) and valid lengths."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.RandomState(15)
    for bits in (8, 4, 2):
        for g, c in ((32, 16), (64, 32), (64, 45)):
            p, t, hd = 3, 320, 128
            q, kc, vc = (torch.from_numpy(a) for a in chunk(rng, p, c, hd))
            packs = packed_planes(rng, p, t, hd, bits, g, g)
            for kind in ("full", "partial", "zero"):
                cur = torch.from_numpy(lengths(kind, p, t))
                want = fused_ops.chunk_prefill_planes(
                    q, *(packs[n] for n in NAMES), kc, vc, cur, bits=bits,
                    k_group=g, v_group=g)
                got = fused_ops.chunk_prefill_planes(
                    q.cuda(), *(packs[n].cuda() for n in NAMES), kc.cuda(),
                    vc.cuda(), cur.cuda(), bits=bits, k_group=g, v_group=g)
                torch.testing.assert_close(got.cpu(), want, **TOL)


@pytest.mark.cuda
def test_flash_attention_matches_plain():
    """On the card: the CUDA kernels against the plain version, f32 and
    bf16, GQA and ragged lengths: S at each edge of a 64-key tile (1, 63,
    64, 65, 127), batch 2 without GQA, every head dim the tensor-core
    kernel takes (16, 32, 64, 128), q scaled by 8 (a peaked softmax rounds
    P hardest), and bf16 at hd 8, which stays on the CUDA-core kernel.
    bf16 at hd 16-128 must take the tensor-core kernel, f32 never."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    shapes = [(2, 96, 4, 2, 64), (1, 301, 8, 2, 128), (1, 64, 4, 4, 16),
              (1, 200, 4, 1, 32), (2, 130, 4, 4, 64)]
    shapes += [(1, s, 4, 2, 128) for s in (1, 63, 64, 65, 127)]
    cases = [(shape, 1.0) for shape in shapes]
    cases += [((1, 257, 4, 2, 128), 8.0), ((1, 77, 4, 2, 8), 1.0)]
    for shape, q_scale in cases:
        for tdt in (torch.float32, torch.bfloat16):
            q, k, v = qkv(24, *shape)
            q, k, v = (torch.from_numpy(a).to(tdt) for a in (q * q_scale,
                                                             k, v))
            want = prefill_ops.causal_attention(q, k, v)
            before = prefill_kernel.LAUNCHES["flash_attention_mma"]
            got = prefill_ops.causal_attention(q.cuda(), k.cuda(), v.cuda())
            torch.testing.assert_close(got.cpu(), want, **TOL)
            mma = tdt == torch.bfloat16 and shape[-1] % 16 == 0
            assert (prefill_kernel.LAUNCHES["flash_attention_mma"]
                    - before) == int(mma), (shape, tdt)


def falcon_scan_inputs(seed, b, s, d, n, h0_scale=1.0):
    """``scan_inputs`` in falcon-mamba's decay regime: its init's a =
    -(1 ... N) on every channel and step sizes dt uniform in [0, 1), so
    that each decay factor exp(dt a) spans e^-16 to 1."""
    dt, x, bs, cs, _, h0 = scan_inputs(seed, b, s, d, n, h0_scale)
    dt = np.random.RandomState(seed + 1).uniform(0.0, 1.0, dt.shape)
    a = -np.tile(np.arange(1, n + 1), (d, 1))
    return (dt.astype(np.float32), x, bs, cs, a.astype(np.float32), h0)


@pytest.mark.cuda
def test_selective_scan_matches_plain():
    """On the card: the CUDA scan against the plain version over every
    state size it takes, lengths that no chunk divides (1 and 577),
    ragged channel counts, batches with a non-zero h0, and falcon-mamba's
    decay regime, which exercises the SFU exponential over its whole
    range (``chip_smoke.py`` repeats this at full width)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cases = [(scan_inputs, shape, 0.1) for shape in (
        (1, 1, 64, 16), (2, 77, 200, 16), (3, 130, 128, 8), (1, 33, 50, 32),
        (2, 19, 130, 4), (1, 40, 129, 2), (2, 9, 260, 1), (3, 1, 96, 8),
        (1, 577, 192, 16), (1, 577, 64, 32))]
    cases += [(scan_inputs, (2, 577, 300, 16), 1.0),
              (falcon_scan_inputs, (1, 577, 256, 16), 1.0),
              (falcon_scan_inputs, (2, 130, 96, 16), 0.0)]
    for make, shape, h0_scale in cases:
        args = [torch.from_numpy(a) for a in make(30, *shape, h0_scale)]
        y_want, h_want = scan_ops.selective_scan(*args)
        y_got, h_got = scan_ops.selective_scan(*(a.cuda() for a in args))
        what = f"{make.__name__}{shape} h0 scale {h0_scale}"
        torch.testing.assert_close(y_got.cpu(), y_want, **SCAN_TOL,
                                   msg=lambda m: f"{what} y: {m}")
        torch.testing.assert_close(h_got.cpu(), h_want, **SCAN_TOL,
                                   msg=lambda m: f"{what} hT: {m}")
