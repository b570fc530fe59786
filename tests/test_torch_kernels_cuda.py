"""The port's KIVI quantize, attention and selective-scan kernels (the
scan's backward among them) against their plain versions on the card.

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
KIVI quantize and dequantize are held bit for bit. The scan's backward
holds each gradient within ``SCAN_BWD_TOL`` times its largest magnitude
(the forward's tolerance, since it recomputes the forward's states with the
kernel's expf and sums in another order), and two calls bit-equal.
"""
import numpy as np
import pytest
import torch

from repro_torch.device import cap_test_threads
from repro_torch.kernels.decode_attn import kernel as decode_kernel
from repro_torch.kernels.decode_attn import ops as decode_ops
from repro_torch.kernels.fused_prefill import kernel as fused_kernel
from repro_torch.kernels.fused_prefill import ops as fused_ops
from repro_torch.kernels.kivi import kernel as kivi_kernel
from repro_torch.kernels.kivi import ref as tkivi
from repro_torch.kernels.mamba_scan import kernel as scan_kernel
from repro_torch.kernels.mamba_scan import ops as scan_ops
from repro_torch.kernels.mamba_scan import ref as scan_ref
from repro_torch.kernels.prefill_attn import kernel as prefill_kernel
from repro_torch.kernels.prefill_attn import ops as prefill_ops

cap_test_threads()

TOL = dict(rtol=1e-4, atol=2e-4)
SCAN_TOL = dict(rtol=1e-4, atol=1e-4)
SCAN_BWD_TOL = 1e-4
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


def kivi_matrix(rng, rows, cols, bits, group):
    """K/V-like values with the cases that test rounding: a spread of
    column scales, a constant block (groups of scale 0 along either axis)
    and a block of exact half-steps of the top code."""
    x = rng.randn(rows, cols).astype(np.float32)
    x *= rng.rand(1, cols).astype(np.float32) * 8 + 0.05
    r, c = min(group, rows), min(group, cols)
    x[:r, :c] = 1.25
    h = max(0, min(group, rows - group))
    steps = 2 * (2 ** bits - 1) + 1
    i = np.arange(group)
    x[group:group + h, :c] = ((i[:h, None] + i[None, :c]) % steps) * 0.5
    return x


# (bits, axis, group, rows, cols, offset in f32 of x from a 16-byte
# boundary)
KIVI_CASES = [
    case for bits in (8, 4, 2) for case in (
        [(bits, 0, g, 384, 200, 0) for g in (32, 64, 128)]
        + [(bits, 1, g, 77, 384, 0) for g in (32, 64, 128)]
        + [(bits, 0, 64, 192, 203, 0),    # K: a ragged column tile
           (bits, 0, 320, 640, 72, 0),    # K: a group past 256 rows
           (bits, 0, 600, 1200, 40, 0),   # K: staged in three pieces
           (bits, 1, 24, 50, 96, 0),      # V: 6 units on 8 lanes
           (bits, 1, 3 * (8 // bits), 40, 96, 0),  # V: units of 1 or 2
           (bits, 1, 256, 9, 512, 0),     # V: two units a lane
           (bits, 1, 1024, 5, 2048, 0),   # V: units read again
           (bits, 1, 16, 130, 16, 0),     # V: a state row (d_state 16)
           (bits, 0, 64, 128, 256, 1),    # x not 16-byte aligned
           (bits, 1, 64, 33, 128, 1)])]


@pytest.mark.cuda
def test_kivi_quantize_bit_equal():
    """On the card: KIVI quantize equals the plain version bit for bit
    (packed codes, scales and zeros) at 8, 4 and 2 bits, both groupings,
    groups of 32, 64 and 128, ragged row and column counts, a matrix that
    is not 16-byte aligned, and the layouts that take the kernels' other
    branches: K groups staged in pieces, V groups in units of fewer than 4
    values, over fewer lanes than a power of two fills, or of more units
    than a lane holds in registers."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.RandomState(40)
    for bits, axis, g, rows, cols, offset in KIVI_CASES:
        x = kivi_matrix(rng, rows, cols, bits, g)
        want = tkivi.quantize_ref(torch.from_numpy(x), bits, g, axis)
        buf = torch.zeros(rows * cols + offset, device="cuda")
        buf[offset:] = torch.from_numpy(x).reshape(-1).cuda()
        got = kivi_kernel.quantize(buf[offset:].view(rows, cols), bits, g,
                                   axis)
        for name, a, b in zip(("packed", "scale", "zero"), got,
                              (want.packed, want.scale, want.zero)):
            assert torch.equal(a.cpu(), b), (
                f"{name} differs: bits {bits} axis {axis} group {g} "
                f"({rows}, {cols}) offset {offset}")


@pytest.mark.cuda
def test_kivi_dequantize_bit_equal():
    """On the card: KIVI dequantize equals the plain version bit for bit
    over ``KIVI_CASES``: both groupings, 8, 4 and 2 bits, groups of 3
    bytes' codes (a V unit of 4 values across two groups), of 24 and up to
    1024, ragged column counts (K's 203 goes a column at a time), and, where
    a case has an offset, packed bytes, scales and zeros that many bytes
    or floats past an aligned address (the value-at-a-time paths)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.RandomState(41)
    for bits, axis, g, rows, cols, offset in KIVI_CASES:
        x = kivi_matrix(rng, rows, cols, bits, g)
        qt = tkivi.quantize_ref(torch.from_numpy(x), bits, g, axis)
        want = tkivi.dequantize_ref(qt)
        parts = []
        for a in (qt.packed, qt.scale, qt.zero):
            buf = torch.zeros(a.numel() + offset, dtype=a.dtype,
                              device="cuda")
            buf[offset:] = a.reshape(-1).cuda()
            parts.append(buf[offset:].view(a.shape))
        got = kivi_kernel.dequantize(*parts, bits, g, axis, x.shape[axis])
        assert torch.equal(got.cpu(), want), (
            f"bits {bits} axis {axis} group {g} ({rows}, {cols}) offset "
            f"{offset}")


@pytest.mark.cuda
def test_kivi_dequantize_large_shapes():
    """On the card: dequantize past the sizes where its fast indexing
    stops. V-style over 2^32 + 65536 values (the kernel's 64-bit index
    path; 17 GB of output), held bit for bit against the plain version on
    its first and last rows; K-style over 8,388,740 columns, more column
    tiles than a grid's y dimension holds, held bit for bit everywhere."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator(device="cuda").manual_seed(5)

    def planes(p_shape, s_shape):
        packed = torch.randint(0, 256, p_shape, generator=gen,
                               device="cuda", dtype=torch.uint8)
        scale = torch.rand(s_shape, generator=gen, device="cuda")
        zero = torch.randn(s_shape, generator=gen, device="cuda")
        return packed, scale, zero

    rows, cols, bits, g = 65537, 65536, 4, 64
    packed, scale, zero = planes((rows, cols // 2), (rows, cols // g))
    got = kivi_kernel.dequantize(packed, scale, zero, bits, g, 1, cols)
    for sl in (slice(0, 2), slice(rows - 2, rows)):
        want = tkivi.dequantize_ref(tkivi.Quantized(
            packed[sl], scale[sl], zero[sl], bits, g, 1, cols))
        assert torch.equal(got[sl], want), f"V rows {sl}"
    del got, packed, scale, zero
    torch.cuda.empty_cache()

    rows, cols, bits, g = 16, 65535 * 128 + 260, 4, 16
    packed, scale, zero = planes((rows // 2, cols), (rows // g, cols))
    got = kivi_kernel.dequantize(packed, scale, zero, bits, g, 0, rows)
    want = tkivi.dequantize_ref(tkivi.Quantized(packed, scale, zero, bits,
                                                g, 0, rows))
    assert torch.equal(got, want), "K past grid.y"


# (bits, K group, V group, Gq, T, hd, packed planes offset in bytes): every
# bit width at the first shapes; Gq 1, 12, 32 and 40 (row blocks of 8); hd
# 64, 32, 8 and 4 (V rows of 1 and 2 bytes, V groups of 4 and 8 within a
# 4-byte word); T of 4160 (65 tiles) and 304 (a last tile of 48 tokens);
# K groups of 128 and 24 (spanning tiles); T not a multiple of 16 (a K
# group of 12: parts of a stage copied 4 bytes or a byte at a time);
# planes 4 bytes, 2 bytes and 1 byte past an aligned address (the codes 1
# and 2 bytes, scales and zeros aligned); groups of a few tokens or
# channels, whose rings take 2 stages (4 bits, groups of 2) and 1 (8 bits,
# groups of 1, 8 rows). Every layout takes decode_ring, one launch a call.
DECODE_CASES = (
    [(bits, g, g, gq, 320, 128, 0) for bits in (8, 4, 2)
     for g, gq in ((32, 4), (64, 8), (64, 12))]
    + [(4, 64, 64, gq, 320, 128, 0) for gq in (1, 32, 40)]
    + [(4, 64, hd, 4, 320, hd, 0) for hd in (64, 32)]
    + [(bits, 32, 4, 4, 320, 8, 0) for bits in (8, 4, 2)]
    + [(2, 16, 4, 2, 192, 4, 0), (8, 16, 4, 3, 192, 4, 0)]
    + [(4, 64, 64, 4, 4160, 128, 0), (8, 16, 16, 4, 304, 64, 0)]
    + [(4, 128, 32, 4, 384, 128, 0), (2, 24, 64, 5, 576, 128, 0)]
    + [(bits, 12, 64, 4, 324, 128, 0) for bits in (8, 4, 2)]
    + [(4, 64, 64, 4, 320, 128, off) for off in (4, 2, 1)]
    + [(4, 2, 2, 4, 320, 128, 0), (8, 1, 1, 8, 320, 128, 0),
       (8, 3, 2, 5, 201, 128, 1)])


@pytest.mark.cuda
def test_decode_attn_matches_plain():
    """On the card: the CUDA kernel against the plain version over
    ``DECODE_CASES`` and valid lengths T, partial, 0, at the edge of the
    first split and inside it; every call is one launch, and bytes past
    cur_len set to 255 change nothing (``chip_smoke.py`` repeats this at
    full width)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.RandomState(10)
    for bits, kg, vg, gq, t, hd, offset in DECODE_CASES:
        p = 3
        q = torch.from_numpy(rng.randn(p, gq, hd).astype(np.float32))
        packs = packed_planes(rng, p, t, hd, bits, kg, vg)

        def to_card(planes):
            """The planes on the card, ``offset`` bytes past an aligned
            address."""
            out = {}
            for n in NAMES:
                a, skip = planes[n], offset // planes[n].element_size()
                buf = torch.zeros(a.numel() + skip, dtype=a.dtype,
                                  device="cuda")
                buf[skip:] = a.reshape(-1).cuda()
                out[n] = buf[skip:].view(a.shape)
            return out

        on_card = to_card(packs)
        rb = decode_kernel.ring_rows(gq)
        sl = decode_kernel.ring_split_len(t, p * -(-gq // rb))
        edge = np.asarray([[sl], [min(t, 2 * sl)], [sl]], np.int32)
        first = np.asarray([[sl // 2 + 1], [1], [sl - 1]], np.int32)
        kinds = {k: lengths(k, p, t) for k in ("full", "partial", "zero")}
        kinds.update(edge=edge, first=first)
        what = f"bits {bits} groups {kg}/{vg} Gq {gq} T {t} hd {hd} " \
               f"offset {offset}"
        for kind, n in kinds.items():
            cur = torch.from_numpy(n)
            want = decode_ops.decode_attention_planes(
                q, *(packs[n] for n in NAMES), cur, bits=bits, k_group=kg,
                v_group=vg)
            before = decode_kernel.LAUNCHES["decode_attn"]
            got = decode_ops.decode_attention_planes(
                q.cuda(), *(on_card[n] for n in NAMES), cur.cuda(),
                bits=bits, k_group=kg, v_group=vg)
            torch.testing.assert_close(
                got.cpu(), want, **TOL,
                msg=lambda m: f"{what} cur_len {kind}: {m}")
            launches = decode_kernel.LAUNCHES["decode_attn"] - before
            assert launches == 1, what
        cur = torch.from_numpy(kinds["partial"]).cuda()
        spoiled = {n: packs[n].clone() for n in NAMES}
        for i, m in enumerate(kinds["partial"][:, 0].tolist()):
            spoiled["k_packed"][i, -(-m // (8 // bits)):] = 255
            spoiled["v_packed"][i, m:] = 255
        spoiled = to_card(spoiled)
        assert torch.equal(
            decode_ops.decode_attention_planes(
                q.cuda(), *(spoiled[n] for n in NAMES), cur, bits=bits,
                k_group=kg, v_group=vg),
            decode_ops.decode_attention_planes(
                q.cuda(), *(on_card[n] for n in NAMES), cur, bits=bits,
                k_group=kg, v_group=vg)), f"{what}: tail bytes"


@pytest.mark.cuda
def test_decode_attn_streams_and_graphs():
    """On the card: decode_ring's arrival counters under two streams and a
    CUDA graph. Calls of two layouts (16 splits and 5) queued on two
    streams at once, each stream with its own counters, match the plain
    version on every call; the first call on a stream refuses to be
    captured into a graph, and a graph captured after one call on its
    stream replays the eager result."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.RandomState(12)
    calls = []
    for p, gq, t in ((8, 4, 4096), (3, 8, 320)):
        q = torch.from_numpy(rng.randn(p, gq, 128).astype(np.float32))
        packs = packed_planes(rng, p, t, 128, 4, 64, 64)
        cur = torch.from_numpy(lengths("partial", p, t))
        want = decode_ops.decode_attention_planes(
            q, *(packs[n] for n in NAMES), cur, bits=4, k_group=64,
            v_group=64)
        args = (q.cuda(), *(packs[n].cuda() for n in NAMES), cur.cuda())
        calls.append((args, want))
    kw = dict(bits=4, k_group=64, v_group=64)
    streams = [torch.cuda.Stream() for _ in calls]
    outs = [[] for _ in calls]
    torch.cuda.synchronize()
    for _ in range(50):
        for (args, _), st, out in zip(calls, streams, outs):
            with torch.cuda.stream(st):
                out.append(decode_ops.decode_attention_planes(*args, **kw))
    torch.cuda.synchronize()
    for (_, want), out in zip(calls, outs):
        for got in out:
            torch.testing.assert_close(got.cpu(), want, **TOL)

    args, want = calls[0]
    graph = torch.cuda.CUDAGraph()
    fresh = torch.cuda.Stream()
    with pytest.raises(RuntimeError, match="captured"):
        with torch.cuda.graph(graph, stream=fresh):
            decode_ops.decode_attention_planes(*args, **kw)
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        decode_ops.decode_attention_planes(*args, **kw)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        got = decode_ops.decode_attention_planes(*args, **kw)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        torch.testing.assert_close(got.cpu(), want, **TOL)


# (bits, K group, V group, C, T, hd, q scale): the first nine at the
# shapes of the first kernel; then chunk sizes 1 to 64 (a warp takes 16
# rows, a block 32), T of one and three 64-token tiles, every head dim the
# tensor-core kernel takes, K groups that are not a tile's divisor (24) or
# span two tiles (128), groups of 8, q scaled by 8 (the least margin in
# the emulation), and hd 8, which stays on the CUDA-core kernel
FUSED_CASES = (
    [(bits, g, g, c, 320, 128, 1.0) for bits in (8, 4, 2)
     for g, c in ((32, 16), (64, 32), (64, 45))]
    + [(4, 64, 64, c, 192, 128, 1.0) for c in (1, 17, 33, 64)]
    + [(4, 64, 64, 32, 64, 128, 1.0), (8, 64, 64, 16, 192, 128, 1.0)]
    + [(8, 32, 16, 16, 192, hd, 1.0) for hd in (16, 32, 64)]
    + [(2, 24, 16, 17, 192, 32, 1.0), (8, 128, 64, 16, 256, 128, 1.0),
       (4, 8, 8, 33, 192, 64, 1.0)]
    + [(bits, 64, 64, 32, 320, 128, 8.0) for bits in (8, 4, 2)]
    + [(4, 32, 8, 16, 128, 8, 1.0)])


@pytest.mark.cuda
def test_fused_prefill_matches_plain():
    """On the card: the CUDA kernels against the plain version over
    ``FUSED_CASES`` and valid lengths T, partial and 0. Head dims 16-128
    with groups that are multiples of 8 must take the tensor-core kernel
    (``fused_mma``), hd 8 the CUDA-core one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.RandomState(15)
    for bits, kg, vg, c, t, hd, q_scale in FUSED_CASES:
        p = 3
        q, kc, vc = (torch.from_numpy(a) for a in chunk(rng, p, c, hd))
        q = q * q_scale
        packs = packed_planes(rng, p, t, hd, bits, kg, vg)
        mma = hd % 16 == 0 and kg % 8 == 0 and vg % 8 == 0
        for kind in ("full", "partial", "zero"):
            cur = torch.from_numpy(lengths(kind, p, t))
            want = fused_ops.chunk_prefill_planes(
                q, *(packs[n] for n in NAMES), kc, vc, cur, bits=bits,
                k_group=kg, v_group=vg)
            before = fused_kernel.LAUNCHES["fused_prefill_mma"]
            got = fused_ops.chunk_prefill_planes(
                q.cuda(), *(packs[n].cuda() for n in NAMES), kc.cuda(),
                vc.cuda(), cur.cuda(), bits=bits, k_group=kg, v_group=vg)
            what = f"bits {bits} groups {kg}/{vg} C {c} T {t} hd {hd} " \
                   f"q x {q_scale} cur_len {kind}"
            torch.testing.assert_close(got.cpu(), want, **TOL,
                                       msg=lambda m: f"{what}: {m}")
            assert (fused_kernel.LAUNCHES["fused_prefill_mma"]
                    - before) == int(mma), what


def misaligned(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of CUDA tensor ``t`` whose data starts 4 bytes past
    a 16-byte boundary: a layout that the attention kernels' tensor-core
    forms refuse, so the CUDA-core form takes it."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out



@pytest.mark.cuda
def test_flash_attention_matches_plain():
    """On the card: the CUDA kernels against the plain version, f32 and
    bf16, GQA 4:1, 2:1 and 1:1 and ragged lengths: S at each edge of a
    64-key tile (1, 63, 64, 65, 127) and a 1000, batch 2 without GQA,
    every head dim the tensor-core kernels take (16, 32, 64, 128), q scaled
    by 8 (a peaked softmax rounds P hardest), hd 8 and a misaligned copy,
    which stay on the CUDA-core kernel. Each call's launch counter shows
    the kernel: at hd 16-128 with aligned tensors ``flash_fwd_mma`` for
    bf16 and ``flash_fwd_mma_f32`` for f32, ``flash_fwd`` otherwise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    shapes = [(2, 96, 4, 2, 64), (1, 301, 8, 2, 128), (1, 64, 4, 4, 16),
              (1, 200, 4, 1, 32), (2, 130, 4, 4, 64), (1, 1000, 8, 2, 64),
              (1, 1000, 4, 4, 16), (1, 1000, 8, 2, 32), (1, 1000, 8, 8, 128)]
    shapes += [(1, s, 4, 2, 128) for s in (1, 63, 64, 65, 127)]
    cases = [(shape, 1.0, False) for shape in shapes]
    cases += [((1, 257, 4, 2, 128), 8.0, False), ((1, 257, 16, 4, 128), 8.0,
                                                  False),
              ((1, 77, 4, 2, 8), 1.0, False), ((1, 257, 16, 4, 128), 1.0, True),
              ((1, 100, 4, 4, 64), 1.0, True)]
    for shape, q_scale, shift in cases:
        for tdt in (torch.float32, torch.bfloat16):
            q, k, v = qkv(24, *shape)
            q, k, v = (torch.from_numpy(a).to(tdt) for a in (q * q_scale,
                                                             k, v))
            want = prefill_ops.causal_attention(q, k, v)
            on_card = [misaligned(t.cuda()) if shift else t.cuda()
                       for t in (q, k, v)]
            before = dict(prefill_kernel.LAUNCHES)
            got = prefill_ops.causal_attention(*on_card)
            what = (shape, q_scale, shift, tdt)
            torch.testing.assert_close(got.cpu(), want, **TOL,
                                       msg=lambda m: f"{what}: {m}")
            ran = "flash_attention_cores"
            if shape[-1] % 16 == 0 and not shift:
                ran = ("flash_attention_mma" if tdt == torch.bfloat16
                       else "flash_attention_mma_f32")
            moved = {key: n - before[key]
                     for key, n in prefill_kernel.LAUNCHES.items()}
            assert moved == {"flash_attention": 1, ran: 1,
                             **{key: 0 for key in moved
                                if key not in ("flash_attention", ran)}}, \
                what


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


@pytest.mark.cuda
def test_selective_scan_backward_matches_plain():
    """On the card: the gradients of ``ops.selective_scan`` under autograd
    (the forward kernel with checkpoints, then the backward kernel) against
    the plain backward, over every state size, lengths that no checkpoint
    interval divides, lengths under one interval (1 and 5 at N 16), B 3,
    ragged channel counts, with and without a gradient of hT; the
    checkpoints have the shape ``checkpoint_shape`` reads from the library,
    two calls of the backward are bit-equal, and one backward call is one
    count."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    shapes = ((1, 1, 64, 16), (2, 77, 200, 16), (3, 130, 128, 8),
              (1, 33, 50, 32), (2, 19, 130, 4), (1, 40, 129, 2),
              (2, 9, 260, 1), (2, 577, 300, 16), (3, 9, 64, 16),
              (3, 1, 96, 16), (2, 5, 64, 16), (1, 47, 160, 16),
              (2, 31, 64, 32))
    for shape in shapes:
        args = [torch.from_numpy(a).cuda()
                for a in falcon_scan_inputs(31, *shape)]
        rng = np.random.RandomState(32)
        b, s, d, n = shape
        _, _, ckpt = scan_kernel.selective_scan(*args, checkpoints=True)
        steps = scan_kernel.LIBRARY.lib().selective_scan_checkpoint_steps(n)
        assert ckpt.shape == scan_kernel.checkpoint_shape(b, s, d, n) == \
            (b, -(-s // steps), d, n), shape
        dy = torch.from_numpy(rng.randn(b, s, d).astype(np.float32)).cuda()
        for dht in (None, torch.from_numpy(
                rng.randn(b, d, n).astype(np.float32)).cuda()):
            want = scan_ref.selective_scan_bwd_ref(*args, dy, dht)
            runs = []
            for _ in range(2):
                leaves = [t.clone().requires_grad_() for t in args]
                before = scan_kernel.LAUNCHES["selective_scan_bwd"]
                y, h_t = scan_ops.selective_scan(*leaves)
                loss = (y * dy).sum()
                if dht is not None:
                    loss = loss + (h_t * dht).sum()
                runs.append(torch.autograd.grad(loss, leaves))
                assert (scan_kernel.LAUNCHES["selective_scan_bwd"]
                        - before) == 1
            for name, got, again, w in zip(
                    ("ddt", "dx", "dbs", "dcs", "da", "dh0"), *runs, want):
                what = f"{shape} dhT {dht is not None} {name}"
                assert torch.equal(got, again), what
                tol = SCAN_BWD_TOL * float(w.abs().max())
                torch.testing.assert_close(got, w, rtol=SCAN_BWD_TOL,
                                           atol=tol,
                                           msg=lambda m: f"{what}: {m}")
