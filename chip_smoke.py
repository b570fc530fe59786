#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and the repo's ``src/`` beside this file; it
imports nothing of JAX and nothing of the JAX package. Phases, each of which
stops the run with a non-zero exit when it fails:

1. build   — print the card and its power limit; build the five CUDA
             libraries (``kivi``, ``decode_attn``, ``fused_prefill``,
             ``flash_attn``, ``selective_scan`` under
             ``src/repro_torch/kernels/*/csrc/``), one ``nvcc`` each, all
             started together.
2. kernels — at full-width adaptcache-8b shapes, each kernel against its
             plain torch version (``ref.py``) on the same inputs on the card:
             KIVI quantize/dequantize bit-equal on a (32*512, 1024) f32
             matrix for 8/4/2 bits and both groupings; decode_attn (8 planes,
             4 query rows, 4096 tokens, hd 128) and fused_prefill (32 planes,
             a 32-token chunk over 4096 packed tokens) for 8/4/2 bits and
             valid lengths T, partial and 0, within rtol 1e-4 / atol 2e-4,
             with bytes past the valid length set to 255 changing nothing;
             flash_attention (S 4096, 32 heads over 8 KV heads) for f32 and
             bf16 inputs within the same tolerance. Each is timed with CUDA
             events (warm-up, a synchronize on every repetition) beside its
             plain version, its bound and, for flash_attention, PyTorch's
             ``scaled_dot_product_attention`` in the same type (f32 with
             TF32 off, and bf16); the attention kernels and their plain
             versions also as device time (CUDA-graph replays, without the
             host's share). The selective scan at full-width falcon-mamba-7b
             shapes (D 8192, N 16): (B 1, S 640), (B 1, S 4096) and (B 2,
             S 577, h0 != 0), y and hT within rtol 1e-4 / atol 1e-4, timed
             the same way, beside its byte bound and its SFU floor (one
             exponential a (t, d, n) step at 16 a clock on each SM).
3. serving — full-width adaptcache-8b (32 layers, d_model 4096, bf16,
             seeded random weights, ~16 GB) behind ``build_engine`` with the
             fixed KIVI policy, so every insert compresses and every hit
             decompresses: ``engine.process`` on Poisson requests, then
             ``summarize``. The KIVI launch counters are zeroed just before
             ``process`` and read just after; every kernel of the path must
             have launched. A new engine then serves the first request
             (a miss: prefill, quantize, decode) under ``torch.profiler``
             (CPU and CUDA activities): the ten device operations with the
             most time, the scan's and KIVI's shares and the device's idle
             share of the profiled window are printed. Then the outputs are
             checked: the summary is complete and finite, compressing a real
             prefill entry through the kernel gives the plain version's
             bytes, and the model's decode step agrees with its prefill.
4. fused   — the fused-compute path: the port's ``kernel_bench`` at full
             width measures the fused calibration on the card (the counters
             of decode_attn, fused_prefill and flash_attention are zeroed
             just before and must each be above 0 just after); phase 3's
             workload is served again on the same runner with
             ``fused_compute=True`` and the measured residual fraction. The
             summary must be complete and finite, the residual in [0, 1],
             and where hits and quality equal phase 3's, the mean TTFT no
             higher.
5. mamba   — phase 3-4's model is freed; full-width falcon-mamba-7b (64
             Mamba-1 layers, d_model 4096, d_inner 8192, d_state 16, bf16,
             ~7.0 B seeded params) serves phase 3's workload through
             ``build_engine``. The selective-scan and KIVI counters are
             zeroed just before ``engine.process`` and read just after: the
             scan must have launched a positive multiple of 64 times (one a
             layer a prefill) and KIVI quantize at least once; one request
             is then profiled as in phase 3. No request hits: the reference
             sizes its tiers from ``kv_bytes_per_token``,
             which counts attention layers only, so on this model they hold
             1.5 and 6 bytes. So a real prefill's ``ssm``/``conv`` state is
             compressed through the kernel (at 4 bits and at the served
             rate's bits) and decompressed, bit-equal to the plain version,
             and generation from the decompressed state must answer. The
             decode step must agree with the prefill in f32 (the same
             weights widened), within a relative logit error of 1e-4; the
             bf16 error is printed beside it.

The line before the last is the ``kernels`` JSON line; the last line is
``{"ok": true, "device": {...}}``. Measurements also go to
``chiprun_out/chip_smoke.json``.
The measured fused calibration goes beside it (``fused_calibration.json``).
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BPS = 3.35e12            # H100 SXM HBM3, NVIDIA data sheet
F32_OPS = 67e12              # H100 SXM f32 outside the tensor cores
TF32_OPS = 495e12            # H100 SXM dense TF32 tensor cores
SFU_PER_CLOCK = 16           # exponentials a clock on one SM
TOL = dict(rtol=1e-4, atol=2e-4)
ARCH = "adaptcache-8b"
T_TOKENS = 512               # context length of the kernel phase
MAIN_BITS = 4                # KIVI rate 0.16 picks 4 bits (the served path)
RATE = 0.16
# f32 operations per element, counted from the kernels' source
QUANT_OPS = 9                # min, max, sub, div, rint, 2 clamps, shift, or
DEQUANT_OPS = 5              # shift, and, convert, fma (2)
MAMBA_ARCH = "falcon-mamba-7b"
REPLACES = {"quantize": "src/repro/kernels/kivi/kernel.py:71",
            "dequantize": "src/repro/kernels/kivi/kernel.py:99",
            "decode_attn": "src/repro/kernels/decode_attn/kernel.py:133",
            "fused_prefill": "src/repro/kernels/fused_prefill/kernel.py:127",
            "flash_attention": "src/repro/kernels/prefill_attn/kernel.py:73",
            "selective_scan": "src/repro/kernels/mamba_scan/kernel.py:76"}
SOURCE = "src/repro_torch/kernels/kivi/csrc/kivi.cu"
SOURCES = {"decode_attn": "src/repro_torch/kernels/decode_attn/csrc/"
                          "decode_attn.cu",
           "fused_prefill": "src/repro_torch/kernels/fused_prefill/csrc/"
                            "fused_prefill.cu",
           "flash_attention": "src/repro_torch/kernels/prefill_attn/csrc/"
                              "flash_attn.cu",
           "selective_scan": "src/repro_torch/kernels/mamba_scan/csrc/"
                             "selective_scan.cu"}
# full-width adaptcache-8b: 32 query heads over 8 KV heads, head dim 128,
# KIVI group 64; decode (P planes, Gq rows, T tokens), fused (P planes,
# C-token chunk, T-token prefix), flash (B, S, H, Kv)
DECODE = dict(p=8, gq=4, t=4096, hd=128, group=64)
FUSED = dict(p=32, c=32, t=4096, hd=128, group=64)
FLASH = dict(b=1, s=4096, h=32, kv=8, hd=128)
# full-width falcon-mamba-7b: d_inner 8192, d_state 16; the first case is
# the main path's (a 384-640-token context), the third ragged and batched
SCAN = (dict(b=1, s=640, d=8192, n=16, h0=0.0),
        dict(b=1, s=4096, d=8192, n=16, h0=0.0),
        dict(b=2, s=577, d=8192, n=16, h0=0.1))
SCAN_TOL = dict(rtol=1e-4, atol=1e-4)   # the reference's kernel-vs-ref
DECODE_TOL_F32 = 1e-4   # the port's f32 logit tolerance (CPU parity tests)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def time_ms(fn, reps: int, warmup: int = 3) -> float:
    """Median device time of one call: CUDA events around each call,
    synchronized after every repetition."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def device_ms(fn, calls: int) -> float:
    """Device time of one call, without the host's share: ``calls`` calls
    captured into one CUDA graph, the graph replayed between CUDA events
    (median of 5 replays, a synchronize after each), divided by
    ``calls``. ``time_ms`` of a small kernel is mostly the Python wrapper
    and the launch; this is the time the card spends."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    del graph
    torch.cuda.empty_cache()
    return float(np.median(times))


def bound_ms(n_bytes: float, n_ops: float, ops_rate: float = F32_OPS):
    t_bytes, t_ops = n_bytes / HBM_BPS * 1e3, n_ops / ops_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def attention_bound(n_bytes: float, flops: float) -> dict:
    """The least time for an attention kernel: its bytes over the memory
    rate or its matrix-product operations over the TF32 tensor-core rate,
    whichever is larger; beside it the f32 CUDA-core time of the same
    operations, the rate these first kernels run at."""
    t, by = bound_ms(n_bytes, flops, TF32_OPS)
    return {"bound_ms": t, "bound_by": by, "bytes": n_bytes, "flops": flops,
            "f32_core_ms": flops / F32_OPS * 1e3}


def close_err(what: str, got: torch.Tensor, want: torch.Tensor,
              tol: dict = TOL) -> float:
    """Max abs error of a kernel against its plain version; fails outside
    ``tol`` (rtol 1e-4 / atol 2e-4 unless given) or on a non-finite
    value."""
    torch.cuda.synchronize()
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        fail(f"{what}: shape {tuple(got.shape)} (want {tuple(want.shape)}) "
             "or non-finite values")
    if not torch.allclose(got, want, **tol):
        fail(f"{what}: differs from the plain version beyond rtol "
             f"{tol['rtol']:g} / atol {tol['atol']:g} (max abs err "
             f"{float((got - want).abs().max()):.3g})")
    return float((got - want).abs().max())


def packed_planes(seed: int, p: int, t: int, hd: int, bits: int,
                  group: int):
    """Random K and V planes (P, T, hd), KIVI-packed on the card in the
    decode_attn layout: [k_packed, k_scale, k_zero, v_packed, v_scale,
    v_zero]."""
    from repro_torch.launch.kernel_bench import quantize_planes
    gen = torch.Generator(device="cuda").manual_seed(seed)
    k = torch.randn((p, t, hd), generator=gen, device="cuda")
    v = torch.randn((p, t, hd), generator=gen, device="cuda")
    return (list(quantize_planes(k, bits, group, 0)[:3])
            + list(quantize_planes(v, bits, group, 1)[:3]))


def valid_lengths(p: int, t: int):
    """cur_len (P, 1) cases: all T tokens, a spread of partial lengths
    above 0 (splits wholly past the end among them), and 0 (every token
    masked: the uniform mean of all T values)."""
    partial = [t, t - 1, 1, t // 2] + [max(1, (977 * i + 61) % t)
                                       for i in range(p)]
    return {name: torch.tensor(n[:p], dtype=torch.int32,
                               device="cuda").reshape(p, 1)
            for name, n in (("full", [t] * p), ("partial", partial),
                            ("zero", [0] * p))}


def spoil_tail(packs, cur: torch.Tensor, bits: int):
    """Copies of the packed planes with every byte that holds only tokens
    at or past cur_len set to 255."""
    cpb = 8 // bits
    out = [x.clone() for x in packs]
    for i, n in enumerate(cur[:, 0].tolist()):
        out[0][i, -(-n // cpb):] = 255            # K: tokens along rows
        out[3][i, n:] = 255                       # V: one row per token
    return out


def phase_packed_attention(name: str, dims: dict, kernel_fn, plain_fn,
                           io_floats: int, flops: float, seed: int):
    """decode_attn or fused_prefill at ``dims``: the kernel against its
    plain version for 8/4/2 bits and every valid-length case, the tail
    check, and the timings. ``kernel_fn(packs, cur_len, **kw)`` and
    ``plain_fn`` run one call on the packed planes; ``io_floats`` counts
    the f32 values of the call's dense inputs and output."""
    p, t, hd, g = dims["p"], dims["t"], dims["hd"], dims["group"]
    lens = valid_lengths(p, t)
    rows, worst = [], 0.0
    for bits in (8, 4, 2):
        packs = packed_planes(seed + bits, p, t, hd, bits, g)
        kw = dict(bits=bits, k_group=g, v_group=g)
        outs = {}
        for case, cur in lens.items():
            outs[case] = kernel_fn(packs, cur, **kw)
            worst = max(worst, close_err(
                f"{name} bits={bits} cur_len={case}", outs[case],
                plain_fn(packs, cur, **kw)))
        spoiled = spoil_tail(packs, lens["partial"], bits)
        if not torch.equal(kernel_fn(spoiled, lens["partial"], **kw),
                           outs["partial"]):
            fail(f"{name} bits={bits}: bytes past cur_len changed the "
                 "output")
        n_bytes = (io_floats * 4 + 2 * p * t * hd * bits / 8
                   + 2 * 2 * p * (t // g) * hd * 4 + p * 4)
        kern = lambda: kernel_fn(packs, lens["full"], **kw)
        plain = lambda: plain_fn(packs, lens["full"], **kw)
        row = {"bits": bits, "shape": dict(dims),
               "ms": device_ms(kern, calls=20),
               "plain_ms": device_ms(plain, calls=5),
               "call_ms": time_ms(kern, reps=20),
               "plain_call_ms": time_ms(plain, reps=5),
               **attention_bound(n_bytes, flops)}
        rows.append(row)
        print(f"  {name} bits={bits} {dims}: within tolerance for cur_len "
              f"T / partial / 0, tail bytes ignored; device "
              f"{row['ms']:.4f} ms (plain {row['plain_ms']:.4f}, bound "
              f"{row['bound_ms']:.4f} by {row['bound_by']}, f32 cores "
              f"{row['f32_core_ms']:.4f}); per call {row['call_ms']:.4f} "
              f"ms (plain {row['plain_call_ms']:.4f})")
    return rows, worst


def phase_decode_attn(ops, ref):
    d = DECODE
    p, gq, t, hd = d["p"], d["gq"], d["t"], d["hd"]
    gen = torch.Generator(device="cuda").manual_seed(7)
    q = torch.randn((p, gq, hd), generator=gen, device="cuda")
    return phase_packed_attention(
        "decode_attn", d,
        lambda packs, cur, **kw: ops.decode_attention_planes(
            q, *packs, cur, **kw),
        lambda packs, cur, **kw: ref.decode_attention_planes_ref(
            q, *packs, cur, **kw),
        io_floats=2 * p * gq * hd, flops=4 * p * gq * t * hd, seed=0)


def phase_fused_prefill(ops, ref):
    f = FUSED
    p, c, t, hd = f["p"], f["c"], f["t"], f["hd"]
    gen = torch.Generator(device="cuda").manual_seed(8)
    q, kc, vc = (torch.randn((p, c, hd), generator=gen, device="cuda")
                 for _ in range(3))
    return phase_packed_attention(
        "fused_prefill", f,
        lambda packs, cur, **kw: ops.chunk_prefill_planes(
            q, *packs, kc, vc, cur, **kw),
        lambda packs, cur, **kw: ref.chunk_prefill_planes_ref(
            q, *packs, kc, vc, cur, **kw),
        io_floats=4 * p * c * hd, flops=4 * p * c * hd * (t + (c + 1) / 2),
        seed=10)


def phase_flash_attention(ops, ref):
    import torch.nn.functional as F
    fa = FLASH
    b, s, h, kv, hd = fa["b"], fa["s"], fa["h"], fa["kv"], fa["hd"]
    gen = torch.Generator(device="cuda").manual_seed(9)
    q = torch.randn((b, s, h, hd), generator=gen, device="cuda")
    k = torch.randn((b, s, kv, hd), generator=gen, device="cuda")
    v = torch.randn((b, s, kv, hd), generator=gen, device="cuda")
    rows, worst = [], 0.0
    for dtype in (torch.float32, torch.bfloat16):
        qq, kk, vv = (x.to(dtype) for x in (q, k, v))
        got = ops.causal_attention(qq, kk, vv)
        worst = max(worst, close_err(f"flash_attention {dtype}", got,
                                     ref.causal_attention_gqa_ref(qq, kk,
                                                                  vv)))
        es = qq.element_size()
        n_bytes = (b * s * h * hd * es + 2 * b * s * kv * hd * es
                   + b * s * h * hd * 4)
        kern = lambda: ops.causal_attention(qq, kk, vv)
        plain = lambda: ref.causal_attention_gqa_ref(qq, kk, vv)
        row = {"dtype": str(dtype).replace("torch.", ""), "shape": dict(fa),
               "ms": device_ms(kern, calls=2),
               "plain_ms": device_ms(plain, calls=1),
               "call_ms": time_ms(kern, reps=10),
               "plain_call_ms": time_ms(plain, reps=3),
               **attention_bound(n_bytes, 4 * b * h * hd * s * (s + 1) / 2)}
        # the yardstick only: PyTorch's own attention in the same type
        # (f32 without TF32, or bf16), which the port never calls
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (qq, kk, vv))
        lib = lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)
        # per call: at this size the host's share is negligible
        row["library_ms"] = time_ms(lib, reps=10)
        row["library_max_abs_diff"] = float(
            (lib().transpose(1, 2).float() - got).abs().max())
        rows.append(row)
        print(f"  flash_attention {row['dtype']} (B, S, H, Kv, hd)=({b}, "
              f"{s}, {h}, {kv}, {hd}): within tolerance; device "
              f"{row['ms']:.4f} ms (plain {row['plain_ms']:.4f}, sdpa "
              f"{row['library_ms']:.4f}, bound {row['bound_ms']:.4f} by "
              f"{row['bound_by']}, f32 cores {row['f32_core_ms']:.4f}); per "
              f"call {row['call_ms']:.4f} ms (plain "
              f"{row['plain_call_ms']:.4f})")
    return rows, worst


def scan_inputs(case: dict, seed: int):
    """(dt, x, bs, cs, a, h0) on the card, made with numpy as the
    reference's kernel test makes them (dt = |N(0, 1)| / 10, a =
    -|N(0, 1)|; h0 N(0, 1) times the case's scale)."""
    rng = np.random.RandomState(seed)
    b, s, d, n = case["b"], case["s"], case["d"], case["n"]
    arrays = (np.abs(rng.randn(b, s, d)).astype(np.float32) * 0.1,
              rng.randn(b, s, d).astype(np.float32),
              rng.randn(b, s, n).astype(np.float32),
              rng.randn(b, s, n).astype(np.float32),
              -np.abs(rng.randn(d, n)).astype(np.float32),
              rng.randn(b, d, n).astype(np.float32) * case["h0"])
    return [torch.from_numpy(a).cuda() for a in arrays]


def sm_clock_hz() -> float:
    """The card's highest SM clock, as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout
    return float(out.strip()) * 1e6


def phase_selective_scan(ops, ref):
    """The scan against its plain version (a sequential loop over time) at
    each case of ``SCAN``, then timed: device time (CUDA-graph replays) and
    per call (events), beside the plain version, the bound and the SFU
    floor (its exponentials over the special-function units' rate at the
    card's highest clock)."""
    clock = sm_clock_hz()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows, worst = [], 0.0
    for i, case in enumerate(SCAN):
        b, s, d, n = case["b"], case["s"], case["d"], case["n"]
        args = scan_inputs(case, seed=40 + i)
        y, h_t = ops.selective_scan(*args)
        y_ref, h_ref = ref.selective_scan_ref(*args)
        for what, got, want in (("y", y, y_ref), ("hT", h_t, h_ref)):
            worst = max(worst, close_err(f"selective_scan {case} {what}",
                                         got, want, SCAN_TOL))
        n_bytes = 4 * (3 * b * s * d + 2 * b * s * n + d * n + 2 * b * d * n)
        t, by = bound_ms(n_bytes, 7 * b * s * d * n)
        exps = b * s * d * n
        kern = lambda: ops.selective_scan(*args)
        plain = lambda: ref.selective_scan_ref(*args)
        row = {"shape": dict(case), "ms": device_ms(kern, calls=10),
               "plain_ms": device_ms(plain, calls=1),
               "call_ms": time_ms(kern, reps=20),
               "plain_call_ms": time_ms(plain, reps=2, warmup=1),
               "bound_ms": t, "bound_by": by, "bytes": n_bytes,
               "f32_ops_ms": 7 * b * s * d * n / F32_OPS * 1e3,
               "exps": exps, "sm_clock_hz": clock,
               "sfu_ms": exps / (SFU_PER_CLOCK * sms * clock) * 1e3,
               "library_ms": None}
        rows.append(row)
        print(f"  selective_scan (B, S, D, N)=({b}, {s}, {d}, {n}), h0 "
              f"scale {case['h0']}: y and hT within rtol 1e-4 / atol 1e-4; "
              f"device {row['ms']:.4f} ms (plain {row['plain_ms']:.4f}, "
              f"bound {t:.4f} by {by}, SFU floor "
              f"{row['sfu_ms']:.4f}); per call {row['call_ms']:.4f} ms "
              f"(plain {row['plain_call_ms']:.4f})")
    return rows, worst


def kv_matrix(rows: int, cols: int, bits: int, seed: int) -> torch.Tensor:
    """K/V-like values with the cases that test rounding: a spread of
    scales, constant groups (scale 0) and, where the top code allows it,
    groups whose codes fall on exact half-steps."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((rows, cols), generator=gen, device="cuda")
    x *= torch.rand((1, cols), generator=gen, device="cuda") * 8 + 0.05
    x[:64, :64] = 1.25                      # constant groups, both axes
    i = torch.arange(64, device="cuda")
    steps = 2 * (2 ** bits - 1) + 1         # 0, 0.5, ..., 2^bits - 1
    x[64:128, :64] = ((i[:, None] + i[None, :]) % steps) * 0.5
    return x.contiguous()


def phase_kernels(kernel, ref, Quantized):
    rows, cols = 32 * T_TOKENS, 1024
    results, worst = [], {"quantize": 0.0, "dequantize": 0.0}
    for bits in (8, 4, 2):
        for axis in (0, 1):
            x = kv_matrix(rows, cols, bits, seed=bits * 10 + axis)
            gs = 64
            packed, scale, zero = kernel.quantize(x, bits, gs, axis)
            torch.cuda.synchronize()
            qr = ref.quantize_ref(x, bits, gs, axis)
            for name, a, b in (("packed", packed, qr.packed),
                               ("scale", scale, qr.scale),
                               ("zero", zero, qr.zero)):
                if a.shape != b.shape or not torch.equal(a, b):
                    fail(f"quantize bits={bits} axis={axis}: {name} differs "
                         "from the plain version")
            qt = Quantized(packed, scale, zero, bits, gs, axis, x.shape[axis])
            out = kernel.dequantize(packed, scale, zero, bits, gs, axis,
                                    x.shape[axis])
            torch.cuda.synchronize()
            want = ref.dequantize_ref(qt)
            if not torch.equal(out, want):
                fail(f"dequantize bits={bits} axis={axis}: differs from the "
                     "plain version")
            if not bool(torch.isfinite(out).all()):
                fail(f"dequantize bits={bits} axis={axis}: non-finite values")
            err_q = max(float((packed.int() - qr.packed.int()).abs().max()),
                        float((scale - qr.scale).abs().max()),
                        float((zero - qr.zero).abs().max()))
            err_d = float((out - want).abs().max())
            worst["quantize"] = max(worst["quantize"], err_q)
            worst["dequantize"] = max(worst["dequantize"], err_d)

            n_el, n_groups = rows * cols, rows * cols // gs
            code_bytes = n_el * bits / 8
            side_bytes = 2 * n_groups * 4
            q_bound = bound_ms(n_el * 4 + code_bytes + side_bytes,
                               n_el * QUANT_OPS)
            d_bound = bound_ms(code_bytes + side_bytes + n_el * 4,
                               n_el * DEQUANT_OPS)
            row = {
                "bits": bits, "axis": axis, "shape": [rows, cols],
                "quantize_ms": time_ms(
                    lambda: kernel.quantize(x, bits, gs, axis), reps=20),
                "quantize_plain_ms": time_ms(
                    lambda: ref.quantize_ref(x, bits, gs, axis), reps=5),
                "quantize_bound_ms": q_bound[0],
                "quantize_bound_by": q_bound[1],
                "dequantize_ms": time_ms(
                    lambda: kernel.dequantize(packed, scale, zero, bits, gs,
                                              axis, x.shape[axis]), reps=20),
                "dequantize_plain_ms": time_ms(
                    lambda: ref.dequantize_ref(qt), reps=5),
                "dequantize_bound_ms": d_bound[0],
                "dequantize_bound_by": d_bound[1],
            }
            results.append(row)
            print(f"  bits={bits} axis={axis} (T*L, F)=({rows}, {cols}): "
                  f"bit-equal; quantize {row['quantize_ms']:.4f} ms "
                  f"(plain {row['quantize_plain_ms']:.4f}, bound "
                  f"{row['quantize_bound_ms']:.4f}); dequantize "
                  f"{row['dequantize_ms']:.4f} ms (plain "
                  f"{row['dequantize_plain_ms']:.4f}, bound "
                  f"{row['dequantize_bound_ms']:.4f})")
    return results, worst


def summarize_profile(events, device_type) -> dict:
    """From a profiler's events: the device's busy time (the union of its
    activities' intervals) and idle share over the profiled window (the
    first to the last event, host or device), the ten device operations
    with the most total time, and the selective scan's and KIVI's totals."""
    dev = [e for e in events if e.device_type == device_type]
    if not dev:
        fail("the profile recorded no device activity")
    busy, end = 0.0, -math.inf
    for start, stop in sorted((e.time_range.start, e.time_range.end)
                              for e in dev):
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
    window = (max(e.time_range.end for e in events)
              - min(e.time_range.start for e in events))
    total, calls = {}, {}
    for e in dev:
        total[e.name] = total.get(e.name, 0.0) + e.time_range.elapsed_us()
        calls[e.name] = calls.get(e.name, 0) + 1
    top = sorted(total, key=total.get, reverse=True)[:10]
    share = lambda pat: sum(t for k, t in total.items() if re.search(pat, k))
    return {"window_ms": window / 1e3, "busy_ms": busy / 1e3,
            "idle_share": 1.0 - busy / window,
            "top": [{"name": k, "ms": total[k] / 1e3, "calls": calls[k]}
                    for k in top],
            "scan_ms": share(r"scan_fwd") / 1e3,
            "kivi_ms": share(r"quantize_(rows|cols)") / 1e3}


def profile_request(engine, request, label: str) -> dict:
    """``torch.profiler`` (CPU and CUDA activities) over ``engine.process``
    of one request, summarized by ``summarize_profile`` and printed."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        result = engine.process([request])[0]
        torch.cuda.synchronize()
    out = summarize_profile(prof.events(), DeviceType.CUDA)
    out["hit_tier"] = result.hit_tier
    busy = out["busy_ms"]
    print(f"  profile of one {label} request (hit tier {result.hit_tier}): "
          f"window {out['window_ms']:.1f} ms, device busy {busy:.1f} ms, "
          f"idle share {out['idle_share']:.4f}")
    for i, op in enumerate(out["top"], 1):
        print(f"    {i:2d}. {op['ms']:9.3f} ms {op['calls']:6d} calls "
              f"{100 * op['ms'] / busy:5.1f} % of busy  {op['name'][:90]}")
    for what in ("scan", "kivi"):
        ms = out[f"{what}_ms"]
        print(f"    {what}: {ms:.3f} ms, {100 * ms / busy:.2f} % of busy, "
              f"{100 * ms / out['window_ms']:.3f} % of the window")
    return out


def serve(runner, cfg, n_active: int, kernels=(), want_hits: bool = True,
          profile_label=None, **engine_kw):
    """Serve the fixed workload (one context per task, ~8 s of Poisson
    requests, seeded) through ``build_engine`` with the fixed KIVI policy,
    and check the summary; with ``profile_label``, then profile the first
    request served by a new engine (``profile_request``), which has not
    memoized the context's prefill: a miss that prefills and quantizes.
    Returns (summary, results, requests, contexts, wall seconds of
    ``engine.process``, the launches of the KIVI kernels and of the kernel
    modules in ``kernels`` during it, the profile or None)."""
    from repro_torch.kernels.kivi import kernel as kivi_kernel
    from repro_torch.serving.baselines import build_engine
    from repro_torch.serving.engine import summarize
    from repro_torch.serving.workload import make_contexts, poisson_requests

    rng = np.random.RandomState(0)
    contexts = make_contexts(rng, cfg.vocab_size, 1, min_len=384,
                             max_len=640, n_probes=2)
    requests = poisson_requests(rng, contexts, rate_hz=1.0, duration_s=8.0)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ssd_") as ssd_root:
        make_rig = lambda: build_engine(
            runner, contexts, cfg, n_active, policy=("kivi", RATE),
            dram_entries=1.5, ssd_entries=6.0, ssd_root=ssd_root,
            **engine_kw)
        rig = make_rig()
        counters = [kivi_kernel.LAUNCHES] + [m.LAUNCHES for m in kernels]
        for c in counters:
            for k in c:
                c[k] = 0
        t0 = time.perf_counter()
        results = rig.engine.process(requests)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = {k: n for c in counters for k, n in c.items()}
        summary = summarize(results,
                            selector_stats=rig.controller.selector.stats)
        print(f"  {len(contexts)} contexts of "
              f"{[len(c.tokens) for c in contexts]} tokens, {len(requests)} "
              f"requests, engine.process {wall_s:.2f} s wall")
        check_summary(summary, results, len(requests), want_hits)
        prof = (profile_request(make_rig().engine, requests[0],
                                profile_label) if profile_label else None)
    return summary, results, requests, contexts, wall_s, launches, prof


def check_summary(summary, results, n_requests: int,
                  want_hits: bool = True) -> None:
    """Complete, finite, answered, and (``want_hits``) the cache served
    hits."""
    if summary.get("n") != n_requests or len(results) != n_requests:
        fail(f"summary counts {summary.get('n')} of {n_requests} requests")
    bad = [k for k, v in summary.items()
           if isinstance(v, float) and not math.isfinite(v)]
    if bad:
        fail(f"non-finite summary values: {bad}")
    if not 0.0 <= summary["quality_mean"] <= 1.0:
        fail(f"quality_mean {summary['quality_mean']} outside [0, 1]")
    if want_hits and summary["hit_rate"] <= 0.0:
        fail("no request hit the cache: decompress never served")
    if any(len(r.answer) == 0 for r in results):
        fail("a request produced no answer tokens")


def phase_serving():
    from repro_torch.configs import get_config
    from repro_torch.core.compression import KIVICompression
    from repro_torch.models import build_model
    from repro_torch.serving.runner import ModelRunner

    cfg = get_config(ARCH)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = model.param_count(params)
    print(f"  {ARCH}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads / {cfg.n_kv_heads} KV heads, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.param_dtype}: "
          f"{n_params / 1e9:.3f} B params "
          f"({n_params * 2 / 1e9:.2f} GB), init "
          f"{time.perf_counter() - t0:.1f} s")
    runner = ModelRunner(model, params, capacity=1024)
    n_active = model.active_param_count()
    summary, _, _, contexts, wall_s, launches, prof = serve(
        runner, cfg, n_active, profile_label="phase-3")
    print("  summary (TTFT is simulated on the reference's A100 TimeModel, "
          "not measured on this card):")
    for k, v in summary.items():
        print(f"    {k:28s} {v}")
    print(f"  kernel launches during engine.process: {launches}")
    missing = [k for k, n in launches.items() if n <= 0]
    if missing:
        fail(f"main path never launched {missing}")

    # a real prefill entry through the kernel == the plain version's bytes
    kv = runner.prefill_entry(contexts[0].tokens)
    for name in ("k", "v"):
        shape = (cfg.n_layers, len(contexts[0].tokens),
                 cfg.n_kv_heads * cfg.resolved_head_dim)
        if kv[name].shape != shape or not np.isfinite(kv[name]).all():
            fail(f"prefill KVData {name}: shape {kv[name].shape}, want "
                 f"{shape}, finite values")
    on_card = KIVICompression(device="cuda").compress(kv, RATE)
    on_cpu = KIVICompression(device="cpu").compress(kv, RATE)
    for key, a in on_card.arrays.items():
        if not np.array_equal(a, on_cpu.arrays[key]):
            fail(f"compress of a real entry: {key} differs between the "
                 "kernel and the plain version")
    back_card = KIVICompression(device="cuda").decompress(on_card)
    back_cpu = KIVICompression(device="cpu").decompress(on_cpu)
    for name in ("k", "v"):
        if not np.array_equal(back_card[name], back_cpu[name]):
            fail(f"decompress of a real entry: {name} differs between the "
                 "kernel and the plain version")
    print(f"  real {len(contexts[0].tokens)}-token entry: compress and "
          f"decompress bit-equal to the plain version "
          f"({on_card.meta['bits']} bits, rate {on_card.rate:.4f})")

    # the decode step against the prefill on the same tokens (bf16)
    rel = decode_vs_prefill(model, params, contexts[0].tokens)
    if not rel < 5e-2:
        fail(f"decode step disagrees with prefill: max rel err {rel:.3g}")
    print(f"  decode step vs prefill logits (bf16): max rel err {rel:.3g}")
    return summary, launches, wall_s, (runner, cfg, n_active), prof


def phase_fused(attn_kernels, summary3, serving):
    """The fused-compute path: kernel_bench's calibration on the card, then
    the same workload priced with it."""
    import contextlib
    import io

    from repro_torch.core.estimator import load_fused_calibration
    from repro_torch.launch import kernel_bench

    for mod in attn_kernels.values():
        for k in mod.LAUNCHES:
            mod.LAUNCHES[k] = 0
    buf = io.StringIO()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cal_") as tmp, \
            contextlib.redirect_stdout(buf):
        cal_path = Path(tmp) / "fused_calibration.json"
        kernel_bench.main(["--out", str(cal_path)])
        torch.cuda.synchronize()
        cal = load_fused_calibration(str(cal_path))
        raw = json.loads(cal_path.read_text())
    bench_s = time.perf_counter() - t0
    launches = {name: mod.LAUNCHES[name]
                for name, mod in attn_kernels.items()}
    rows = [r for r in buf.getvalue().splitlines() if r]
    print(f"  kernel_bench (full width) in {bench_s:.1f} s:")
    for r in rows:
        print(f"    {r}")
    print(f"  kernel launches during kernel_bench: {launches}")
    missing = [k for k, n in launches.items() if n <= 0]
    if missing:
        fail(f"the fused-compute path never launched {missing}")
    if not all(math.isfinite(x) and x > 0
               for x in (cal.fused_s, cal.dequant_s, cal.attn_s)):
        fail(f"calibration times not finite and positive: {raw}")
    if not 0.0 <= cal.residual_frac <= 1.0:
        fail(f"residual fraction {cal.residual_frac} outside [0, 1]")
    print(f"  calibration ({raw['shape']}, {raw['bits']} bits, "
          f"{raw['device']}, {raw['power_limit']}): fused "
          f"{cal.fused_s * 1e3:.4f} ms, dequant {cal.dequant_s * 1e3:.4f} ms, "
          f"attn {cal.attn_s * 1e3:.4f} ms; residual {cal.residual_frac:.4f},"
          f" speedup {cal.speedup:.3f}x")

    runner, cfg, n_active = serving
    summary, _, _, _, wall_s, _, _ = serve(
        runner, cfg, n_active, fused_compute=True,
        fused_residual_frac=cal.residual_frac)
    print("  phase 3 (profiled decompress) vs fused pricing at the measured "
          "residual (simulated TTFT, A100 TimeModel):")
    for k, v in summary.items():
        print(f"    {k:28s} {summary3.get(k)!s:>24s}  {v}")
    same = (summary["hit_rate"] == summary3["hit_rate"]
            and summary["quality_mean"] == summary3["quality_mean"])
    speedup = summary3["ttft_mean_s"] / max(summary["ttft_mean_s"], 1e-12)
    print(f"  same hits and quality: {same}; mean TTFT "
          f"{summary3['ttft_mean_s']:.6f} -> {summary['ttft_mean_s']:.6f} s "
          f"({speedup:.4f}x)")
    if same and summary["ttft_mean_s"] > summary3["ttft_mean_s"]:
        fail("fused pricing charged more at the same hits and quality")
    return {"calibration": raw, "residual_frac": cal.residual_frac,
            "speedup": cal.speedup, "bench_rows": rows,
            "bench_s": bench_s, "launches": launches, "summary": summary,
            "same_hits_and_quality": same, "ttft_speedup": speedup,
            "wall_s": wall_s}


def decode_vs_prefill(model, params, tokens) -> float:
    """Max relative error of the decode step's logits on the last of 64
    tokens (from the prefill of the first 63) against the prefill of all
    64; infinite when the decode step gives a non-finite value."""
    toks = torch.as_tensor(tokens[:64], device="cuda")[None]
    want, _ = model.prefill(params, {"tokens": toks}, capacity=128)
    _, cache = model.prefill(params, {"tokens": toks[:, :-1]}, capacity=128)
    got, _ = model.decode_step(params, cache, 63, toks[:, -1:])
    want, got = want.float()[0, -1], got.float()[0, -1]
    if not bool(torch.isfinite(got).all()):
        return math.inf
    return float((want - got).abs().max() / want.abs().max())


def widened(tree):
    """A param tree with every leaf copied to f32."""
    if isinstance(tree, dict):
        return {k: widened(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [widened(v) for v in tree]
    return tree.to(torch.float32)


def phase_mamba(scan_kernel):
    """Full-width falcon-mamba-7b served through ``build_engine``, its
    kernels counted; then the state's KIVI round trip through the kernel
    and the decode step against the prefill."""
    from repro_torch.configs import get_config
    from repro_torch.core.compression import KIVICompression
    from repro_torch.models import build_model
    from repro_torch.serving.runner import ModelRunner

    cfg = get_config(MAMBA_ARCH)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = model.param_count(params)
    if n_params != model.active_param_count():
        fail(f"{MAMBA_ARCH}: {n_params} params initialised, the config "
             f"counts {model.active_param_count()}")
    print(f"  {MAMBA_ARCH}: {cfg.n_layers} Mamba-1 layers, d_model "
          f"{cfg.d_model}, d_inner {cfg.d_inner}, d_state "
          f"{cfg.ssm.d_state}, dt_rank {cfg.resolved_dt_rank}, vocab "
          f"{cfg.vocab_size}, {cfg.param_dtype}: {n_params / 1e9:.3f} B "
          f"params, init {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card")
    runner = ModelRunner(model, params, capacity=1024)
    summary, results, requests, contexts, wall_s, launches, prof = serve(
        runner, cfg, n_params, kernels=(scan_kernel,), want_hits=False,
        profile_label="phase-5")
    print("  summary (TTFT is simulated on the reference's A100 TimeModel, "
          "not measured on this card):")
    for k, v in summary.items():
        print(f"    {k:28s} {v}")
    print(f"  kernel launches during engine.process: {launches}")
    n_scan = launches["selective_scan"]
    if n_scan <= 0 or n_scan % cfg.n_layers:
        fail(f"selective_scan launched {n_scan} times during "
             f"engine.process: want a positive multiple of {cfg.n_layers}")
    if launches["quantize_k"] + launches["quantize_v"] <= 0:
        fail("KIVI quantize never launched during engine.process")
    print(f"  hit rate {summary['hit_rate']}: the reference sizes its tiers "
          "from kv_bytes_per_token(), which counts attention layers only, "
          "so on this model each tier holds 1.5 or 6 bytes and every state "
          "entry is evicted; the round trip below checks decompression")

    # a real prefill's state through the kernel == the plain version's
    ctx = contexts[0]
    kv = runner.prefill_entry(ctx.tokens)
    shapes = {"ssm": (cfg.n_layers, cfg.d_inner, cfg.ssm.d_state),
              "conv": (cfg.n_layers, cfg.ssm.d_conv - 1, cfg.d_inner)}
    for name, shape in shapes.items():
        if kv[name].shape != shape or not np.isfinite(kv[name]).all():
            fail(f"prefill state {name}: shape {kv[name].shape}, want "
                 f"{shape}, finite values")
    card, cpu = KIVICompression(device="cuda"), KIVICompression(device="cpu")
    round_trips, back = {}, None
    for bits in (4, None):                 # 4 bits, then the served rate's
        on_card = card.compress(kv, RATE, bits=bits)
        used = on_card.meta["bits"]
        if used in round_trips:
            continue
        on_cpu = cpu.compress(kv, RATE, bits=bits)
        for key, a in on_card.arrays.items():
            if not np.array_equal(a, on_cpu.arrays[key]):
                fail(f"compress of a real state ({used} bits): {key} "
                     "differs between the kernel and the plain version")
        back_card, back_cpu = card.decompress(on_card), cpu.decompress(on_cpu)
        for name in shapes:
            if not np.array_equal(back_card[name], back_cpu[name]):
                fail(f"decompress of a real state ({used} bits): {name} "
                     "differs between the kernel and the plain version")
        err = {name: float(np.abs(back_card[name] - kv[name]).max())
               for name in shapes}
        round_trips[used] = {"rate": on_card.rate, "max_abs_err": err}
        back = back_card if used == 4 else back
        print(f"  real {len(ctx.tokens)}-token state, {used} bits (rate "
              f"{on_card.rate:.4f}): compress and decompress bit-equal to "
              f"the plain version; max abs error of the round trip "
              f"ssm {err['ssm']:.4g}, conv {err['conv']:.4g}")
    req = next(r for r in requests if r.context_key == ctx.key)
    answer = runner.generate_from_kvdata(back, len(ctx.tokens), req.question,
                                         req.max_new_tokens)
    if len(answer) != req.max_new_tokens:
        fail(f"generation from the decompressed state gave {len(answer)} "
             f"of {req.max_new_tokens} answer tokens")
    print(f"  generation from the 4-bit state: {len(answer)} answer tokens")
    # the decode step against the prefill, held in f32 on the same
    # weights: in bf16, rounding that depends on the prefill's length
    # (cuBLAS picks its algorithm by shape) grows through 64 random layers
    # to several percent of the logits, so bf16 is reported, not held
    rel16 = decode_vs_prefill(model, params, ctx.tokens)
    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    params32 = widened(params)
    rel32 = decode_vs_prefill(build_model(cfg32), params32, ctx.tokens)
    del params32
    torch.cuda.empty_cache()
    if not rel32 < DECODE_TOL_F32:
        fail(f"decode step disagrees with prefill in f32: max rel err "
             f"{rel32:.3g} (limit {DECODE_TOL_F32:g})")
    print(f"  decode step vs prefill logits: f32 (the same weights widened) "
          f"max rel err {rel32:.3g}, within {DECODE_TOL_F32:g}; bf16 "
          f"{rel16:.3g}")
    return {"summary": summary, "launches": launches, "wall_s": wall_s,
            "n_params": n_params, "round_trips": round_trips,
            "decode_rel_err_f32": rel32, "decode_rel_err_bf16": rel16,
            "answer_tokens": len(answer), "profile": prof}


def main() -> int:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a "
             "CUDA card")
    from repro_torch.kernels._build import build_all
    from repro_torch.kernels.decode_attn import kernel as decode_kernel
    from repro_torch.kernels.decode_attn import ops as decode_ops
    from repro_torch.kernels.decode_attn import ref as decode_ref
    from repro_torch.kernels.fused_prefill import kernel as fused_kernel
    from repro_torch.kernels.fused_prefill import ops as fused_ops
    from repro_torch.kernels.fused_prefill import ref as fused_ref
    from repro_torch.kernels.kivi import kernel, ref
    from repro_torch.kernels.kivi.ref import Quantized
    from repro_torch.kernels.mamba_scan import kernel as scan_kernel
    from repro_torch.kernels.mamba_scan import ops as scan_ops
    from repro_torch.kernels.mamba_scan import ref as scan_ref
    from repro_torch.kernels.prefill_attn import kernel as flash_kernel
    from repro_torch.kernels.prefill_attn import ops as flash_ops
    from repro_torch.kernels.prefill_attn import ref as flash_ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")

    print("[1/5] build")
    attn_kernels = {"decode_attn": decode_kernel,
                    "fused_prefill": fused_kernel,
                    "flash_attention": flash_kernel}
    libs = ([kernel.LIBRARY] + [m.LIBRARY for m in attn_kernels.values()]
            + [scan_kernel.LIBRARY])
    for lib in libs:
        shutil.rmtree(lib.build_dir, ignore_errors=True)
    t0 = time.perf_counter()
    built = build_all(libs)
    build_s = time.perf_counter() - t0
    print(f"  built {len(built)} libraries in parallel in {build_s:.1f} s")
    for path, log in built:
        print(f"  {path.relative_to(ROOT)}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"    ptxas: {line.strip()}")

    print("[2/5] kernels against the plain version")
    kernel_rows, worst = phase_kernels(kernel, ref, Quantized)
    timed_rows = {
        "decode_attn": phase_decode_attn(decode_ops, decode_ref),
        "fused_prefill": phase_fused_prefill(fused_ops, fused_ref),
        "flash_attention": phase_flash_attention(flash_ops, flash_ref),
        "selective_scan": phase_selective_scan(scan_ops, scan_ref),
    }

    print("[3/5] serving full-width adaptcache-8b through build_engine")
    summary, launches, wall_s, serving, profile3 = phase_serving()

    print("[4/5] fused compute: kernel_bench calibration, then serving "
          "priced with it")
    fused = phase_fused(attn_kernels, summary, serving)

    print("[5/5] serving full-width falcon-mamba-7b through build_engine")
    del serving                            # free adaptcache-8b's weights
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  adaptcache-8b freed: {torch.cuda.memory_allocated() / 1e9:.2f} "
          "GB left on the card")
    mamba = phase_mamba(scan_kernel)

    entries = []
    for op in ("quantize", "dequantize"):
        for axis, style in ((0, "k"), (1, "v")):
            row = next(r for r in kernel_rows
                       if r["bits"] == MAIN_BITS and r["axis"] == axis)
            entries.append({
                "name": f"kivi_{op}_{style}",
                "route": "cuda",
                "source": SOURCE,
                "replaces": REPLACES[op],
                "launches": launches[f"{op}_{style}"],
                "max_abs_err": worst[op],
                "ms": row[f"{op}_ms"],
                "plain_ms": row[f"{op}_plain_ms"],
                "bound_ms": row[f"{op}_bound_ms"],
                "bound_by": row[f"{op}_bound_by"],
                "library_ms": None,
            })
    for kname, (rows, err) in timed_rows.items():
        # the main path's case: 4-bit KIVI prefix; f32 flash attention;
        # the scan at (B 1, S 640)
        row = rows[0] if kname in ("flash_attention", "selective_scan") \
            else next(r for r in rows if r["bits"] == MAIN_BITS)
        entries.append({
            "name": kname,
            "route": "cuda",
            "source": SOURCES[kname],
            "replaces": REPLACES[kname],
            "launches": (mamba["launches"][kname]
                         if kname == "selective_scan"
                         else fused["launches"][kname]),
            "max_abs_err": err,
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row.get("library_ms"),
        })
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps({
        "card": smi, "device": name, "torch": torch.__version__,
        "build_s": build_s, "kernel_rows": kernel_rows,
        "timed_rows": {k: v[0] for k, v in timed_rows.items()},
        "kernels": entries, "summary": summary, "launches": launches,
        "engine_wall_s": wall_s, "profile_phase3": profile3,
        "fused": fused, "mamba": mamba},
        indent=1, default=float))
    (out_dir / "fused_calibration.json").write_text(
        json.dumps(fused["calibration"], indent=2))
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
