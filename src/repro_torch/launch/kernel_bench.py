"""Micro-benchmarks of the port's kernels and the fused-compute calibration.

    PYTHONPATH=src python -m repro_torch.launch.kernel_bench [--smoke]
        [--device cuda|cpu] [--out PATH]

The port of ``benchmarks/kernel_bench.py``: prints ``name,us_per_call,
derived`` CSV rows for the KIVI quantize/dequantize, ``prefill_attn``,
``decode_attn`` and ``fused_prefill`` kernels, and writes the fused
calibration JSON that ``serve --fused-compute --fused-calibration`` reads
(``core.estimator.load_fused_calibration``):

* ``fused_s``: one call of the fused chunk-prefill kernel (4-bit prefix);
* ``dequant_s``: the standalone dequantize it replaces, the port's KIVI
  dequantize kernel over the stacked prefix planes (K as a (P*T, hd)
  axis-0 matrix, V as a (P*T, hd) axis-1 matrix; groups never cross
  planes because T is a multiple of the group);
* ``attn_s``: the dense two-pass attention as ONE library call on the
  same shapes, as the reference times one jitted ``chunk_prefill_ref``:
  ``scaled_dot_product_attention`` over the dequantized f32 prefix
  concatenated with the chunk (built before the clock starts), masked by
  ``chunk_prefill_ref``'s own visible mask (``attn_baseline``). It is a
  timing yardstick only: the port computes nothing through it. The eager
  plain ``chunk_prefill_ref``, several launches, is kept as the extra
  ``chunk_prefill_plain_*`` row beside the ``chunk_prefill_sdpa_*`` row.

The residual fraction (fused - attn) / dequant says how much of the
dequantize the fused kernel still pays. The TF32 flags
(``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32``) are set off, so every f32 product,
the yardstick's among them, is full f32. The JSON carries the reference's
keys plus ``device`` and ``power_limit``, with ``backend`` ``cuda`` or
``cpu``. By default it goes to ``experiments/torch/fused_calibration.json``;
the reference's ``experiments/fused_calibration.json`` is never written.

The default shapes are adaptcache-8b's full widths (32 query heads, 8 KV
heads, head dim 128, KIVI group 64); ``--smoke`` takes the reference's own
small shapes. Runs on CUDA unless ``--device cpu`` is asked for, and
raises where CUDA is asked for and absent. On the card every repetition is
timed with CUDA events and synchronized: a single synchronize after the
loop would let independent launches overlap and under-measure each (the
reference's ``timeit`` lesson). On the CPU the kernels' plain versions
run, timed on the host clock; those are CPU numbers, not device numbers.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.decode_attn import ops as decode_ops
from repro_torch.kernels.fused_prefill import ops as fused_ops
from repro_torch.kernels.fused_prefill import ref as fused_ref
from repro_torch.kernels.kivi import ops as kivi_ops
from repro_torch.kernels.prefill_attn import ops as prefill_ops

CALIBRATION_PATH = os.path.join("experiments", "torch",
                                "fused_calibration.json")
CAL_BITS = 4                  # the serving default: KIVI rate 0.16 -> 4 bits

# kivi (T, F) matrices; prefill (B, S, H, Kv, hd); decode (P, T, Gq, hd,
# group); fused (P, T, C, hd, group)
SHAPES = {
    "full": {"kivi": [(32 * 512, 1024)],
             "prefill": [(1, 4096, 32, 8, 128)],
             "decode": (8, 4096, 4, 128, 64),
             "fused": (32, 4096, 32, 128, 64)},
    "smoke": {"kivi": [(1024, 512), (4096, 1024)],
              "prefill": [(1, 512, 4, 2, 64)],
              "decode": (8, 1024, 4, 64, 64),
              "fused": (4, 512, 64, 64, 32)},
}


def make_timer(device: torch.device) -> Callable[..., float]:
    """Mean time of one call in MICROSECONDS; the warm-up call and every
    repetition finish before the next starts."""
    def time_us(fn: Callable[[], object], reps: int = 5) -> float:
        fn()
        if device.type != "cuda":
            # a benchmark of the host: real time, not simulated
            total_s = 0.0
            for _ in range(reps):
                t0 = time.perf_counter()  # simcheck: ignore[wallclock]
                fn()
                t1 = time.perf_counter()  # simcheck: ignore[wallclock]
                total_s += t1 - t0
            return total_s / reps * 1e6
        torch.cuda.synchronize(device)
        total_ms = 0.0
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize(device)
            total_ms += start.elapsed_time(end)
        return total_ms / reps * 1e3
    return time_us


def power_limit(device: torch.device) -> Optional[str]:
    """The card's power limit as nvidia-smi reports it (None on the CPU)."""
    smi = shutil.which("nvidia-smi")
    if device.type != "cuda" or smi is None:
        return None
    return subprocess.run(
        [smi, f"--id={device.index or 0}", "--query-gpu=power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def _randn(rng, shape, device) -> torch.Tensor:
    return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(device)


def quantize_planes(x: torch.Tensor, bits: int, group: int, axis: int):
    """KIVI-quantize (P, T, hd) planes in the decode_attn layout, as one
    stacked (P*T, hd) matrix. Returns (packed, scale, zero, the stacked
    ``Quantized``, the dequantized planes)."""
    p, t, hd = x.shape
    qt = kivi_ops.quantize(x.reshape(p * t, hd), bits, group, axis)
    planes = [a.reshape((p, -1) + a.shape[1:]) if axis == 0
              else a.reshape(p, t, -1)
              for a in (qt.packed, qt.scale, qt.zero)]
    dense = kivi_ops.dequantize(qt).reshape(p, t, hd)
    return (*planes, qt, dense)


def bench_kivi(rng, device, time_us, shapes, rows: List[str]) -> None:
    for t, f in shapes:
        x = _randn(rng, (t, f), device)
        for bits in (2, 4, 8):
            us = time_us(lambda: kivi_ops.quantize(x, bits, 64, 0))
            qt = kivi_ops.quantize(x, bits, 64, 0)
            nbytes = sum(a.numel() * a.element_size()
                         for a in (qt.packed, qt.scale, qt.zero))
            rows.append(f"kivi_quant_{t}x{f}_{bits}b,{us:.1f},"
                        f"ratio={nbytes / (x.numel() * 4):.3f}")
            us = time_us(lambda: kivi_ops.dequantize(qt))
            rows.append(f"kivi_dequant_{t}x{f}_{bits}b,{us:.1f},")


def bench_prefill_attn(rng, device, time_us, shapes,
                       rows: List[str]) -> None:
    for b, s, h, kv, hd in shapes:
        q = _randn(rng, (b, s, h, hd), device)
        k = _randn(rng, (b, s, kv, hd), device)
        v = _randn(rng, (b, s, kv, hd), device)
        for dtype, tag in ((torch.float32, ""), (torch.bfloat16, "_bf16")):
            qq, kk, vv = (a.to(dtype) for a in (q, k, v))
            us = time_us(lambda: prefill_ops.causal_attention(qq, kk, vv))
            rows.append(f"prefill_attn_{b}x{s}x{h}x{hd}{tag},{us:.1f},")


def bench_decode_attn(rng, device, time_us, shape, rows: List[str]) -> None:
    p, t, gq, hd, group = shape
    q = _randn(rng, (p, gq, hd), device)
    cur = torch.full((p, 1), t, dtype=torch.int32, device=device)
    for bits in (2, 4, 8):
        kp, ks, kz, _, _ = quantize_planes(_randn(rng, (p, t, hd), device),
                                           bits, group, 0)
        vp, vs, vz, _, _ = quantize_planes(_randn(rng, (p, t, hd), device),
                                           bits, group, 1)
        us = time_us(lambda: decode_ops.decode_attention_planes(
            q, kp, ks, kz, vp, vs, vz, cur, bits=bits, k_group=group,
            v_group=group))
        rows.append(f"decode_attn_{p}x{t}x{hd}_{bits}b,{us:.1f},")


def attn_baseline(q, k_prefix, v_prefix, k_chunk, v_chunk,
                  cur_len) -> Callable[[], torch.Tensor]:
    """The one library call that ``attn_s`` times: a zero-argument callable
    computing ``fused_ref.chunk_prefill_ref`` with the same arguments, as
    ``scaled_dot_product_attention`` over [prefix; chunk] keys and values
    under its visible mask, all built here, before any clock starts."""
    c, t = q.shape[-2], k_prefix.shape[-2]
    k = torch.cat([k_prefix.float(), k_chunk.float()], dim=-2)
    v = torch.cat([v_prefix.float(), v_chunk.float()], dim=-2)
    mask = fused_ref.visible_mask(t, c, cur_len, q)
    qf = q.float()
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        qf, k, v, attn_mask=mask)


def bench_fused_prefill(rng, device, time_us, shape,
                        rows: List[str]) -> Dict[str, object]:
    """Fused-kernel rows and the fused-vs-two-pass calibration split."""
    p, t, c, hd, group = shape
    q = _randn(rng, (p, c, hd), device)
    kc = _randn(rng, (p, c, hd), device)
    vc = _randn(rng, (p, c, hd), device)
    cur = torch.full((p, 1), t, dtype=torch.int32, device=device)
    cal: Dict[str, object] = {}
    for bits in (2, 4, 8):
        kp, ks, kz, kq, kd = quantize_planes(
            _randn(rng, (p, t, hd), device), bits, group, 0)
        vp, vs, vz, vq, vd = quantize_planes(
            _randn(rng, (p, t, hd), device), bits, group, 1)
        fused_us = time_us(lambda: fused_ops.chunk_prefill_planes(
            q, kp, ks, kz, vp, vs, vz, kc, vc, cur, bits=bits,
            k_group=group, v_group=group))
        dequant_us = time_us(lambda: (kivi_ops.dequantize(kq),
                                      kivi_ops.dequantize(vq)))
        attn_us = time_us(attn_baseline(q, kd, vd, kc, vc, cur))
        speedup = (dequant_us + attn_us) / max(fused_us, 1e-9)
        rows.append(f"fused_prefill_{p}x{t}x{c}x{hd}_{bits}b,"
                    f"{fused_us:.1f},speedup={speedup:.2f}")
        if bits == CAL_BITS:
            plain_us = time_us(lambda: fused_ref.chunk_prefill_ref(
                q, kd, vd, kc, vc, cur))
            rows.append(f"chunk_prefill_sdpa_{p}x{t}x{c}x{hd}_{bits}b,"
                        f"{attn_us:.1f},")
            rows.append(f"chunk_prefill_plain_{p}x{t}x{c}x{hd}_{bits}b,"
                        f"{plain_us:.1f},")
            cal = {"fused_s": fused_us * 1e-6,
                   "dequant_s": dequant_us * 1e-6,
                   "attn_s": attn_us * 1e-6,
                   "shape": f"P{p}xT{t}xC{c}xhd{hd}", "bits": bits,
                   "backend": device.type,
                   "device": (torch.cuda.get_device_name(device)
                              if device.type == "cuda" else "cpu"),
                   "power_limit": power_limit(device)}
    return cal


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; raises where CUDA is "
                         "asked for and absent")
    ap.add_argument("--out", default=CALIBRATION_PATH,
                    help="where the fused calibration JSON goes")
    ap.add_argument("--smoke", action="store_true",
                    help="the reference's small shapes instead of "
                         "adaptcache-8b's full widths")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    shapes = SHAPES["smoke" if args.smoke else "full"]
    time_us = make_timer(device)
    rng = np.random.RandomState(0)
    rows: List[str] = []
    bench_kivi(rng, device, time_us, shapes["kivi"], rows)
    bench_prefill_attn(rng, device, time_us, shapes["prefill"], rows)
    bench_decode_attn(rng, device, time_us, shapes["decode"], rows)
    cal = bench_fused_prefill(rng, device, time_us, shapes["fused"], rows)
    for r in rows:
        print(r)
    out_dir = os.path.dirname(args.out)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(cal, f, indent=2)
    print(f"# fused calibration -> {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
