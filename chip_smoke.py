#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and the repo's ``src/`` beside this file; it
imports nothing of JAX and nothing of the JAX package. Phases, each of which
stops the run with a non-zero exit when it fails:

1. build   — print the card and its power limit; build the KIVI CUDA kernel
             from ``src/repro_torch/kernels/kivi/csrc/kivi.cu``.
2. kernels — at the full-width adaptcache-8b KVData shape, a (32*T, 1024)
             f32 matrix with T = 512, for 8/4/2 bits and K-style (axis 0)
             and V-style (axis 1) grouping: the kernel's packed codes,
             scales, zeros and dequantized values are bit-equal to the
             plain torch version (``ref.py``) on the same inputs. Kernel and
             plain version are timed with CUDA events (warm-up, a
             synchronize on every repetition) beside the byte bound.
3. serving — full-width adaptcache-8b (32 layers, d_model 4096, bf16,
             seeded random weights, ~16 GB) behind ``build_engine`` with the
             fixed KIVI policy, so every insert compresses and every hit
             decompresses: ``engine.process`` on Poisson requests, then
             ``summarize``. The kernel launch counters are zeroed just
             before ``process`` and read just after; every kernel of the
             path must have launched. Then the outputs are checked: the
             summary is complete and finite, compressing a real prefill
             entry through the kernel gives the plain version's bytes, and
             the model's decode step agrees with its prefill.

The line before the last is the ``kernels`` JSON line; the last line is
``{"ok": true, "device": {...}}``. Measurements also go to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import json
import math
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
ARCH = "adaptcache-8b"
T_TOKENS = 512               # context length of the kernel phase
MAIN_BITS = 4                # KIVI rate 0.16 picks 4 bits (the served path)
RATE = 0.16
# f32 operations per element, counted from the kernels' source
QUANT_OPS = 9                # min, max, sub, div, rint, 2 clamps, shift, or
DEQUANT_OPS = 5              # shift, and, convert, fma (2)
REPLACES = {"quantize": "src/repro/kernels/kivi/kernel.py:71",
            "dequantize": "src/repro/kernels/kivi/kernel.py:99"}
SOURCE = "src/repro_torch/kernels/kivi/csrc/kivi.cu"


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


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes, t_ops = n_bytes / HBM_BPS * 1e3, n_ops / F32_OPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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


def phase_serving(kernel):
    from repro_torch.configs import get_config
    from repro_torch.core.compression import KIVICompression
    from repro_torch.models import build_model
    from repro_torch.serving.baselines import build_engine
    from repro_torch.serving.engine import summarize
    from repro_torch.serving.runner import ModelRunner
    from repro_torch.serving.workload import make_contexts, poisson_requests

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

    rng = np.random.RandomState(0)
    contexts = make_contexts(rng, cfg.vocab_size, 1, min_len=384,
                             max_len=640, n_probes=2)
    requests = poisson_requests(rng, contexts, rate_hz=1.0, duration_s=8.0)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ssd_") as ssd_root:
        rig = build_engine(runner, contexts, cfg,
                           model.active_param_count(), policy=("kivi", RATE),
                           dram_entries=1.5, ssd_entries=6.0,
                           ssd_root=ssd_root)
        for k in kernel.LAUNCHES:
            kernel.LAUNCHES[k] = 0
        t0 = time.perf_counter()
        results = rig.engine.process(requests)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = dict(kernel.LAUNCHES)
    summary = summarize(results, selector_stats=rig.controller.selector.stats)
    print(f"  {len(contexts)} contexts of "
          f"{[len(c.tokens) for c in contexts]} tokens, {len(requests)} "
          f"requests, engine.process {wall_s:.2f} s wall")
    print("  summary (TTFT is simulated on the reference's A100 TimeModel, "
          "not measured on this card):")
    for k, v in summary.items():
        print(f"    {k:28s} {v}")
    print(f"  kernel launches during engine.process: {launches}")
    missing = [k for k, n in launches.items() if n <= 0]
    if missing:
        fail(f"main path never launched {missing}")

    # outputs: complete, finite, answered
    if summary.get("n") != len(requests) or len(results) != len(requests):
        fail(f"summary counts {summary.get('n')} of {len(requests)} requests")
    bad = [k for k, v in summary.items()
           if isinstance(v, float) and not math.isfinite(v)]
    if bad:
        fail(f"non-finite summary values: {bad}")
    if not 0.0 <= summary["quality_mean"] <= 1.0:
        fail(f"quality_mean {summary['quality_mean']} outside [0, 1]")
    if summary["hit_rate"] <= 0.0:
        fail("no request hit the cache: decompress never served")
    if any(len(r.answer) == 0 for r in results):
        fail("a request produced no answer tokens")

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
    toks = torch.as_tensor(contexts[0].tokens[:64], device="cuda")[None]
    want, _ = model.prefill(params, {"tokens": toks}, capacity=128)
    _, cache = model.prefill(params, {"tokens": toks[:, :-1]}, capacity=128)
    got, _ = model.decode_step(params, cache, 63, toks[:, -1:])
    want, got = want.float()[0, -1], got.float()[0, -1]
    rel = float((want - got).abs().max() / want.abs().max())
    if not (torch.isfinite(got).all() and rel < 5e-2):
        fail(f"decode step disagrees with prefill: max rel err {rel:.3g}")
    print(f"  decode step vs prefill logits (bf16): max rel err {rel:.3g}")
    return summary, launches


def main() -> int:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a "
             "CUDA card")
    from repro_torch.kernels.kivi import kernel, ref
    from repro_torch.kernels.kivi.ref import Quantized

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")

    print("[1/3] build")
    shutil.rmtree(kernel.BUILD_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    lib, log = kernel.build()
    build_s = time.perf_counter() - t0
    print(f"  built {lib.relative_to(ROOT)} in {build_s:.1f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    print("[2/3] kernels against the plain version (bit-equal)")
    kernel_rows, worst = phase_kernels(kernel, ref, Quantized)

    print("[3/3] serving full-width adaptcache-8b through build_engine")
    summary, launches = phase_serving(kernel)

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
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps({
        "card": smi, "device": name, "torch": torch.__version__,
        "build_s": build_s, "kernel_rows": kernel_rows,
        "kernels": entries, "summary": summary, "launches": launches},
        indent=1, default=float))
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
