#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and the repo's ``src/`` beside this file; it
imports nothing of JAX and nothing of the JAX package. Phases, each of which
stops the run with a non-zero exit when it fails:

1. build   — print the card, its power limit and its total memory (the
             roofline's ``HBM_BYTES`` beside it); build the five CUDA
             libraries (``kivi``, ``decode_attn``, ``fused_prefill``,
             ``flash_attn``, ``selective_scan`` under
             ``src/repro_torch/kernels/*/csrc/``), one ``nvcc`` each, all
             started together, and print each kernel's registers and
             spills as ptxas reports them.
2. kernels — at full-width adaptcache-8b shapes, each kernel against its
             plain torch version (``ref.py``) on the same inputs on the card:
             KIVI quantize/dequantize bit-equal on a (32*512, 1024) f32
             matrix for 8/4/2 bits and both groupings, timed as device time
             (CUDA-graph replays) beside the time of one call (events, the
             host's wrapper included), and quantize and dequantize
             bit-equal at layouts outside the model's (K groups staged in
             pieces, a ragged K column count, V groups of 24, of 3 bytes'
             codes and of 1024); decode_attn (8 planes, 4 query rows, 4096
             tokens, hd 128: its one-launch kernel ``decode_ring``) and
             fused_prefill (32 planes, a 32-token chunk over 4096 packed
             tokens; at hd 128 its tensor-core kernel ``fused_mma``) for
             8/4/2 bits and valid lengths T, partial and 0, within rtol
             1e-4 / atol 2e-4, with bytes past the valid length set to 255
             changing nothing, and the same checks of ``decode_ring`` at
             its other paths (T not a multiple of 16: a K group of 12 over
             4092 tokens; codes 1 byte past an aligned address; 1 and 32
             query rows; groups of 2 and of 1, rings of 2 and 1 stages),
             one launch a call, and of fused_prefill's CUDA-core kernel
             ``fused_split`` at hd 8 and at a K group of 12;
             flash_attention (S 4096, 32 heads over 8 KV heads) through
             each of its three kernels, each launch counted: f32 inputs
             (the tensor-core kernel ``flash_fwd_mma_f32``), bf16 inputs
             (``flash_fwd_mma``) and a misaligned f32 copy (the CUDA-core
             ``flash_fwd``), within the same tolerance, and f32 at S 1000
             with hd 64 and 16 (the tensor cores) and hd 8 (the CUDA
             cores), q scaled by 1 and 8. Each is
             timed with CUDA events (warm-up, a synchronize on every
             repetition) beside its plain version, its bound and, for
             flash_attention, PyTorch's ``scaled_dot_product_attention`` in
             the same type (f32 with TF32 off, and bf16); the attention
             kernels and their plain versions also as device time
             (CUDA-graph replays, without the host's share). The bf16
             flash row's bound is at the bf16 tensor-core rate, the f32
             rows' at the TF32 rate, each with the floor of its
             tensor-core form beside it at the bf16 rate (the two-part P,
             1.5 times the products; three-part scores and two-part P V,
             4.5 times; three products of two-part operands throughout, 3
             times, beside the f32 rows); so is fused_prefill's. At 4
             bits, ``torch.profiler`` divides each call's time between the
             kernels it launches: decode_attn's one, fused_prefill's split
             pass and merge.
             The selective scan at full-width falcon-mamba-7b shapes
             (D 8192, N 16): (B 1, S 640), (B 1, S 4096) and (B 2,
             S 577, h0 != 0), y and hT within rtol 1e-4 / atol 1e-4, timed
             the same way, beside its byte bound and its SFU floor (one
             exponential a (t, d, n) step at 16 a clock on each SM). The
             scan's backward kernel at the same three cases and at the
             training shape (B 2, S 512), with a random dy and the gradient
             of hT absent and present, against the plain backward: each
             gradient within 1e-4 of its largest magnitude, two calls
             bit-equal; timed the same way beside its bound.
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
             of decode_attn, fused_prefill and flash_attention, and the
             counts of flash_attention's three kernels and fused_prefill's
             tensor-core launches, are zeroed just before and must each be
             above 0 just after: kernel_bench times f32 attention through
             a misaligned copy too, which the CUDA-core kernel takes; every
             decode_attn call must have been one launch, and every
             fused_prefill call, all at hd 128, must have taken the
             tensor-core kernel); phase 3's
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
             is then profiled as in phase 3. The tiers count each entry's
             fixed state (``ModelConfig.state_bytes``), so a reused
             document may hit; hits are not required. A real prefill's
             ``ssm``/``conv`` state is
             compressed through the kernel (at 4 bits and at the served
             rate's bits) and decompressed, bit-equal to the plain version,
             and generation from the decompressed state must answer. The
             decode step must agree with the prefill in f32 (the same
             weights widened), within a relative logit error of 1e-4; the
             bf16 error is printed beside it.
6. training — after phase 5's model is freed (the memory left is printed):
             (a) smoke adaptcache-8b in f32 takes 5 steps of
             ``make_train_step`` on the card and on the CPU from one init,
             on the recall pipeline (seq 192, batch 8) under the serve
             driver's WSD schedule: each step's loss within 1e-3 relative,
             the first grad norm within 1e-4. The train driver
             (``repro_torch.launch.train``) takes 20 smoke steps on the card
             with a checkpoint every 10, then resumes from step 20, its
             leaves bit-equal to the saved ones. (b) full-width
             adaptcache-8b (8.03 B params, bf16, int8 AdamW state, remat,
             seeded init) on the recall pipeline at batch 2 x seq 512: the
             chunked loss of step 0 against the plain cross-entropy of
             ``Model.forward`` (1e-3 relative), then 4 timed steps, each
             printed with its loss, grad norm, wall time (synchronized;
             ``adamw_update``'s share beside it), tokens/s, peak memory and
             model FLOPs share (6 N tokens over the step time at 989
             TFLOP/s); every loss and grad norm must be finite and every
             leaf must change in the first step. One more step is profiled
             as in phase 3. Training adaptcache-8b reaches no hand-written
             kernel.
7. mamba training — after phase 6 frees its model: (a) smoke
             falcon-mamba-7b in f32, 5 steps on the card and on the CPU
             from one init, held as in phase 6 (a): the card's steps run the
             scan's forward with checkpoints and its backward kernel. Then
             the serve driver (``repro_torch.launch.serve --arch
             falcon-mamba-7b``) trains the smoke model for its default 150
             steps on the card and serves it. (b) full-width falcon-mamba-7b
             (64 layers, 7,006,326,784 seeded params, bf16, int8 AdamW state,
             remat) on the recall pipeline at batch 2 x seq 512, as phase 6
             (b) but at lr 1e-2 (dt_bias, bf16 at magnitudes up to 6.9,
             moves only past half its ulp, 2^-7 to 2^-6; at 3e-3 it cannot
             move): the scan's counters are zeroed just before the second
             step and read just after: 128 forward launches (each layer
             twice under remat) and 64 backward calls.
8. moe     — after phase 7 frees its model: full-width olmoe-1b-7b (16
             layers, d_model 2048, 64 experts top-8 of width 1024, GQA 16
             heads, bf16, 6.92 B seeded params) serves phase 3's workload
             through ``build_engine`` with the fixed KIVI policy. The KIVI
             counters are zeroed just before ``engine.process`` and read
             just after: each form the entry's layout needs must have
             launched (``check_kivi_launches``: K-style grouping for ``k``,
             V-style for every other array; here all four), the summary
             must show hits, and one request (a miss) is profiled as in
             phase 3, with the device time and the host time of the MoE
             routing (the ``moe.route`` span of ``models/moe.py``, traced
             by ``repro_torch.runtime.trace``: routing, the sort and the
             wait for each expert's row count).
             A real prefill entry's compress and decompress through the
             kernel are bit-equal to the plain version. The decode step
             against the prefill is printed in bf16 and held in f32 within
             1e-4 relative: the f32 model is the same seed's init in f32
             (the bf16 weights before their rounding) at full depth, built
             after the bf16 model is freed; the smallest gap between a
             router's k-th and (k+1)-th probability is printed beside it.
9. mla     — the same for full-width deepseek-v2-lite-16b (27 layers, one
             dense prefix layer, MLA latent rank 512 and rope dim 64, 64
             routed + 2 shared experts top-6, 15.71 B params; its f32 model,
             62.8 GB, fits only once the bf16 one is freed). Its entry is
             the latent (``ckv``, ``krope``), which KIVI groups along
             features only: the ``_cols`` kernels (the ``_v`` counters)
             must launch, and the ``_rows`` ones (``_k``) must count
             exactly 0, which the check says.
10. vlm    — the same for full-width internvl2-1b (24 layers, d_model
             896, GQA 14 over 2 heads, 494,556,160 params; no MoE, so no
             expert fields or routing gaps), served text-only as the
             reference serves it: both KIVI forms launch. Then, on the
             bf16 model (printed) and on the same seed's f32 model (held):
             256 seeded patch embeddings in front of 63 tokens, the decode
             step at slot 256 + 63 against the prefill of 256 + 64 within
             1e-4; and the packed-uint8 quantized decode cache (eager
             torch, no kernel): 64 tokens decoded one by one at 8, 4 and 2
             bits against the exact decode of the 64th, 8 bits within 0.02
             and the error monotone in bits, the 4-bit leaf uint8 of width
             hd/2, a decode step's time at each width.
11. encdec — full-width seamless-m4t-large-v2 (24 encoder + 24 decoder
             layers, d_model 1024, 2,034,784,256 params, bf16) through the
             model's entry points (neither serve driver can serve it):
             seeded stub frames (1, 1024, 1024), phase 3's first context
             (556 tokens), capacity 1024. ``encode``, the prefill and 32
             decode steps timed with CUDA events, one decode step
             profiled, the cross cache's shape and bytes printed; the
             decoder's entry (``cache_to_kvdata``: K and V of (24, 556,
             1024), the cross cache dropped, as the reference drops it)
             through the KIVI kernels bit-equal to the plain version,
             every form launched; the decode step against the prefill
             over the frames in bf16 (printed) and in f32 (the same seed's
             f32 init, held within 1e-4).
12. launch — (a) the dry run (``repro_torch.launch.dryrun``) of
             qwen3-1.7b x train_4k, olmoe-1b-7b x decode_32k and
             falcon-mamba-7b x long_500k on the fake (16, 16) mesh and
             jamba-1.5-large-398b x train_4k (int8 state) on (2, 16, 16),
             each in its own process on this host's CPU (its fake group
             never shares a process with the card's NCCL group), each held
             to ``ok`` and its row printed: FLOPs, HBM and collective bytes
             a chip, the three terms, the bottleneck, the analytic peak
             against the card's memory; (b) on a process group of one
             (NCCL) and ``make_host_mesh("cuda")``: full-width olmoe-1b-7b
             in f32 with its params wrapped as DTensors (no copy), a
             prefill of phase 3's 556-token context and 16 greedy decode
             steps through ``moe_fwd_ep``, each step's logits within 1e-4
             of the same steps on plain tensors (``moe_fwd``), a decode
             step's time both ways; full-width falcon-mamba-7b in bf16, a
             prefill of 556 tokens with DTensor params: 64 scan launches
             on the local shards, logits bit-equal to the plain prefill;
             (c) the step counter's FLOPs of the olmoe decode step on the
             card equal to its count on meta tensors, the step's time
             beside its roofline (one card, ``launch.roofline``).

The line before the last is the ``kernels`` JSON line (eleven entries,
each with its own kernel's launches: phase 3's for KIVI, phase 4's for the
attention kernels, flash_attention's f32 tensor-core, bf16 tensor-core
and CUDA-core kernels as three entries, phase 5's for the scan, phase 7's
counted step for ``selective_scan_bwd``; the scan's also counts phase
12's, with ``launches_by_phase``), and the seven
before it phase 6's ``training``, phase 7's ``mamba_training``, phase 8's
``moe_serving``, phase 9's ``mla_serving``, phase 10's ``vlm_serving``,
phase 11's ``encdec`` and phase 12's ``launch`` summaries (launches, wall
times, idle shares, the dry-run rows); the
last line is
``{"ok": true, "device": {...}}``. Every ``serve`` traces its decode
steps and fails unless each one replays the runner's CUDA graph
(``check_decode_graph``); their counts print as ``decode_graph``.
Measurements also go to
``chiprun_out/chip_smoke.json``.
The measured fused calibration goes beside it (``fused_calibration.json``).
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
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
T_START = time.perf_counter()

from repro_torch.runtime import trace  # noqa: E402

HBM_BPS = 3.35e12            # H100 SXM HBM3, NVIDIA data sheet
F32_OPS = 67e12              # H100 SXM f32 outside the tensor cores
TF32_OPS = 495e12            # H100 SXM dense TF32 tensor cores
BF16_OPS = 989e12            # H100 SXM dense bf16 tensor cores
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
MOE_ARCH = "olmoe-1b-7b"               # phase 8: MoE, GQA
MLA_ARCH = "deepseek-v2-lite-16b"      # phase 9: MLA, MoE, a dense prefix
VLM_ARCH = "internvl2-1b"              # phase 10: patches, GQA 14 / 2
ENCDEC_ARCH = "seamless-m4t-large-v2"  # phase 11: encoder-decoder
HOST_RANGES = trace.SPANS              # the port's record_function ranges
DECODE_GRAPH: list = []                # each serve's decode counters
REPLACES = {"quantize": "src/repro/kernels/kivi/kernel.py:71",
            "dequantize": "src/repro/kernels/kivi/kernel.py:99",
            "decode_attn": "src/repro/kernels/decode_attn/kernel.py:133",
            "fused_prefill": "src/repro/kernels/fused_prefill/kernel.py:127",
            "flash_attention": "src/repro/kernels/prefill_attn/kernel.py:73",
            "selective_scan": "src/repro/kernels/mamba_scan/kernel.py:76",
            "selective_scan_bwd": "jax.grad of src/repro/models/mamba.py:121"}
SOURCE = "src/repro_torch/kernels/kivi/csrc/kivi.cu"
SOURCES = {"decode_attn": "src/repro_torch/kernels/decode_attn/csrc/"
                          "decode_attn.cu",
           "fused_prefill": "src/repro_torch/kernels/fused_prefill/csrc/"
                            "fused_prefill.cu",
           "flash_attention": "src/repro_torch/kernels/prefill_attn/csrc/"
                              "flash_attn.cu",
           "selective_scan": "src/repro_torch/kernels/mamba_scan/csrc/"
                             "selective_scan.cu",
           "selective_scan_bwd": "src/repro_torch/kernels/mamba_scan/csrc/"
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
# the scan's backward: SCAN's cases and the training shape (full-width
# falcon-mamba at batch 2 x 512); each gradient within rtol 1e-4 and an atol
# of 1e-4 times its largest magnitude (the forward's tolerance: it
# recomputes the forward's states with the kernel's expf, and sums dB and dC
# over D channels, da over B S steps, in another order)
SCAN_BWD = SCAN + (dict(b=2, s=512, d=8192, n=16, h0=0.0),)
SCAN_BWD_TOL = 1e-4
GRADS = ("ddt", "dx", "dbs", "dcs", "da", "dh0")
DECODE_TOL_F32 = 1e-4   # the port's f32 logit tolerance (CPU parity tests)
# phase 6: smoke training on the card against the CPU (f32, the serve
# driver's recall pipeline and schedule), then full-width adaptcache-8b
SMOKE_TRAIN_STEPS, SMOKE_SEQ, SMOKE_BATCH = 150, 192, 8
CARD_CPU_LOSS_RTOL = 1e-3       # each step's loss
CARD_CPU_GNORM_RTOL = 1e-4      # the first step's grad norm
FULL_SEQ, FULL_BATCH, TRAIN_STEPS = 512, 2, 4
FULL_TRAIN_LR = 3e-3            # the smoke schedule's peak: bf16 leaves move
# falcon-mamba's dt_bias is stored in bf16 at magnitudes 2.3-6.9 (the
# inverse softplus of 0.001-0.1), where a step moves an element only past
# half its ulp, 2^-7 to 2^-6: at 1e-2 the elements under 4 in magnitude move
MAMBA_TRAIN_LR = 1e-2
CE_RTOL = 1e-3                  # chunked loss against the plain one


def ptxas_usage(log: str):
    """(kernel, "N registers, S bytes spill stores, L bytes spill loads")
    for each kernel in ``nvcc -Xptxas -v`` output; names are demangled by
    ``c++filt`` where it exists."""
    out, name, spill = [], "?", ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            if shutil.which("c++filt"):
                full = subprocess.run(["c++filt", name], capture_output=True,
                                      text=True).stdout
                m = re.search(r"(\w+(?:<[^()]*>)?)\(", full)
                name = m.group(1) if m else name
        elif "spill stores" in line:
            spill = ", ".join(x.strip() for x in line.split(",")[1:])
        elif "registers" in line:
            regs = re.search(r"Used (\d+) registers", line)
            out.append((name, f"{regs.group(1) if regs else '?'} registers, "
                              f"{spill}"))
    return out


def elapsed() -> str:
    return f"{time.perf_counter() - T_START:.0f} s since start"


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
    # captured on the warm-up's stream: decode_attn's arrival counters are
    # made by the first call on a stream, which cannot be captured
    with torch.cuda.graph(graph, stream=side):
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


def kernel_us(fn, calls: int = 20) -> dict:
    """Device time of each kernel that ``calls`` calls of ``fn`` launch, in
    microseconds a call, by ``torch.profiler`` (CUDA activity): how a
    call's time divides between its kernels (fused_prefill's split pass
    and its merge)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    dev = lambda e: (getattr(e, "device_time_total", 0)
                     or getattr(e, "cuda_time_total", 0))
    return {e.key[:60]: dev(e) / calls for e in prof.key_averages()
            if dev(e) > 0}


def bound_ms(n_bytes: float, n_ops: float, ops_rate: float = F32_OPS):
    t_bytes, t_ops = n_bytes / HBM_BPS * 1e3, n_ops / ops_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def attention_bound(n_bytes: float, flops: float,
                    ops_rate: float = TF32_OPS) -> dict:
    """The least time for an attention kernel: its bytes over the memory
    rate or its matrix-product operations over the tensor cores' rate for
    its inputs (TF32 for f32, unless given), whichever is larger; beside
    it the f32 CUDA-core time of the same operations, the rate the f32
    kernels run at."""
    t, by = bound_ms(n_bytes, flops, ops_rate)
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
                  group: int, v_group: int | None = None):
    """Random K and V planes (P, T, hd), KIVI-packed on the card in the
    decode_attn layout: [k_packed, k_scale, k_zero, v_packed, v_scale,
    v_zero]; V in groups of ``v_group`` where given, else ``group``."""
    from repro_torch.launch.kernel_bench import quantize_planes
    gen = torch.Generator(device="cuda").manual_seed(seed)
    k = torch.randn((p, t, hd), generator=gen, device="cuda")
    v = torch.randn((p, t, hd), generator=gen, device="cuda")
    return (list(quantize_planes(k, bits, group, 0)[:3])
            + list(quantize_planes(v, bits, v_group or group, 1)[:3]))


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
                           io_floats: int, flops: float, seed: int,
                           ops_rate: float = TF32_OPS, split: float = 0.0):
    """decode_attn or fused_prefill at ``dims``: the kernel against its
    plain version for 8/4/2 bits and every valid-length case, the tail
    check, and the timings. ``kernel_fn(packs, cur_len, **kw)`` and
    ``plain_fn`` run one call on the packed planes; ``io_floats`` counts
    the f32 values of the call's dense inputs and output. The bound takes
    the products at ``ops_rate``; a kernel that multiplies two-part bf16
    operands gets the floor of its ``split`` times the products beside
    it."""
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
               **attention_bound(n_bytes, flops, ops_rate)}
        if bits == MAIN_BITS:
            row["kernel_us"] = kernel_us(kern)
        floor = ""
        if split:
            row["split_floor_ms"] = split * flops / BF16_OPS * 1e3
            floor = f", two-part floor {row['split_floor_ms']:.4f}"
        rows.append(row)
        print(f"  {name} bits={bits} {dims}: within tolerance for cur_len "
              f"T / partial / 0, tail bytes ignored; device "
              f"{row['ms']:.4f} ms (plain {row['plain_ms']:.4f}, bound "
              f"{row['bound_ms']:.4f} by {row['bound_by']}{floor}, f32 cores "
              f"{row['f32_core_ms']:.4f}); per call {row['call_ms']:.4f} "
              f"ms (plain {row['plain_call_ms']:.4f})")
        for kname, us in row.get("kernel_us", {}).items():
            print(f"    {us:9.3f} us a call  {kname}")
    return rows, worst


def decode_call(ops, kernel, launches: int, what: str):
    """``ops.decode_attention_planes`` that fails unless the call launched
    ``launches`` kernels (decode_ring: 1)."""
    def call(*args, **kw):
        before = kernel.LAUNCHES["decode_attn"]
        out = ops.decode_attention_planes(*args, **kw)
        if kernel.LAUNCHES["decode_attn"] - before != launches:
            fail(f"decode_attn {what}: "
                 f"{kernel.LAUNCHES['decode_attn'] - before} launches a "
                 f"call, expected {launches}")
        return out
    return call


def phase_decode_attn(ops, ref):
    from repro_torch.kernels.decode_attn import kernel
    d = DECODE
    p, gq, t, hd = d["p"], d["gq"], d["t"], d["hd"]
    gen = torch.Generator(device="cuda").manual_seed(7)
    q = torch.randn((p, gq, hd), generator=gen, device="cuda")
    call = decode_call(ops, kernel, 1, f"at {d}")
    return phase_packed_attention(
        "decode_attn", d,
        lambda packs, cur, **kw: call(q, *packs, cur, **kw),
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
        seed=10, ops_rate=BF16_OPS, split=3.0)


def phase_fused_split(ops, ref, kernel):
    """fused_prefill's CUDA-core kernel, ``fused_split``, which takes the
    layouts the tensor-core kernel does not: hd 8, and at hd 128 a K group
    of 12 tokens (not a multiple of 8), each at P 32, C 32 over about 4096
    packed tokens. Within tolerance against the plain version for 8/4/2
    bits and valid lengths T, partial and 0, tail bytes ignored; the
    tensor-core count must not move. Returns the largest error."""
    p, c = FUSED["p"], FUSED["c"]
    worst = 0.0
    for hd, t, kg, vg in ((8, 4096, 64, 8), (128, 4080, 12, 64)):
        gen = torch.Generator(device="cuda").manual_seed(12 + hd)
        q, kc, vc = (torch.randn((p, c, hd), generator=gen, device="cuda")
                     for _ in range(3))
        lens = valid_lengths(p, t)
        before = kernel.LAUNCHES["fused_prefill_mma"]
        for bits in (8, 4, 2):
            packs = packed_planes(20 + bits, p, t, hd, bits, kg, vg)
            kw = dict(bits=bits, k_group=kg, v_group=vg)
            outs = {}
            for case, cur in lens.items():
                outs[case] = ops.chunk_prefill_planes(q, *packs, kc, vc, cur,
                                                      **kw)
                worst = max(worst, close_err(
                    f"fused_split hd={hd} groups {kg}/{vg} bits={bits} "
                    f"cur_len={case}", outs[case],
                    ref.chunk_prefill_planes_ref(q, *packs, kc, vc, cur,
                                                 **kw)))
            spoiled = spoil_tail(packs, lens["partial"], bits)
            if not torch.equal(ops.chunk_prefill_planes(
                    q, *spoiled, kc, vc, lens["partial"], **kw),
                    outs["partial"]):
                fail(f"fused_split hd={hd} bits={bits}: bytes past cur_len "
                     "changed the output")
        if kernel.LAUNCHES["fused_prefill_mma"] != before:
            fail(f"fused_prefill at hd={hd}, groups {kg}/{vg} took the "
                 "tensor-core kernel")
        print(f"  fused_split (P, C, T, hd)=({p}, {c}, {t}, {hd}), groups "
              f"{kg}/{vg}: within tolerance for 8/4/2 bits and cur_len T / "
              f"partial / 0, tail bytes ignored, none on fused_mma")
    print(f"  fused_split max abs err {worst:.3g}")
    return worst


def phase_decode_layouts(ops, ref, kernel):
    """decode_ring's other paths at P 8, hd 128, each one launch a call: T
    not a multiple of 16 (a K group of 12 over 4092 tokens: parts of a
    stage copied 4 bytes at a time), packed planes 1 byte past an aligned
    address (the codes copied a byte at a time), 1 query row and 32 (four
    row blocks of 8), and groups of 2 (a ring of 2 stages) and of 1 at 8
    bits (1 stage). Within tolerance against the plain version for the
    case's bit widths and valid lengths T, partial and 0, tail bytes
    ignored. Returns the largest error."""
    p, hd = DECODE["p"], DECODE["hd"]
    worst = 0.0
    for gq, t, kg, vg, offset, widths in (
            (4, 4092, 12, 64, 0, (8, 4, 2)), (4, 4096, 64, 64, 1, (8, 4, 2)),
            (1, 4096, 64, 64, 0, (8, 4, 2)), (32, 4096, 64, 64, 0, (8, 4, 2)),
            (4, 4096, 2, 2, 0, (4,)), (8, 4096, 1, 1, 0, (8,))):
        gen = torch.Generator(device="cuda").manual_seed(40 + gq)
        q = torch.randn((p, gq, hd), generator=gen, device="cuda")
        lens = valid_lengths(p, t)
        what = (f"decode_ring (P, Gq, T, hd)=({p}, {gq}, {t}, {hd}), groups "
                f"{kg}/{vg}, codes {offset} byte(s) past an aligned address")
        call = decode_call(ops, kernel, 1, what)

        def shift(planes):
            """The packed codes ``offset`` bytes past an aligned address."""
            if not offset:
                return planes
            out = list(planes)
            for i in (0, 3):
                buf = torch.empty(planes[i].numel() + offset,
                                  dtype=torch.uint8, device="cuda")
                out[i] = buf[offset:].view(planes[i].shape)
                out[i].copy_(planes[i])
            return out

        for bits in widths:
            packs = shift(packed_planes(30 + bits, p, t, hd, bits, kg, vg))
            kw = dict(bits=bits, k_group=kg, v_group=vg)
            outs = {}
            for case, cur in lens.items():
                outs[case] = call(q, *packs, cur, **kw)
                worst = max(worst, close_err(
                    f"{what} bits={bits} cur_len={case}", outs[case],
                    ref.decode_attention_planes_ref(q, *packs, cur, **kw)))
            spoiled = shift(spoil_tail(packs, lens["partial"], bits))
            if not torch.equal(call(q, *spoiled, lens["partial"], **kw),
                               outs["partial"]):
                fail(f"{what} bits={bits}: bytes past cur_len changed the "
                     "output")
        print(f"  {what}: within tolerance for {widths} bits and cur_len T /"
              f" partial / 0, tail bytes ignored, one launch a call")
    print(f"  decode_attn's other layouts: max abs err {worst:.3g}")
    return worst


# flash attention's kernels at FLASH: (row name, input type, misaligned
# copy, the LAUNCHES key of the kernel the C entry must pick)
FLASH_FORMS = (("f32", torch.float32, False, "flash_attention_mma_f32"),
               ("bf16", torch.bfloat16, False, "flash_attention_mma"),
               ("f32_cores", torch.float32, True, "flash_attention_cores"))
# more layouts held to the plain version (not timed): ragged S at head dims
# 64 and 16 on the tensor cores, hd 8 on the CUDA cores
FLASH_CHECKS = ((dict(FLASH, s=1000, hd=64), "flash_attention_mma_f32"),
                (dict(FLASH, s=1000, hd=16), "flash_attention_mma_f32"),
                (dict(FLASH, s=1000, hd=8), "flash_attention_cores"))


def misaligned(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of CUDA tensor ``t`` whose data starts 4 bytes past
    a 16-byte boundary: a layout that the attention kernels' tensor-core
    forms refuse, so the CUDA-core form takes it."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def flash_call(ops, kernel, key: str, qq, kk, vv):
    """One counted call of the attention: fails unless the C entry launched
    the kernel that ``key`` counts."""
    before = kernel.LAUNCHES[key]
    got = ops.causal_attention(qq, kk, vv)
    if kernel.LAUNCHES[key] != before + 1:
        fail(f"flash_attention {tuple(qq.shape)} {qq.dtype} did not launch "
             f"the kernel {key} counts")
    return got


def phase_flash_attention(ops, ref, kernel):
    """Each of flash attention's three kernels at FLASH against the plain
    version, timed beside its bound, the plain version and SDPA in the same
    type; then FLASH_CHECKS."""
    import torch.nn.functional as F

    fa = FLASH
    b, s, h, kv, hd = fa["b"], fa["s"], fa["h"], fa["kv"], fa["hd"]
    gen = torch.Generator(device="cuda").manual_seed(9)
    q = torch.randn((b, s, h, hd), generator=gen, device="cuda")
    k = torch.randn((b, s, kv, hd), generator=gen, device="cuda")
    v = torch.randn((b, s, kv, hd), generator=gen, device="cuda")
    rows, worst = [], 0.0
    for label, dtype, shift, key in FLASH_FORMS:
        qq, kk, vv = ((misaligned(x) if shift else x.to(dtype))
                      for x in (q, k, v))
        got = flash_call(ops, kernel, key, qq, kk, vv)
        want = ref.causal_attention_gqa_ref(qq, kk, vv)
        err = close_err(f"flash_attention {label}", got, want)
        worst = max(worst, err)
        es = qq.element_size()
        n_bytes = (b * s * h * hd * es + 2 * b * s * kv * hd * es
                   + b * s * h * hd * 4)
        kern = lambda: ops.causal_attention(qq, kk, vv)
        plain = lambda: ref.causal_attention_gqa_ref(qq, kk, vv)
        flops = 4 * b * h * hd * s * (s + 1) / 2
        bf16 = dtype == torch.bfloat16
        row = {"dtype": label, "kernel": key, "shape": dict(fa),
               "max_abs_err": err, "ms": device_ms(kern, calls=2),
               "plain_ms": device_ms(plain, calls=1),
               "call_ms": time_ms(kern, reps=10),
               "plain_call_ms": time_ms(plain, reps=3),
               **attention_bound(n_bytes, flops,
                                 BF16_OPS if bf16 else TF32_OPS),
               # the tensor-core forms' floors at the bf16 rate: P's two
               # parts multiply V (bf16, 1.5 times the products); six
               # products of three-part q and K for the scores and three of
               # two-part P and V (f32, 4.5 times), beside three products
               # of two-part operands throughout (3 times)
               "split_floor_ms": (1.5 if bf16 else 4.5) * flops / BF16_OPS
               * 1e3}
        if not bf16:
            row["three_product_floor_ms"] = 3 * flops / BF16_OPS * 1e3
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
        print(f"  flash_attention {label} ({key}) (B, S, H, Kv, hd)=({b}, "
              f"{s}, {h}, {kv}, {hd}): within tolerance (max abs err "
              f"{err:.3g}); device "
              f"{row['ms']:.4f} ms (plain {row['plain_ms']:.4f}, sdpa "
              f"{row['library_ms']:.4f}, bound {row['bound_ms']:.4f} by "
              f"{row['bound_by']}, tensor-core form's floor "
              f"{row['split_floor_ms']:.4f}"
              + (f", three products' floor "
                 f"{row['three_product_floor_ms']:.4f}" if not bf16 else "")
              + f", f32 cores "
              f"{row['f32_core_ms']:.4f}); per call {row['call_ms']:.4f} ms "
              f"(plain {row['plain_call_ms']:.4f})")
    for case, key in FLASH_CHECKS:
        b, s, h, kv, hd = (case[n] for n in ("b", "s", "h", "kv", "hd"))
        gen = torch.Generator(device="cuda").manual_seed(10)
        for q_scale in (1.0, 8.0):
            qq = torch.randn((b, s, h, hd), generator=gen,
                             device="cuda") * q_scale
            kk = torch.randn((b, s, kv, hd), generator=gen, device="cuda")
            vv = torch.randn((b, s, kv, hd), generator=gen, device="cuda")
            got = flash_call(ops, kernel, key, qq, kk, vv)
            err = close_err(f"flash_attention {case} q x {q_scale}", got,
                            ref.causal_attention_gqa_ref(qq, kk, vv))
            worst = max(worst, err)
            print(f"  flash_attention f32 (B, S, H, Kv, hd)=({b}, {s}, {h}, "
                  f"{kv}, {hd}), q x {q_scale} ({key}): within tolerance "
                  f"(max abs err {err:.3g})")
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


def scan_bwd_bytes(b: int, s: int, d: int, n: int) -> int:
    """Bytes the vector-Jacobian product must move without dhT, whatever the
    kernel's design: dt, x, dy, B, C, a and h0 read once, the six gradients
    written once. The checkpoints that a kernel reads besides are its own
    choice and not counted."""
    reads = 3 * b * s * d + 2 * b * s * n + d * n + b * d * n
    writes = 2 * b * s * d + 2 * b * s * n + d * n + b * d * n
    return 4 * (reads + writes)


def phase_selective_scan_bwd(kernel, ref):
    """The scan's backward kernel against the plain backward at each case of
    ``SCAN_BWD``, with a random dy and dhT absent and present: each gradient
    within ``SCAN_BWD_TOL`` of its largest magnitude, two calls bit-equal.
    Timed with dhT absent (training drops hT) as the forward is, beside its
    bound: the bytes, or one exponential a (b, t, d, n) on the SFU, whichever
    is larger."""
    clock = sm_clock_hz()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows, worst = [], 0.0
    for i, case in enumerate(SCAN_BWD):
        b, s, d, n = case["b"], case["s"], case["d"], case["n"]
        args = scan_inputs(case, seed=60 + i)
        _, _, ckpt = kernel.selective_scan(*args, checkpoints=True)
        gen = torch.Generator(device="cuda").manual_seed(70 + i)
        dy = torch.randn((b, s, d), generator=gen, device="cuda")
        dht = torch.randn((b, d, n), generator=gen, device="cuda")
        errs = {}
        for dh in (None, dht):
            got = kernel.selective_scan_bwd(*args[:5], ckpt, dy, dh)
            again = kernel.selective_scan_bwd(*args[:5], ckpt, dy, dh)
            want = ref.selective_scan_bwd_ref(*args, dy, dh)
            what = f"selective_scan_bwd {case} dhT {dh is not None}"
            for name, g, a, w in zip(GRADS, got, again, want):
                if not torch.equal(g, a):
                    fail(f"{what} {name}: two calls differ")
                top = float(w.abs().max())
                err = close_err(f"{what} {name}", g, w,
                                dict(rtol=SCAN_BWD_TOL,
                                     atol=SCAN_BWD_TOL * top))
                errs[name] = max(errs.get(name, 0.0), err / top)
                worst = max(worst, err)
        n_bytes = scan_bwd_bytes(b, s, d, n)
        exps = b * s * d * n
        sfu_ms = exps / (SFU_PER_CLOCK * sms * clock) * 1e3
        t_bytes = n_bytes / HBM_BPS * 1e3
        t, by = (t_bytes, "bytes") if t_bytes >= sfu_ms else (sfu_ms,
                                                              "operations")
        kern = lambda: kernel.selective_scan_bwd(*args[:5], ckpt, dy, None)
        plain = lambda: ref.selective_scan_bwd_ref(*args, dy, None)
        row = {"shape": dict(case), "ms": device_ms(kern, calls=10),
               "plain_ms": device_ms(plain, calls=1),
               "call_ms": time_ms(kern, reps=20),
               "plain_call_ms": time_ms(plain, reps=2, warmup=1),
               "bound_ms": t, "bound_by": by, "bytes": n_bytes,
               "exps": exps, "sm_clock_hz": clock, "sfu_ms": sfu_ms,
               "rel_err": errs,
               "max_abs_err": worst, "library_ms": None}
        rows.append(row)
        print(f"  selective_scan_bwd (B, S, D, N)=({b}, {s}, {d}, {n}), h0 "
              f"scale {case['h0']}, dhT absent and present: within "
              f"{SCAN_BWD_TOL:g} of each gradient's largest magnitude (worst "
              f"{max(errs.values()):.2e}), two calls bit-equal; device "
              f"{row['ms']:.4f} ms (plain {row['plain_ms']:.4f}, bound "
              f"{t:.4f} by {by}, SFU floor "
              f"{sfu_ms:.4f}); per call {row['call_ms']:.4f} ms (plain "
              f"{row['plain_call_ms']:.4f})")
        del args, ckpt, dy, dht
        torch.cuda.empty_cache()
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
            quant = lambda: kernel.quantize(x, bits, gs, axis)
            dequant = lambda: kernel.dequantize(packed, scale, zero, bits,
                                                gs, axis, x.shape[axis])
            # ms: device time (CUDA-graph replays); call_ms: one call
            # between events, the host's wrapper included; the plain
            # versions per call (quantize_ref copies a host scalar to the
            # card, which a CUDA graph cannot capture)
            row = {
                "bits": bits, "axis": axis, "shape": [rows, cols],
                "quantize_ms": device_ms(quant, calls=20),
                "quantize_call_ms": time_ms(quant, reps=20),
                "quantize_plain_ms": time_ms(
                    lambda: ref.quantize_ref(x, bits, gs, axis), reps=5),
                "quantize_bound_ms": q_bound[0],
                "quantize_bound_by": q_bound[1],
                "dequantize_ms": device_ms(dequant, calls=20),
                "dequantize_call_ms": time_ms(dequant, reps=20),
                "dequantize_plain_ms": time_ms(
                    lambda: ref.dequantize_ref(qt), reps=5),
                "dequantize_bound_ms": d_bound[0],
                "dequantize_bound_by": d_bound[1],
            }
            results.append(row)
            print(f"  bits={bits} axis={axis} (T*L, F)=({rows}, {cols}): "
                  f"bit-equal; quantize device {row['quantize_ms']:.4f} ms "
                  f"(per call {row['quantize_call_ms']:.4f}, plain "
                  f"{row['quantize_plain_ms']:.4f}, bound "
                  f"{row['quantize_bound_ms']:.4f}); dequantize device "
                  f"{row['dequantize_ms']:.4f} ms (per call "
                  f"{row['dequantize_call_ms']:.4f}, plain "
                  f"{row['dequantize_plain_ms']:.4f}, bound "
                  f"{row['dequantize_bound_ms']:.4f})")
    return results, worst


def phase_kivi_layouts(kernel, ref):
    """KIVI quantize and dequantize bit-equal to the plain version at
    layouts outside the model's, which take the kernels' other branches:
    K groups of 320 and 640 rows (staged in two and three pieces), 203
    columns (dequantize a column at a time), V groups of 24 (six units of
    4 values on 8 lanes), of 3 bytes' codes (units of 1, 2 or 4 values at
    8, 4 or 2 bits; dequantize's units of 4 values span two groups at 8
    and 4 bits) and of 1024 (a lane's units past its first two are read
    again), for 8/4/2 bits."""
    for bits in (8, 4, 2):
        cpb = 8 // bits
        layouts = ((0, 320, 640, 1024), (0, 640, 1280, 1024),
                   (0, 64, 4096, 203), (1, 24, 4096, 960),
                   (1, 3 * cpb, 4096, 960), (1, 1024, 512, 4096))
        for i, (axis, gs, rows, cols) in enumerate(layouts):
            x = kv_matrix(rows, cols, bits, seed=100 + 10 * bits + i)
            got = kernel.quantize(x, bits, gs, axis)
            torch.cuda.synchronize()
            want = ref.quantize_ref(x, bits, gs, axis)
            for name, a, b in zip(("packed", "scale", "zero"), got,
                                  (want.packed, want.scale, want.zero)):
                if a.shape != b.shape or not torch.equal(a, b):
                    fail(f"quantize bits={bits} axis={axis} group={gs} "
                         f"({rows}, {cols}): {name} differs from the plain "
                         "version")
            back = kernel.dequantize(*got, bits, gs, axis, x.shape[axis])
            torch.cuda.synchronize()
            if not torch.equal(back, ref.dequantize_ref(want)):
                fail(f"dequantize bits={bits} axis={axis} group={gs} "
                     f"({rows}, {cols}): differs from the plain version")
        print(f"  quantize and dequantize bits={bits}: bit-equal at (axis, "
              f"group, rows, cols) {', '.join(str(lay) for lay in layouts)}")


def summarize_profile(events, device_type) -> dict:
    """From a profiler's events: the device's busy time (the union of its
    activities' intervals) and idle share over the profiled window (the
    first to the last event, host or device), the ten device operations
    with the most total time, the selective scan's (forward, and backward
    with the sum of its partials) and KIVI's totals, and the MoE routing's
    (the ``moe.route`` span of ``models/moe.py``: the device time of the
    kernels launched inside it, and its host time, the wait for the
    experts' row counts included). The device-side copies of host ranges
    are not device activity and are left out."""
    dev = [e for e in events
           if e.device_type == device_type and e.name not in HOST_RANGES]
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
    moe = [e for e in events
           if e.name == "moe.route" and e.device_type != device_type]
    return {"window_ms": window / 1e3, "busy_ms": busy / 1e3,
            "idle_share": 1.0 - busy / window,
            "top": [{"name": k, "ms": total[k] / 1e3, "calls": calls[k]}
                    for k in top],
            "scan_ms": share(r"scan_(fwd|bwd)|sum_parts") / 1e3,
            "kivi_ms": share(r"quantize_(rows|cols)") / 1e3,
            "moe_route_ms": sum(e.device_time_total for e in moe) / 1e3,
            "moe_route_host_ms": sum(e.cpu_time_total for e in moe) / 1e3,
            "moe_route_calls": len(moe)}


def profile_call(fn, label: str, shares=("scan", "kivi")):
    """``torch.profiler`` (CPU and CUDA activities) over ``fn()``,
    summarized by ``summarize_profile`` and printed with the shares of the
    kernels named in ``shares``. The port's tracer is on inside, so its
    spans are ranges of the profile. Returns (the summary, ``fn``'s
    result)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    trace.enable()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            result = fn()
            torch.cuda.synchronize()
    finally:
        trace.take()
        trace.disable()
    out = summarize_profile(prof.events(), DeviceType.CUDA)
    busy = out["busy_ms"]
    print(f"  profile of {label}: window {out['window_ms']:.1f} ms, device "
          f"busy {busy:.1f} ms, idle share {out['idle_share']:.4f}")
    for i, op in enumerate(out["top"], 1):
        print(f"    {i:2d}. {op['ms']:9.3f} ms {op['calls']:6d} calls "
              f"{100 * op['ms'] / busy:5.1f} % of busy  {op['name'][:90]}")
    for what in shares:
        ms = out[f"{what}_ms"]
        print(f"    {what}: {ms:.3f} ms, {100 * ms / busy:.2f} % of busy, "
              f"{100 * ms / out['window_ms']:.3f} % of the window")
    return out, result


def profile_request(engine, request, label: str,
                    shares=("scan", "kivi")) -> dict:
    """``profile_call`` over ``engine.process`` of one request."""
    out, result = profile_call(lambda: engine.process([request])[0],
                               f"one {label} request", shares)
    out["hit_tier"] = result.hit_tier
    print(f"    hit tier of the profiled request: {result.hit_tier}")
    return out


def serve(runner, cfg, n_active: int, kernels=(), want_hits: bool = True,
          profile_label=None, profile_shares=("scan", "kivi"), **engine_kw):
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
        trace.enable()
        try:
            results = rig.engine.process(requests)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
        finally:
            traced = trace.take().counters
            trace.disable()
        check_decode_graph(cfg, traced)
        launches = {k: n for c in counters for k, n in c.items()}
        summary = summarize(results,
                            selector_stats=rig.controller.selector.stats)
        print(f"  {len(contexts)} contexts of "
              f"{[len(c.tokens) for c in contexts]} tokens, {len(requests)} "
              f"requests, engine.process {wall_s:.2f} s wall")
        check_summary(summary, results, len(requests), want_hits)
        prof = (profile_request(make_rig().engine, requests[0],
                                profile_label, profile_shares)
                if profile_label else None)
    return summary, results, requests, contexts, wall_s, launches, prof


def check_decode_graph(cfg, counters: dict) -> dict:
    """The decode steps of one ``serve`` (the tracer's counters): every
    step over the runner's pooled caches is a CUDA graph replay
    (``models/decode_graph.py``) and none runs eagerly, with at most one
    capture a cache shape (the engine's lanes and ``generate_from_kvdata``'s
    one lane). Recorded in ``DECODE_GRAPH``."""
    got = {k: counters.get(f"decode.{k}", 0)
           for k in ("graph_captures", "graph_replays", "eager_steps")}
    print(f"  decode steps: {got['graph_replays']} graph replays, "
          f"{got['eager_steps']} eager, {got['graph_captures']} captures")
    if got["eager_steps"] or not got["graph_replays"]:
        fail(f"{cfg.name}: the served decode steps did not all replay a "
             f"graph: {got}")
    if got["graph_captures"] > 2:
        fail(f"{cfg.name}: {got['graph_captures']} captures in one serve")
    DECODE_GRAPH.append({"arch": cfg.name, **got})
    return got


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


def check_kivi_launches(launches: dict, names) -> dict:
    """The KIVI forms an entry of the arrays ``names`` must launch, checked
    against ``launches`` (the counts of one ``engine.process``): K-style
    grouping along tokens (``quantize_rows``/``dequantize_rows``, the
    ``_k`` counters) for ``k``, V-style grouping along features (the
    ``_cols`` kernels, ``_v``) for every other array. A form the layout
    launches must count above 0, and a form it never launches exactly 0.
    Returns {counter: launched?}."""
    from repro_torch.core.compression.kivi import _axis_for

    styles = {"k" if _axis_for(name) == 0 else "v" for name in names}
    want = {f"{op}_{style}": style in styles
            for op in ("quantize", "dequantize") for style in ("k", "v")}
    missing = [k for k, on in want.items() if on and launches[k] <= 0]
    if missing:
        fail(f"main path never launched {missing}")
    stray = {k: launches[k] for k, on in want.items()
             if not on and launches[k] != 0}
    if stray:
        fail(f"{stray} launched, but no array of {tuple(names)} is grouped "
             "that way")
    idle = [k for k, on in want.items() if not on]
    print(f"  KIVI forms of {tuple(names)}: launched "
          f"{[k for k, on in want.items() if on]}"
          + (f"; {idle} at 0, as the layout needs" if idle else ""))
    return want


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
    check_kivi_launches(launches, ("k", "v"))

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

    # kernel_bench's decode calls, counted where it makes them
    decode_ops = kernel_bench.decode_ops
    decode_planes = decode_ops.decode_attention_planes
    decode_calls = [0]

    def counted_decode(*args, **kw):
        decode_calls[0] += 1
        return decode_planes(*args, **kw)

    for mod in attn_kernels.values():
        for k in mod.LAUNCHES:
            mod.LAUNCHES[k] = 0
    buf = io.StringIO()
    t0 = time.perf_counter()
    decode_ops.decode_attention_planes = counted_decode
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_cal_") as tmp, \
                contextlib.redirect_stdout(buf):
            cal_path = Path(tmp) / "fused_calibration.json"
            kernel_bench.main(["--out", str(cal_path)])
            torch.cuda.synchronize()
            cal = load_fused_calibration(str(cal_path))
            raw = json.loads(cal_path.read_text())
    finally:
        decode_ops.decode_attention_planes = decode_planes
    bench_s = time.perf_counter() - t0
    launches = {name: n for mod in attn_kernels.values()
                for name, n in mod.LAUNCHES.items()}
    rows = [r for r in buf.getvalue().splitlines() if r]
    print(f"  kernel_bench (full width) in {bench_s:.1f} s:")
    for r in rows:
        print(f"    {r}")
    print(f"  kernel launches during kernel_bench: {launches}")
    missing = [k for k, n in launches.items() if n <= 0]
    if missing:
        fail(f"the fused-compute path never launched {missing}")
    if launches["decode_attn"] != decode_calls[0]:
        fail(f"{launches['decode_attn']} decode_attn launches for "
             f"{decode_calls[0]} calls: one a call expected")
    print(f"  decode_attn: {decode_calls[0]} calls, one launch each")
    # two launches a call; every call is at hd 128, the tensor cores' case
    if 2 * launches["fused_prefill_mma"] != launches["fused_prefill"]:
        fail(f"{launches['fused_prefill_mma']} of "
             f"{launches['fused_prefill'] // 2} fused_prefill calls took the "
             "tensor-core kernel")
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


def decode_vs_prefill(model, params, tokens, extra=None, capacity: int = 128,
                      slot: int = 63) -> float:
    """Max relative error of the decode step's logits on the last of 64
    tokens (from the prefill of the first 63) against the prefill of all
    64; infinite when the decode step gives a non-finite value. ``extra``
    holds the batch's other inputs (frames, patches) for both prefills,
    ``slot`` the decode step's cache slot (63, after any patches)."""
    extra = extra or {}
    toks = torch.as_tensor(tokens[:64], device="cuda")[None]
    want, _ = model.prefill(params, {"tokens": toks, **extra},
                            capacity=capacity)
    _, cache = model.prefill(params, {"tokens": toks[:, :-1], **extra},
                             capacity=capacity)
    got, _ = model.decode_step(params, cache, slot, toks[:, -1:])
    return rel_err(got, want)


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / max |want| over the last position's logits;
    infinite when ``got`` holds a non-finite value."""
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
    if launches["selective_scan_bwd"] != 0:
        fail("serving launched the scan's backward")
    print(f"  hit rate {summary['hit_rate']}: the tiers are sized with "
          "each entry's fixed state (ModelConfig.state_bytes); the round "
          "trip below checks decompression")

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


def train_batches(cfg, seq: int, batch: int, n: int, device):
    """``n`` batches of the recall pipeline (seed 0) as long tensors."""
    from repro_torch.training.data import Pipeline, PipelineConfig

    pipe = Pipeline(PipelineConfig(cfg.vocab_size, seq, batch,
                                   kind="recall"))
    return [{k: torch.as_tensor(v, dtype=torch.long, device=device)
             for k, v in pipe.next_batch().items()} for _ in range(n)]


def train_card_vs_cpu(arch: str = ARCH) -> dict:
    """5 f32 steps of smoke ``arch`` from one init, on the card and on the
    CPU, on the same batches, under the serve driver's schedule."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import smoke_opt_config
    from repro_torch.models import build_model
    from repro_torch.training import tree as tree_lib
    from repro_torch.training.optimizer import adamw_init
    from repro_torch.training.train_step import TrainState, make_train_step

    cfg = get_config(arch, smoke=True)
    model = build_model(cfg)
    opt = smoke_opt_config(SMOKE_TRAIN_STEPS)
    params = model.init(0, "cpu")
    devices = {"card": "cuda", "cpu": "cpu"}
    states = {}
    for where, dev in devices.items():
        p = tree_lib.map_leaves(lambda t: t.to(dev, copy=True), params)
        states[where] = TrainState(p, adamw_init(opt, p))
    step = make_train_step(model, opt)
    rows = []
    for i, b in enumerate(train_batches(cfg, SMOKE_SEQ, SMOKE_BATCH, 5,
                                        "cpu")):
        met = {}
        for where, dev in devices.items():
            states[where], m = step(states[where],
                                    {k: v.to(dev) for k, v in b.items()})
            met[where] = {k: float(v) for k, v in m.items()}
        card, cpu = met["card"], met["cpu"]
        loss_rel = abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"])
        gn_rel = (abs(card["grad_norm"] - cpu["grad_norm"])
                  / abs(cpu["grad_norm"]))
        rows.append({"step": i, "card": card, "cpu": cpu,
                     "loss_rel_err": loss_rel, "grad_norm_rel_err": gn_rel})
        print(f"  step {i}: loss card {card['loss']:.6f} cpu "
              f"{cpu['loss']:.6f} (rel {loss_rel:.2e}), grad norm card "
              f"{card['grad_norm']:.6f} cpu {cpu['grad_norm']:.6f} (rel "
              f"{gn_rel:.2e})")
        if not all(math.isfinite(v) for d in met.values() for v in d.values()):
            fail(f"smoke training step {i}: non-finite metrics {met}")
        if not loss_rel <= CARD_CPU_LOSS_RTOL:
            fail(f"smoke training step {i}: the card's loss differs from "
                 f"the CPU's by {loss_rel:.3g} (limit {CARD_CPU_LOSS_RTOL:g})")
        if i == 0 and not gn_rel <= CARD_CPU_GNORM_RTOL:
            fail(f"smoke training step 0: the card's grad norm differs from "
                 f"the CPU's by {gn_rel:.3g} (limit {CARD_CPU_GNORM_RTOL:g})")
    return {"steps": rows}


def train_driver_resume() -> dict:
    """The train driver on the card: 20 smoke steps with a checkpoint every
    10, then a second run with --resume, which must restore step 20's
    leaves bit for bit on the card."""
    import contextlib
    import io

    from repro_torch.launch import train as train_driver
    from repro_torch.training import tree as tree_lib

    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as ckpt:
        args = ["--arch", ARCH, "--smoke", "--steps", "20", "--ckpt-every",
                "10", "--ckpt-dir", ckpt, "--device", "cuda"]
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            first = train_driver.train(args)
            again = train_driver.train(args + ["--resume"])
        wall_s = time.perf_counter() - t0
        on_disk = sorted(os.listdir(ckpt))
    text = buf.getvalue()
    for line in text.splitlines():
        print(f"    {line}")
    if "resumed from step 20" not in text or int(again.opt.step) != 20:
        fail("the train driver did not resume at step 20")
    if on_disk != ["LATEST", "step_10", "step_20"]:
        fail(f"checkpoint directory holds {on_disk}")
    a, b = tree_lib.leaves(first), tree_lib.leaves(again)
    if len(a) != len(b) or not all(
            y.device.type == "cuda" and x.dtype == y.dtype
            and torch.equal(x, y) for x, y in zip(a, b)):
        fail("the resumed state differs from the saved one")
    print(f"  train driver: 20 steps, checkpoints {on_disk[1:]}, resumed at "
          f"step 20 with all {len(b)} leaves bit-equal on the card "
          f"({wall_s:.1f} s)")
    return {"leaves": len(b), "checkpoints": on_disk, "wall_s": wall_s}


def train_full_width(arch: str = ARCH, lr: float = FULL_TRAIN_LR,
                     counted=None, want_launches=None) -> dict:
    """Full-width ``arch``, bf16, int8 AdamW state, remat: the chunked loss
    against the plain cross-entropy at step 0, TRAIN_STEPS timed steps
    (every leaf must change in the first), then one profiled step. With
    ``counted`` (a kernel module), its ``LAUNCHES`` are zeroed just before
    the second step and read just after, and must equal ``want_launches``."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, transformer
    from repro_torch.models.layers import cross_entropy_loss
    from repro_torch.training import train_step as train_step_mod
    from repro_torch.training import tree as tree_lib
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_step import init_train_state

    cfg = get_config(arch)
    model = build_model(cfg)
    opt = AdamWConfig(lr=lr, int8_state=True)
    t0 = time.perf_counter()
    state = init_train_state(model, 0, opt, "cuda")
    torch.cuda.synchronize()
    n_params = model.param_count(state.params)
    opt_bytes = sum(t.numel() * t.element_size()
                    for t in tree_lib.leaves(state.opt))
    print(f"  {arch}: {n_params:,} params ({cfg.param_dtype}), int8 AdamW "
          f"state {opt_bytes / 1e9:.2f} GB, init "
          f"{time.perf_counter() - t0:.1f} s; "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card")
    batches = train_batches(cfg, FULL_SEQ, FULL_BATCH, TRAIN_STEPS + 1,
                            "cuda")
    tokens = FULL_SEQ * FULL_BATCH

    # step 0: the chunked loss (128-token chunks) and the train step's own
    # loss (one 512-token chunk) against the plain cross-entropy
    with torch.no_grad():
        chunked = float(transformer.loss_fn(state.params, cfg, batches[0],
                                            loss_chunk=128))
        plain = float(cross_entropy_loss(model.forward(state.params,
                                                       batches[0]),
                                         batches[0]["labels"]))
    ce_rel = abs(chunked - plain) / abs(plain)
    print(f"  step 0 loss: chunked {chunked:.6f}, plain cross-entropy "
          f"{plain:.6f} (rel {ce_rel:.2e})")
    if not (math.isfinite(plain) and ce_rel <= CE_RTOL):
        fail(f"chunked loss {chunked} against plain {plain}: rel "
             f"{ce_rel:.3g} (limit {CE_RTOL:g})")

    # time adamw_update inside each step (synchronized on both sides)
    adamw_update = train_step_mod.adamw_update
    opt_s = []

    def timed_update(*args, **kw):
        torch.cuda.synchronize()
        u0 = time.perf_counter()
        out = adamw_update(*args, **kw)
        torch.cuda.synchronize()
        opt_s.append(time.perf_counter() - u0)
        return out

    step_fn = train_step_mod.make_train_step(model, opt, remat=True)
    before = [t.to("cpu", copy=True) for t in tree_lib.leaves(state.params)]
    rows = []
    train_step_mod.adamw_update = timed_update
    try:
        for i in range(TRAIN_STEPS):
            if counted is not None and i == 1:
                counted.LAUNCHES.update(dict.fromkeys(counted.LAUNCHES, 0))
            # each step's own peak, without the leaf check's copies after
            # step 0 (a copy and a mask of the largest leaf)
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            s0 = time.perf_counter()
            state, m = step_fn(state, batches[i])
            loss, gnorm = float(m["loss"]), float(m["grad_norm"])
            torch.cuda.synchronize()
            dt = time.perf_counter() - s0
            del m
            if counted is not None and i == 1:
                launches = dict(counted.LAUNCHES)
                print(f"  kernel launches in step 1: {launches}")
                if launches != want_launches:
                    fail(f"step 1 launched {launches}, want "
                         f"{want_launches}")
            row = {"step": i, "loss": loss, "grad_norm": gnorm,
                   "step_s": dt, "adamw_s": opt_s[-1],
                   "tokens_per_s": tokens / dt,
                   "max_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
                   "model_flops_share": 6 * n_params * tokens
                   / (dt * BF16_OPS)}
            rows.append(row)
            print(f"  step {i}: loss {loss:.4f}, grad norm {gnorm:.4f}, "
                  f"{dt * 1e3:.1f} ms (adamw_update {opt_s[-1] * 1e3:.1f} "
                  f"ms), {row['tokens_per_s']:.0f} tokens/s, peak "
                  f"{row['max_memory_gb']:.2f} GB, model FLOPs share "
                  f"{row['model_flops_share']:.4f}")
            if not (math.isfinite(loss) and math.isfinite(gnorm)):
                fail(f"full-width step {i}: loss {loss}, grad norm {gnorm}")
            if i == 0:
                changed = [float((x.to("cuda") != y).count_nonzero())
                           / y.numel() for x, y in
                           zip(before, tree_lib.leaves(state.params))]
                del before
                if min(changed) == 0.0:
                    names = ["/".join(map(str, path)) for (path, _), c in zip(
                        tree_lib.flatten_with_paths(state.params), changed)
                        if c == 0.0]
                    fail(f"{len(names)} of {len(changed)} leaves unchanged "
                         f"after step 1: {names}")
                print(f"  after step 1 all {len(changed)} leaves changed "
                      f"(each in {min(changed):.4f}-{max(changed):.4f} of "
                      "its elements)")
    finally:
        train_step_mod.adamw_update = adamw_update
    profile, _ = profile_call(
        lambda: step_fn(state, batches[TRAIN_STEPS]),
        f"one full-width train step ({FULL_BATCH} x {FULL_SEQ} tokens)",
        shares=() if counted is None else ("scan",))
    steady = sorted(r["step_s"] for r in rows[1:])
    step_s = steady[len(steady) // 2]
    out = {"n_params": n_params, "opt_state_gb": opt_bytes / 1e9,
           "batch": FULL_BATCH, "seq": FULL_SEQ, "lr": lr,
           "ce_chunked": chunked, "ce_plain": plain, "ce_rel_err": ce_rel,
           "leaves_changed_frac_min": min(changed), "steps": rows,
           "median_step_s": step_s, "tokens_per_s": tokens / step_s,
           "model_flops_share": 6 * n_params * tokens / (step_s * BF16_OPS),
           "max_memory_gb": max(r["max_memory_gb"] for r in rows),
           "profile": profile}
    if counted is not None:
        out["launches"] = launches
    del state, batches
    return out


def phase_training(card: str) -> dict:
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    print(f"  {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated, "
          f"{free / 1e9:.2f} of {total / 1e9:.2f} GB free on the card")
    print("  (a) smoke adaptcache-8b, f32: the card against the CPU")
    card_cpu = train_card_vs_cpu()
    driver = train_driver_resume()
    print(f"  (b) full-width {ARCH}, bf16, int8 AdamW state, remat, on "
          f"{card}")
    full = train_full_width()
    return {"card_vs_cpu": card_cpu, "driver": driver, "full_width": full}


def serve_driver_mamba(scan_kernel) -> dict:
    """The serve driver for falcon-mamba-7b on the card at its default
    training steps: it trains the smoke model (through the scan's forward
    and backward kernels), then serves it."""
    import contextlib
    import io

    from repro_torch.launch import serve as serve_driver

    scan_kernel.LAUNCHES.update(dict.fromkeys(scan_kernel.LAUNCHES, 0))
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = serve_driver.main(["--arch", MAMBA_ARCH, "--duration", "30"])
    wall_s = time.perf_counter() - t0
    launches = dict(scan_kernel.LAUNCHES)
    text = buf.getvalue()
    for line in text.splitlines():
        print(f"    {line}")
    trained = f"smoke model trained {SMOKE_TRAIN_STEPS} steps"
    if rc != 0 or trained not in text or "=== serving summary ===" not in text:
        fail(f"the serve driver for {MAMBA_ARCH} returned {rc} without "
             f"'{trained}' and a serving summary")
    if launches["selective_scan_bwd"] <= 0 or launches["selective_scan"] <= 0:
        fail(f"the serve driver's training launched {launches}")
    print(f"  serve driver: trained {SMOKE_TRAIN_STEPS} steps and served "
          f"({wall_s:.1f} s); scan launches {launches}")
    return {"rc": rc, "wall_s": wall_s, "launches": launches}


def phase_mamba_training(card: str, scan_kernel) -> dict:
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    print(f"  (a) smoke {MAMBA_ARCH}, f32: the card against the CPU")
    card_cpu = train_card_vs_cpu(MAMBA_ARCH)
    driver = serve_driver_mamba(scan_kernel)
    print(f"  (b) full-width {MAMBA_ARCH}, bf16, int8 AdamW state, remat, on "
          f"{card}")
    from repro_torch.configs import get_config
    layers = get_config(MAMBA_ARCH).n_layers
    # remat runs each layer's forward twice: once in the step, once again
    # in its backward
    full = train_full_width(MAMBA_ARCH, MAMBA_TRAIN_LR, counted=scan_kernel,
                            want_launches={"selective_scan": 2 * layers,
                                           "selective_scan_bwd": layers})
    return {"card_vs_cpu": card_cpu, "driver": driver, "full_width": full}


def routing_gaps(fn):
    """``fn()``, recording for every ``router_topk`` call the gap between
    the k-th and the (k+1)-th largest router probability of its last row
    (the token a decode step and its prefill both route). Returns (fn's
    result, the gaps in call order)."""
    from repro_torch.models import moe as moe_lib

    plain, gaps = moe_lib.router_topk, []

    def recorded(logits, top_k, renormalize=True):
        probs = torch.softmax(logits[-1].float(), dim=-1)
        top = torch.topk(probs, top_k + 1).values
        gaps.append(float(top[top_k - 1] - top[top_k]))
        return plain(logits, top_k, renormalize)

    moe_lib.router_topk = recorded
    try:
        return fn(), gaps
    finally:
        moe_lib.router_topk = plain


def phase_family_serving(arch: str, label: str, checks=None) -> dict:
    """Full-width ``arch`` (bf16, seeded) served through ``build_engine``
    with the fixed KIVI policy, its KIVI launches counted by form
    (``check_kivi_launches``) and one request profiled; a real prefill
    entry's round trip through the kernel against the plain version; the
    decode step against the prefill in bf16 (printed) and in f32 (held to
    DECODE_TOL_F32). The f32 model is the same seed's init in f32, the bf16
    weights before their rounding, at full depth: it is built after the
    bf16 model is freed (deepseek-v2-lite's would not fit beside it). A
    MoE config's routing gaps are printed beside the f32 check.
    ``checks(model, params, tokens, hold)``, when given, runs on the bf16
    model (``hold`` False: print) and on the f32 one (``hold`` True: fail
    on a miss); its two results land under ``checks``."""
    from repro_torch.configs import get_config
    from repro_torch.core.compression import KIVICompression
    from repro_torch.models import build_model
    from repro_torch.serving.runner import ModelRunner

    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(arch)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params, n_active = model.param_count(params), model.active_param_count()
    m = cfg.moe
    attn = (f"MLA r {cfg.mla.kv_lora_rank}, rope {cfg.mla.qk_rope_head_dim}"
            if cfg.mla else f"{cfg.n_heads} heads / {cfg.n_kv_heads} KV heads")
    ffn = (f"{m.n_routed_experts} routed + {m.n_shared_experts} shared "
           f"experts top-{m.top_k} of width {m.expert_d_ff}" if m else
           f"d_ff {cfg.d_ff}")
    prefix = f" ({m.first_k_dense} dense prefix)" if m else ""
    print(f"  {arch}: {cfg.n_layers} layers{prefix}, d_model {cfg.d_model}, "
          f"{attn}, {ffn}, vocab {cfg.vocab_size}, {cfg.param_dtype}: "
          f"{n_params:,} params ({n_active:,} active), "
          f"init {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card")
    runner = ModelRunner(model, params, capacity=1024)
    torch.cuda.reset_peak_memory_stats()
    summary, _, _, contexts, wall_s, launches, prof = serve(
        runner, cfg, n_active, profile_label=label,
        profile_shares=("kivi", "moe_route") if m else ("kivi",))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print("  summary (TTFT is simulated on the reference's A100 TimeModel, "
          "not measured on this card):")
    for k, v in summary.items():
        print(f"    {k:28s} {v}")
    print(f"  kernel launches during engine.process: {launches}; peak "
          f"memory {peak_gb:.2f} GB")
    if m:
        print(f"    moe.route host time {prof['moe_route_host_ms']:.3f} "
              f"ms in {prof['moe_route_calls']} calls, "
              f"{100 * prof['moe_route_host_ms'] / prof['window_ms']:.2f} "
              "% of the window")

    # a real prefill entry through the kernel == the plain version's bytes
    ctx = contexts[0]
    kv = runner.prefill_entry(ctx.tokens)
    names = tuple(k for k in kv if k != "positions")
    forms = check_kivi_launches(launches, names)
    for name in names:
        if (kv[name].shape[:2] != (cfg.n_layers, len(ctx.tokens))
                or not np.isfinite(kv[name]).all()):
            fail(f"prefill KVData {name}: shape {kv[name].shape}, want "
                 f"({cfg.n_layers}, {len(ctx.tokens)}, ...), finite values")
    card, cpu = KIVICompression(device="cuda"), KIVICompression(device="cpu")
    on_card, on_cpu = card.compress(kv, RATE), cpu.compress(kv, RATE)
    for key, a in on_card.arrays.items():
        if not np.array_equal(a, on_cpu.arrays[key]):
            fail(f"compress of a real entry: {key} differs between the "
                 "kernel and the plain version")
    back_card, back_cpu = card.decompress(on_card), cpu.decompress(on_cpu)
    for name in names:
        if not np.array_equal(back_card[name], back_cpu[name]):
            fail(f"decompress of a real entry: {name} differs between the "
                 "kernel and the plain version")
    shapes = {name: kv[name].shape for name in names}
    print(f"  real {len(ctx.tokens)}-token entry {shapes}: compress and "
          f"decompress bit-equal to the plain version "
          f"({on_card.meta['bits']} bits, rate {on_card.rate:.4f})")

    rel16 = decode_vs_prefill(model, params, ctx.tokens)
    checked = {}
    if checks:
        checked["bf16"] = checks(model, params, ctx.tokens, False)
    del runner, params, kv, on_card, on_cpu, back_card, back_cpu
    gc.collect()
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    model32 = build_model(cfg32)
    params32 = model32.init(seed=0, device="cuda")
    print(f"  f32 model (the same seed): "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card")
    f32_check = lambda: decode_vs_prefill(model32, params32, ctx.tokens)
    rel32, gaps = routing_gaps(f32_check) if m else (f32_check(), None)
    if checks:
        checked["f32"] = checks(model32, params32, ctx.tokens, True)
    del params32
    gc.collect()
    torch.cuda.empty_cache()
    gap = ""
    if m:
        n_moe = sum(cfg.uses_moe_at(i) for i in range(cfg.n_layers))
        low = min(range(len(gaps)), key=gaps.__getitem__)
        gap = (f"; smallest routing gap {gaps[low]:.3g} (k-th against "
               f"(k+1)-th router probability of the last token, MoE layer "
               f"{low % n_moe} of {n_moe})")
    if not rel32 < DECODE_TOL_F32:
        fail(f"decode step disagrees with prefill in f32: max rel err "
             f"{rel32:.3g} (limit {DECODE_TOL_F32:g}){gap}")
    print(f"  decode step vs prefill logits: f32 max rel err {rel32:.3g}, "
          f"within {DECODE_TOL_F32:g}{gap}; bf16 {rel16:.3g} (printed"
          + (": a near tie in bf16 routing may pick another expert)" if m
             else ")"))
    out = {"arch": arch, "n_params": n_params, "n_active": n_active,
           "summary": summary, "launches": launches, "kivi_forms": forms,
           "wall_s": wall_s, "peak_memory_gb": peak_gb,
           "entry_shapes": shapes, "decode_rel_err_f32": rel32,
           "decode_rel_err_bf16": rel16, "profile": prof, "checks": checked}
    if m:
        out["routing_gap_min"] = min(gaps)
    return out


def vlm_checks(model, params, tokens, hold: bool) -> dict:
    """The vision input and the packed quantized decode cache (A10) of a
    VLM on the card. (b) 256 seeded patch embeddings (N(0, 1) x 0.1) in
    front of 63 tokens: the decode step at slot 256 + 63 against the
    prefill of 256 + 64. (c) the 64 tokens decoded one by one into the
    packed cache at 8, 4 and 2 bits against the exact decode of the 64th
    (after the prefill of 63): the reference test's bounds (8 bits within
    0.02, the error monotone in bits), the cache uint8 of width hd/2 at 4
    bits, and one decode step's time at each width (CUDA events). With
    ``hold`` (the f32 model) a miss fails the run; otherwise the numbers
    are printed."""
    cfg, tag = model.cfg, "f32" if hold else "bf16"
    n = cfg.n_patches
    rng = np.random.RandomState(0)
    patches = torch.from_numpy((rng.randn(1, n, cfg.d_model) * 0.1).astype(
        np.float32)).to("cuda")
    rel_patch = decode_vs_prefill(model, params, tokens,
                                  {"patch_embeds": patches},
                                  capacity=n + 128, slot=n + 63)
    if hold and not rel_patch < DECODE_TOL_F32:
        fail(f"{n} patches + 64 tokens: decode step disagrees with prefill "
             f"in {tag}: max rel err {rel_patch:.3g} (limit "
             f"{DECODE_TOL_F32:g})")
    print(f"  {tag}: {n} patches + 64 tokens, decode at slot {n + 63} vs "
          f"prefill: max rel err {rel_patch:.3g}"
          + (f", within {DECODE_TOL_F32:g}" if hold else " (printed)"))

    toks = torch.as_tensor(tokens[:64], device="cuda")[None]
    _, cache = model.prefill(params, {"tokens": toks[:, :-1]}, capacity=128)
    exact, _ = model.decode_step(params, cache, 63, toks[:, -1:])
    step = lambda c, slot: model.decode_step(params, c, slot, toks[:, -1:])
    times = {16: time_ms(lambda: step(cache, 64), 10)}
    errs = {}
    for bits in (8, 4, 2):
        qc = model.init_cache(batch=1, capacity=128, device="cuda",
                              kv_bits=bits)
        for t in range(64):
            logits, qc = model.decode_step(params, qc, t, toks[:, t:t + 1])
        errs[bits] = rel_err(logits, exact)
        times[bits] = time_ms(lambda: step(qc, 64), 10)
    leaf = model.init_cache(batch=1, capacity=8, device="cuda",
                            kv_bits=4)["stack"][0]["self"]["k_packed"]
    shape_ok = (leaf.dtype == torch.uint8
                and leaf.shape[-1] == cfg.resolved_head_dim // 2)
    ok = errs[8] < 0.02 and errs[8] <= errs[4] <= errs[2] and shape_ok
    if hold and not ok:
        fail(f"quantized decode cache in {tag}: rel errors {errs} (want 8 "
             f"bits < 0.02, monotone in bits), 4-bit leaf {leaf.dtype} "
             f"{tuple(leaf.shape)}")
    print(f"  {tag}: packed quantized decode of the 64th token against the "
          f"exact decode: max rel err 8 bits {errs[8]:.4g}, 4 bits "
          f"{errs[4]:.4g}, 2 bits {errs[2]:.4g}"
          + (" (within 0.02 at 8 bits, monotone)" if hold else
             f" ({'within' if ok else 'outside'} the f32 bounds)")
          + f"; 4-bit leaf {leaf.dtype} {tuple(leaf.shape)}; a decode step "
          f"at slot 64: exact {times[16]:.3f} ms, 8 bits {times[8]:.3f}, "
          f"4 bits {times[4]:.3f}, 2 bits {times[2]:.3f} ms")
    return {"patch_decode_rel_err": rel_patch, "quantized_rel_err": errs,
            "decode_step_ms": times}


def phase_encdec() -> dict:
    """Full-width seamless-m4t-large-v2 (bf16, seeded) through the model's
    own entry points, as neither serve driver can serve it (ROADMAP C):
    seeded stub frames (1, 1024, 1024), the 556-token first context of
    phase 3's workload, capacity 1024. ``encode``, the prefill (the
    encoder included) and 32 decode steps each timed with CUDA events; one
    decode step profiled; the prefill's decoder entry through
    ``cache_to_kvdata`` (the cross cache dropped, as the reference drops
    it) and the KIVI kernels, bit-equal to the plain version, each form
    launched; the decode step against the prefill in bf16 (printed) and
    in f32 (the same seed's f32 init, built after the bf16 model is freed;
    held to DECODE_TOL_F32)."""
    from repro_torch.configs import get_config
    from repro_torch.core.compression import KIVICompression
    from repro_torch.kernels.kivi import kernel as kivi_kernel
    from repro_torch.models import build_model
    from repro_torch.models import transformer
    from repro_torch.serving.runner import cache_to_kvdata
    from repro_torch.serving.workload import make_contexts

    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(ENCDEC_ARCH)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = model.param_count(params)
    print(f"  {ENCDEC_ARCH}: {cfg.n_enc_layers} encoder + {cfg.n_layers} "
          f"decoder layers, d_model {cfg.d_model}, {cfg.n_heads} heads / "
          f"{cfg.n_kv_heads} KV heads, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}, {cfg.param_dtype}: {n_params:,} params, init "
          f"{time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card")
    rng = np.random.RandomState(0)
    ctx = make_contexts(rng, cfg.vocab_size, 1, min_len=384, max_len=640,
                        n_probes=2)[0]
    frames = torch.from_numpy((np.random.RandomState(0).randn(
        1, cfg.n_frames, cfg.d_model) * 0.1).astype(np.float32)).to("cuda")
    toks = torch.as_tensor(ctx.tokens, device="cuda")[None]
    n = toks.shape[1]
    batch = {"tokens": toks, "frames": frames}
    enc_ms = time_ms(lambda: transformer.encode(params, cfg, frames), 5)
    prefill_ms = time_ms(lambda: model.prefill(params, batch, capacity=1024),
                         3)
    logits, cache = model.prefill(params, batch, capacity=1024)
    cross = cache["stack"][0]["cross"]["k"]
    cross_bytes = 2 * cross.numel() * cross.element_size()
    step_ms, nxt = [], torch.argmax(logits[:, -1], dim=-1)[:, None]
    for i in range(32):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        logits, cache = model.decode_step(params, cache, n + i, nxt)
        end.record()
        torch.cuda.synchronize()
        step_ms.append(start.elapsed_time(end))
        nxt = torch.argmax(logits[:, -1], dim=-1)[:, None]
    if not bool(torch.isfinite(logits).all()):
        fail("seamless decode gave non-finite logits")
    print(f"  encode of {cfg.n_frames} frames {enc_ms:.3f} ms, prefill of "
          f"{n} tokens (the encoder included) {prefill_ms:.3f} ms, 32 decode "
          f"steps median {np.median(step_ms):.3f} ms (min "
          f"{min(step_ms):.3f}, max {max(step_ms):.3f}); cross cache K "
          f"and V of {tuple(cross.shape)} each (layers, batch, frames, KV "
          f"heads, hd), {cross_bytes / 1e6:.1f} MB")
    prof, _ = profile_call(lambda: model.decode_step(params, cache, n + 32,
                                                     nxt),
                           "one seamless decode step", ())

    # the decoder's entry, as the runner extracts it (the prefill's rows
    # [0, n), which the decode steps after them left as they were),
    # through the kernel
    kv = cache_to_kvdata(cache, cfg, n)
    names = tuple(k for k in kv if k != "positions")
    want = (cfg.n_layers, n, cfg.n_kv_heads * cfg.resolved_head_dim)
    if names != ("k", "v") or any(kv[k].shape != want for k in names):
        fail(f"seamless KVData {[(k, kv[k].shape) for k in names]}: want k "
             f"and v of {want}, the cross cache dropped")
    card, cpu = KIVICompression(device="cuda"), KIVICompression(device="cpu")
    for k in kivi_kernel.LAUNCHES:
        kivi_kernel.LAUNCHES[k] = 0
    on_card = card.compress(kv, RATE)
    back_card = card.decompress(on_card)
    launches = dict(kivi_kernel.LAUNCHES)
    on_cpu = cpu.compress(kv, RATE)
    back_cpu = cpu.decompress(on_cpu)
    for key, a in on_card.arrays.items():
        if not np.array_equal(a, on_cpu.arrays[key]):
            fail(f"compress of the seamless entry: {key} differs between "
                 "the kernel and the plain version")
    for name in names:
        if not np.array_equal(back_card[name], back_cpu[name]):
            fail(f"decompress of the seamless entry: {name} differs between "
                 "the kernel and the plain version")
    idle = [k for k in ("quantize_k", "quantize_v", "dequantize_k",
                        "dequantize_v") if launches[k] <= 0]
    if idle:
        fail(f"the seamless entry's round trip never launched {idle}")
    print(f"  decoder entry {want} K and V: compress and decompress "
          f"bit-equal to the plain version ({on_card.meta['bits']} bits); "
          f"KIVI launches {launches}")

    rel16 = decode_vs_prefill(model, params, ctx.tokens, {"frames": frames})
    del params, cache, kv, on_card, on_cpu, back_card, back_cpu
    gc.collect()
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    model32 = build_model(cfg32)
    params32 = model32.init(seed=0, device="cuda")
    print(f"  f32 model (the same seed): "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card")
    rel32 = decode_vs_prefill(model32, params32, ctx.tokens,
                              {"frames": frames})
    del params32
    gc.collect()
    torch.cuda.empty_cache()
    if not rel32 < DECODE_TOL_F32:
        fail(f"seamless decode step disagrees with prefill in f32: max rel "
             f"err {rel32:.3g} (limit {DECODE_TOL_F32:g})")
    print(f"  decode step vs prefill logits (64 tokens over the frames): "
          f"f32 max rel err {rel32:.3g}, within {DECODE_TOL_F32:g}; bf16 "
          f"{rel16:.3g} (printed)")
    return {"arch": ENCDEC_ARCH, "n_params": n_params, "tokens": n,
            "encode_ms": enc_ms, "prefill_ms": prefill_ms,
            "decode_step_ms": step_ms, "cross_shape": tuple(cross.shape),
            "cross_bytes": cross_bytes, "launches": launches,
            "decode_rel_err_f32": rel32, "decode_rel_err_bf16": rel16,
            "profile": prof}


def family_line(out: dict, card: str) -> dict:
    """The one-line summary of phase 8, 9 or 10."""
    prof = out["profile"]
    line = {"card": card, "arch": out["arch"], "n_params": out["n_params"],
            "launches": out["launches"], "engine_wall_s": out["wall_s"],
            "peak_memory_gb": out["peak_memory_gb"],
            "hit_rate": out["summary"]["hit_rate"],
            "decode_rel_err_f32": out["decode_rel_err_f32"],
            "decode_rel_err_bf16": out["decode_rel_err_bf16"],
            "profile_idle_share": prof["idle_share"],
            "profile_busy_ms": prof["busy_ms"],
            "profile_window_ms": prof["window_ms"]}
    if "routing_gap_min" in out:
        line["profile_moe_route_ms"] = prof["moe_route_ms"]
        line["profile_moe_route_host_ms"] = prof["moe_route_host_ms"]
    for tag, checked in out["checks"].items():
        line[f"patch_decode_rel_err_{tag}"] = checked["patch_decode_rel_err"]
        line[f"quantized_rel_err_{tag}"] = checked["quantized_rel_err"]
        line[f"quantized_step_ms_{tag}"] = checked["decode_step_ms"]
    line["profile_top3"] = [op["name"][:60] for op in prof["top"][:3]]
    return line


def encdec_line(out: dict, card: str) -> dict:
    """The one-line summary of phase 11."""
    prof = out["profile"]
    return {"card": card, **{k: out[k] for k in (
        "arch", "n_params", "tokens", "encode_ms", "prefill_ms",
        "cross_shape", "cross_bytes", "launches", "decode_rel_err_f32",
        "decode_rel_err_bf16")},
        "decode_step_ms_median": float(np.median(out["decode_step_ms"])),
        "profile_idle_share": prof["idle_share"],
        "profile_busy_ms": prof["busy_ms"],
        "profile_window_ms": prof["window_ms"],
        "profile_top3": [op["name"][:60] for op in prof["top"][:3]]}


# phase 12: the launch tooling
DRYRUN_CELLS = (("qwen3-1.7b", "train_4k", False),
                ("olmoe-1b-7b", "decode_32k", False),
                ("falcon-mamba-7b", "long_500k", False),
                ("jamba-1.5-large-398b", "train_4k", True))
DRYRUN_TIMEOUT_S = 300
MESH_DECODE_STEPS = 16
EP_RTOL = 1e-4                  # the reference's expert-parallel bound


def start_dryruns() -> list:
    """Each dry-run cell in its own process (its fake group of 256 ranks
    never meets this process's NCCL group), all started together, one CPU
    thread each."""
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    procs = []
    for arch, shape, multi_pod in DRYRUN_CELLS:
        tag = f"dryrun_{arch}_{shape}{'_2pod' if multi_pod else ''}"
        log = open(out_dir / f"{tag}.log", "w")
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape, "--json", str(out_dir / f"{tag}.json")]
        if multi_pod:
            cmd.append("--multi-pod")
        procs.append(((arch, shape, multi_pod), out_dir / f"{tag}.json",
                      log, subprocess.Popen(cmd, cwd=ROOT, env=env,
                                            stdout=log, stderr=log)))
    return procs


def finish_dryruns(procs) -> list:
    """Wait for each cell, hold it to ``ok`` and print its row."""
    from repro_torch.launch.mesh import HBM_BYTES
    rows = []
    for (arch, shape, multi_pod), path, log, proc in procs:
        try:
            rc = proc.wait(timeout=DRYRUN_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            fail(f"dry run {arch} x {shape} took over {DRYRUN_TIMEOUT_S} s")
        log.close()
        if rc != 0 or not path.exists():
            fail(f"dry run {arch} x {shape} exited {rc}: "
                 f"{Path(log.name).read_text()[-2000:]}")
        r = json.loads(path.read_text())[0]
        if r["status"] != "ok":
            fail(f"dry run {arch} x {shape}: {r}")
        print(f"  {arch} x {shape} x {r['mesh']}: flops/chip "
              f"{r['flops_per_chip']:.4g}, hbm/chip "
              f"{r['hbm_bytes_per_chip']:.4g} B, collective/chip "
              f"{r['collective_bytes_per_chip']:.4g} B; compute "
              f"{r['t_compute_s'] * 1e3:.3f} ms, memory "
              f"{r['t_memory_s'] * 1e3:.3f} ms, collective "
              f"{r['t_collective_s'] * 1e3:.3f} ms -> {r['bottleneck']}; "
              f"analytic peak {r['analytic_peak_bytes'] / 1e9:.3f} GB "
              f"(fits {HBM_BYTES / 1e9:.1f} GB: {r['fits_hbm']}); "
              f"step {r['step_s']:.1f} s, {r['n_ops']} ops")
        rows.append({k: r[k] for k in (
            "arch", "shape", "mesh", "n_chips", "flops_per_chip",
            "hbm_bytes_per_chip", "collective_bytes_per_chip",
            "collective_detail", "model_flops_per_chip", "t_compute_s",
            "t_memory_s", "t_collective_s", "bottleneck",
            "analytic_peak_bytes", "args_bytes_per_chip",
            "eager_live_peak_bytes", "fits_hbm", "build_s", "step_s",
            "n_ops")})
    return rows


def meta_like(tree):
    """A tree of DTensors with meta shards of the same shapes, dtypes and
    placements (no memory)."""
    from torch.distributed.tensor import DTensor
    from repro_torch.training import tree as tree_lib
    return tree_lib.unflatten(tree, [
        DTensor.from_local(torch.empty(t.to_local().shape, dtype=t.dtype,
                                       device="meta"),
                           t.device_mesh, t.placements, run_check=False)
        for t in tree_lib.leaves(tree)])


def on_mesh(tree, mesh, shardings):
    """A tree of plain tensors as DTensors of its shardings on the (1, 1)
    mesh, each wrapping its tensor (no copy)."""
    from torch.distributed.tensor import DTensor
    from repro_torch.training import tree as tree_lib
    return tree_lib.unflatten(tree, [
        DTensor.from_local(t, mesh, s.placements, run_check=False)
        for t, s in zip(tree_lib.leaves(tree), tree_lib.leaves(shardings),
                        strict=True)])


def greedy_decode(model, params, toks, capacity: int, steps: int, feed=None,
                  wrap=lambda t: t):
    """The prefill of ``toks`` and ``steps`` decode steps, each timed with
    CUDA events: the next token is ``feed``'s, or the argmax of the last
    logits. Returns (each step's last-position logits as plain f32, the
    tokens fed, the step times in ms)."""
    from torch.distributed.tensor import DTensor

    def plain(t):
        return (t.full_tensor() if isinstance(t, DTensor) else t).float()

    logits, cache = model.prefill(params, {"tokens": wrap(toks)},
                                  capacity=capacity)
    outs, fed, times = [plain(logits)[0, -1]], [], []
    n = toks.shape[1]
    for i in range(steps):
        nxt = (feed[i] if feed is not None
               else outs[-1].argmax().reshape(1, 1))
        fed.append(nxt)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        logits, cache = model.decode_step(params, cache, n + i, wrap(nxt))
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
        outs.append(plain(logits)[0, -1])
    return outs, fed, times


def phase_launch(smi: str, scan_kernel) -> dict:
    """(a) dry-run cells on the fake production mesh, in subprocesses on
    this host's CPU, started once olmoe's steps are timed (a host-bound
    eager step shares the host with them otherwise); (b) the mesh path on
    the card: a group
    of one (NCCL), ``make_host_mesh("cuda")``, full-width olmoe-1b-7b in
    f32 through ``moe_fwd_ep`` against the plain path, full-width
    falcon-mamba-7b in bf16 whose scan runs on local shards; (c) the step
    counter's FLOPs of the olmoe decode step on the card against its count
    on meta tensors, and the step's time beside its roofline."""
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch import roofline as rl
    from repro_torch.launch import sharding as shlib
    from repro_torch.launch import specs as sp
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.step_cost import count_step
    from repro_torch.models import build_model
    from repro_torch.models import moe as moe_lib
    from repro_torch.serving.workload import make_contexts

    gc.collect()
    torch.cuda.empty_cache()
    mesh = make_host_mesh("cuda")
    print(f"  mesh {mesh}; backend "
          f"{torch.distributed.get_backend()}, world "
          f"{torch.distributed.get_world_size()}")
    ep_calls = {"n": 0}
    ep_fn = moe_lib.moe_fwd_ep

    def counted_ep(*a, **k):
        ep_calls["n"] += 1
        return ep_fn(*a, **k)
    moe_lib.moe_fwd_ep = counted_ep

    # (b) olmoe-1b-7b in f32: the mesh path against the plain one
    cfg = dataclasses.replace(get_config(MOE_ARCH), dtype="float32",
                              param_dtype="float32")
    model = build_model(cfg)
    params = model.init(seed=0, device="cuda")
    ctx = make_contexts(np.random.RandomState(0), cfg.vocab_size, 1,
                        min_len=384, max_len=640, n_probes=2)[0]
    toks = torch.as_tensor(ctx.tokens, device="cuda")[None]
    n = toks.shape[1]
    capacity = n + MESH_DECODE_STEPS
    print(f"  {MOE_ARCH} f32: {model.param_count(params):,} params, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card; "
          f"a {n}-token context, {MESH_DECODE_STEPS} decode steps")
    with torch.no_grad():
        want, fed, plain_ms = greedy_decode(model, params, toks, capacity,
                                            MESH_DECODE_STEPS)
    if ep_calls["n"]:
        fail("the plain path reached moe_fwd_ep")
    dparams = on_mesh(params, mesh, sp.param_shardings(
        model.init_shapes(), mesh, mode="serve"))
    rep = shlib.NamedSharding(mesh, shlib.P(None, None))

    def wrap(t):
        return on_mesh(t, mesh, rep)

    with torch.no_grad(), shlib.use_mesh(mesh):
        got, _, mesh_ms = greedy_decode(model, dparams, toks, capacity,
                                        MESH_DECODE_STEPS, feed=fed,
                                        wrap=wrap)
    moe_layers = sum(cfg.uses_moe_at(i) for i in range(cfg.n_layers))
    want_ep = moe_layers * (1 + MESH_DECODE_STEPS)
    if ep_calls["n"] != want_ep:
        fail(f"moe_fwd_ep ran {ep_calls['n']} times, not {want_ep}")
    errs = [float((g - w).abs().max() / w.abs().max())
            for g, w in zip(got, want)]
    if not all(math.isfinite(e) and e <= EP_RTOL for e in errs):
        fail(f"mesh path vs plain path: max rel err {max(errs):.3g} > "
             f"{EP_RTOL}")
    print(f"  prefill + {MESH_DECODE_STEPS} decode steps through moe_fwd_ep "
          f"({ep_calls['n']} calls) vs the plain moe_fwd: max rel err "
          f"{max(errs):.3g} (<= {EP_RTOL}); a decode step "
          f"{np.median(mesh_ms):.2f} ms on the mesh, "
          f"{np.median(plain_ms):.2f} ms plain (median of "
          f"{MESH_DECODE_STEPS}; {smi})")

    # (c) the step counter: the card's decode step against meta tensors
    with torch.no_grad(), shlib.use_mesh(mesh):
        _, cache = model.prefill(dparams, {"tokens": wrap(toks)},
                                 capacity=capacity)
        tok = wrap(fed[0])
        step_ms = time_ms(lambda: model.decode_step(dparams, cache, n, tok),
                          5)
        _, card_cost = count_step(model.decode_step, dparams, cache, n, tok)
        meta_params, meta_cache, meta_tok = meta_like((dparams, cache, tok))
        _, meta_cost = count_step(model.decode_step, meta_params, meta_cache,
                                  n, meta_tok)
    if card_cost.flops != meta_cost.flops or card_cost.flops <= 0:
        fail(f"step counter: {card_cost.flops} FLOPs on the card, "
             f"{meta_cost.flops} on meta tensors")
    n_params, n_active = model.param_count(), model.active_param_count()
    shape = ShapeConfig("mesh_decode", capacity, 1, "decode")
    roof = rl.analyze(MOE_ARCH, shape, "1x1", 1, card_cost, cfg, n_params,
                      n_active)
    measured_fraction = (roof.model_flops_per_chip / (step_ms / 1e3)
                         / rl.PEAK_FLOPS_BF16)
    print(f"  step counter: {card_cost.flops:.6g} FLOPs on the card = "
          f"{meta_cost.flops:.6g} on meta tensors; {card_cost.n_ops} ops, "
          f"{card_cost.mem_bytes / 1e9:.3f} GB of op inputs and outputs")
    print(f"  roofline of the decode step (1 card, bf16 weights assumed by "
          f"the model): compute {roof.t_compute * 1e3:.4f} ms, memory "
          f"{roof.t_memory * 1e3:.4f} ms, collective "
          f"{roof.t_collective * 1e3:.4f} ms -> {roof.bottleneck}, "
          f"roofline_fraction {roof.roofline_fraction:.4g}; measured "
          f"{step_ms:.3f} ms (f32 weights, eager DTensor), model FLOPs "
          f"share {measured_fraction:.3g} ({smi})")
    moe_lib.moe_fwd_ep = ep_fn
    del params, dparams, cache, meta_params, meta_cache
    gc.collect()
    torch.cuda.empty_cache()
    procs = start_dryruns()
    t_a = time.perf_counter()

    # (b) falcon-mamba-7b in bf16: the scan on local shards
    from repro_torch.training import tree as tree_lib
    fcfg = get_config(MAMBA_ARCH)
    fmodel = build_model(fcfg)
    fparams = fmodel.init(seed=0, device="cuda")
    ftoks = toks % fcfg.vocab_size
    with torch.no_grad():
        want_logits, _ = fmodel.prefill(fparams, {"tokens": ftoks},
                                        capacity=n)
        fd = on_mesh(fparams, mesh, sp.param_shardings(
            fmodel.init_shapes(), mesh, mode="serve"))
        scan_kernel.LAUNCHES.update(dict.fromkeys(scan_kernel.LAUNCHES, 0))
        with shlib.use_mesh(mesh):
            got_logits, _ = fmodel.prefill(fd, {"tokens": wrap(ftoks)},
                                           capacity=n)
        torch.cuda.synchronize()
        scan_launches = dict(scan_kernel.LAUNCHES)
    got_logits = got_logits.full_tensor()
    if scan_launches["selective_scan"] != fcfg.n_layers:
        fail(f"{MAMBA_ARCH} on the mesh: {scan_launches} scan launches, not "
             f"one a layer ({fcfg.n_layers})")
    if not torch.equal(got_logits, want_logits):
        fail(f"{MAMBA_ARCH} on the mesh: logits differ from the plain "
             f"prefill by {float((got_logits - want_logits).abs().max())}")
    print(f"  {MAMBA_ARCH} bf16 prefill of {n} tokens, DTensor params: "
          f"{scan_launches['selective_scan']} scan launches (one a layer), "
          f"logits bit-equal to the plain prefill")
    del fparams, fd
    gc.collect()
    torch.cuda.empty_cache()

    # (a) the dry-run cells
    print(f"  dry-run cells on the fake production mesh, started "
          f"{time.perf_counter() - t_a:.0f} s ago:")
    rows = finish_dryruns(procs)
    print(f"  dry runs done {time.perf_counter() - t_a:.0f} s after start")
    return {"dryrun": rows, "ep_max_rel_err": max(errs),
            "ep_calls": ep_calls["n"],
            "decode_ms_mesh": float(np.median(mesh_ms)),
            "decode_ms_plain": float(np.median(plain_ms)),
            "counter_flops_card": card_cost.flops,
            "counter_flops_meta": meta_cost.flops,
            "decode_step_ms": step_ms, "roofline": roof.to_dict(),
            "measured_model_flops_share": measured_fraction,
            "scan_launches": scan_launches["selective_scan"],
            "mamba_logits_bit_equal": True, "context_tokens": n}


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
    from repro_torch.launch.mesh import HBM_BYTES
    total = torch.cuda.get_device_properties(0).total_memory
    print(f"total_memory {total} bytes (launch.mesh.HBM_BYTES "
          f"{HBM_BYTES})")

    print(f"[1/12] build ({elapsed()})")
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
        for kname, usage in ptxas_usage(log):
            print(f"    ptxas {kname}: {usage}")

    print(f"[2/12] kernels against the plain version ({elapsed()})")
    kernel_rows, worst = phase_kernels(kernel, ref, Quantized)
    phase_kivi_layouts(kernel, ref)
    timed_rows = {
        "decode_attn": phase_decode_attn(decode_ops, decode_ref),
        "fused_prefill": phase_fused_prefill(fused_ops, fused_ref),
        "flash_attention": phase_flash_attention(flash_ops, flash_ref,
                                                 flash_kernel),
        "selective_scan": phase_selective_scan(scan_ops, scan_ref),
        "selective_scan_bwd": phase_selective_scan_bwd(scan_kernel,
                                                       scan_ref),
    }
    fused_split_err = phase_fused_split(fused_ops, fused_ref, fused_kernel)
    decode_layouts_err = phase_decode_layouts(decode_ops, decode_ref,
                                              decode_kernel)

    print(f"[3/12] serving full-width adaptcache-8b through build_engine "
          f"({elapsed()})")
    summary, launches, wall_s, serving, profile3 = phase_serving()

    print(f"[4/12] fused compute: kernel_bench calibration, then serving "
          f"priced with it ({elapsed()})")
    fused = phase_fused(attn_kernels, summary, serving)

    print(f"[5/12] serving full-width falcon-mamba-7b through build_engine "
          f"({elapsed()})")
    del serving                            # free adaptcache-8b's weights
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  adaptcache-8b freed: {torch.cuda.memory_allocated() / 1e9:.2f} "
          "GB left on the card")
    mamba = phase_mamba(scan_kernel)

    print(f"[6/12] training: the card against the CPU, the train driver's "
          f"resume, full-width adaptcache-8b ({elapsed()})")
    training = phase_training(smi)

    print(f"[7/12] Mamba training: the card against the CPU, the serve "
          f"driver's training, full-width falcon-mamba-7b ({elapsed()})")
    mamba_training = phase_mamba_training(smi, scan_kernel)

    print(f"[8/12] MoE serving: full-width {MOE_ARCH} through build_engine "
          f"({elapsed()})")
    moe_serving = phase_family_serving(MOE_ARCH, "phase-8")

    print(f"[9/12] MLA serving: full-width {MLA_ARCH} through build_engine "
          f"({elapsed()})")
    mla_serving = phase_family_serving(MLA_ARCH, "phase-9")

    print(f"[10/12] VLM serving: full-width {VLM_ARCH} through build_engine, "
          f"its patches and the packed quantized decode cache ({elapsed()})")
    vlm_serving = phase_family_serving(VLM_ARCH, "phase-10", vlm_checks)

    print(f"[11/12] encoder-decoder: full-width {ENCDEC_ARCH}'s encode, "
          f"prefill and decode ({elapsed()})")
    encdec = phase_encdec()

    print(f"[12/12] launch tooling: dry runs on the fake production mesh, "
          f"the mesh path on the card, the step counter ({elapsed()})")
    launch = phase_launch(smi, scan_kernel)
    print(f"  all phases passed ({elapsed()})")

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
                "call_ms": row[f"{op}_call_ms"],
                "plain_ms": row[f"{op}_plain_ms"],
                "bound_ms": row[f"{op}_bound_ms"],
                "bound_by": row[f"{op}_bound_by"],
                "library_ms": None,
            })
    cases = []
    for kname, (rows, err) in timed_rows.items():
        # the main path's case: 4-bit KIVI prefix; f32 flash attention;
        # the scan at (B 1, S 640); its backward at the training shape
        if kname == "selective_scan_bwd":
            row = rows[-1]
        elif kname in ("flash_attention", "selective_scan"):
            row = rows[0]
        else:
            row = next(r for r in rows if r["bits"] == MAIN_BITS)
        # each entry counts its own kernel's launches: flash_attention's
        # f32 row is the f32 tensor-core kernel
        count = row.get("kernel", kname)
        cases.append((kname, kname, row, row.get("max_abs_err", err), count))
    # flash attention's other two kernels
    flash_rows = timed_rows["flash_attention"][0]
    for ename, row in (("flash_attention_bf16", flash_rows[1]),
                       ("flash_attention_cores", flash_rows[2])):
        cases.append((ename, "flash_attention", row, row["max_abs_err"],
                      row["kernel"]))
    counts = {**fused["launches"], **mamba["launches"],
              "selective_scan_bwd": mamba_training["full_width"]["launches"][
                  "selective_scan_bwd"]}
    # the scan's main paths: phase 5's serving and phase 12's mesh prefill
    by_phase = {"selective_scan": {"5": counts["selective_scan"],
                                   "12": launch["scan_launches"]}}
    counts["selective_scan"] += launch["scan_launches"]
    for ename, kname, row, err, count in cases:
        entries.append({
            "name": ename,
            "route": "cuda",
            "source": SOURCES[kname],
            "replaces": REPLACES[kname],
            "launches": counts[count],
            "max_abs_err": err,
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row.get("library_ms"),
        })
        if count in by_phase:
            entries[-1]["launches_by_phase"] = by_phase[count]
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps({
        "card": smi, "device": name, "torch": torch.__version__,
        "total_memory": total,
        "build_s": build_s, "kernel_rows": kernel_rows,
        "timed_rows": {k: v[0] for k, v in timed_rows.items()},
        "fused_split_max_abs_err": fused_split_err,
        "decode_layouts_max_abs_err": decode_layouts_err,
        "kernels": entries, "summary": summary, "launches": launches,
        "engine_wall_s": wall_s, "profile_phase3": profile3,
        "fused": fused, "mamba": mamba, "training": training,
        "mamba_training": mamba_training, "moe_serving": moe_serving,
        "mla_serving": mla_serving, "vlm_serving": vlm_serving,
        "encdec": encdec, "launch": launch, "decode_graph": DECODE_GRAPH,
        "elapsed_s": time.perf_counter() - T_START},
        indent=1, default=float))
    (out_dir / "fused_calibration.json").write_text(
        json.dumps(fused["calibration"], indent=2))
    full = training["full_width"]
    print(json.dumps({"decode_graph": DECODE_GRAPH}))
    print(json.dumps({"training": {
        "card": smi,
        "card_vs_cpu_loss_rel_err_max": max(
            r["loss_rel_err"] for r in training["card_vs_cpu"]["steps"]),
        "card_vs_cpu_grad_norm_rel_err_step0":
            training["card_vs_cpu"]["steps"][0]["grad_norm_rel_err"],
        "resume_leaves_bit_equal": training["driver"]["leaves"],
        **{k: full[k] for k in (
            "n_params", "batch", "seq", "median_step_s", "tokens_per_s",
            "model_flops_share", "max_memory_gb", "ce_rel_err")},
        "losses": [r["loss"] for r in full["steps"]],
        "grad_norms": [r["grad_norm"] for r in full["steps"]],
        "adamw_s": [r["adamw_s"] for r in full["steps"]],
        "profile_idle_share": full["profile"]["idle_share"],
        "profile_busy_ms": full["profile"]["busy_ms"],
        "profile_top3": [op["name"][:60] for op in
                         full["profile"]["top"][:3]]}}))
    mfull = mamba_training["full_width"]
    print(json.dumps({"mamba_training": {
        "card": smi,
        "card_vs_cpu_loss_rel_err_max": max(
            r["loss_rel_err"] for r in mamba_training["card_vs_cpu"]["steps"]),
        "card_vs_cpu_grad_norm_rel_err_step0":
            mamba_training["card_vs_cpu"]["steps"][0]["grad_norm_rel_err"],
        "serve_driver_scan_launches": mamba_training["driver"]["launches"],
        **{k: mfull[k] for k in (
            "n_params", "batch", "seq", "median_step_s", "tokens_per_s",
            "model_flops_share", "max_memory_gb", "ce_rel_err", "launches")},
        "losses": [r["loss"] for r in mfull["steps"]],
        "grad_norms": [r["grad_norm"] for r in mfull["steps"]],
        "adamw_s": [r["adamw_s"] for r in mfull["steps"]],
        "profile_idle_share": mfull["profile"]["idle_share"],
        "profile_busy_ms": mfull["profile"]["busy_ms"],
        "profile_scan_ms": mfull["profile"]["scan_ms"],
        "profile_top3": [op["name"][:60] for op in
                         mfull["profile"]["top"][:3]]}}))
    print(json.dumps({"moe_serving": family_line(moe_serving, smi)}))
    print(json.dumps({"mla_serving": family_line(mla_serving, smi)}))
    print(json.dumps({"vlm_serving": family_line(vlm_serving, smi)}))
    print(json.dumps({"encdec": encdec_line(encdec, smi)}))
    print(json.dumps({"launch": {
        "card": smi, "dryrun": [
            {k: r[k] for k in ("arch", "shape", "mesh", "flops_per_chip",
                               "hbm_bytes_per_chip",
                               "collective_bytes_per_chip", "bottleneck",
                               "analytic_peak_bytes", "fits_hbm", "step_s")}
            for r in launch["dryrun"]],
        **{k: launch[k] for k in (
            "ep_max_rel_err", "ep_calls", "decode_ms_mesh", "decode_ms_plain",
            "counter_flops_card", "counter_flops_meta", "decode_step_ms",
            "measured_model_flops_share", "scan_launches",
            "mamba_logits_bit_equal")},
        "roofline_fraction": launch["roofline"]["roofline_fraction"],
        "roofline_bottleneck": launch["roofline"]["bottleneck"]}}))
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
