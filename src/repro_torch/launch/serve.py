"""Serving driver: AdaptCache end-to-end on a smoke model, in the port.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch adaptcache-8b \
        --policy adaptive --alpha 0.01 --rate 0.5 --duration 60 \
        [--train-steps 150] [--device cuda|cpu] [--fit-estimator] \
        [--replicas N] [--lanes K]

The same flags as ``repro.launch.serve``, plus ``--device`` (CUDA unless
``--device cpu``). Trains the smoke model on the recall task first (so
compression has a measurable quality effect; ``--train-steps 0`` serves
from the seeded init), optionally fits the paper's offline quality
estimator, then serves a Poisson workload on the duplex-async event
engine (loads/prefills overlap decode, inserts and MCKP moves queue on
write channels, ``--prefetch N`` enables speculative SSD->DRAM
promotion; ``--serialized`` selects the legacy blocking loop) and prints
the TTFT/quality/hit-rate summary with the queue/load/prefill/decode
and write-back breakdowns.

Topology flags: ``--split-dram`` gives each replica its own DRAM tier
(locality-aware placement, cross-replica hits pay ``--xlink-gbps``);
``--half-duplex`` makes the shared SSD's reads and writes draw from one
bandwidth budget; ``--prefetch-deadline`` suppresses promotions that
would land after the predicted next hit.

Paging flags: ``--paged`` serves page-granular (``--page-tokens`` per
page) so prefix-sharing requests reuse the matched page run and prefill
only the suffix; ``--chunk-tokens N`` splits (suffix) prefills into
N-token chunks interleaved with decode on one unified compute channel
per replica; ``--affinity`` routes arrivals to the replica whose local
DRAM holds the longest cached page run (needs ``--split-dram``);
``--readahead-pages N`` turns on page-level sequential readahead (hot
page runs staged SSD->DRAM, suffix prefill pipelined with the page
loads); ``--remainder-cache`` stores the sub-page tail per context so
exact repeats recompute nothing. Both need ``--paged``.

``--trace PATH`` serves with the port's tracer on
(``repro_torch.runtime.trace``) and writes its spans to PATH as
chrome-trace JSON on the wall clock (``ts`` in µs since the epoch; lay
them beside a ``torch.profiler`` trace by subtracting its
``baseTimeNanoseconds`` / 1000). Beside the simulated summary it prints
``wall_first_token_p50_s``, the median host seconds from a request's
dispatch to its first answer token, and the counters' totals:
``h2d_bytes`` (bytes copied host to device: lane copies and KIVI's
uploads), ``d2h_bytes`` (device to host: KIVI's results, prefilled
entries, each tick's tokens with its MoE slot counts, a prefill's
per-expert counts), ``host_reads`` (blocking device-to-host reads: one
a decode tick, and one a MoE layer of a prefill) and
``policy.estimates`` (the policy's size estimates).
The simulated summary is the same with and without it.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.runtime import trace
from repro_torch.serving.baselines import build_engine, fit_quality_estimator
from repro_torch.serving.engine import summarize
from repro_torch.serving.runner import ModelRunner
from repro_torch.serving.workload import (
    DEFAULT_TENANTS, make_contexts, make_tenant_workload, poisson_requests,
)
from repro_torch.storage.topology import StorageTopology
from repro_torch.training.data import Pipeline, PipelineConfig
from repro_torch.training.optimizer import AdamWConfig, wsd_schedule
from repro_torch.training.train_step import init_train_state, make_train_step


def smoke_opt_config(steps: int) -> AdamWConfig:
    """The smoke model's optimizer: AdamW under a WSD schedule peaking at
    3e-3 over ``steps`` steps."""
    return AdamWConfig(lr=wsd_schedule(3e-3, steps // 10, steps // 2,
                                       steps // 3))


def train_smoke_model(cfg, steps: int = 150, seq: int = 192, batch: int = 8,
                      seed: int = 0, device="cuda"):
    """Train ``cfg``'s model on the recall pipeline for ``steps`` steps
    from ``seed``'s init on ``device``; returns (model, params). With 0
    steps the params are the seeded init."""
    dev = resolve_device(device)
    model = build_model(cfg)
    opt_cfg = smoke_opt_config(steps)
    state = init_train_state(model, seed, opt_cfg, dev)
    if steps == 0:
        print("no training steps: serving from the seeded init")
        return model, state.params
    step_fn = make_train_step(model, opt_cfg)
    pipe = Pipeline(PipelineConfig(cfg.vocab_size, seq, batch, kind="recall",
                                   seed=seed))
    for _ in range(steps):
        b = {k: torch.as_tensor(v, dtype=torch.long, device=dev)
             for k, v in pipe.next_batch().items()}
        state, m = step_fn(state, b)
    print(f"smoke model trained {steps} steps, final loss "
          f"{float(m['loss']):.4f}")
    return model, state.params


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="adaptcache-8b")
    ap.add_argument("--policy", default="adaptive",
                    help="adaptive | prefill | none | kivi:<rate> | "
                         "streaming_llm:<rate>")
    ap.add_argument("--alpha", type=float, default=0.01)
    ap.add_argument("--depth-discount", type=float, default=0.85,
                    help="run-aware page utility: per-page-depth discount "
                         "on the run's predicted hit rate (adaptive "
                         "policy, paged mode) — hot-prefix pages out-rank "
                         "deep-tail pages at equal recency")
    ap.add_argument("--rate", type=float, default=0.5, help="req/s")
    ap.add_argument("--duration", type=float, default=90.0)
    ap.add_argument("--contexts-per-task", type=int, default=4)
    ap.add_argument("--train-steps", type=int, default=150)
    ap.add_argument("--fit-estimator", action="store_true")
    ap.add_argument("--dram-entries", type=float, default=3.0)
    ap.add_argument("--ssd-entries", type=float, default=12.0)
    ap.add_argument("--replicas", type=int, default=1,
                    help="engine replicas sharing one cache hierarchy")
    ap.add_argument("--lanes", type=int, default=2,
                    help="continuous-batching lanes per replica")
    ap.add_argument("--split-dram", action="store_true",
                    help="per-replica DRAM tiers (dram:<r>, each with "
                         "--dram-entries of its own capacity) instead of "
                         "one shared DRAM tier")
    ap.add_argument("--half-duplex", action="store_true",
                    help="SSD reads and writes share one bandwidth "
                         "budget (single arbitration queue) instead of "
                         "independent duplex channels")
    ap.add_argument("--xlink-gbps", type=float, default=8.0,
                    help="replica-to-replica copy bandwidth for "
                         "cross-replica DRAM hits (GB/s)")
    ap.add_argument("--prefetch", type=int, default=0, metavar="N",
                    help="max in-flight speculative SSD->DRAM promotions "
                         "(0 disables prefetch)")
    ap.add_argument("--prefetch-min-hz", type=float, default=0.0,
                    help="min predicted hit rate for a prefetch candidate")
    ap.add_argument("--prefetch-deadline", action="store_true",
                    help="suppress promotions whose estimated transfer "
                         "would finish after the predicted next hit")
    ap.add_argument("--paged", action="store_true",
                    help="page-granular serving: store/match fixed-token "
                         "pages so partial prefix matches skip re-prefill")
    ap.add_argument("--page-tokens", type=int, default=64,
                    help="tokens per page in --paged mode")
    ap.add_argument("--chunk-tokens", type=int, default=0, metavar="N",
                    help="split (suffix) prefills into N-token chunks "
                         "interleaved with decode on one unified compute "
                         "channel per replica (0 = dedicated prefill "
                         "stream)")
    ap.add_argument("--affinity", action="store_true",
                    help="route arrivals to the replica whose local DRAM "
                         "holds the longest cached page run (requires "
                         "--split-dram to matter)")
    ap.add_argument("--readahead-pages", type=int, default=0, metavar="N",
                    help="page-level sequential readahead: up to N "
                         "in-flight SSD->DRAM page promotions staged "
                         "along hot page runs, and suffix prefill "
                         "pipelined with the page loads (0 disables; "
                         "requires --paged)")
    ap.add_argument("--remainder-cache", action="store_true",
                    help="store the sub-page remainder (T mod page "
                         "tokens) per context so exact repeats are full "
                         "hits instead of re-prefilling the tail "
                         "(requires --paged)")
    ap.add_argument("--fused-compute", action="store_true",
                    help="price compressed KV at resident bytes on the "
                         "compute path: fused-eligible methods (KIVI "
                         "packing) skip the standalone decompress pass "
                         "and HBM-bound attention terms read packed "
                         "bytes (kernels/fused_prefill)")
    ap.add_argument("--fused-calibration", default="",
                    help="path to a fused-calibration JSON written by the "
                         "port's kernel_bench (python -m "
                         "repro_torch.launch.kernel_bench; default "
                         "experiments/torch/fused_calibration.json); sets the "
                         "residual decompress fraction from measurement "
                         "instead of the ideal-fusion default of 0")
    ap.add_argument("--sanitize", action="store_true",
                    help="run the event engine under the SimSanitizer "
                         "runtime invariant checker (byte conservation, "
                         "causality, write fencing, transfer accounting; "
                         "read-only — results are bit-identical; also "
                         "enabled by SIMCHECK=1)")
    ap.add_argument("--selector", default="indexed",
                    choices=["indexed", "scan"],
                    help="placement selection engine: incremental "
                         "per-tier move heaps (indexed, amortized "
                         "O(log N)) or the reference full scan — "
                         "decisions are identical (docs/perf.md)")
    ap.add_argument("--tenants", type=int, default=0, metavar="N",
                    help="serve a multi-tenant diurnal workload mixing the "
                         "first N default tenants (chat/rag/agent: "
                         "priority tier, token quota, TTFT SLO) instead "
                         "of the single-tenant Poisson mix (0 = off)")
    ap.add_argument("--token-budget", type=int, default=0, metavar="T",
                    help="per-tick prefill token budget on the unified "
                         "compute channel: each tick admits at most T "
                         "chunk tokens (tier/deadline priority order) "
                         "before booking decode, bounding decode "
                         "inter-token latency under prefill storms "
                         "(0 = FIFO interleave; requires --chunk-tokens)")
    ap.add_argument("--slo", type=float, default=0.0, metavar="S",
                    help="override every tenant's TTFT SLO to S seconds "
                         "for deadline-based chunk ordering (0 keeps "
                         "each tenant's own SLO; requires --tenants)")
    ap.add_argument("--serialized", action="store_true",
                    help="use the legacy load-blocking loop (baseline)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device the model and the KIVI kernel run "
                         "on (cuda unless 'cpu' is asked for)")
    ap.add_argument("--trace", default="", metavar="PATH",
                    help="serve with the port's tracer on and write its "
                         "spans to PATH as chrome-trace JSON; prints the "
                         "wall-clock first-token p50 and the counters")
    args = ap.parse_args(argv)
    if (args.readahead_pages or args.remainder_cache) and not args.paged:
        ap.error("--readahead-pages and --remainder-cache are page-native "
                 "features: add --paged")
    if args.token_budget and not args.chunk_tokens:
        ap.error("--token-budget budgets the unified compute tick: add "
                 "--chunk-tokens")
    if args.slo and not args.tenants:
        ap.error("--slo overrides tenant TTFT SLOs: add --tenants")

    smoke_cfg = get_config(args.arch, smoke=True)
    full_cfg = get_config(args.arch)
    model, params = train_smoke_model(smoke_cfg, args.train_steps,
                                      device=args.device)
    runner = ModelRunner(model, params, capacity=1024)

    rng = np.random.RandomState(args.seed)
    tenants = None
    if args.tenants:
        import dataclasses as _dc
        tenants = list(DEFAULT_TENANTS[:args.tenants])
        if args.slo:
            tenants = [_dc.replace(t, ttft_slo_s=args.slo)
                       for t in tenants]
        contexts, requests = make_tenant_workload(
            rng, smoke_cfg.vocab_size,
            n_docs_per_tenant=args.contexts_per_task,
            tenants=tenants, base_rate_hz=args.rate,
            duration_s=args.duration)
        print(f"{len(tenants)} tenants: "
              + ", ".join(f"{t.name}(tier={t.tier}, "
                          f"quota={t.quota_tokens}tok)" for t in tenants))
    else:
        contexts = make_contexts(rng, smoke_cfg.vocab_size,
                                 args.contexts_per_task, n_probes=3)
        requests = poisson_requests(rng, contexts, args.rate, args.duration)
    print(f"{len(contexts)} contexts, {len(requests)} requests")

    if args.policy in ("adaptive", "prefill"):
        policy = args.policy
    else:
        name, _, r = args.policy.partition(":")
        policy = (name, float(r) if r else 1.0)

    topology = StorageTopology(replicas=args.replicas,
                               shared_dram=not args.split_dram,
                               duplex_ssd=not args.half_duplex,
                               xlink_bps=args.xlink_gbps * 1e9)
    n_active = build_model(full_cfg).active_param_count()
    residual_frac = 0.0
    if args.fused_calibration:
        from repro_torch.core.estimator import load_fused_calibration
        cal = load_fused_calibration(args.fused_calibration)
        residual_frac = cal.residual_frac
        print(f"fused calibration: speedup {cal.speedup:.2f}x, "
              f"residual frac {residual_frac:.3f}")
    rig = build_engine(runner, contexts, full_cfg, n_active, policy=policy,
                       alpha=args.alpha, dram_entries=args.dram_entries,
                       ssd_entries=args.ssd_entries,
                       n_replicas=args.replicas, n_lanes=args.lanes,
                       prefetch_max_inflight=args.prefetch,
                       prefetch_min_hz=args.prefetch_min_hz,
                       prefetch_deadline=args.prefetch_deadline,
                       topology=topology,
                       page_tokens=args.page_tokens if args.paged else 0,
                       chunk_tokens=args.chunk_tokens,
                       affinity=args.affinity,
                       readahead_pages=args.readahead_pages,
                       remainder_cache=args.remainder_cache,
                       depth_discount=args.depth_discount,
                       fused_compute=args.fused_compute,
                       fused_residual_frac=residual_frac,
                       sanitize=args.sanitize,
                       selector=args.selector,
                       token_budget=args.token_budget,
                       tenants=tenants)
    if args.fit_estimator and args.policy == "adaptive":
        fit_quality_estimator(rig, contexts)
        print("quality estimator fitted")

    if args.serialized and (args.paged or args.chunk_tokens):
        print("note: --serialized ignores --paged/--chunk-tokens "
              "(whole-context blocking loop)")
    if args.trace:
        trace.enable()
    try:
        results = (rig.engine.process_serialized(requests)
                   if args.serialized else rig.engine.process(requests))
    finally:
        records = trace.take()
        trace.disable()
    s = summarize(results,
                  chunk_stats=(rig.engine.chunk_stats
                               if args.chunk_tokens and not args.serialized
                               else None),
                  readahead_stats=(rig.engine.readahead_stats
                                   if args.readahead_pages
                                   and not args.serialized else None),
                  selector_stats=rig.controller.selector.stats)
    print("\n=== serving summary ===")
    for k, v in s.items():
        print(f"  {k:16s} {v:.4f}" if isinstance(v, float) else
              f"  {k:16s} {v}")
    if args.prefetch and not args.serialized:
        for k, v in rig.engine.prefetch_stats.items():
            print(f"  prefetch.{k:10s} {v}")
    # readahead counters already appear as the summary's readahead_*
    # keys (summarize is passed readahead_stats above)
    for k, v in rig.controller.stats().items():
        if isinstance(v, (int, float)):
            print(f"  ctrl.{k:14s} {v}")
    if args.trace:
        with open(args.trace, "w") as f:
            json.dump(records.chrome_trace(), f)
        walls = [r.wall_first_token_s for r in results
                 if r.wall_first_token_s is not None]
        print(f"\n=== traced (wall clock; {len(records.spans)} spans in "
              f"{args.trace}) ===")
        if walls:
            print(f"  wall_first_token_p50_s {statistics.median(walls):.6f}")
        for k, v in sorted(records.counters.items()):
            print(f"  {k:22s} {v}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
