"""Engine builders: AdaptCache + the paper's four baselines on one rig.

    build_engine(..., policy="adaptive", alpha=0.01)
    build_engine(..., policy=("kivi", 0.16))          # KIVI LRU
    build_engine(..., policy=("streaming_llm", 0.25)) # StreamingLLM LRU
    build_engine(..., policy=("none", 1.0))           # Without Compression
    build_engine(..., policy="prefill")               # always recompute

Tier sizing: capacities are given in *average-entry units* and bandwidths
are scaled by (full-scale entry bytes / smoke entry bytes), so the
DRAM-vs-SSD pressure and delay regime match the paper's 100 GB/400 GB
A100 box while the actual stored bytes are smoke-scale (DESIGN.md §8.5).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core.compression import default_registry
from repro_torch.core.controller import AdaptCacheController, SimClock
from repro_torch.core.estimator import (
    DEFAULT_DECOMPRESS_BPS, FUSED_COMPUTE_METHODS, DelayProfile,
    FrequencyEstimator, QualityEstimator,
)
from repro_torch.core.policy import AdaptivePolicy, FixedPolicy
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.runner import ModelRunner
from repro_torch.serving.timemodel import A100, DeviceModel, TimeModel
from repro_torch.serving.workload import Context, Tenant
from repro_torch.storage.tier import DRAMTier, DeviceSpec, SSDTier
from repro_torch.storage.topology import StorageTopology

PolicySpec = Union[str, Tuple[str, float]]


@dataclasses.dataclass
class EngineRig:
    engine: ServingEngine
    controller: AdaptCacheController
    quality_est: Optional[QualityEstimator]
    clock: SimClock


def build_engine(runner: ModelRunner, contexts: Sequence[Context],
                 full_cfg: ModelConfig, n_active_params: int,
                 policy: PolicySpec = "adaptive", alpha: float = 0.01,
                 dram_entries: float = 4.0, ssd_entries: float = 24.0,
                 device: DeviceModel = A100,
                 quality_est: Optional[QualityEstimator] = None,
                 ssd_root: Optional[str] = None,
                 n_replicas: int = 1, n_lanes: int = 2,
                 prefetch_max_inflight: int = 0,
                 prefetch_min_hz: float = 0.0,
                 prefetch_cooldown_s: float = 1.0,
                 prefetch_deadline: bool = False,
                 topology: Optional[StorageTopology] = None,
                 page_tokens: int = 0,
                 chunk_tokens: int = 0,
                 affinity: bool = False,
                 readahead_pages: int = 0,
                 remainder_cache: bool = False,
                 depth_discount: float = 0.85,
                 fused_compute: bool = False,
                 fused_residual_frac: float = 0.0,
                 sanitize: bool = False,
                 selector: str = "indexed",
                 token_budget: int = 0,
                 tenants: Optional[Sequence[Tenant]] = None) -> EngineRig:
    # the KIVI arms quantize and dequantize where the model runs
    methods = default_registry(runner.device)
    smoke_cfg = runner.model.cfg
    if topology is None:
        topology = StorageTopology(replicas=n_replicas)
    elif not topology.shared_dram and topology.replicas != n_replicas:
        raise ValueError("topology replica count must match n_replicas")

    # ---- entry-size scaling: smoke bytes <-> full-scale bytes ----
    avg_tokens = float(np.mean([len(c.tokens) for c in contexts]))
    smoke_entry = max(1.0, avg_tokens * smoke_cfg.kv_bytes_per_token() * 2.0)
    full_entry = avg_tokens * max(full_cfg.kv_bytes_per_token(), 1)
    scale = full_entry / smoke_entry
    # the replica-to-replica link moves the same smoke-scale bytes the
    # tiers store, so its bandwidth scales with them
    topology = dataclasses.replace(topology,
                                   xlink_bps=topology.xlink_bps / scale)

    # per-replica DRAM: EACH replica brings ``dram_entries`` of its own
    # host memory (aggregate capacity grows with replicas, as in a real
    # multi-host deployment); shared DRAM is one global tier as before
    dram_spec = DeviceSpec("dram", int(dram_entries * smoke_entry),
                           16e9 / scale, 16e9 / scale, 20e-6)
    ssd_spec = DeviceSpec("ssd", int(ssd_entries * smoke_entry),
                          1e9 / scale, 1e9 / scale, 100e-6)
    tiers = {name: DRAMTier(dram_spec, name=name)
             for name in topology.dram_names}
    tiers["ssd"] = SSDTier(ssd_spec, root=ssd_root)
    order = topology.tier_names

    freq = FrequencyEstimator(halflife_s=600.0)
    # fused compute: KIVI-packed methods skip the standalone decompress
    # pass (the attention kernel dequantizes in VREGs), paying only the
    # measured residual fraction — kernel_bench calibrates it; 0.0 is
    # the ideal-fusion default. Off = profiled pricing, bit-identical.
    delay_profile = DelayProfile(
        {m: (bps / scale if np.isfinite(bps) else bps)
         for m, bps in DEFAULT_DECOMPRESS_BPS.items()},
        fused_methods=(FUSED_COMPUTE_METHODS if fused_compute
                       else frozenset()),
        fused_residual_frac=fused_residual_frac)
    qe = quality_est or QualityEstimator()

    if policy == "adaptive":
        pol = AdaptivePolicy(methods, tiers, order, qe, freq, delay_profile,
                             alpha=alpha, topology=topology,
                             depth_discount=depth_discount)
    elif policy == "prefill":
        # zero-capacity tiers: every request misses -> recompute
        tiers = {name: DRAMTier(DeviceSpec("dram", 0, 16e9, 16e9),
                                name=name)
                 for name in topology.dram_names}
        tiers["ssd"] = SSDTier(DeviceSpec("ssd", 0, 1e9, 1e9),
                               root=ssd_root)
        pol = FixedPolicy(methods, order, "none", 1.0, topology=topology)
    else:
        mname, rate = policy
        pol = FixedPolicy(methods, order, mname, rate, topology=topology)

    clock = SimClock()
    ctrl = AdaptCacheController(methods, tiers, order, pol, delay_profile,
                                freq, clock=clock, topology=topology,
                                selector=selector)
    # composed-quality pricing: match_prefix scores each served piece
    # through the same estimator the adaptive policy optimizes with, so
    # FetchPlan.quality / RequestResult.composed_quality are consistent
    # across adaptive and fixed-rate baselines
    ctrl.quality_est = qe
    # multi-tenant SLO knobs: tenant quotas are declared in TOKENS and
    # converted to stored smoke-scale bytes with the same per-token
    # factor the tiers are sized with, so a quota of N tokens holds the
    # same tier fraction at any scale; zero/absent quotas enforce nothing
    tenant_map = {t.name: t for t in tenants} if tenants else None
    if tenant_map:
        tok_bytes = smoke_cfg.kv_bytes_per_token() * 2.0
        ctrl.set_tenant_quotas(
            {t.name: int(t.quota_tokens * tok_bytes)
             for t in tenant_map.values() if t.quota_tokens > 0})
    tm = TimeModel(full_cfg, device, n_active_params)
    eng = ServingEngine(runner, ctrl, tm, contexts, n_replicas=n_replicas,
                        n_lanes=n_lanes, sim_clock=clock,
                        prefetch_max_inflight=prefetch_max_inflight,
                        prefetch_min_hz=prefetch_min_hz,
                        prefetch_cooldown_s=prefetch_cooldown_s,
                        prefetch_deadline=prefetch_deadline,
                        page_tokens=page_tokens, chunk_tokens=chunk_tokens,
                        affinity=affinity, readahead_pages=readahead_pages,
                        remainder_cache=remainder_cache,
                        fused_compute=fused_compute, sanitize=sanitize,
                        token_budget=token_budget, tenants=tenant_map)
    return EngineRig(eng, ctrl, qe, clock)


def fit_quality_estimator(rig: EngineRig, contexts: Sequence[Context],
                          samples_per_task: int = 3) -> QualityEstimator:
    """Paper's offline profiling: sample entries per dataset, run probe
    questions through compress->generate->compare, fit the curves."""
    qe = rig.quality_est
    by_task: Dict[str, list] = {}
    for c in contexts:
        by_task.setdefault(c.task_type, []).append(c)
    for task, ctxs in by_task.items():
        sample = ctxs[:samples_per_task]
        kvs, probes = [], []
        for c in sample:
            kv = rig.engine.runner.prefill_entry(c.tokens)
            kvs.append(kv)
            probes.append(rig.engine.quality_probe(c))

        def probe_dispatch(kv, mname, rate, _kvs=kvs, _probes=probes):
            i = next(j for j, K in enumerate(_kvs) if K is kv)
            return _probes[i](kv, mname, rate)

        qe.fit(task, rig.engine.controller.methods, kvs, probe_dispatch)
    return qe
