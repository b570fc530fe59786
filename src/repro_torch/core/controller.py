"""AdaptCacheController: the facade tying estimator + policy + executor.

Serving-engine contract:
    insert(key, kv, task_type, now=t [, transfers])  — store a fresh entry
    fetch(key, now=t)                  — load on hit; (kv, delay breakdown)
    promote(key, now=t [, transfers])  — speculative prefetch into DRAM
    prefetch_candidates(now=t)         — hot slow-tier keys, hottest first
    run_candidates(now=t)              — hot PAGE RUNS (key chain) for
                                         sequential readahead
    lookup(key)                        — tier name or None
    stats()                            — hit rates per tier, byte counters

``now`` is the *simulated* event-loop timestamp: the event-driven engine
passes the issue time on fetch and the completion time on insert, so
frequency estimates (EWMA hit rates) and utility recomputation see the
same clock the requests experience. When callers omit ``now`` the
controller falls back to ``clock()``; serving rigs wire a shared
``SimClock`` there (advanced by the engine as events fire), standalone
use defaults to wall time. One controller may be shared by N engine
replicas — all state (tiers, meta, estimators) is global to the
hierarchy while fetch *contention* is modeled engine-side per tier.

Topology awareness: constructed with a ``StorageTopology`` whose DRAM is
split per replica, ``insert``/``fetch``/``promote`` take the acting
replica. Inserts stamp ``meta.home_replica`` so the policy's expanded
MCKP (one knapsack choice per replica DRAM) prices sibling placements
with the replica-to-replica copy; fetches of entries resident in a
sibling's DRAM report ``remote``/``xlink_delay_s`` and count in
``hit_remote``; promotions target the acting replica's own DRAM.

Decision vs movement: every state-changing call is an *instantaneous
placement decision* on the data plane (bytes land immediately, so byte
conservation is exact at every event), while the *time cost* of each
byte movement is reported as a ``Transfer`` appended to the caller's
``transfers`` list. The event engine books those transfers on the
destination tier's write ``IOChannel`` (``Tier.store_delay_s``) and the
source tier's read channel, and fences fetches of still-writing keys —
so insert write-back, MCKP demotions, and prefetch promotions all
contend with serving fetches in simulated time. Callers that pass no
``transfers`` list (unit tests, the serialized baseline loop) keep the
legacy zero-delay semantics.

Capacity is enforced by the greedy MCKP loop: after any byte growth in a
tier, apply minimal-marginal-utility-drop moves until all tiers fit
(demotions cascade fast tier -> slow tier -> eviction).
"""
from __future__ import annotations

import dataclasses
import heapq
import time
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.compression.base import KVData, kv_nbytes, kv_num_tokens
from repro_torch.core.entry import EntryMeta
from repro_torch.core.estimator import (
    DelayProfile, FrequencyEstimator, QualityEstimator,
    RunFrequencyEstimator, redundancy_feature,
)
from repro_torch.core.executor import Executor
from repro_torch.core.policy import AdaptivePolicy, BasePolicy, Move, Placement
from repro_torch.core.selector import make_selector
from repro_torch.runtime import trace
from repro_torch.storage.tier import Tier
from repro_torch.storage.topology import StorageTopology


class SimClock:
    """Mutable simulated-time source shared by engine and controller."""

    def __init__(self, now: float = 0.0):
        self.now = now

    def __call__(self) -> float:
        return self.now

    def advance(self, t: float) -> None:
        self.now = max(self.now, t)


@dataclasses.dataclass(frozen=True)
class Transfer:
    """One queued byte movement emitted by a placement decision.

    ``dst_tier`` is charged on its WRITE channel for ``nbytes``;
    ``src_tier`` (when the bytes come out of another tier: demote,
    recompress, promote) is charged on its READ channel for
    ``read_nbytes`` first. Fresh inserts have no source tier.
    """
    key: str
    kind: str                       # "insert" | "demote" | "recompress" | "promote"
    dst_tier: str
    nbytes: int
    src_tier: Optional[str] = None
    read_nbytes: int = 0


@dataclasses.dataclass
class FetchResult:
    kv: KVData
    tier: str
    method: str
    rate: float
    load_delay_s: float
    decompress_delay_s: float
    nbytes: int
    # topology: the entry lived in a SIBLING replica's DRAM — the hit
    # pays the replica-to-replica copy on top of the owner's read path
    remote: bool = False
    xlink_delay_s: float = 0.0
    # uncompressed footprint of the entry (EntryMeta.orig_bytes): lets
    # the engine price HBM reads at RESIDENT bytes instead of the dense
    # footprint when the attention kernel consumes the packed format
    orig_nbytes: int = 0

    @property
    def total_delay_s(self) -> float:
        return self.load_delay_s + self.xlink_delay_s \
            + self.decompress_delay_s


class AdaptCacheController:
    """Facade tying estimator + policy + executor into one cache API.

    Contract: every public call is instantaneous on the data plane —
    bytes land (or leave) the moment the call returns, so per-tier byte
    conservation holds at every event; the TIME cost of each movement is
    returned as queued ``Transfer``s / delay fields for the caller to
    book. All delays are SECONDS of simulated time, all sizes are stored
    BYTES (post-compression). ``now`` arguments are simulated timestamps
    and must be monotone per caller: the engine passes fetch *issue*
    times and insert *completion* times, so EWMA frequency estimates see
    the clock the requests experience. The controller is shared state
    across engine replicas; it performs no locking and assumes the
    single-threaded event-loop discipline of the serving engine.
    """

    def __init__(self, methods, tiers: Dict[str, Tier],
                 tier_order: Sequence[str], policy: BasePolicy,
                 delay_profile: DelayProfile,
                 freq: FrequencyEstimator,
                 # standalone (non-engine) use falls back to wall time
                 # by design; serving rigs always wire a SimClock here
                 clock=time.monotonic,  # simcheck: ignore[wallclock]
                 topology: Optional[StorageTopology] = None,
                 selector: str = "indexed"):
        self.methods = methods
        self.tiers = tiers
        self.tier_order = list(tier_order)
        self.policy = policy
        self.delay_profile = delay_profile
        self.freq = freq
        self.clock = clock
        self.topology = topology
        self.executor = Executor(methods, tiers, tier_order)
        self.meta: Dict[str, EntryMeta] = {}
        # page-run signals (paged serving): run-level hit-rate EWMA plus
        # the latest observed page-key chain per run, consumed by the
        # engine's sequential readahead (run_candidates). The registry
        # is capped: when it overflows, the coldest run (and its EWMA
        # state) is dropped, so a long unique-context stream cannot grow
        # it or the per-event candidate scan without bound.
        self.run_freq = RunFrequencyEstimator()
        self.page_runs: Dict[str, List[str]] = {}
        self.max_page_runs = 512
        # reverse map page/remainder key -> run key, maintained alongside
        # page_runs: the policy's run-aware utility looks a page's run up
        # here (pruned together with the capped registry)
        self.run_of: Dict[str, str] = {}
        if isinstance(policy, AdaptivePolicy):
            policy.bind_run_signals(self.run_freq, self.run_of.get)
        # optional quality estimator for request-level composed quality
        # (PagedPrefixCache.match_prefix prices each matched piece with
        # it); serving rigs wire the same estimator the policy uses
        self.quality_est: Optional[QualityEstimator] = None
        self.counters = {"hits": 0, "misses": 0, "inserts": 0,
                         "prefetches": 0, "hit_remote": 0,
                         "page_runs": 0, "page_run_hits": 0,
                         "page_runs_full": 0, "page_runs_partial": 0,
                         "page_runs_miss": 0, "quota_evictions": 0,
                         **{f"hit_{t}": 0 for t in tier_order}}
        # placement selection engine: "indexed" (amortized O(log N)
        # lazy move heaps) or "scan" (the reference full scan) — both
        # produce identical decisions (see repro_torch.core.selector and
        # docs/perf.md); fig10 pins the equivalence at scale
        self.selector = make_selector(selector, self)
        # optional: callers (tests, the SIMCHECK cross-check harness)
        # set this to a list to record every applied enforcement Move
        self.move_log: Optional[List[Move]] = None
        # per-tenant resident-byte quotas (tenant name -> bytes; empty =
        # quotas off, zero behavior change). Inserts stamped with a
        # quoted tenant trigger quota eviction BEFORE capacity
        # enforcement, so a storming tenant sheds its own coldest bytes
        # instead of flushing other tenants' hot sets.
        self.tenant_quotas: Dict[str, int] = {}

    def set_tenant_quotas(self, quotas: Dict[str, int]) -> None:
        """Install per-tenant resident-byte quotas (<= 0 = unlimited)."""
        self.tenant_quotas = {name: int(b) for name, b in quotas.items()
                              if b and b > 0}

    def tenant_resident_bytes(self, tenant: str) -> int:
        """The tenant's resident footprint across all tiers (ledger)."""
        return self.executor.tenant_resident_bytes(tenant)

    # -- public API -----------------------------------------------------------
    def lookup(self, key: str) -> Optional[str]:
        m = self.meta.get(key)
        return m.tier if m and m.tier else None

    def insert(self, key: str, kv: KVData, task_type: str,
               now: Optional[float] = None,
               transfers: Optional[List[Transfer]] = None,
               replica: Optional[int] = None,
               tenant: Optional[str] = None) -> Placement:
        now = self.clock() if now is None else now
        old = self.meta.get(key)
        if old is not None and old.tier:
            return Placement(old.tier, old.method, old.rate)
        if old is not None:
            # Re-insert after eviction: the policy's utility ranking runs
            # on hits/last_hit history, so merge into the surviving meta
            # instead of rebuilding it (only content-derived features and
            # the creation stamp refresh).
            meta = old
            meta.task_type = task_type
            meta.n_tokens = kv_num_tokens(kv)
            meta.orig_bytes = kv_nbytes(kv)
            meta.redundancy = redundancy_feature(kv)
            meta.created_at = now
            meta.home_replica = replica
            meta.tenant = tenant
        else:
            meta = EntryMeta(key=key, task_type=task_type,
                             n_tokens=kv_num_tokens(kv),
                             orig_bytes=kv_nbytes(kv),
                             redundancy=redundancy_feature(kv),
                             created_at=now, home_replica=replica,
                             tenant=tenant)
        with trace.span("policy.admit") as sp:
            if sp:
                sp.attrs["key"] = key
            placement = self.policy.admit(meta, kv)
        self.executor.store(meta, kv, placement)
        self.meta[key] = meta
        if not self.freq.seen(key):      # keep the EWMA of returning keys
            self.freq.on_insert(key, now)
        self.counters["inserts"] += 1
        self.selector.touch(key, now)
        if transfers is not None:
            transfers.append(Transfer(key, "insert", meta.tier, meta.nbytes))
        # quota BEFORE capacity: an over-quota tenant's insert storm
        # sheds its own coldest entries first, which usually also fixes
        # the tier overflow — other tenants' hot sets survive
        self._enforce_quota(tenant, now)
        self._enforce(placement.tier, now, transfers=transfers)
        return placement

    def fetch(self, key: str, now: Optional[float] = None,
              replica: Optional[int] = None) -> Optional[FetchResult]:
        with trace.span("serve.fetch") as sp:
            if sp:
                sp.attrs["key"] = key
            return self._fetch(key, now, replica)

    def _fetch(self, key: str, now: Optional[float],
               replica: Optional[int]) -> Optional[FetchResult]:
        now = self.clock() if now is None else now
        meta = self.meta.get(key)
        if meta is None or meta.tier is None:
            self.counters["misses"] += 1
            return None
        tier = self.tiers[meta.tier]
        kv, entry = self.executor.fetch(meta)
        load = tier.load_delay_s(meta.nbytes)
        dec = self.delay_profile.decompress_delay_s(meta.method, meta.nbytes)
        # cross-replica hit: the bytes live in a sibling replica's DRAM —
        # the fetch pays the owner's read path PLUS the replica link
        remote = (self.topology is not None
                  and not self.topology.is_local_hit(meta.tier, replica))
        xlink = self.topology.cross_delay_s(meta.nbytes) if remote else 0.0
        meta.hits += 1
        meta.last_hit = now
        self.freq.on_hit(key, now)
        self.selector.touch(key, now)
        self.counters["hits"] += 1
        self.counters[f"hit_{meta.tier}"] += 1
        if remote:
            self.counters["hit_remote"] += 1
        return FetchResult(kv, meta.tier, meta.method, meta.rate,
                           load, dec, meta.nbytes, remote=remote,
                           xlink_delay_s=xlink, orig_nbytes=meta.orig_bytes)

    def note_page_run(self, n_hit: int, n_pages: int,
                      run_key: Optional[str] = None,
                      keys: Optional[List[str]] = None,
                      now: Optional[float] = None,
                      rem_hit: bool = False,
                      rem_key: Optional[str] = None) -> None:
        """Record one page-granular prefix match (``PagedPrefixCache``):
        under paging, ``hits``/``misses`` count individual page fetches
        — matched pages count hits (in ``fetch``), and every unmatched
        page beyond the run break counts a miss HERE, so ``hit_rate``'s
        denominator is the fixed per-request page count rather than
        whichever pages happened to match. A run that matched nothing in
        a sub-page context (no pages to count) still counts one miss —
        unless a remainder entry served the request (``rem_hit``), which
        counts as a FULL run even when the chain is empty. Run-level
        counters keep the request-granular view (full/partial/miss runs
        plus the total pages reused). When ``run_key`` is given the
        run-level frequency EWMA is updated and ``keys`` (the requesting
        context's full page chain, plus ``rem_key`` when the context has
        a stored remainder) is remembered as the run's latest trajectory
        — the chain sequential readahead will walk (``run_candidates``)
        and the reverse ``run_of`` map the policy's run-aware utility
        reads; a diverging variant simply overwrites it."""
        self.counters["page_runs"] += 1
        self.counters["page_run_hits"] += n_hit
        self.counters["misses"] += max(0, n_pages - n_hit)
        if n_hit == 0 and not rem_hit:
            if n_pages == 0:
                self.counters["misses"] += 1   # sub-page context, no tail
            self.counters["page_runs_miss"] += 1
        elif n_hit < n_pages:
            self.counters["page_runs_partial"] += 1
        else:
            self.counters["page_runs_full"] += 1
        if run_key is not None:
            now = self.clock() if now is None else now
            self.run_freq.note_run(run_key, now)
            chain: List[str] = []
            if keys is not None:
                self.page_runs[run_key] = list(keys)
                chain = list(keys)
                for k in keys:
                    self.run_of[k] = run_key
                if rem_key is not None:
                    self.run_of[rem_key] = run_key
                    chain.append(rem_key)
            # the run's EWMA advanced (and possibly its chain): every
            # member page's run-priced score is stale in the selector
            self.selector.on_run_signal(run_key, chain, now)
            if keys is not None and len(self.page_runs) > self.max_page_runs:
                coldest = min(
                    self.page_runs,
                    key=lambda rk: (self.run_freq.predict(rk, now), rk))
                self.page_runs.pop(coldest)
                self.run_freq.forget(coldest)
                dropped = sorted(k for k, rk in self.run_of.items()
                                 if rk == coldest)
                self.run_of = {k: rk for k, rk in self.run_of.items()
                               if rk != coldest}
                # pruned members fall back to per-entry pricing
                self.selector.on_run_drop(coldest, dropped, now)

    # -- speculative prefetch ---------------------------------------------------
    def prefetch_candidates(self, now: Optional[float] = None,
                            limit: int = 8,
                            min_hz: float = 0.0) -> List[str]:
        """Slow-tier resident keys ranked by predicted hit rate (hottest
        first), filtered to rates >= ``min_hz``. The engine walks this
        list and lets ``promote`` decide per key whether displacement is
        safe. Only slow-LEVEL residents qualify: an entry in a sibling
        replica's DRAM is already one link away and must not ping-pong
        between replica DRAMs via the prefetcher."""
        now = self.clock() if now is None else now
        if self.topology is not None:
            slow_tiers = [t for t in self.tier_order
                          if self.topology.level(t) > 0]
        else:
            slow_tiers = self.tier_order[1:]
        # per-tier index instead of the full meta scan; top-k heap
        # selection instead of a full sort (nsmallest(k, key=...) equals
        # sorted(key=...)[:k] — documented, stable), and the >= min_hz
        # filter commutes with selection because it is a prefix of the
        # (-rate, key) order restricted to qualifying items
        cands = ((self.freq.predict(m.key, now), m.key)
                 for t in slow_tiers
                 for m in self.executor.iter_entries(t))
        return [k for f, k in heapq.nsmallest(
            limit, (c for c in cands if c[0] >= min_hz),
            key=lambda t: (-t[0], t[1]))]

    def run_candidates(self, now: Optional[float] = None, limit: int = 8,
                       min_hz: float = 0.0
                       ) -> List[Tuple[str, List[str]]]:
        """Page runs ranked by run-level predicted hit rate (hottest
        first): ``(run_key, latest page-key chain)`` pairs, filtered to
        rates >= ``min_hz``. The engine's sequential readahead walks
        each chain in order and promotes slow-tier-resident pages before
        they are requested again; ``promote``'s displacement guard still
        arbitrates every individual move."""
        now = self.clock() if now is None else now
        # top-k heap instead of sorting the whole run registry on every
        # idle readahead walk (same selection: nsmallest == sorted[:k])
        cands = ((self.run_freq.predict(rk, now), rk)
                 for rk in self.page_runs)
        return [(rk, self.page_runs[rk])
                for f, rk in heapq.nsmallest(
                    limit, (c for c in cands if c[0] >= min_hz),
                    key=lambda t: (-t[0], t[1]))]

    def promote(self, key: str, now: Optional[float] = None,
                transfers: Optional[List[Transfer]] = None,
                dst_tier: Optional[str] = None) -> Optional[Transfer]:
        """Speculatively move a slow-tier entry into a fast tier
        (``dst_tier``; default the global fastest — per-replica setups
        pass the promoting replica's own DRAM).

        Declines (returns None) unless the entry fits in free fast-tier
        space plus space the active policy would actually free from
        strictly-colder residents — a prefetch must never evict an entry
        hotter than the one being promoted. The would-be victims are
        derived from ``policy.pick_move`` itself (the same selector the
        subsequent ``_enforce`` runs), not from an independent frequency
        ranking: under ``FixedPolicy`` enforcement is pure LRU, and a
        guard that scanned coldest-by-EWMA first could approve a
        promotion whose real LRU victim is hotter than the promotee.
        """
        now = self.clock() if now is None else now
        fast = self.tier_order[0] if dst_tier is None else dst_tier
        meta = self.meta.get(key)
        if meta is None or meta.tier is None or meta.tier == fast:
            return None
        if (self.topology is not None
                and self.topology.level(meta.tier) == 0):
            return None     # no sideways DRAM->DRAM moves via prefetch
        if meta.nbytes > self.tiers[fast].spec.capacity_bytes:
            return None
        need = meta.nbytes - self.tiers[fast].free_bytes
        if need > 0:
            mine = self.freq.predict(key, now)
            freed = 0
            # displacement-guard simulation on the selector (per-tier
            # index / move heaps instead of a full meta scan); close()
            # restores any cursor state even on early veto returns
            sim = self.selector.begin_sim(fast, now)
            try:
                while freed < need:
                    move = sim.next_move(now)
                    if move is None:
                        break
                    victim = self.meta[move.key]
                    if (move.kind != "recompress"
                            and self.freq.predict(victim.key, now) >= mine):
                        return None  # would displace an as-hot entry
                    # a recompression keeps the entry resident (no
                    # displacement to veto); either way count the bytes
                    # the move frees and drop the entry from the
                    # hypothetical tier state — conservative for
                    # repeated recompression (under-counts freeable
                    # bytes, never over-approves)
                    freed += (move.freed_bytes if move.kind == "recompress"
                              else victim.nbytes)
            finally:
                sim.close()
            if freed < need:
                return None
        src = meta.tier
        nb = self.executor.promote(meta, fast)
        self.selector.touch(key, now)
        tr = Transfer(key, "promote", fast, nb, src_tier=src, read_nbytes=nb)
        if transfers is not None:
            transfers.append(tr)
        self.counters["prefetches"] += 1
        self._enforce(fast, now, transfers=transfers)
        return tr

    # -- per-tenant quota enforcement -------------------------------------------
    def _enforce_quota(self, tenant: Optional[str], now: float,
                       max_moves: int = 10000) -> None:
        """Evict the tenant's own least valuable residents until its
        ledger fits its quota. Evictions free bytes without writing any
        (no Transfer), exactly like capacity-enforcement evicts; the
        victim order is ``policy.quota_victim_key`` (LRU for fixed
        policies, utility-per-byte for the adaptive one)."""
        if not tenant or not self.tenant_quotas:
            return
        quota = self.tenant_quotas.get(tenant, 0)
        if quota <= 0:
            return
        moves = 0
        while (self.executor.tenant_resident_bytes(tenant) > quota
               and moves < max_moves):
            move = self.selector.pick_quota_victim(tenant, now)
            if move is None:
                break
            meta = self.meta[move.key]
            self.executor.apply(move, meta)
            self.selector.touch(move.key, now)
            self.counters["quota_evictions"] += 1
            if self.move_log is not None:
                self.move_log.append(move)
            moves += 1

    # -- capacity enforcement ---------------------------------------------------
    def _entries_in(self, tier_name: str):
        # per-tier executor index in insertion-seq order: identical to
        # the old [m for m in meta.values() if m.tier == tier_name] scan
        # (metas never leave the dict; re-inserts keep their position)
        return self.executor.entries_in(tier_name)

    def _enforce(self, start_tier: str, now: float, max_moves: int = 10000,
                 transfers: Optional[List[Transfer]] = None):
        pending = [start_tier]
        moves = 0
        while pending and moves < max_moves:
            tname = pending.pop()
            tier = self.tiers[tname]
            while tier.used_bytes > tier.spec.capacity_bytes:
                move = self.selector.pick_move(tname, now)
                if move is None:
                    break
                meta = self.meta[move.key]
                read_nbytes = meta.nbytes
                affected = self.executor.apply(move, meta)
                self.selector.touch(move.key, now)
                self.selector.stats["moves_applied"] += 1
                if self.move_log is not None:
                    self.move_log.append(move)
                moves += 1
                if transfers is not None and move.kind != "evict":
                    # evictions free bytes without writing any; demotes
                    # and recompressions are real queued byte movements
                    transfers.append(Transfer(
                        move.key, move.kind,
                        move.dst_tier or move.tier, meta.nbytes,
                        src_tier=move.tier, read_nbytes=read_nbytes))
                if affected and affected not in pending:
                    pending.append(affected)
                if moves >= max_moves:
                    break

    # -- stats ------------------------------------------------------------------
    def stats(self) -> Dict[str, float]:
        total = self.counters["hits"] + self.counters["misses"]
        out = dict(self.counters)
        out.update(self.executor.stats)
        # placement-selector work counters: how much scoring the
        # selection engine did, in event counts rather than wall-clock
        for k, v in self.selector.stats.items():
            out[f"selector_{k}"] = v
        out["lookup_total"] = total
        out["hit_rate"] = self.counters["hits"] / total if total else 0.0
        out["hit_rate_remote"] = (self.counters["hit_remote"] / total
                                  if total else 0.0)
        for t in self.tier_order:
            out[f"hit_rate_{t}"] = (self.counters[f"hit_{t}"] / total
                                    if total else 0.0)
            out[f"used_{t}"] = self.tiers[t].used_bytes
        # per-tenant resident footprints from the executor ledger —
        # only present when tenanted entries exist, so untenanted runs
        # keep their exact stats schema
        tenants = sorted({ten
                          for bucket in self.executor.tenant_ledger.values()
                          for ten in bucket if ten})
        for ten in tenants:
            out[f"tenant_bytes_{ten}"] = \
                self.executor.tenant_resident_bytes(ten)
        return out
