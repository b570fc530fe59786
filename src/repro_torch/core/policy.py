"""AdaptCache policy optimizer: utility-driven greedy MCKP (paper §2).

    Utility(i) = Freq(i) · (α·Quality(i, M, R) − Delay(i, M, R, tier))
    Delay      = size/Bandwidth(tier) + latency + decompress(method, size)

Total utility across entries subject to per-tier capacities is a
Multiple-Choice Knapsack — NP-hard; following the paper we apply the
textbook greedy (Kellerer et al. §11) on **marginal utility drop per byte
freed**: whenever a tier is over capacity, the cheapest move is applied:

    move ∈ { compress further (any method, any smaller rate),
             demote to the next tier (same method/rate),
             evict (from the last tier) }

    drop/byte = (U_before − U_after) / freed_bytes_in_this_tier

which is exactly the paper's (U(i,m) − U(i,n)) / (size(i)·(m−n)) with our
size bookkeeping. FixedPolicy implements the baselines (no-compression LRU,
KIVI LRU, StreamingLLM LRU) on the same machinery so the comparison is
apples-to-apples.

Under a split-DRAM ``StorageTopology`` the knapsack's choice set expands
from {DRAM, SSD, evict} x codec to one choice per REPLICA DRAM: the
delay term of a sibling replica's DRAM includes the replica-to-replica
copy every home-replica hit would pay, so admission prefers the home
DRAM, spills into sibling DRAM while the link beats the SSD, and
demotes to the shared SSD after that.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.compression.base import CompressionMethod, KVData
from repro_torch.core.entry import EntryMeta
from repro_torch.core.estimator import DelayProfile, FrequencyEstimator, QualityEstimator
from repro_torch.runtime import trace
from repro_torch.storage.tier import Tier
from repro_torch.storage.topology import StorageTopology


@dataclasses.dataclass(frozen=True)
class Move:
    """One MCKP enforcement step.

    A move is no longer an instantaneous mutation: the controller turns
    each applied move into a queued ``Transfer`` (see
    ``repro_torch.core.controller``) so demotions and recompressions are booked
    on the same I/O channels as serving fetches. ``dst_tier`` names the
    tier whose write path receives the bytes ("demote": the next tier,
    "recompress": in place, "evict": nothing is written).
    """
    key: str
    kind: str                       # "recompress" | "demote" | "evict"
    tier: str                       # tier the move frees bytes in
    method: str = "none"            # target method (recompress)
    rate: float = 1.0               # target rate (recompress)
    freed_bytes: int = 0
    drop_per_byte: float = 0.0
    dst_tier: Optional[str] = None  # tier receiving the bytes (None: evict)


@dataclasses.dataclass(frozen=True)
class Placement:
    tier: str
    method: str
    rate: float


class BasePolicy:
    """Interface used by the controller.

    Contract: ``admit`` maps a fresh entry to a ``Placement`` (tier,
    codec, rate) and ``pick_move`` proposes ONE capacity-restoring move
    for an over-full tier; neither mutates any state — the controller's
    executor applies decisions, so a policy can be re-queried freely.
    Utilities are in (quality x Hz) minus SECONDS-of-delay units; all
    sizes are stored BYTES. Page (``pg-*``) and remainder (``rem-*``)
    entries flow through the same machinery as whole contexts — each is
    one independent knapsack item whose bytes/frequency/quality carry
    its own accounting (a remainder is just the smallest, deepest item
    of its run).

    Policies constructed with a ``StorageTopology`` see the expanded
    placement space: the knapsack choices per entry are
    {each replica's DRAM, shared SSD, evict} x codec, and a placement in
    a *sibling* replica's DRAM is priced with the replica-to-replica
    copy every cross-replica hit pays (``meta.home_replica`` names the
    replica whose requests hit the entry). Without a topology the
    legacy linear ``tier_order`` semantics apply unchanged.
    """

    topology: Optional[StorageTopology] = None
    tier_order: List[str] = []

    def admit(self, meta: EntryMeta, kv: KVData) -> Placement:
        raise NotImplementedError

    def pick_move(self, tier_name: str, entries: Sequence[EntryMeta],
                  now: float, kv_lookup=None) -> Optional[Move]:
        raise NotImplementedError

    def pick_move_scan(self, tier_name: str, entries: Sequence[EntryMeta],
                       now: float, kv_lookup=None) -> Optional[Move]:
        """Reference full-scan selection. ``AdaptivePolicy``/``FixedPolicy``
        implement the scan here (``pick_move`` delegates to it); for a
        custom policy that only overrides ``pick_move`` this default
        keeps the two names interchangeable."""
        return self.pick_move(tier_name, entries, now, kv_lookup=kv_lookup)

    # -- incremental-selector hooks (see repro_torch.core.selector) ---------------
    def entry_best_move(self, tier_name: str, meta: EntryMeta, now: float,
                        kv_lookup=None) -> Optional[Move]:
        """The single entry's own minimal-drop move — the inner loop of
        the scan, exposed so the incremental selector can (re)score one
        entry in O(ladder) instead of O(tier)."""
        raise NotImplementedError

    def selector_halflife_s(self, key: str) -> Optional[float]:
        """Half-life (seconds) of the EWMA whose decay uniformly scales
        this key's move scores between touches, or None when the
        selection key is time-invariant (recency LRU). Entries sharing a
        half-life share one decay factor, so their cached scores stay
        comparable without rescoring."""
        raise NotImplementedError

    def selector_recency_key(self, meta: EntryMeta):
        """Time-invariant ordering key (policies whose
        ``selector_halflife_s`` is None): smaller selects first."""
        raise NotImplementedError

    def quota_victim_key(self, meta: EntryMeta, now: float):
        """Total order for per-tenant QUOTA eviction (smaller evicts
        first). Unlike capacity enforcement — which frees bytes in one
        over-full tier — quota eviction must shrink a tenant's TOTAL
        resident footprint, so demotion doesn't help and the victim is
        evicted outright. Default is LRU with the paged depth tie-break
        (``FixedPolicy.selector_recency_key`` semantics); ``seq`` makes
        the order total."""
        return (meta.last_hit or meta.created_at, -_page_depth(meta.key),
                meta.seq)

    def next_tier(self, tier_name: str) -> Optional[str]:
        """Demotion target for ``tier_name`` (None: evict-only tier)."""
        if self.topology is not None:
            return self.topology.next_tier(tier_name)
        t_idx = self.tier_order.index(tier_name)
        return (self.tier_order[t_idx + 1]
                if t_idx + 1 < len(self.tier_order) else None)

    def home_tier(self, meta: EntryMeta) -> Optional[str]:
        """The DRAM tier local to the entry's home replica, if any."""
        if (self.topology is None or self.topology.shared_dram
                or meta.home_replica is None):
            return None
        return self.topology.dram_for(meta.home_replica)


class AdaptivePolicy(BasePolicy):
    """The paper's utility-driven policy (module doc): admission picks
    the max-utility (tier, method, rate) state for an entry, and
    enforcement applies the greedy MCKP move with minimal marginal
    utility drop per byte freed. ``utility`` is
    ``Freq(Hz) * (alpha * Quality[0..1] - Delay[s])`` where Delay is the
    unqueued load + decompress (+ cross-replica link) estimate for the
    entry's stored bytes — so alpha trades answer quality against
    seconds of fetch delay. Timestamps (``now``) are simulated seconds
    from the controller's clock."""

    def __init__(self, methods: Dict[str, CompressionMethod],
                 tiers: Dict[str, Tier], tier_order: Sequence[str],
                 quality: QualityEstimator, freq: FrequencyEstimator,
                 delay_profile: DelayProfile, alpha: float = 1.0,
                 topology: Optional[StorageTopology] = None,
                 depth_discount: float = 0.85):
        self.methods = methods
        self.tiers = tiers
        self.tier_order = list(tier_order)      # fast -> slow
        self.quality = quality
        self.freq = freq
        self.delay_profile = delay_profile
        self.alpha = alpha
        self.topology = topology
        # run-aware page frequency (bound by the controller): a page's
        # future hits come from its RUN's traffic, discounted by depth —
        # page i of a run only serves requests whose match reaches it
        self.depth_discount = depth_discount
        self.run_freq: Optional[FrequencyEstimator] = None
        self.run_lookup = None                  # page/rem key -> run key

    def bind_run_signals(self, run_freq: FrequencyEstimator,
                         run_lookup) -> None:
        """Wire the controller's run-level EWMA + page->run map so
        ``utility`` can rank ``pg-*``/``rem-*`` entries by their run's
        traffic instead of the per-entry estimate (which is blind to the
        prefix sharing that makes early pages hot)."""
        self.run_freq = run_freq
        self.run_lookup = run_lookup

    def _entry_freq(self, key: str, now: float) -> float:
        """Predicted hit rate: run-aware for page/remainder entries
        whose run is known (run EWMA x depth_discount^depth — hot-prefix
        pages out-rank deep-tail pages at equal recency), the per-entry
        EWMA otherwise."""
        if self.run_freq is not None and key.startswith(("pg-", "rem-")):
            run_key = self.run_lookup(key) if self.run_lookup else None
            if run_key is not None and self.run_freq.seen(run_key):
                depth = max(0, _page_depth(key))
                return (self.run_freq.predict(run_key, now)
                        * self.depth_discount ** depth)
        return self.freq.predict(key, now)

    # -- utility ------------------------------------------------------------
    def _delay_term_s(self, tier_name: str, method: str, nbytes: int,
                    home_tier: Optional[str] = None) -> float:
        tier = self.tiers[tier_name]
        # fused compute path feeds back into the knapsack here: when the
        # DelayProfile marks a method fused (the attention kernel decodes
        # it in-register), its decompress term shrinks to the calibrated
        # residual, so compressed-in-DRAM placements get cheaper exactly
        # where the serving engine prices them cheaper — DRAM effectively
        # grows by the compression ratio in the MCKP's eyes.
        d = (tier.load_delay_s(nbytes)
             + self.delay_profile.decompress_delay_s(method, nbytes))
        # a sibling replica's DRAM serves the home replica's hits only
        # through the replica-to-replica link — price that copy in
        if (home_tier is not None and tier_name != home_tier
                and self.topology is not None
                and self.topology.level(tier_name) == 0
                and self.topology.replica_of(tier_name) is not None):
            d += self.topology.cross_delay_s(nbytes)
        return d

    def utility(self, meta: EntryMeta, tier_name: str, method: str,
                rate: float, nbytes: int, now: float) -> float:
        f = self._entry_freq(meta.key, now)
        q = self.quality.predict(meta.task_type, method, rate, meta.redundancy)
        return f * (self.alpha * q
                    - self._delay_term_s(tier_name, method, nbytes,
                                       home_tier=self.home_tier(meta)))

    def current_utility(self, meta: EntryMeta, now: float) -> float:
        return self.utility(meta, meta.tier, meta.method, meta.rate,
                            meta.nbytes, now)

    # -- candidate enumeration ------------------------------------------------
    def _candidate_states(self, meta: EntryMeta, kv_like: KVData
                          ) -> List[Tuple[str, float, int]]:
        """(method, rate, est_nbytes) states strictly smaller than current."""
        out = []
        if kv_like is None:
            return out
        for mname, m in self.methods.items():
            if not m.applicable(kv_like):
                continue
            for rate in m.rates(kv_like):
                nb = m.estimate_nbytes(kv_like, rate)
                trace.count("policy.estimates")
                if nb < meta.nbytes:
                    out.append((mname, rate, nb))
        return out

    # -- admission ------------------------------------------------------------
    def admit(self, meta: EntryMeta, kv: KVData) -> Placement:
        """Choose the (tier, method, rate) with max utility for a new entry,
        preferring states that fit the fast tier without displacing
        higher-marginal-utility residents (the subsequent enforce pass
        settles global feasibility)."""
        now = meta.created_at
        best: Tuple[float, Placement] = (-math.inf, Placement(
            self.tier_order[-1], "none", 1.0))
        for tier_name in self.tier_order:
            for mname, m in self.methods.items():
                if not m.applicable(kv):
                    continue
                for rate in m.rates(kv):
                    nb = m.estimate_nbytes(kv, rate)
                    trace.count("policy.estimates")
                    u = self.utility(meta, tier_name, mname, rate, nb, now)
                    if u > best[0]:
                        best = (u, Placement(tier_name, mname, rate))
        return best[1]

    # -- capacity enforcement ---------------------------------------------------
    def entry_best_move(self, tier_name: str, meta: EntryMeta, now: float,
                        kv_lookup=None) -> Optional[Move]:
        """One entry's minimal-drop move over its full ladder: the exact
        arithmetic of the reference scan's inner loop, so the strict-<
        per-entry best combined across entries (first-seen wins on ties)
        reproduces the flattened scan move-for-move."""
        next_tier = self.next_tier(tier_name)
        u_cur = self.current_utility(meta, now)
        kv_like = kv_lookup(meta.key) if kv_lookup else None
        best: Optional[Move] = None

        # (a) recompress in place
        for mname, rate, nb in self._candidate_states(meta, kv_like):
            freed = meta.nbytes - nb
            if freed <= 0:
                continue
            u_new = self.utility(meta, tier_name, mname, rate, nb, now)
            drop = (u_cur - u_new) / freed
            if best is None or drop < best.drop_per_byte:
                best = Move(meta.key, "recompress", tier_name, mname,
                            rate, freed, drop, dst_tier=tier_name)

        # (b) demote to next tier (same state)
        if next_tier is not None:
            u_new = self.utility(meta, next_tier, meta.method, meta.rate,
                                 meta.nbytes, now)
            drop = (u_cur - u_new) / meta.nbytes
            if best is None or drop < best.drop_per_byte:
                best = Move(meta.key, "demote", tier_name, meta.method,
                            meta.rate, meta.nbytes, drop,
                            dst_tier=next_tier)

        # (c) evict — the LIMIT POINT of the compression ladder
        # (EVICPRESS): rate -> 0 keeps zero utility, so eviction is
        # just the final rung, scored on the SAME drop-per-byte
        # scale as recompress/demote on EVERY tier. A
        # negative-utility entry (delay term exceeds alpha*quality)
        # has negative drop: removing it is a strict improvement and
        # the greedy takes it before touching anything useful.
        drop = u_cur / meta.nbytes
        if best is None or drop < best.drop_per_byte:
            best = Move(meta.key, "evict", tier_name, meta.method,
                        meta.rate, meta.nbytes, drop)
        return best

    def pick_move_scan(self, tier_name: str, entries: Sequence[EntryMeta],
                       now: float, kv_lookup=None) -> Optional[Move]:
        """Reference selection: minimal marginal-utility-drop move over a
        full scan of ``entries`` (strict < keeps the first seen on ties).
        The incremental selector must match this move-for-move; it stays
        the ground truth for tests and the SIMCHECK cross-check."""
        best: Optional[Move] = None
        for meta in entries:
            cand = self.entry_best_move(tier_name, meta, now,
                                        kv_lookup=kv_lookup)
            if cand is not None and (best is None or
                                     cand.drop_per_byte < best.drop_per_byte):
                best = cand
        return best

    def pick_move(self, tier_name: str, entries: Sequence[EntryMeta],
                  now: float, kv_lookup=None) -> Optional[Move]:
        """Minimal marginal-utility-drop move freeing bytes in tier_name."""
        return self.pick_move_scan(tier_name, entries, now,
                                   kv_lookup=kv_lookup)

    def selector_halflife_s(self, key: str) -> Optional[float]:
        """Scores decay with the EWMA pricing the key RIGHT NOW: the run
        estimator for pages with a known run, the per-entry estimator
        otherwise (``_entry_freq``). A change of pricing source always
        comes with a run signal, which re-touches the affected keys."""
        if self.run_freq is not None and key.startswith(("pg-", "rem-")):
            run_key = self.run_lookup(key) if self.run_lookup else None
            if run_key is not None and self.run_freq.seen(run_key):
                return self.run_freq.halflife
        return self.freq.halflife

    def quota_victim_key(self, meta: EntryMeta, now: float):
        """Quota eviction drops the tenant's least valuable resident
        bytes: current utility per stored byte, ascending."""
        return (self.current_utility(meta, now) / max(1, meta.nbytes),
                meta.seq)


def _page_depth(key: str) -> int:
    """Page index of a ``PagedPrefixCache`` key (``pg-<hash>-<i>``);
    -1 for whole-context entries. Pages of one context are inserted in
    one burst with equal timestamps, so pure LRU can't order them — a
    page is only useful while every EARLIER page of its run is resident,
    so at equal recency the deepest page should leave first. Remainder
    entries (``rem-<hash>-<n_pages>``) carry the page COUNT as their
    index, one past the deepest page: a remainder is only useful while
    its whole base run is resident, so it is the first to go."""
    if not key.startswith(("pg-", "rem-")):
        return -1
    _, _, idx = key.rpartition("-")
    return int(idx) if idx.isdigit() else -1


class FixedPolicy(BasePolicy):
    """Baselines: fixed (method, rate) + LRU demotion/eviction.

    method='none'          -> Without-Compression baseline
    method='kivi', rate    -> KIVI LRU
    method='streaming_llm' -> StreamingLLM LRU

    Page entries get a recency tie-break: among equally-recent entries
    the DEEPEST page demotes/evicts first (a partial run keeps its
    useful prefix). Whole-context entries tie-break exactly as before
    (insertion order), so non-paged behavior is unchanged.
    """

    def __init__(self, methods: Dict[str, CompressionMethod],
                 tier_order: Sequence[str], method: str, rate: float,
                 topology: Optional[StorageTopology] = None):
        self.methods = methods
        self.tier_order = list(tier_order)
        self.method = method
        self.rate = rate
        self.topology = topology

    def admit(self, meta: EntryMeta, kv: KVData) -> Placement:
        m = self.methods[self.method]
        rate = (m.closest_rate(kv, self.rate)
                if m.applicable(kv) else 1.0)
        method = self.method if m.applicable(kv) else "none"
        # locality-aware LRU: land in the inserting replica's own DRAM
        tier = self.home_tier(meta) or self.tier_order[0]
        return Placement(tier, method, rate)

    def entry_best_move(self, tier_name: str, meta: EntryMeta, now: float,
                        kv_lookup=None) -> Optional[Move]:
        """LRU has no per-entry ladder: the move is demote-or-evict at
        drop 0.0 — the ORDER lives in ``selector_recency_key``."""
        next_tier = self.next_tier(tier_name)
        if next_tier is not None:
            return Move(meta.key, "demote", tier_name, meta.method,
                        meta.rate, meta.nbytes, 0.0, dst_tier=next_tier)
        return Move(meta.key, "evict", tier_name, meta.method, meta.rate,
                    meta.nbytes, 0.0)

    def selector_halflife_s(self, key: str) -> Optional[float]:
        return None     # recency key is time-invariant between touches

    def selector_recency_key(self, meta: EntryMeta):
        return (meta.last_hit or meta.created_at, -_page_depth(meta.key))

    def pick_move_scan(self, tier_name: str, entries: Sequence[EntryMeta],
                       now: float, kv_lookup=None) -> Optional[Move]:
        if not entries:
            return None
        lru = min(entries, key=self.selector_recency_key)
        return self.entry_best_move(tier_name, lru, now,
                                    kv_lookup=kv_lookup)

    def pick_move(self, tier_name: str, entries: Sequence[EntryMeta],
                  now: float, kv_lookup=None) -> Optional[Move]:
        return self.pick_move_scan(tier_name, entries, now,
                                   kv_lookup=kv_lookup)
