"""Incremental placement selection: per-tier lazy move heaps.

The reference MCKP selection (``BasePolicy.pick_move_scan``) re-scores
every resident entry's full recompress/demote/evict ladder on every
pick — O(tier population) per freed move, which made ``_enforce``
quadratic in the cache population. This module makes selection
amortized O(log N) **without changing a single decision**:

* ``ScanSelector`` wraps the reference scan behind the same interface
  (the ground truth for tests, the fig10 baseline, and the SIMCHECK
  cross-check).

* ``IndexedSelector`` keeps one min-heap of cached move scores per
  (tier, EWMA half-life class). Why that is sound:

  - Every candidate utility of an entry shares the entry's frequency
    factor ``F(t) = rate * 0.5**((t - last)/halflife)``, so the entry's
    best move (and its drop-per-byte, up to the shared decay) is
    time-invariant between *touches* — events that change the entry's
    EWMA state, placement, bytes, or pricing source (hit, insert,
    placement move, run signal, registry prune, alpha change).
  - All entries priced by the same estimator share the decay factor
    ``0.5**(-(t)/halflife)``, so scores *normalized to a fixed
    reference time* (``score / 0.5**((t_scored - t_ref)/h)``) stay
    mutually comparable inside one half-life class without rescoring.
    Classes (per-entry vs run EWMA half-lives) are compared by
    denormalizing each class's top to the query time.
  - Staleness rule: a touch eagerly re-scores the entry and pushes a
    fresh record stamped with a bumped version; old records become
    garbage discarded lazily when they surface at the top of the heap
    (``heap_revalidations``). Eager re-push (rather than validate-only
    at pop) matters for exactness: a hit can *lower* an entry's EWMA
    rate, and a stale overestimating record would otherwise hide a
    better candidate behind it.
  - Ties: records carry the entry's insertion sequence
    (``EntryMeta.seq``), reproducing the scan's first-seen-wins
    ordering; the winner's ``Move`` is recomputed exactly at the query
    time via ``entry_best_move``, so the returned move (including its
    ``drop_per_byte`` float) is bit-identical to the scan's.

``docs/perf.md`` carries the full design + equivalence argument.
"""
from __future__ import annotations

import heapq
from typing import Dict, List, Optional, Tuple

from repro_torch.core.entry import EntryMeta
from repro_torch.core.policy import Move


class SelectorMismatch(AssertionError):
    """The incremental selector and the reference scan disagreed on a
    move (raised by the SIMCHECK cross-check; see docs/perf.md)."""


def _fresh_stats() -> Dict[str, int]:
    return {"pick_move_calls": 0, "entries_scored": 0,
            "heap_revalidations": 0, "heap_pushes": 0,
            "moves_applied": 0, "crosschecks": 0}


def pick_quota_victim(controller, tenant: str, now: float
                      ) -> Optional[Move]:
    """Per-tenant QUOTA eviction pick, shared by both selectors.

    Scans the over-quota tenant's residents slowest tier first (cold
    deep bytes leave before hot fast ones) and returns an evict ``Move``
    for the entry with the smallest ``policy.quota_victim_key``. Quota
    pressure only ever touches the owing tenant's own entries, so this
    is a tenant-filtered scan over the executor's per-tier index — rare
    (only fires while a tenant is over quota) and trivially
    decision-identical between the scan and indexed selectors, which is
    why it lives outside the per-tier move heaps."""
    ten = tenant or ""
    policy = controller.policy
    for tname in reversed(controller.tier_order):
        best = None
        for m in controller.executor.entries_in(tname):
            if (m.tenant or "") != ten:
                continue
            k = policy.quota_victim_key(m, now)
            if best is None or k < best[0]:
                best = (k, m)
        if best is not None:
            victim = best[1]
            return Move(victim.key, "evict", tname, victim.method,
                        victim.rate, victim.nbytes, 0.0)
    return None


class ScanSelector:
    """Reference selection: every pick re-scans the tier via
    ``policy.pick_move_scan`` (the pre-indexed behavior, preserved
    verbatim — including the displacement-guard simulation)."""

    name = "scan"

    def __init__(self, controller):
        self.c = controller
        self.stats = _fresh_stats()
        self.crosscheck_every = 0       # meaningless for the reference

    # -- touch hooks: the scan caches nothing ---------------------------------
    def touch(self, key: str, now: float) -> None:
        pass

    def on_run_signal(self, run_key: str, keys: List[str],
                      now: float) -> None:
        pass

    def on_run_drop(self, run_key: str, keys: List[str],
                    now: float) -> None:
        pass

    # -- selection ------------------------------------------------------------
    def pick_move(self, tier_name: str, now: float) -> Optional[Move]:
        entries = self.c._entries_in(tier_name)
        self.stats["pick_move_calls"] += 1
        self.stats["entries_scored"] += len(entries)
        return self.c.policy.pick_move_scan(
            tier_name, entries, now, kv_lookup=self.c.executor.proxies.get)

    def begin_sim(self, tier_name: str, now: float) -> "_ScanSim":
        return _ScanSim(self, tier_name)

    def pick_quota_victim(self, tenant: str, now: float) -> Optional[Move]:
        return pick_quota_victim(self.c, tenant, now)


class _ScanSim:
    """Displacement-guard cursor: repeated picks over a hypothetically
    shrinking candidate snapshot; nothing is applied or mutated."""

    def __init__(self, sel: ScanSelector, tier_name: str):
        self.sel = sel
        self.tier = tier_name
        self.candidates = sel.c._entries_in(tier_name)

    def next_move(self, now: float) -> Optional[Move]:
        if not self.candidates:
            return None
        self.sel.stats["pick_move_calls"] += 1
        self.sel.stats["entries_scored"] += len(self.candidates)
        move = self.sel.c.policy.pick_move_scan(
            self.tier, self.candidates, now,
            kv_lookup=self.sel.c.executor.proxies.get)
        if move is not None:
            self.candidates = [m for m in self.candidates
                               if m.key != move.key]
        return move

    def close(self) -> None:
        pass


class IndexedSelector:
    """Amortized O(log N) selection over per-tier lazy move heaps.

    Invariant (audited by tests + ``SimSanitizer``): every resident
    entry has exactly one *fresh* record — version matching
    ``_ver[key]`` — in its current tier's half-life-class heap; all
    other records are garbage discarded at pop time.
    """

    name = "indexed"
    # re-anchor the normalization reference once the shared decay spans
    # this many half-lives (keeps normalized scores far from under/
    # overflow; the rebase rescores everything, so it is exact)
    REBASE_HALFLIVES = 120.0

    def __init__(self, controller):
        self.c = controller
        self.stats = _fresh_stats()
        # tier -> half-life class (seconds, or None) -> heap of records
        # (normalized score, seq, key, version)
        self.heaps: Dict[str, Dict[Optional[float], List[tuple]]] = {
            t: {} for t in controller.tier_order}
        self._ver: Dict[str, int] = {}
        self.t_ref_s = 0.0
        # run membership mirror of controller.run_of: lets a run signal
        # re-touch exactly its member pages without scanning meta
        self._run_members: Dict[str, set] = {}
        self._member_run: Dict[str, str] = {}
        # pricing epoch: a mid-run alpha change invalidates every cached
        # score at once — detected on the next pick, full re-score
        self._alpha = getattr(controller.policy, "alpha", None)
        # when > 0, every Nth pick_move re-runs the reference scan and
        # asserts the same move (enabled by sanitized/SIMCHECK runs)
        self.crosscheck_every = 0

    # -- touch hooks ----------------------------------------------------------
    def touch(self, key: str, now: float) -> None:
        """The entry's cached score is stale (hit / insert / placement
        change / pricing change): bump its version and, if resident,
        push one fresh record."""
        self._ver[key] = self._ver.get(key, 0) + 1
        meta = self.c.meta.get(key)
        if meta is not None and meta.tier is not None:
            self._push(meta, now)

    def on_run_signal(self, run_key: str, keys: List[str],
                      now: float) -> None:
        """The run's EWMA advanced and/or its chain changed: every
        member page's run-priced score is stale. Chains are short (one
        context's pages), so re-touching all members stays cheap."""
        members = self._run_members.setdefault(run_key, set())
        for k in keys:
            old = self._member_run.get(k)
            if old is not None and old != run_key:
                self._run_members.get(old, set()).discard(k)
            self._member_run[k] = run_key
            members.add(k)
        for k in sorted(members):
            self.touch(k, now)

    def on_run_drop(self, run_key: str, keys: List[str],
                    now: float) -> None:
        """The run registry pruned this run: members fall back to
        per-entry frequency pricing (possibly a different class)."""
        members = self._run_members.pop(run_key, set()) | set(keys)
        for k in sorted(members):
            if self._member_run.get(k) == run_key:
                del self._member_run[k]
            self.touch(k, now)

    # -- scoring --------------------------------------------------------------
    def _push(self, meta: EntryMeta, now: float) -> None:
        pol = self.c.policy
        move = pol.entry_best_move(meta.tier, meta, now,
                                   kv_lookup=self.c.executor.proxies.get)
        self.stats["entries_scored"] += 1
        if move is None:
            return                  # entry offers no move: nothing to rank
        halflife_s = pol.selector_halflife_s(meta.key)
        if halflife_s is None:
            norm = pol.selector_recency_key(meta)
        else:
            if (now - self.t_ref_s) / halflife_s > self.REBASE_HALFLIVES:
                self._rebase(now)   # rescored everything, meta included
                return
            norm = move.drop_per_byte / (
                0.5 ** ((now - self.t_ref_s) / halflife_s))
        heap = self.heaps.setdefault(meta.tier, {}).setdefault(
            halflife_s, [])
        heapq.heappush(heap, (norm, meta.seq, meta.key,
                              self._ver.get(meta.key, 0)))
        self.stats["heap_pushes"] += 1

    def _rebase(self, now: float) -> None:
        """Re-anchor ``t_ref_s`` and rescore every resident entry (rare:
        once per ``REBASE_HALFLIVES`` half-lives, or on alpha change)."""
        self.t_ref_s = now
        for tname in self.c.tier_order:
            self.heaps[tname] = {}
            for meta in self.c.executor.entries_in(tname):
                self._ver[meta.key] = self._ver.get(meta.key, 0) + 1
                self._push(meta, now)

    def _check_epoch(self, now: float) -> None:
        alpha = getattr(self.c.policy, "alpha", None)
        if alpha != self._alpha:
            self._alpha = alpha
            self._rebase(now)

    def _settle(self, tier_name: str, heap: List[tuple]
                ) -> Optional[tuple]:
        """Discard garbage until the heap's top record is fresh (or the
        heap drains); returns that record without popping it."""
        while heap:
            _norm, _seq, key, ver = heap[0]
            meta = self.c.meta.get(key)
            if (ver != self._ver.get(key, 0) or meta is None
                    or meta.tier != tier_name):
                heapq.heappop(heap)
                self.stats["heap_revalidations"] += 1
                continue
            return heap[0]
        return None

    def _best_class(self, tier_name: str, now: float
                    ) -> Optional[Tuple[Optional[float], tuple]]:
        """(half-life class, top record) with the minimal true score at
        ``now``; classes are compared by denormalizing each top."""
        best = None             # ((true score, seq), class, record)
        classes = self.heaps.setdefault(tier_name, {})
        for halflife_s in sorted(
                classes, key=lambda h: -1.0 if h is None else h):
            rec = self._settle(tier_name, classes[halflife_s])
            if rec is None:
                continue
            if halflife_s is None:
                true_score = rec[0]
            else:
                true_score = rec[0] * 0.5 ** (
                    (now - self.t_ref_s) / halflife_s)
            cand = (true_score, rec[1])
            if best is None or cand < best[0]:
                best = (cand, halflife_s, rec)
        return None if best is None else (best[1], best[2])

    # -- selection ------------------------------------------------------------
    def pick_move(self, tier_name: str, now: float) -> Optional[Move]:
        self._check_epoch(now)
        self.stats["pick_move_calls"] += 1
        top = self._best_class(tier_name, now)
        move = None
        if top is not None:
            meta = self.c.meta[top[1][2]]
            self.stats["entries_scored"] += 1
            move = self.c.policy.entry_best_move(
                tier_name, meta, now,
                kv_lookup=self.c.executor.proxies.get)
        if self.crosscheck_every > 0 and (
                self.stats["pick_move_calls"]
                % self.crosscheck_every == 0):
            self._crosscheck(tier_name, now, move)
        return move

    def _crosscheck(self, tier_name: str, now: float,
                    move: Optional[Move]) -> None:
        self.stats["crosschecks"] += 1
        ref = self.c.policy.pick_move_scan(
            tier_name, self.c._entries_in(tier_name), now,
            kv_lookup=self.c.executor.proxies.get)
        if ref != move:
            raise SelectorMismatch(
                f"selector cross-check failed for tier '{tier_name}' at "
                f"t={now:.9f}: indexed picked {move}, reference scan "
                f"picked {ref}")

    def begin_sim(self, tier_name: str, now: float) -> "_IndexedSim":
        self._check_epoch(now)
        return _IndexedSim(self, tier_name)

    def pick_quota_victim(self, tenant: str, now: float) -> Optional[Move]:
        # shared tenant-filtered scan (see module function): quota picks
        # bypass the move heaps entirely, so no heap maintenance here —
        # the controller's post-apply touch() removes the stale record
        return pick_quota_victim(self.c, tenant, now)


class _IndexedSim:
    """Displacement-guard cursor over the live heaps: each accepted
    winner's record is popped and held aside (the natural 'already
    hypothetically displaced' exclusion), then pushed back on close —
    the guard never leaves a mark on selection state."""

    def __init__(self, sel: IndexedSelector, tier_name: str):
        self.sel = sel
        self.tier = tier_name
        self._held: List[Tuple[Optional[float], tuple]] = []

    def next_move(self, now: float) -> Optional[Move]:
        sel = self.sel
        sel.stats["pick_move_calls"] += 1
        top = sel._best_class(self.tier, now)
        if top is None:
            return None
        halflife_s, rec = top
        heapq.heappop(sel.heaps[self.tier][halflife_s])
        self._held.append((halflife_s, rec))
        meta = sel.c.meta[rec[2]]
        sel.stats["entries_scored"] += 1
        return sel.c.policy.entry_best_move(
            self.tier, meta, now, kv_lookup=sel.c.executor.proxies.get)

    def close(self) -> None:
        for halflife_s, rec in self._held:
            heapq.heappush(
                self.sel.heaps[self.tier].setdefault(halflife_s, []), rec)
        self._held = []


def make_selector(name: str, controller):
    if name == "indexed":
        return IndexedSelector(controller)
    if name == "scan":
        return ScanSelector(controller)
    raise ValueError(
        f"unknown selector '{name}' (expected 'indexed' or 'scan')")
