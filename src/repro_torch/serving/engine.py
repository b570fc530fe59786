"""ServingEngine: duplex-async event-driven AdaptCache serving simulator.

The engine runs the paper's Fig. 1 pipeline as a discrete-event
simulation instead of a serialized request loop:

  arrival      -> request lands on the least-loaded replica; a free lane
                  is reserved and the KV fetch / prefill is ISSUED
  load-done    -> hit path: the entry's bytes were booked on the shared
                  per-tier read IOChannel (DRAM: many streams, SSD: one
                  at 1 GB/s — replicas contend) + decompress delay; the
                  lane joins the replica's continuous batch only now. A
                  fetch of a key whose bytes are still being written
                  (in-flight insert / demotion / promotion) fences on
                  the transfer before its read is booked
  prefill-done -> miss path: recompute booked on the replica's prefill
                  stream (prefills queue behind each other, never behind
                  decode); concurrent misses on one context coalesce onto
                  a single in-flight prefill; the fresh entry's placement
                  is decided at completion time and its bytes are booked
                  on the destination tier's WRITE channel (async
                  write-back) together with any MCKP demotions the
                  insert triggered — enforcement contends with serving
  write-done   -> a queued transfer (insert write-back, demotion,
                  recompression, prefetch promotion) finished; fenced
                  fetches of that key may now start
  decode-tick  -> ALL active lanes of a replica decode one step in one
                  batched model call; ticks keep firing while loads and
                  writes are in flight — decode never stalls on I/O

Speculative prefetch: when enabled (``prefetch_max_inflight > 0``), idle
slow-tier read-channel time is used to promote the hottest SSD-resident
entries (ranked by ``FrequencyEstimator`` predictions) into DRAM with no
lane reserved, so a later arrival for that key is a pure DRAM hit. A
promotion never displaces an entry hotter than the one promoted
(controller guard), and per-request ``prefetch_hit`` plus engine-level
``prefetch_stats`` (issued / hits / wasted / suppressed) attribute the
effect. With ``prefetch_deadline=True`` a promotion is only issued when
its estimated transfer completes before the FrequencyEstimator's
predicted next hit — losers are counted as ``suppressed``.

Topology (``StorageTopology`` on the controller): with per-replica DRAM
tiers, requests route to their replica's DRAM first — an entry resident
in a SIBLING replica's DRAM is a ``remote_hit`` that pays the
replica-to-replica link on top of the owner's read channel; inserts
stamp the home replica so MCKP placement is locality-aware; miss
coalescing and prefetch are replica-local (each replica promotes into
its OWN DRAM). With ``duplex_ssd=False`` the shared SSD's reads,
write-backs, and prefetch transfers all arbitrate in ONE half-duplex
bandwidth queue instead of the PR-2 independent read/write pair.

TTFT decomposes into queue (lane wait) + load|prefill (I/O / compute
queueing included) + decode (teacher-forced question steps), reported
per request in ``RequestResult`` along with the write-back breakdown
(``wb_queue_s`` / ``wb_transfer_s`` for the insert this request owned,
``write_wait_s`` for time fenced behind an in-flight write). Simulated
time comes from the calibrated full-scale ``TimeModel``; token content
is computed for real on the smoke model (batched lane decode is
bit-exact vs the sequential path), so quality attribution is exact. The
controller's clock is the event clock: ``fetch`` sees issue time,
``insert`` sees completion time.

Paged serving (``page_tokens > 0``): contexts are stored as fixed-token
PAGES (rolling prefix-hash keys, ``serving/chunking.py``) instead of
whole entries, so a request sharing only a PREFIX with cached traffic
still reuses the matched page run. ``match_prefix`` returns a fetch
*plan* — per-page owning tier, bytes, link and decompress prices — and
the engine books each page read on that tier's ``IOChannel``: partial
loads contend with write-back and prefetch like every other transfer,
and pages homed on a sibling replica's DRAM pay the link (per-page
``remote`` accounting). Only the un-matched suffix is prefilled; the
fresh pages are inserted (stamped with the prefilling replica) when it
completes. ``RequestResult`` carries ``pages_hit`` and
``tokens_reused_frac``.

Chunked prefill (``chunk_tokens > 0``): the dedicated per-replica
prefill stream is replaced by ONE unified compute channel per replica
(Sarathi-style). Suffix prefill splits into ``chunk_tokens``-token
chunks priced by ``TimeModel.chunk_prefill_s``; each chunk and each
decode tick books the same single-stream channel, so prefill chunks
interleave with decode steps instead of running on a phantom second
accelerator (``chunk-done`` events drive the chain; interleave counters
in ``chunk_stats``). With ``chunk_tokens == 0`` the legacy dedicated
prefill stream is used unchanged.

Prefix-affinity routing (``affinity=True``): arrivals prefer the
replica whose LOCAL DRAM holds the longest cached page run for the
request's context (whole-entry residence when paging is off), falling
back to least-loaded — attacking the cross-replica hit traffic that
least-loaded routing produces under split DRAM.

Sequential readahead (``readahead_pages > 0``, paged mode): the
prefetcher becomes page-native. At dispatch, a matched page run
immediately triggers speculative SSD->DRAM promotions for that run's
slow-resident pages — the pages just read from SSD plus the NEXT pages
of the chain — queued on the tier channels BEHIND the serving reads; in
idle time, runs ranked hot by the controller's run-level
``RunFrequencyEstimator`` are walked the same way before any of their
pages is requested again. A promotion whose run diverges (a variant's
chain departs before reaching the page) is cancelled; one demoted
before any hit counts wasted and cools down. Readahead also turns the
paged partial-hit path into a fetch-compute PIPELINE: suffix chunks
issue at dispatch and overlap the page loads (CacheGen-style streaming
instead of fetch-then-compute), with admission fencing on BOTH the
final chunk and the last page read.

Remainder caching (``remainder_cache=True``, paged mode): the
``T mod page_tokens`` tail that the paged path otherwise recomputes on
every exact repeat is stored as a per-context remainder entry keyed by
the full-context hash (``serving/chunking.py``); a full page-run match
then also fetches the remainder and admits with zero prefill
(``RequestResult.remainder_hit``). A broken base run never consults the
remainder, so page eviction implicitly invalidates it.

All features default OFF; the degenerate configuration is bit-for-bit
the PR-4 event path (pinned against the committed fig6 artifacts).

``process_serialized`` preserves the seed's one-request-at-a-time loop
(every load blocks the server, inserts land instantly) as the measured
baseline the event engine is judged against; see
``benchmarks/fig3_overlap.py`` and ``benchmarks/fig4_prefetch.py``.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.base import LayerKind
from repro_torch.core.controller import AdaptCacheController, SimClock, Transfer
from repro_torch.runtime import trace
from repro_torch.serving.chunking import (
    PagedPrefixCache, join_kv, page_keys, tail_kv,
)
from repro_torch.serving.metrics import percentile_summary, quality_score, safe_mean
from repro_torch.serving.runner import ModelRunner
from repro_torch.serving.sanitizer import SimSanitizer
from repro_torch.serving.scheduler import (
    EV_ARRIVAL, EV_CHUNK_DONE, EV_LOAD_DONE, EV_PREFILL_DONE, EV_TICK,
    EV_WRITE_DONE, EVENT_NAMES, ContinuousBatcher, EventLoop, LaneSet,
)
from repro_torch.serving.timemodel import (
    ComputeChannel, TimeModel, build_tier_channels,
)
from repro_torch.serving.workload import Context, Request, Tenant
from repro_torch.storage.topology import StorageTopology

DEFAULT_IO_STREAMS = {"dram": 8, "ssd": 1}


def _fresh_chunk_stats() -> Dict[str, float]:
    """Chunked-prefill interleave counters: chunks booked / compute
    queueing / decode ticks pushed behind a chunk (plus the worst
    single-tick delay), and the budgeted-tick deferral counters
    (chunks held for a later tick and the time they waited)."""
    return {"chunks_issued": 0, "queue_s": 0.0,
            "ticks_delayed": 0, "tick_delay_s": 0.0,
            "tick_delay_max_s": 0.0,
            "chunks_deferred": 0, "defer_wait_s": 0.0}


@dataclasses.dataclass
class RequestResult:
    req_id: int
    context_key: str
    task_type: str
    arrival_s: float
    ttft_s: float
    queue_s: float
    load_s: float
    prefill_s: float
    hit_tier: Optional[str]          # None = miss (prefilled)
    method: str
    rate: float
    quality: float
    answer: List[int]
    decode_s: float = 0.0            # ttft - queue - load - prefill
    finish_s: float = 0.0            # last answer token time
    replica: int = 0
    truncated: bool = False          # lane hit cache capacity early;
    #                                  excluded from TTFT aggregates
    prefetch_hit: bool = False       # hit served by a speculative promotion
    write_wait_s: float = 0.0        # fetch fenced behind an in-flight write
    wb_queue_s: float = 0.0          # this request's insert: write-queue wait
    wb_transfer_s: float = 0.0       # ... and pure write-transfer time
    remote_hit: bool = False         # entry lived in a sibling replica's
    #                                  DRAM; load paid the replica link
    pages_hit: int = 0               # matched page run length (paged mode)
    tokens_reused_frac: float = 0.0  # source-token coverage of the run:
    #                                  1 - (suffix re-prefilled / context)
    remainder_hit: bool = False      # full run + remainder entry matched:
    #                                  the exact repeat recomputed nothing
    composed_quality: float = 1.0    # estimator-side quality of the served
    #                                  KV: per-piece (method, rate) scores
    #                                  composed along the matched run
    #                                  (QualityEstimator.compose); 1.0 for
    #                                  misses (recompute is exact)
    tenant: Optional[str] = None     # owning tenant (multi-tenant runs);
    #                                  None = untenanted
    # host seconds from the request's dispatch to its first answer token
    # (``repro_torch.runtime.trace`` on; None off): wall clock, never
    # simulated time, and left out of comparisons and ``summarize``
    wall_first_token_s: Optional[float] = dataclasses.field(
        default=None, compare=False)

    @property
    def itl_s(self) -> float:
        """Mean inter-token latency of the generated answer: decode time
        past the first token, per generated token after the first."""
        steps = max(1, len(self.answer) - 1)
        return max(0.0, self.finish_s - self.arrival_s - self.ttft_s) / steps


@dataclasses.dataclass
class _PagedJob:
    """One in-flight page-granular request: matched-page loads book on
    the owning tiers' channels, then the un-matched suffix prefills in
    chunks, then the owner (and any coalesced waiters) admit."""
    rep: "_Replica"
    lane: int
    req: Any
    ctx: Any
    kv_final: Any                    # lane content: pages + fresh suffix
    orig_len: int
    t_dispatch: float
    rec: Dict[str, Any]              # hit-attribution fields for pending
    chunks: List[Tuple[int, int]]    # (n_new_tokens, n_past_tokens)
    insert_task: Optional[str] = None  # owner stores fresh KV at the end
    insert_whole: bool = False       # whole-entry insert (chunked-only
    #                                  mode); False = page inserts
    ci: int = 0                      # next chunk index
    t_load_done: float = -1.0        # page loads landed (-1: no pages)
    waiters: List[Tuple[int, Any, float]] = dataclasses.field(
        default_factory=list)        # coalesced: (lane, req, t_coalesce)
    pipelined: bool = False          # readahead mode: suffix chunks run
    #                                  CONCURRENTLY with the page loads
    loads_pending: bool = False      # pipelined: page reads still in
    #                                  flight (admission fences on them)
    chunks_done: bool = False        # pipelined: final chunk landed
    #                                  before the loads did
    kv_frac: float = 1.0             # fraction of dense KV bytes the
    #                                  matched prefix costs per HBM read
    #                                  (fused compute path; 1.0 = dense)
    matched_tokens: int = 0          # source tokens the matched run
    #                                  covers (the kv_frac-priced span)


class _Replica(LaneSet):
    """One engine replica: lane bookkeeping, a private prefill stream,
    and replica-LOCAL miss coalescing (two replicas missing on the same
    context each run their own prefill — coalescing only folds misses
    that share an accelerator)."""

    def __init__(self, idx: int, batcher: ContinuousBatcher):
        super().__init__(batcher)
        self.idx = idx
        self.prefill_chan = ComputeChannel(f"prefill{idx}")
        # coalesced in-flight prefills: ctx_key -> (kv, done_time)
        self.inflight: Dict[str, Tuple[Any, float]] = {}


class ServingEngine:
    """Discrete-event AdaptCache serving front end (see module doc).

    Contract: ``process`` consumes a request stream and returns one
    ``RequestResult`` per request with an additive latency breakdown —
    ``queue_s + load_s + prefill_s + decode_s == ttft_s`` (all SECONDS
    of simulated time; byte counts everywhere are stored bytes). Token
    content is computed for real on the smoke model and is independent
    of timing knobs. Event ordering at equal timestamps is: load/prefill
    completions, then arrivals, then decode ticks (a lane freed at t can
    absorb a request arriving at t; ticks see every admission made at
    t), then write completions and chunk completions — see
    ``serving/scheduler.py``. The controller's simulated clock is
    advanced to each event time before its handler runs, and fetches
    observe issue time while inserts observe completion time.
    """

    def __init__(self, runner: ModelRunner, controller: AdaptCacheController,
                 time_model: TimeModel, contexts: Sequence[Context],
                 max_new_tokens: int = 24, decode_batch: int = 8,
                 n_replicas: int = 1, n_lanes: int = 2,
                 io_streams: Optional[Dict[str, int]] = None,
                 sim_clock: Optional[SimClock] = None,
                 prefetch_max_inflight: int = 0,
                 prefetch_min_hz: float = 0.0,
                 prefetch_cooldown_s: float = 1.0,
                 prefetch_deadline: bool = False,
                 page_tokens: int = 0,
                 chunk_tokens: int = 0,
                 affinity: bool = False,
                 readahead_pages: int = 0,
                 remainder_cache: bool = False,
                 fused_compute: bool = False,
                 sanitize: bool = False,
                 token_budget: int = 0,
                 tenants: Optional[Dict[str, Tenant]] = None):
        if n_replicas < 1 or n_lanes < 1:
            raise ValueError("need at least one replica with one lane")
        if (readahead_pages > 0 or remainder_cache) and page_tokens <= 0:
            raise ValueError(
                "readahead_pages / remainder_cache are page-native "
                "features: enable paged serving (page_tokens > 0) first")
        if token_budget > 0 and chunk_tokens <= 0:
            raise ValueError(
                "token_budget is a chunked-prefill feature: enable the "
                "unified compute tick (chunk_tokens > 0) first")
        self.runner = runner
        self.controller = controller
        # storage topology: per-replica DRAM routing, cross-replica hit
        # pricing, half-duplex SSD arbitration. None = PR-2 semantics.
        self.topology: Optional[StorageTopology] = \
            getattr(controller, "topology", None)
        if (self.topology is not None
                and not self.topology.shared_dram
                and self.topology.replicas != n_replicas):
            raise ValueError(
                f"topology has {self.topology.replicas} replica DRAM "
                f"tiers but engine runs {n_replicas} replicas")
        self.tm = time_model
        self.contexts: Dict[str, Context] = {c.key: c for c in contexts}
        self.max_new = max_new_tokens
        self.decode_batch = decode_batch
        self.n_replicas = n_replicas
        self.n_lanes = n_lanes
        self.io_streams = dict(DEFAULT_IO_STREAMS if io_streams is None
                               else io_streams)
        self.sim_clock = sim_clock
        # speculative prefetch: 0 in-flight = disabled; min_hz is the
        # FrequencyEstimator prediction floor for promotion candidates;
        # a key whose promotion is wasted (demoted before any hit) is
        # barred from re-promotion for cooldown_s of sim time — the freq
        # guard and the policy's own enforcement ordering can disagree
        # (e.g. LRU demotes by last_hit), which would otherwise ping-pong
        self.prefetch_max_inflight = prefetch_max_inflight
        self.prefetch_min_hz = prefetch_min_hz
        self.prefetch_cooldown_s = prefetch_cooldown_s
        # deadline-aware trigger: only promote when the estimated
        # transfer lands BEFORE the FrequencyEstimator's predicted next
        # hit — a promotion that loses the race serves nothing and burns
        # slow-tier bandwidth. Off by default (PR-2 semantics).
        self.prefetch_deadline = prefetch_deadline
        self.prefetch_stats = {"issued": 0, "hits": 0, "wasted": 0,
                               "suppressed": 0}
        # page-granular serving: contexts stored/matched as fixed-token
        # pages (0 = whole-context entries, the legacy path). SSM state
        # summarizes the whole prefix and cannot be paged.
        if page_tokens > 0 and any(k == LayerKind.MAMBA
                                   for k in runner.model.cfg.layer_kinds()):
            raise ValueError(
                "paged serving requires attention-only models: SSM state "
                "summarizes the whole prefix and cannot be split into "
                "pages")
        self.page_tokens = page_tokens
        self.paged = (PagedPrefixCache(controller, page_tokens,
                                       remainder=remainder_cache)
                      if page_tokens > 0 else None)
        # sequential readahead: >0 bounds BOTH the in-flight page
        # promotions and how deep past the matched run the chain is
        # walked; also switches the partial-hit path to the pipelined
        # fetch-compute overlap. 0 = PR-4 fetch-then-compute semantics.
        self.readahead_pages = readahead_pages
        self.remainder_cache = remainder_cache
        self.readahead_stats = {"issued": 0, "hits": 0, "wasted": 0,
                                "cancelled": 0, "piggybacked": 0}
        # chunked prefill: suffix prefill splits into chunk_tokens-token
        # chunks on ONE unified compute channel per replica that decode
        # ticks also book (0 = dedicated prefill stream, legacy timing)
        self.chunk_tokens = chunk_tokens
        self.chunk_stats = _fresh_chunk_stats()
        # Sarathi-style per-tick prefill token budget (see LaneSet):
        # bounds the prefill tokens fused ahead of each decode step; 0 =
        # FIFO interleave (chunks book the channel when ready, legacy
        # timing). Queued chunks order by (tenant tier, deadline).
        self.token_budget = token_budget
        # tenant registry (name -> Tenant): scheduling priority tiers +
        # deadlines for budgeted chunk reordering. Quotas are installed
        # on the CONTROLLER (set_tenant_quotas), not here.
        self.tenants: Dict[str, Tenant] = dict(tenants) if tenants else {}
        # fused compute path (kernels/fused_prefill): attention consumes
        # the packed prefix directly, so fused-eligible matched pieces
        # price their RESIDENT bytes on the HBM-bound terms of
        # chunk_prefill_s / decode_step_s. Which methods qualify comes
        # from the controller's DelayProfile (fused_methods), the same
        # gate that zeroes their standalone decompress pass. Off = every
        # read prices dense bytes, bit-identical to the pre-fused engine.
        self.fused_compute = fused_compute
        # prefix-affinity arrival routing (split-DRAM topologies only)
        self.affinity = affinity
        self._pkeys: Dict[str, List[str]] = {}
        self._ref_cache: Dict[str, List[int]] = {}
        self._prefill_cache: Dict[str, Any] = {}
        self.last_trace: List[Tuple[float, str, Dict[str, Any]]] = []
        self.last_event_count = 0
        # runtime invariant checking (SimSanitizer): explicit flag or
        # the SIMCHECK env toggle (CI runs the smoke replays under it).
        # The sanitizer only OBSERVES — results are bit-identical.
        self.sanitize = (sanitize
                         or os.environ.get("SIMCHECK", "") not in ("", "0"))
        self.last_sanitizer: Optional[SimSanitizer] = None

    def _fetched_kv_frac(self, fetched) -> float:
        """Decode-read byte fraction for a whole-entry hit: resident
        over dense bytes when the fused kernel consumes the stored
        format directly; 1.0 (dense pricing) otherwise."""
        if (not self.fused_compute
                or fetched.method
                not in self.controller.delay_profile.fused_methods
                or fetched.orig_nbytes <= 0):
            return 1.0
        return min(1.0, fetched.nbytes / fetched.orig_nbytes)

    def _entry_quality(self, key: str, method: str, rate: float) -> float:
        """Estimator-side quality of one served whole entry — the
        single-piece degenerate of the composed run quality."""
        if method == "none":
            return 1.0
        qe = (self.controller.quality_est
              or getattr(self.controller.policy, "quality", None))
        if qe is None:
            return 1.0
        meta = self.controller.meta.get(key)
        return qe.predict(meta.task_type if meta else "qa", method, rate,
                          meta.redundancy if meta else 0.5)

    # -- reference answers (uncompressed prefill), cached -----------------------
    def _probe_key(self, ctx_key: str, question: np.ndarray,
                   max_new: int) -> str:
        h = hashlib.sha1(np.asarray(question).tobytes()).hexdigest()[:10]
        return f"{ctx_key}:{h}:{max_new}"

    def reference_answer(self, ctx: Context, question: np.ndarray,
                         max_new: Optional[int] = None) -> List[int]:
        n = self.max_new if max_new is None else max_new
        pk = self._probe_key(ctx.key, question, n)
        if pk not in self._ref_cache:
            ans, _ = self.runner.generate_uncompressed(ctx.tokens, question,
                                                       n)
            self._ref_cache[pk] = ans
        return self._ref_cache[pk]

    def _prefill_kv(self, ctx: Context):
        """Real-compute prefill, memoized per context (deterministic)."""
        if ctx.key not in self._prefill_cache:
            self._prefill_cache[ctx.key] = self.runner.prefill_entry(
                ctx.tokens)
        return self._prefill_cache[ctx.key]

    def _score(self, req: Request, ctx: Context, answer: List[int],
               skip_quality: bool) -> float:
        if skip_quality:
            return 1.0
        ref = self.reference_answer(ctx, req.question, req.max_new_tokens)
        return quality_score(ctx.task_type, answer, ref)

    # -- event-driven serving loop ----------------------------------------------
    def process(self, requests: Sequence[Request],
                skip_quality: bool = False) -> List[RequestResult]:
        """Simulate the full request stream on N replicas; returns one
        RequestResult per request with the queue/load/prefill/decode
        breakdown. Loads and prefills overlap decode (see module doc).
        Each replica's lanes take their cache from the runner's pool for
        the call and give it back at its end."""
        runner = self.runner
        batchers = []
        try:
            for _ in range(self.n_replicas):
                batchers.append(ContinuousBatcher(
                    runner.model, runner.params, self.tm, runner.pool,
                    n_slots=self.n_lanes, capacity=runner.capacity))
            return self._process(requests, skip_quality, batchers)
        finally:
            for b in batchers:
                b.close()

    def _process(self, requests: Sequence[Request], skip_quality: bool,
                 batchers: List[ContinuousBatcher]) -> List[RequestResult]:
        loop = EventLoop()
        events = self.last_trace = []
        topo = self.topology
        self.prefetch_stats = {"issued": 0, "hits": 0, "wasted": 0,
                               "suppressed": 0}
        self.readahead_stats = {"issued": 0, "hits": 0, "wasted": 0,
                                "cancelled": 0, "piggybacked": 0}
        self.chunk_stats = _fresh_chunk_stats()
        # per-tier channels: duplex tiers get independent read/write
        # queues (writes priced by Tier.store_delay_s); a half-duplex SSD
        # REUSES its read channel for writes, so serving reads,
        # write-backs, and prefetch transfers arbitrate in one
        # shared-budget queue
        channels, wchannels = build_tier_channels(
            self.controller.tiers, self.io_streams,
            duplex_for=lambda name: (topo is None or topo.duplex_ssd
                                     or StorageTopology.level(name) == 0))
        fast_tier = self.controller.tier_order[0]

        def is_dram(name: Optional[str]) -> bool:
            if name is None:
                return False
            return (StorageTopology.level(name) == 0 if topo is not None
                    else name == fast_tier)

        def dram_of(rep: "_Replica") -> str:
            """The DRAM tier a replica promotes into / routes to first."""
            if topo is None or topo.shared_dram:
                return fast_tier
            return topo.dram_for(rep.idx)
        replicas = [_Replica(i, b) for i, b in enumerate(batchers)]
        if self.chunk_tokens > 0:
            # unified compute: decode ticks and prefill chunks share ONE
            # single-stream channel per replica (see LaneSet.tick);
            # token_budget > 0 arms the budgeted tick on every replica
            for r in replicas:
                r.compute_chan = ComputeChannel(f"compute{r.idx}")
                r.compute_stats = self.chunk_stats
                r.token_budget = self.token_budget
        san = self.last_sanitizer = (
            SimSanitizer(self.controller, EVENT_NAMES) if self.sanitize
            else None)
        if san is not None:
            loop.sanitizer = san
            # arm the incremental selector's reference cross-check:
            # every Nth pick_move re-runs the full scan and asserts the
            # identical move. Read-only (counters aside), so sanitized
            # runs stay bit-identical to unsanitized ones.
            sel = self.controller.selector
            if getattr(sel, "name", "") == "indexed" \
                    and sel.crosscheck_every == 0:
                sel.crosscheck_every = 7
            san.watch_channels(channels.values())
            san.watch_channels(wchannels.values())
            san.watch_channels(r.prefill_chan for r in replicas)
            if self.chunk_tokens > 0:
                san.watch_channels(r.compute_chan for r in replicas)
        # per-request breakdown records, filled at admission
        pending: Dict[int, Dict[str, Any]] = {}
        # in-flight writes: key -> sim time its bytes are fully landed;
        # fetches of these keys fence on the transfer
        ready_at: Dict[str, float] = {}
        # speculative promotions not yet rewarded by a hit
        prefetched: Dict[str, bool] = {}
        # keys barred from re-promotion after a wasted promotion
        # (shared by entry prefetch and page readahead)
        pf_cooldown_s: Dict[str, float] = {}
        pf_inflight = [0]
        # sequential readahead: page key -> run key for promotions not
        # yet rewarded by a hit; ra_writes marks whose promote Transfer
        # is still in flight (EV_WRITE_DONE bookkeeping)
        ra_inflight: Dict[str, str] = {}
        ra_writes: set = set()
        ra_count = [0]
        results: List[RequestResult] = []

        def note(now: float, kind: str, **info) -> None:
            events.append((now, kind, info))

        def tick_time(now: float) -> None:
            if self.sim_clock is not None:
                self.sim_clock.advance(now)

        def book(now: float, transfers: List[Transfer], cause: str
                 ) -> List[Tuple[Transfer, float, float]]:
            """Book controller-emitted transfers: source-tier read first
            (contends with serving fetches), then the destination write
            channel. Returns (transfer, queue_s, transfer_s) per entry;
            fences the key until its write lands."""
            out = []
            for tr in transfers:
                t0 = now
                if tr.src_tier is not None:
                    t0 = channels[tr.src_tier].submit(now, tr.read_nbytes)
                # the write is priced by the destination tier's own
                # store_delay_s model, queued on its write channel
                start, done = wchannels[tr.dst_tier].book_service(
                    t0, self.controller.tiers[tr.dst_tier].store_delay_s(
                        tr.nbytes))
                ready_at[tr.key] = max(ready_at.get(tr.key, 0.0), done)
                if tr.kind == "demote" and prefetched.pop(tr.key, None):
                    self.prefetch_stats["wasted"] += 1
                    pf_cooldown_s[tr.key] = now + self.prefetch_cooldown_s
                elif (tr.kind in ("demote", "insert")
                        and ra_inflight.pop(tr.key, None) is not None):
                    # readahead promotion destroyed before any request
                    # used it: demoted back out, or — since evictions
                    # emit no Transfer — evicted and freshly re-inserted
                    # (the re-inserted page must not later be credited
                    # as a readahead hit). Wasted slow-channel bandwidth.
                    self.readahead_stats["wasted"] += 1
                    pf_cooldown_s[tr.key] = now + self.prefetch_cooldown_s
                note(now, "write_issue", key=tr.key, move=tr.kind,
                     tier=tr.dst_tier, nbytes=tr.nbytes, done=done,
                     cause=cause)
                if san is not None:
                    san.note_transfer_booked(tr, done)
                loop.push(done, EV_WRITE_DONE, (tr, cause))
                out.append((tr, start - now, done - start))
            return out

        def prefetch_one(now: float, dst: Optional[str]) -> bool:
            """Try to issue ONE speculative promotion into ``dst``
            (None: the global fast tier). Returns True when issued."""
            for key in self.controller.prefetch_candidates(
                    now=now, limit=8, min_hz=self.prefetch_min_hz):
                if ready_at.get(key, 0.0) > now:
                    continue                 # already moving
                if pf_cooldown_s.get(key, 0.0) > now:
                    continue                 # recently bounced / suppressed
                src = self.controller.lookup(key)
                if src is None or is_dram(src):
                    continue
                if channels[src].queue_depth(now) > 0:
                    continue                 # channel busy serving
                if self.prefetch_deadline and not deadline_ok(now, key,
                                                              src, dst):
                    continue
                transfers: List[Transfer] = []
                tr = self.controller.promote(key, now=now,
                                             transfers=transfers,
                                             dst_tier=dst)
                if tr is None:               # displacement unsafe
                    continue
                pf_inflight[0] += 1
                prefetched[key] = True
                self.prefetch_stats["issued"] += 1
                note(now, "prefetch_issue", key=key, src=src,
                     dst=tr.dst_tier, nbytes=tr.nbytes)
                book(now, transfers, "prefetch")
                return True
            return False

        def deadline_ok(now: float, key: str, src: str,
                        dst: Optional[str]) -> bool:
            """Deadline-aware trigger: issue only when the estimated
            transfer (source read — idle, the caller checked — then the
            destination write behind whatever that channel already has
            queued) completes before the predicted next hit. A losing
            promotion is suppressed and the key cooled down so one slow
            candidate is counted once per window, not once per event."""
            dname = dst or fast_tier
            nb = self.controller.tiers[src].entry_nbytes(key)
            dst_tier = self.controller.tiers[dname]
            read_done = now + self.controller.tiers[src].load_delay_s(nb)
            est_done = max(read_done, wchannels[dname].next_free(now)) \
                + dst_tier.store_delay_s(nb)
            hz = self.controller.freq.predict(key, now)
            if hz <= 0.0 or est_done <= now + 1.0 / hz:
                return True
            self.prefetch_stats["suppressed"] += 1
            pf_cooldown_s[key] = now + self.prefetch_cooldown_s
            note(now, "prefetch_suppress", key=key, est_done=est_done,
                 predicted_gap_s=1.0 / hz)
            return False

        def readahead_run(now: float, rep: _Replica, run_key: str,
                          chain: List[str], idle_only: bool,
                          served: Optional[Dict[str, float]] = None
                          ) -> None:
            """Walk ``chain`` in page order and promote its slow-tier
            residents into the acting replica's DRAM (sequential
            readahead), up to ``readahead_pages`` promotions in flight
            engine-wide. ``idle_only`` (the hot-run background walk)
            skips pages whose source channel is busy serving; the
            dispatch-time walk queues BEHIND the serving reads it just
            booked — and a promotion of a page the current serving plan
            is ALREADY reading (``served``: page key -> read completion)
            piggybacks on that in-flight read instead of re-booking the
            slow channel: the bytes are coming off the SSD anyway, so
            the promotion pays only the DRAM write (counted in
            ``readahead_stats['piggybacked']``). The controller's
            displacement guard arbitrates every move, and
            wasted/cancelled promotions cool the key down like entry
            prefetch."""
            for key in chain:
                if ra_count[0] >= self.readahead_pages:
                    return
                tier = self.controller.lookup(key)
                if tier is None or is_dram(tier):
                    continue         # a gap re-fills at insert time
                if (key in ra_inflight or ready_at.get(key, 0.0) > now
                        or pf_cooldown_s.get(key, 0.0) > now):
                    continue
                if idle_only and channels[tier].queue_depth(now) > 0:
                    return           # don't contend with serving reads
                transfers: List[Transfer] = []
                tr = self.controller.promote(key, now=now,
                                             transfers=transfers,
                                             dst_tier=dram_of(rep))
                if tr is None:       # displacement unsafe
                    continue
                ra_inflight[key] = run_key
                ra_writes.add(key)
                ra_count[0] += 1
                self.readahead_stats["issued"] += 1
                note(now, "readahead_issue", key=key, run=run_key,
                     src=tr.src_tier, dst=tr.dst_tier, nbytes=tr.nbytes)
                if served is not None and key in served:
                    # piggyback: the DRAM write starts once the serving
                    # read has the bytes; any enforce-induced transfers
                    # the promotion triggered still book normally
                    t0 = max(now, served[key])
                    _, done = wchannels[tr.dst_tier].book_service(
                        t0, self.controller.tiers[tr.dst_tier].store_delay_s(
                            tr.nbytes))
                    ready_at[tr.key] = max(ready_at.get(tr.key, 0.0), done)
                    self.readahead_stats["piggybacked"] += 1
                    note(now, "readahead_piggyback", key=key, run=run_key,
                         dst=tr.dst_tier, nbytes=tr.nbytes, done=done)
                    if san is not None:
                        san.note_transfer_booked(tr, done)
                    loop.push(done, EV_WRITE_DONE, (dataclasses.replace(
                        tr, src_tier=None, read_nbytes=0), "readahead"))
                    book(now, [t for t in transfers if t is not tr],
                         "readahead")
                else:
                    book(now, transfers, "readahead")

        def maybe_readahead(now: float, rep: Optional[_Replica] = None
                            ) -> None:
            """Background half of sequential readahead: walk the runs
            the controller's run-level FrequencyEstimator ranks hottest
            and stage their next pages into DRAM before any request
            needs them, using idle slow-channel time only."""
            if self.readahead_pages <= 0 or self.paged is None:
                return
            if ra_count[0] >= self.readahead_pages:
                return              # budget full: skip the candidate scan
            reps = [rep] if rep is not None else list(replicas)
            for run_key, chain in self.controller.run_candidates(
                    now=now, limit=8, min_hz=self.prefetch_min_hz):
                if ra_count[0] >= self.readahead_pages:
                    return
                for r in reps:
                    readahead_run(now, r, run_key, chain, idle_only=True)

        def maybe_prefetch(now: float, rep: Optional[_Replica] = None
                           ) -> None:
            """Use idle slow-tier read-channel time to promote hot
            SSD-resident entries into DRAM — no lane reserved; a later
            arrival for the key becomes a pure DRAM hit. Prefetch is
            replica-local under a split-DRAM topology: each replica
            promotes into its OWN DRAM (``rep`` names the acting
            replica; None — e.g. a write completion — tries every
            replica in turn). Page-run readahead rides the same idle
            trigger but its own in-flight budget."""
            maybe_readahead(now, rep)
            if self.prefetch_max_inflight <= 0:
                return
            reps = [rep] if rep is not None else list(replicas)
            progress = True
            while pf_inflight[0] < self.prefetch_max_inflight and progress:
                progress = False
                for r in reps:
                    if pf_inflight[0] >= self.prefetch_max_inflight:
                        break
                    if prefetch_one(now, dram_of(r)):
                        progress = True

        def pkeys(ctx: Context) -> List[str]:
            """Page-key chain for a context, hashed once per engine."""
            if ctx.key not in self._pkeys:
                self._pkeys[ctx.key] = page_keys(ctx.tokens,
                                                 self.page_tokens)
            return self._pkeys[ctx.key]

        def route(req: Request) -> _Replica:
            """Arrival routing: least-loaded, unless prefix affinity is
            on under a split-DRAM topology — then prefer the replica
            whose LOCAL DRAM holds the longest cached page run for the
            request's context (whole-entry residence when paging is
            off), tie-broken least-loaded."""
            base = min(replicas, key=lambda r: (r.occupancy(), r.idx))
            if (not self.affinity or topo is None or topo.shared_dram
                    or len(replicas) == 1):
                return base
            ctx = self.contexts[req.context_key]
            if self.paged is not None:
                keys = pkeys(ctx)
                best, best_run = base, 0
                for r in replicas:
                    run = self.paged.local_run(ctx.tokens, dram_of(r),
                                               keys=keys)
                    if run > best_run or (
                            run == best_run and run > 0
                            and (r.occupancy(), r.idx)
                            < (best.occupancy(), best.idx)):
                        best, best_run = r, run
                return best
            tier = self.controller.lookup(req.context_key)
            owner = (StorageTopology.replica_of(tier)
                     if tier is not None else None)
            return replicas[owner] if owner is not None else base

        def chunk_priority(job: _PagedJob, n_new: int):
            """Queued-chunk order for the budgeted tick: tenant tier
            first (0 = highest priority), then the request's TTFT
            deadline (``arrival + ttft_slo_s``; no SLO = last within
            the tier), then arrival — so under a low-priority storm the
            high-priority tenant's chunks cut the queue. The req_id /
            chunk-index tail makes the key total (heap never compares
            the fire closure)."""
            ten = self.tenants.get(job.ctx.tenant or "")
            tier = ten.tier if ten is not None else (1 << 30)
            deadline = (job.req.arrival_s + ten.ttft_slo_s
                        if ten is not None and ten.ttft_slo_s > 0
                        else math.inf)
            return (tier, deadline, job.req.arrival_s, job.req.req_id,
                    job.ci)

        def issue_chunk(job: _PagedJob, now: float) -> None:
            """Book the next suffix-prefill chunk. Chunked mode books
            the replica's unified compute channel (contending with
            decode ticks) — immediately in FIFO mode, via the replica's
            budgeted priority queue when token_budget > 0; chunking off
            books the legacy dedicated prefill stream with the
            monolithic prefill cost."""
            n_new, n_past = job.chunks[job.ci]
            if self.chunk_tokens > 0:
                # fused pricing: the matched span of the past context is
                # read at resident (packed) bytes; tokens prefilled by
                # EARLIER chunks of this job are fresh dense KV
                kvb = None
                if (self.fused_compute and job.kv_frac < 1.0
                        and n_past > 0):
                    m = min(job.matched_tokens, n_past)
                    dense = self.tm.cfg.kv_bytes_per_token()
                    kvb = dense * (m * job.kv_frac + (n_past - m)) / n_past
                svc = self.tm.chunk_prefill_s(n_new, n_past,
                                              kv_bytes_per_token=kvb)
                ci = job.ci

                def fire(t: float, n_new=n_new, svc=svc, ci=ci) -> float:
                    start, end = job.rep.compute_chan.book(t, svc)
                    # interleave counters track the UNIFIED tick only —
                    # a monolithic suffix on the dedicated stream is not
                    # a chunk
                    self.chunk_stats["chunks_issued"] += 1
                    self.chunk_stats["queue_s"] += start - t
                    note(t, "chunk_issue", req_id=job.req.req_id,
                         replica=job.rep.idx, idx=ci, n_new=n_new,
                         done=end)
                    loop.push(end, EV_CHUNK_DONE, job)
                    return end

                if self.token_budget > 0:
                    job.rep.submit_chunk(chunk_priority(job, n_new),
                                         n_new, fire, now, loop=loop)
                else:
                    fire(now)
                return
            svc = self.tm.prefill_s(n_new)
            start, end = job.rep.prefill_chan.book(now, svc)
            note(now, "chunk_issue", req_id=job.req.req_id,
                 replica=job.rep.idx, idx=job.ci, n_new=n_new, done=end)
            loop.push(end, EV_CHUNK_DONE, job)

        def finish_job(job: _PagedJob, now: float) -> None:
            """Final chunk (or pure page hit) landed: store the fresh
            KV, admit the owner and every coalesced waiter."""
            rep = job.rep
            rec = dict(job.rec)
            if job.insert_task is not None:
                transfers: List[Transfer] = []
                if job.insert_whole:
                    self.controller.insert(
                        job.req.context_key, job.kv_final, job.insert_task,
                        now=now, transfers=transfers, replica=rep.idx,
                        tenant=job.ctx.tenant)
                else:
                    out = self.paged.insert_context(
                        job.ctx.tokens, self._prefill_kv(job.ctx),
                        job.insert_task, now=now, transfers=transfers,
                        replica=rep.idx, keys=pkeys(job.ctx),
                        tenant=job.ctx.tenant)
                    note(now, "page_insert", req_id=job.req.req_id,
                         inserted=out.inserted, pages=out.pages,
                         remainder_tokens=out.remainder_tokens)
                q = x = 0.0
                for tr, q_s, x_s in book(now, transfers, "insert"):
                    if tr.kind == "insert":
                        q, x = q + q_s, x + x_s
                rec["wb_queue_s"], rec["wb_transfer_s"] = q, x
            rep.inflight.pop(job.req.context_key, None)
            t0 = job.t_load_done if job.t_load_done >= 0 else job.t_dispatch
            # lane-level decode pricing: the matched span stays packed,
            # the fresh suffix is dense — weight over the whole context
            m = min(job.matched_tokens, job.orig_len)
            lane_frac = ((m * job.kv_frac + (job.orig_len - m))
                         / job.orig_len if job.orig_len > 0 else 1.0)
            rep.admit(job.lane, job.req, job.kv_final, job.orig_len, now,
                      kv_frac=lane_frac)
            pending[job.req.req_id] = {
                "queue_s": job.t_dispatch - job.req.arrival_s,
                "load_s": t0 - job.t_dispatch, "prefill_s": now - t0,
                **rec, "replica": rep.idx}
            note(now, "paged_admit", req_id=job.req.req_id,
                 replica=rep.idx, lane=job.lane)
            for lane, wreq, t_c in job.waiters:
                rep.admit(lane, wreq, job.kv_final, job.orig_len, now,
                          kv_frac=lane_frac)
                pending[wreq.req_id] = {
                    "queue_s": t_c - wreq.arrival_s, "load_s": 0.0,
                    "prefill_s": now - t_c, "hit_tier": None,
                    "method": "none", "rate": 1.0, "replica": rep.idx}
                note(now, "paged_admit", req_id=wreq.req_id,
                     replica=rep.idx, lane=lane, coalesced=True)
            rep.ensure_tick(loop, now)
            maybe_prefetch(now, rep)

        def launch_job(job: _PagedJob, plan, now: float
                       ) -> Dict[str, float]:
            """Book the matched pages' reads on their owning tiers'
            channels (fencing on in-flight writes per page), then chain
            into the suffix chunks at load completion — or, in readahead
            mode, issue the chunks IMMEDIATELY so compute overlaps the
            page I/O (fetch-compute pipeline) and fence the admission on
            whichever side finishes last. Returns each booked page's
            channel-read completion time so dispatch-time readahead can
            piggyback promotions on the in-flight serving reads."""
            rep = job.rep
            served: Dict[str, float] = {}
            if plan is not None and plan.n_pages:
                t_done, wait_s = now, 0.0
                for p in plan.pages:
                    start = max(now, ready_at.get(p.key, 0.0))
                    wait_s = max(wait_s, start - now)
                    if san is not None:
                        san.note_read(p.key, start)
                    io_done = channels[p.tier].submit(start, p.nbytes)
                    served[p.key] = io_done
                    done = (io_done
                            + p.xlink_delay_s + p.decompress_delay_s)
                    t_done = max(t_done, done)
                job.rec["write_wait_s"] = wait_s
                note(now, "page_load_issue", req_id=job.req.req_id,
                     replica=rep.idx, pages=plan.n_pages,
                     nbytes=plan.nbytes, done=t_done)
                if job.chunks:
                    rep.inflight[job.req.context_key] = job
                    if self.readahead_pages > 0:
                        job.pipelined = True
                        job.loads_pending = True
                        issue_chunk(job, now)
                loop.push(t_done, EV_LOAD_DONE, job)
            else:
                job.t_load_done = now
                rep.inflight[job.req.context_key] = job
                issue_chunk(job, now)
            return served

        def make_chunks(suffix: int, past: int) -> List[Tuple[int, int]]:
            if suffix <= 0:
                return []
            if self.chunk_tokens <= 0:
                return [(suffix, past)]
            # budgeted tick: a chunk must fit inside one tick's token
            # budget or the drain could never release it (Sarathi sizes
            # chunks to the budget by construction)
            step = (min(self.chunk_tokens, self.token_budget)
                    if self.token_budget > 0 else self.chunk_tokens)
            out, off = [], 0
            while off < suffix:
                n = min(step, suffix - off)
                out.append((n, past + off))
                off += n
            return out

        def dispatch_paged(rep: _Replica, lane: int, req: Request,
                           now: float) -> None:
            ctx = self.contexts[req.context_key]
            ent = rep.inflight.get(req.context_key)
            if ent is not None:          # coalesce onto the in-flight job
                ent.waiters.append((lane, req, now))
                note(now, "prefill_coalesce", req_id=req.req_id,
                     replica=rep.idx)
                return
            keys = pkeys(ctx)
            t_ctx = len(ctx.tokens)
            plan = self.paged.match_prefix(ctx.tokens, now=now,
                                           replica=rep.idx, keys=keys)
            suffix = t_ctx - plan.src_tokens
            if self.readahead_pages > 0 and keys:
                # the run diverged: in-flight readahead for pages the
                # latest trajectory no longer reaches is cancelled (the
                # promoted bytes stay where they landed; the key cools
                # down so the stale branch is not re-staged)
                chain = set(keys)
                # sorted(): cancellation emits trace entries and cools
                # keys down — pin the scan order so the replay trace is
                # independent of promotion insertion history
                for k, rk in sorted(ra_inflight.items()):
                    if rk == keys[0] and k not in chain:
                        ra_inflight.pop(k)
                        # a page the LRU already evicted outright (no
                        # Transfer, never re-inserted) was wasted, not
                        # cancelled — its bytes are gone either way
                        if self.controller.lookup(k) is None:
                            self.readahead_stats["wasted"] += 1
                        else:
                            self.readahead_stats["cancelled"] += 1
                        pf_cooldown_s[k] = now + self.prefetch_cooldown_s
                        note(now, "readahead_cancel", key=k, run=rk)
            # a full page-run hit never touches the real-compute prefill:
            # the lane content comes entirely from the fetched pages
            if plan.n_pages == 0:
                kv_final = self._prefill_kv(ctx)
            elif suffix == 0:
                kv_final = plan.kv
            else:
                kv_final = join_kv([plan.kv,
                                    tail_kv(self._prefill_kv(ctx),
                                            plan.src_tokens)])
            if plan.n_pages:
                pf_hit = False
                for p in plan.pages:
                    if (is_dram(p.tier)
                            and prefetched.pop(p.key, None) is not None):
                        pf_hit = True
                    if (is_dram(p.tier)
                            and ra_inflight.pop(p.key, None) is not None):
                        self.readahead_stats["hits"] += 1
                if pf_hit:
                    self.prefetch_stats["hits"] += 1
                # attribute the hit to the SLOWEST tier in the run (the
                # page that gates the load) and price page compression
                # as the kept-token fraction
                deep = max(plan.pages,
                           key=lambda p: StorageTopology.level(p.tier))
                rec = {"hit_tier": deep.tier, "method": "paged",
                       "rate": plan.n_tokens / max(1, plan.src_tokens),
                       "remote_hit": any(p.remote for p in plan.pages),
                       "prefetch_hit": pf_hit,
                       # a matched remainder rides plan.pages but is not
                       # a page — pages_hit stays the true run length
                       "pages_hit": plan.n_pages
                       - (1 if plan.remainder_tokens else 0),
                       "tokens_reused_frac": plan.src_tokens / t_ctx,
                       "remainder_hit": plan.remainder_tokens > 0,
                       "composed_quality": plan.quality}
            else:
                rec = {"hit_tier": None, "method": "none", "rate": 1.0}
            kv_frac = 1.0
            if self.fused_compute and plan.n_pages:
                kv_frac = plan.kv_bytes_frac(
                    self.controller.delay_profile.fused_methods)
            job = _PagedJob(rep, lane, req, ctx, kv_final, t_ctx, now, rec,
                            make_chunks(suffix, plan.src_tokens),
                            insert_task=(ctx.task_type if suffix > 0
                                         else None),
                            kv_frac=kv_frac,
                            matched_tokens=plan.src_tokens)
            served = launch_job(job, plan, now)
            # sequential readahead, dispatch half: stage this run's
            # slow-resident pages (the SSD pages just read — promotions
            # of those piggyback on the in-flight serving reads — plus
            # the NEXT pages of the chain) behind the serving reads.
            # ``keys`` can be empty on a remainder-only match of a
            # sub-page context — no run to walk then.
            if self.readahead_pages > 0 and plan.n_pages and keys:
                readahead_run(now, rep, keys[0], keys, idle_only=False,
                              served=served)

        def dispatch(rep: _Replica, lane: int, req: Request,
                     now: float) -> None:
            trace.begin_request(req.req_id)
            if self.paged is not None:
                return dispatch_paged(rep, lane, req, now)
            ctx = self.contexts[req.context_key]
            fetched = self.controller.fetch(req.context_key, now=now,
                                            replica=rep.idx)
            if fetched is not None:
                # fence: the entry's bytes may still be in flight toward
                # its tier (async insert/demote/promote)
                start = max(now, ready_at.get(req.context_key, 0.0))
                if san is not None:
                    san.note_read(req.context_key, start)
                # the read is booked on the OWNING tier's channel (a
                # remote DRAM hit contends with the owner's local reads)
                # and a cross-replica hit additionally pays the link
                io_done = channels[fetched.tier].submit(start, fetched.nbytes)
                done = io_done + fetched.xlink_delay_s \
                    + fetched.decompress_delay_s
                pf_hit = (is_dram(fetched.tier)
                          and prefetched.pop(req.context_key, None)
                          is not None)
                if pf_hit:
                    self.prefetch_stats["hits"] += 1
                note(now, "load_issue", req_id=req.req_id,
                     tier=fetched.tier, nbytes=fetched.nbytes,
                     replica=rep.idx, remote=fetched.remote, done=done)
                loop.push(done, EV_LOAD_DONE,
                          (rep, lane, req, fetched.kv, len(ctx.tokens),
                           now, {"hit_tier": fetched.tier,
                                 "method": fetched.method,
                                 "rate": fetched.rate,
                                 "prefetch_hit": pf_hit,
                                 "remote_hit": fetched.remote,
                                 "write_wait_s": start - now,
                                 "composed_quality": self._entry_quality(
                                     req.context_key, fetched.method,
                                     fetched.rate),
                                 "_kv_frac": self._fetched_kv_frac(
                                     fetched)}))
            elif req.context_key in rep.inflight:
                ent = rep.inflight[req.context_key]
                if isinstance(ent, _PagedJob):   # chunked-whole in flight
                    ent.waiters.append((lane, req, now))
                    note(now, "prefill_coalesce", req_id=req.req_id,
                         replica=rep.idx)
                    return
                kv, done = ent
                done = max(done, now)
                note(now, "prefill_coalesce", req_id=req.req_id,
                     replica=rep.idx, done=done)
                loop.push(done, EV_PREFILL_DONE,
                          (rep, lane, req, kv, len(ctx.tokens), now, None))
            elif self.chunk_tokens > 0:
                # whole-context miss, chunked: the prefill interleaves
                # with decode on the unified channel and inserts the
                # whole entry at completion
                t_ctx = len(ctx.tokens)
                job = _PagedJob(rep, lane, req, ctx, self._prefill_kv(ctx),
                                t_ctx, now,
                                {"hit_tier": None, "method": "none",
                                 "rate": 1.0},
                                make_chunks(t_ctx, 0),
                                insert_task=ctx.task_type,
                                insert_whole=True)
                launch_job(job, None, now)
            else:
                kv = self._prefill_kv(ctx)
                done = rep.prefill_chan.submit(
                    now, self.tm.prefill_s(len(ctx.tokens)))
                rep.inflight[req.context_key] = (kv, done)
                note(now, "prefill_issue", req_id=req.req_id,
                     replica=rep.idx, done=done)
                loop.push(done, EV_PREFILL_DONE,
                          (rep, lane, req, kv, len(ctx.tokens), now,
                           ctx.task_type))

        def issue(rep: _Replica, now: float) -> None:
            rep.issue(now, lambda lane, req, t: dispatch(rep, lane, req, t))

        req_by_id = {r.req_id: r for r in requests}
        for req in requests:
            # a workload may stamp arrivals before the clock start; they
            # land immediately (push rejects past-time scheduling)
            loop.push(max(loop.now, req.arrival_s), EV_ARRIVAL, req)

        while loop:
            now, kind, payload = loop.pop()
            tick_time(now)
            if kind == EV_ARRIVAL:
                req = payload
                rep = route(req)
                rep.waiting.append(req)
                note(now, "arrival", req_id=req.req_id, replica=rep.idx)
                issue(rep, now)
                maybe_prefetch(now, rep)

            elif kind == EV_CHUNK_DONE:
                job = payload
                job.ci += 1
                note(now, "chunk_done", req_id=job.req.req_id,
                     replica=job.rep.idx, idx=job.ci - 1,
                     remaining=len(job.chunks) - job.ci)
                if job.ci < len(job.chunks):
                    issue_chunk(job, now)
                elif job.pipelined and job.loads_pending:
                    job.chunks_done = True  # compute beat the page I/O;
                    #                         admission fences on the loads
                else:
                    finish_job(job, now)

            elif kind == EV_LOAD_DONE and isinstance(payload, _PagedJob):
                job = payload
                job.t_load_done = now
                if job.pipelined:
                    job.loads_pending = False
                    if job.chunks_done:     # compute already finished
                        finish_job(job, now)
                    # else: the in-flight chunk chain admits the job
                elif job.chunks:        # fetch-then-compute: the suffix
                    issue_chunk(job, now)   # starts once the pages landed
                else:
                    finish_job(job, now)    # pure page hit

            elif kind in (EV_LOAD_DONE, EV_PREFILL_DONE):
                rep, lane, req, kv, orig_len, issue_t, extra = payload
                if kind == EV_PREFILL_DONE:
                    hit = {"hit_tier": None, "method": "none", "rate": 1.0}
                    if isinstance(extra, str):       # owner of the prefill
                        transfers: List[Transfer] = []
                        self.controller.insert(
                            req.context_key, kv, extra, now=now,
                            transfers=transfers, replica=rep.idx,
                            tenant=self.contexts[req.context_key].tenant)
                        rep.inflight.pop(req.context_key, None)
                        booked = book(now, transfers, "insert")
                        for tr, q_s, x_s in booked:
                            if tr.kind == "insert":
                                hit["wb_queue_s"] = q_s
                                hit["wb_transfer_s"] = x_s
                    timing = {"load_s": 0.0, "prefill_s": now - issue_t}
                    kv_frac = 1.0
                else:
                    hit = extra
                    timing = {"load_s": now - issue_t, "prefill_s": 0.0}
                    kv_frac = hit.pop("_kv_frac", 1.0)
                rep.admit(lane, req, kv, orig_len, now, kv_frac=kv_frac)
                pending[req.req_id] = {
                    "queue_s": issue_t - req.arrival_s, **timing, **hit,
                    "replica": rep.idx}
                note(now, EVENT_NAMES[kind], req_id=req.req_id,
                     replica=rep.idx, lane=lane)
                rep.ensure_tick(loop, now)
                maybe_prefetch(now, rep)

            elif kind == EV_WRITE_DONE:
                tr, cause = payload
                if san is not None:
                    san.note_transfer_done(tr, now)
                if ready_at.get(tr.key, 0.0) <= now:
                    ready_at.pop(tr.key, None)
                if tr.kind == "promote":
                    if tr.key in ra_writes:     # readahead budget, not
                        ra_writes.discard(tr.key)   # the entry-prefetch one
                        ra_count[0] -= 1
                    else:
                        pf_inflight[0] -= 1
                note(now, "write_done", key=tr.key, move=tr.kind,
                     tier=tr.dst_tier, cause=cause)
                maybe_prefetch(now)

            elif kind == EV_TICK:
                rep = payload
                done = rep.tick(loop, now)
                if done is None:            # all lanes idle; chain stopped
                    maybe_prefetch(now, rep)
                    if san is not None:
                        san.after_event(now, kind)
                    continue
                note(now, "tick", replica=rep.idx, finished=len(done),
                     lanes=sum(s.active for s in rep.batcher.slots)
                     + len(done))
                for sched in done:
                    rec = pending.pop(sched.req_id)
                    req = req_by_id[sched.req_id]
                    ctx = self.contexts[sched.context_key]
                    non_decode = (rec["queue_s"] + rec["load_s"]
                                  + rec["prefill_s"])
                    results.append(RequestResult(
                        sched.req_id, sched.context_key, ctx.task_type,
                        req.arrival_s, sched.ttft_s, rec["queue_s"],
                        rec["load_s"], rec["prefill_s"], rec["hit_tier"],
                        rec["method"], rec["rate"],
                        self._score(req, ctx, sched.tokens, skip_quality),
                        sched.tokens,
                        decode_s=sched.ttft_s - non_decode,
                        finish_s=sched.finish_s, replica=rec["replica"],
                        truncated=sched.truncated,
                        prefetch_hit=rec.get("prefetch_hit", False),
                        write_wait_s=rec.get("write_wait_s", 0.0),
                        wb_queue_s=rec.get("wb_queue_s", 0.0),
                        wb_transfer_s=rec.get("wb_transfer_s", 0.0),
                        remote_hit=rec.get("remote_hit", False),
                        pages_hit=rec.get("pages_hit", 0),
                        tokens_reused_frac=rec.get("tokens_reused_frac",
                                                   0.0),
                        remainder_hit=rec.get("remainder_hit", False),
                        composed_quality=rec.get("composed_quality",
                                                 1.0),
                        tenant=ctx.tenant,
                        wall_first_token_s=sched.wall_first_token_s))
                issue(rep, now)
                maybe_prefetch(now, rep)

            if san is not None:
                san.after_event(now, kind)

        if san is not None:
            san.finish(loop.now)
        # simulator-throughput numerator for the scale benchmark: how
        # many events this run handled (wall-clock is measured by the
        # benchmark harness, never in here)
        self.last_event_count = loop.processed
        results.sort(key=lambda r: (r.arrival_s, r.req_id))
        return results

    # -- serialized reference loop (the seed behaviour) -------------------------
    def process_serialized(self, requests: Sequence[Request],
                           skip_quality: bool = False) -> List[RequestResult]:
        """Seed serving loop kept as the measured baseline: one server,
        every load/prefill blocks the clock before the next admission."""
        results = []
        server_free_at = 0.0
        for req in sorted(requests, key=lambda r: r.arrival_s):
            ctx = self.contexts[req.context_key]
            start = max(req.arrival_s, server_free_at)
            queue_s = start - req.arrival_s

            fetched = self.controller.fetch(req.context_key, now=start)
            t = len(ctx.tokens)
            kvb = None
            if fetched is not None:
                frac = self._fetched_kv_frac(fetched)
                if frac < 1.0:
                    kvb = self.tm.cfg.kv_bytes_per_token() * frac
            if fetched is None:
                # MISS: prefill (recomputation) and admit into the hierarchy
                kv = self._prefill_kv(ctx)
                prefill_s = self.tm.prefill_s(t)
                load_s = 0.0
                self.controller.insert(req.context_key, kv, ctx.task_type,
                                       now=start, tenant=ctx.tenant)
                method, rate, tier = "none", 1.0, None
            else:
                kv = fetched.kv
                load_s = fetched.total_delay_s
                prefill_s = 0.0
                method, rate, tier = (fetched.method, fetched.rate,
                                      fetched.tier)
            answer = self.runner.generate_from_kvdata(
                kv, t, req.question, req.max_new_tokens)

            decode1 = self.tm.decode_step_s(self.decode_batch, t,
                                            kv_bytes_per_token=kvb)
            # question tokens are teacher-forced decode steps before TTFT
            decode_s = decode1 * (len(req.question) + 1)
            ttft = queue_s + load_s + prefill_s + decode_s
            finish = start + load_s + prefill_s \
                + decode1 * (len(req.question) + req.max_new_tokens)
            server_free_at = finish

            results.append(RequestResult(
                req.req_id, req.context_key, ctx.task_type, req.arrival_s,
                ttft, queue_s, load_s, prefill_s, tier, method, rate,
                self._score(req, ctx, answer, skip_quality), answer,
                decode_s=decode_s, finish_s=finish,
                composed_quality=(
                    self._entry_quality(req.context_key, method, rate)
                    if tier is not None else 1.0),
                tenant=ctx.tenant))
        return results

    # -- estimator probe --------------------------------------------------------
    def quality_probe(self, ctx: Context):
        """Returns probe(kv, method, rate) for QualityEstimator.fit."""
        question = ctx.probes[0]
        ref = self.reference_answer(ctx, question)

        def probe(kv, method_name: str, rate: float) -> float:
            m = self.controller.methods[method_name]
            entry = m.compress(kv, rate)
            dkv = m.decompress(entry)
            ans = self.runner.generate_from_kvdata(
                dkv, len(ctx.tokens), question, self.max_new)
            return quality_score(ctx.task_type, ans, ref)
        return probe


def summarize(results: Sequence[RequestResult],
              prefetch_stats: Optional[Dict[str, int]] = None,
              chunk_stats: Optional[Dict[str, float]] = None,
              readahead_stats: Optional[Dict[str, int]] = None,
              selector_stats: Optional[Dict[str, int]] = None
              ) -> Dict[str, float]:
    if not results:
        return {"n": 0}
    # truncated lanes carry fabricated TTFTs (capacity ran out
    # mid-question) — exclude them from the latency aggregates
    valid = [r for r in results if not r.truncated] or list(results)
    ttfts = np.array([r.ttft_s for r in valid])
    quals = np.array([r.quality for r in results])
    hits = [r for r in results if r.hit_tier is not None]
    n = len(results)
    # per-replica DRAM tiers ("dram:<r>") all count as DRAM hits; remote
    # hits (served from a SIBLING replica's DRAM over the link) are also
    # broken out so topology placement quality is visible
    out = {
        "n": n,
        **percentile_summary("ttft", ttfts),
        "quality_mean": float(quals.mean()),
        "hit_rate": len(hits) / n,
        "hit_rate_dram": sum(r.hit_tier is not None
                             and r.hit_tier.startswith("dram")
                             for r in results) / n,
        "hit_rate_ssd": sum(r.hit_tier == "ssd" for r in results) / n,
        "remote_hit_rate": sum(r.remote_hit for r in results) / n,
        "queue_mean_s": float(np.mean([r.queue_s for r in results])),
        "load_mean_s": float(np.mean([r.load_s for r in results])),
        "prefill_mean_s": float(np.mean([r.prefill_s for r in results])),
        # truncated lanes also poison decode_s (derived from the
        # fabricated TTFT), so it averages over valid results only
        "decode_mean_s": float(np.mean([r.decode_s for r in valid])),
        "truncated_rate": sum(r.truncated for r in results) / n,
        "prefetch_hit_rate": sum(r.prefetch_hit for r in results) / n,
        # async write-back breakdown: fence waits on fetches, and the
        # write-queue/transfer split per OWNED insert (coalesced misses
        # carry no write and would dilute the per-insert cost)
        "write_wait_mean_s": safe_mean([r.write_wait_s for r in results]),
        "wb_queue_mean_s": safe_mean(
            [r.wb_queue_s for r in results if r.hit_tier is None
             and (r.wb_queue_s > 0 or r.wb_transfer_s > 0)]),
        "wb_transfer_mean_s": safe_mean(
            [r.wb_transfer_s for r in results if r.hit_tier is None
             and (r.wb_queue_s > 0 or r.wb_transfer_s > 0)]),
        # page-granular reuse: matched run length, source-token coverage
        # and the share of requests that reused SOME pages but still had
        # to recompute a suffix (the partial-prefix hits paging unlocks).
        # Partiality is judged by coverage, not prefill_s: the pipelined
        # readahead path can fully overlap the suffix compute with page
        # loads, reporting prefill_s == 0 for a genuinely partial hit.
        "pages_hit_mean": float(np.mean([r.pages_hit for r in results])),
        "tokens_reused_frac_mean": float(
            np.mean([r.tokens_reused_frac for r in results])),
        "partial_hit_rate": sum(
            r.pages_hit > 0 and r.tokens_reused_frac < 1.0
            for r in results) / n,
        # remainder caching: exact repeats whose sub-page tail was served
        # from a remainder entry instead of being recomputed
        "remainder_hit_rate": sum(r.remainder_hit for r in results) / n,
        # estimator-side composed quality of the served KV (per-piece
        # rates folded along each request's matched run; 1.0 = every
        # served byte lossless or recomputed)
        "composed_quality_mean": float(
            np.mean([r.composed_quality for r in results])),
    }
    # per-tenant SLO aggregates (TTFT + inter-token latency percentiles)
    # — emitted only when some result carries a tenant, so untenanted
    # runs keep their exact historical key set
    tenants = sorted({r.tenant for r in results if r.tenant})
    for ten in tenants:
        tvalid = [r for r in valid if r.tenant == ten]
        out[f"tenant_{ten}_n"] = sum(r.tenant == ten for r in results)
        out.update(percentile_summary(
            f"tenant_{ten}_ttft", np.array([r.ttft_s for r in tvalid])))
        out.update(percentile_summary(
            f"tenant_{ten}_itl", np.array([r.itl_s for r in tvalid])))
    if prefetch_stats is not None:
        # engine-level prefetch counters (issued / hits / wasted /
        # deadline-suppressed) folded into the summary row
        out.update({f"prefetch_{k}": v for k, v in prefetch_stats.items()})
    if chunk_stats is not None:
        # chunked-prefill interleave counters: chunks booked, compute
        # queueing they saw, and decode ticks pushed behind a chunk
        out.update({f"chunk_{k}": v for k, v in chunk_stats.items()})
    if readahead_stats is not None:
        # sequential-readahead counters: page promotions issued / hit /
        # wasted (demoted unused) / cancelled (run diverged)
        out.update({f"readahead_{k}": v
                    for k, v in readahead_stats.items()})
    if selector_stats is not None:
        # placement-selector work counters (controller.selector.stats):
        # picks issued, entries scored, lazy-heap garbage discarded,
        # moves applied, cross-checks run — selection cost in event
        # counts, wall-clock-free (timing lives in benchmark harnesses)
        out.update({f"selector_{k}": v
                    for k, v in selector_stats.items()})
    return out
