"""Continuous-batching lanes + the discrete-event loop they run under.

Two layers live here:

* ``ContinuousBatcher`` — slot-based continuous batching over the ragged
  decode path. One BATCHED cache pytree holds ``n_slots`` lanes; requests
  are admitted into free lanes (prefill or cache-hit load writes the
  lane), every tick decodes ALL active lanes in one model call with
  per-lane write slots and RoPE positions (`decode_step(cur_index=(B,),
  position=(B,))` — the vector form added for exactly this), finished
  lanes free immediately and new requests stream in: no batch-boundary
  stalls. Token content is computed for real on the smoke model while
  simulated time uses the full-scale ``timemodel``.

* ``EventLoop`` — a priority event queue (arrival / load-complete /
  prefill-complete / decode-tick / write-complete) with a monotonic
  simulated clock and a zero-progress livelock guard. The I/O model is
  fully duplex-async: KV loads and prefills are *booked* on read /
  compute channels, and every byte movement INTO a tier (insert
  write-back, MCKP demotion, speculative prefetch promotion) is booked
  on the destination tier's write channel, completing via
  ``EV_WRITE_DONE``. Decode ticks never stall on storage: a lane joins
  the batch only when its load-complete event fires, and a fetch of a
  still-writing entry fences on the in-flight transfer.
  ``repro_torch.serving.engine.ServingEngine`` is the full AdaptCache front
  end on top of this; ``run_continuous`` below is the thin
  single-batcher harness used by the scheduler tests.
"""
from __future__ import annotations

import collections
import dataclasses
import heapq
import itertools
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.compression.base import KVData
from repro_torch.models import Model
from repro_torch.models.decode_graph import CachePool
from repro_torch.runtime import trace
from repro_torch.serving.runner import write_kvdata
from repro_torch.serving.timemodel import TimeModel
from repro_torch.serving.workload import Request


@dataclasses.dataclass
class SlotState:
    req: Optional[Request] = None
    ttft_s: Optional[float] = None
    started_s: float = 0.0
    write_slot: int = 0              # next cache slot for this lane
    position: int = 0                # next RoPE position
    pending: List[int] = dataclasses.field(default_factory=list)
    generated: List[int] = dataclasses.field(default_factory=list)
    # host seconds from dispatch to the first answer token (tracing on)
    wall_first_token_s: Optional[float] = None
    # fraction of dense KV bytes this lane's context costs per decode
    # read: < 1.0 when the matched prefix stays packed in HBM and the
    # fused kernel dequantizes it in VREGs (1.0 = dense pricing)
    kv_frac: float = 1.0

    @property
    def active(self) -> bool:
        return self.req is not None


@dataclasses.dataclass
class ScheduledResult:
    req_id: int
    context_key: str
    ttft_s: float
    finish_s: float
    tokens: List[int]
    # lane ran out of cache capacity before the answer completed; when it
    # happened mid-question the TTFT is fabricated — aggregates must
    # exclude truncated results (see ``summarize``)
    truncated: bool = False
    wall_first_token_s: Optional[float] = None


class ContinuousBatcher:
    """The lanes' cache is lent by ``pool`` (a
    ``models.decode_graph.CachePool``) and given back by ``close``. A
    pooled cache on CUDA replays each step as one CUDA graph."""

    def __init__(self, model: Model, params, time_model: TimeModel,
                 pool: CachePool, n_slots: int = 4, capacity: int = 1024):
        self.model = model
        self.params = params
        self.tm = time_model
        self.n_slots = n_slots
        self.capacity = capacity
        self.device = params["embed"].device
        self.pool = pool
        self.cache = pool.acquire(params, n_slots, capacity)
        self.slots = [SlotState() for _ in range(n_slots)]
        self._decode = model.decode_step

    def close(self) -> None:
        """Give the cache back to the pool (the batcher serves no more)."""
        self.pool.release(self.cache)
        self.cache = None

    # -- lane loading ---------------------------------------------------------
    def _write_lane(self, lane: int, kv: KVData) -> int:
        """Write a (decompressed) entry into cache lane ``lane``; returns
        number of occupied slots.

        Writes go in place into the target lane of each layer's cache
        leaf (the reference's per-leaf ``.at[...].set`` builds new arrays);
        a mamba layer's state is written whole; no other lane is touched.
        """
        return write_kvdata(self.cache, kv, self.model.cfg, lane,
                            self.device)

    def free_lanes(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if not s.active]

    def admit(self, lane: int, req: Request, kv: KVData, orig_len: int,
              now: float, kv_frac: float = 1.0) -> None:
        n_kept = self._write_lane(lane, kv)
        self.slots[lane] = SlotState(
            req=req, started_s=now, write_slot=n_kept, position=orig_len,
            pending=list(np.asarray(req.question, np.int64)),
            kv_frac=kv_frac)

    def _decode_kvb(self, active: List[int]) -> Optional[float]:
        """Per-token KV-read bytes override for the next decode step:
        the position-weighted mean of the active lanes' ``kv_frac``
        applied to the dense per-token footprint. None (use the dense
        default) when every lane prices dense — the common case, kept
        bit-identical to the pre-fused path."""
        if all(self.slots[i].kv_frac >= 1.0 for i in active):
            return None
        pos_sum = sum(self.slots[i].position for i in active)
        if pos_sum <= 0:
            return None
        frac = (sum(self.slots[i].position * self.slots[i].kv_frac
                    for i in active) / pos_sum)
        return self.tm.cfg.kv_bytes_per_token() * frac

    def next_dt(self) -> Optional[float]:
        """Service time the next ``tick`` will charge (None when all
        lanes are idle) — lets the unified-compute path book the decode
        step on a channel BEFORE running it."""
        active = [i for i, s in enumerate(self.slots) if s.active]
        if not active:
            return None
        max_ctx = max(self.slots[i].position for i in active)
        return self.tm.decode_step_s(len(active), max_ctx,
                                     kv_bytes_per_token=self._decode_kvb(
                                         active))

    # -- one decode tick over all active lanes -------------------------------
    def tick(self, now: float) -> Tuple[List[ScheduledResult], float]:
        active = [i for i, s in enumerate(self.slots) if s.active]
        if not active:
            return [], 0.0
        tokens = np.zeros((self.n_slots, 1), np.int32)
        write = np.zeros((self.n_slots,), np.int32)
        pos = np.zeros((self.n_slots,), np.int32)
        for i in active:
            s = self.slots[i]
            tokens[i, 0] = (s.pending[0] if s.pending
                            else (s.generated[-1] if s.generated else 0))
            write[i] = min(s.write_slot, self.capacity - 1)
            pos[i] = s.position
        if trace.ON:
            trace.set_request([self.slots[i].req.req_id for i in active])
        with trace.span("model.step") as sp:
            if sp:
                sp.attrs.update(lanes=active,
                                ctx=[int(pos[i]) + 1 for i in active])
            # host tensors: the model uploads them (a graph's static inputs)
            logits, self.cache = self._decode(
                self.params, self.cache, torch.from_numpy(write),
                torch.from_numpy(tokens).long(), torch.from_numpy(pos))
            nxt = torch.argmax(logits[:, 0], dim=-1)
            if sp:
                trace.count("host_reads")
                trace.count("d2h_bytes", nxt.nbytes)
            nxt = nxt.cpu().numpy()

        max_ctx = max(self.slots[i].position for i in active)
        dt = self.tm.decode_step_s(len(active), max_ctx,
                                   kv_bytes_per_token=self._decode_kvb(
                                       active))

        done: List[ScheduledResult] = []
        for i in active:
            s = self.slots[i]
            s.write_slot += 1
            s.position += 1
            if s.pending:
                s.pending.pop(0)
                if not s.pending:
                    # logits of the LAST question token produce the first
                    # answer token — capture it now (TTFT point).
                    s.generated.append(int(nxt[i]))
                    if s.ttft_s is None:
                        s.ttft_s = now + dt - s.req.arrival_s
            else:
                s.generated.append(int(nxt[i]))
            if s.generated and s.wall_first_token_s is None:
                s.wall_first_token_s = trace.end_request(s.req.req_id)
            answered = (not s.pending
                        and len(s.generated) >= s.req.max_new_tokens)
            out_of_capacity = s.write_slot >= self.capacity
            if answered or out_of_capacity:
                done.append(ScheduledResult(
                    s.req.req_id, s.req.context_key,
                    s.ttft_s if s.ttft_s is not None else now + dt -
                    s.req.arrival_s,
                    now + dt, list(s.generated),
                    truncated=out_of_capacity and not answered,
                    wall_first_token_s=s.wall_first_token_s))
                # a request cut before its first token closes its span here
                trace.end_request(s.req.req_id)
                self.slots[i] = SlotState()
        return done, dt


# ---------------------------------------------------------------------------
# Discrete-event core
# ---------------------------------------------------------------------------

# Event kinds, in tie-break priority order at equal timestamps: completions
# land before arrivals so a lane freed at t can absorb a request arriving
# at t, and ticks run last so they see every admission made "at" t.
# Write completions (insert write-back, demotions, prefetch promotions)
# order after ticks: in-flight-write fencing is time-based (``ready_at``),
# so same-timestamp ordering only affects the trace, not results.
# Chunk completions (paged/chunked prefill) sort last: chunk chains are
# driven by compute-channel bookings with strictly positive service
# times, so ties are rare and a lane admitted by a same-time chunk-done
# simply joins the NEXT tick.
EV_LOAD_DONE = 0
EV_PREFILL_DONE = 1
EV_ARRIVAL = 2
EV_TICK = 3
EV_WRITE_DONE = 4
EV_CHUNK_DONE = 5

EVENT_NAMES = {EV_LOAD_DONE: "load_done", EV_PREFILL_DONE: "prefill_done",
               EV_ARRIVAL: "arrival", EV_TICK: "tick",
               EV_WRITE_DONE: "write_done", EV_CHUNK_DONE: "chunk_done"}


class EventLoop:
    """Priority queue of timestamped events with a monotonic sim clock.

    The clock never moves backwards. Scheduling an event in the past
    (``when < now``) raises ``ValueError`` at ``push`` time — handlers
    always stamp completions at ``now + service`` or ``max(now, ...)``,
    so a past-time push is a simulation bug, not a policy choice. The
    ``max(now, when)`` clamp in ``pop`` remains as a second line of
    defense (and ``SimSanitizer.on_pop`` checks it when sanitizing).
    ``max_events`` is the zero-progress livelock guard — the seed
    ``run_continuous`` could spin forever re-reading a past arrival
    without advancing time; here any handler that keeps scheduling
    same-time work trips the guard with a clear error instead of
    hanging the process.
    """

    def __init__(self, max_events: int = 2_000_000):
        self._heap: List[Tuple[float, int, int, Any]] = []
        self._seq = itertools.count()
        self.now = 0.0
        self.max_events = max_events
        self.processed = 0
        # optional repro_torch.serving.sanitizer.SimSanitizer (read-only hooks)
        self.sanitizer = None

    def push(self, when: float, kind: int, payload: Any = None) -> None:
        if when < self.now:
            raise ValueError(
                f"cannot schedule '{EVENT_NAMES.get(kind, kind)}' at "
                f"t={when:.9f}: simulated clock is already at "
                f"t={self.now:.9f}")
        heapq.heappush(self._heap, (when, kind, next(self._seq), payload))

    def __bool__(self) -> bool:
        return bool(self._heap)

    def pop(self) -> Tuple[float, int, Any]:
        when, kind, _, payload = heapq.heappop(self._heap)
        if self.sanitizer is not None:
            self.sanitizer.on_pop(self.now, when, kind)
        self.now = max(self.now, when)      # monotonic sim clock
        self.processed += 1
        if self.processed > self.max_events:
            raise RuntimeError(
                f"event loop exceeded {self.max_events} events at "
                f"t={self.now:.3f} — zero-progress livelock?")
        return self.now, kind, payload


class LaneSet:
    """Lane bookkeeping shared by the engine's replicas and the
    ``run_continuous`` harness: requests waiting for a lane, lanes
    reserved by in-flight loads, and the single decode-tick chain per
    batcher (with the zero-progress guard)."""

    def __init__(self, batcher: ContinuousBatcher):
        if batcher.n_slots < 1:
            raise ValueError("need at least one lane")
        self.batcher = batcher
        self.waiting: collections.deque = collections.deque()
        self.reserved: set = set()
        self._tick_scheduled = False
        # unified compute (chunked-prefill mode): when set, decode ticks
        # book their service time on this channel — the same one prefill
        # chunks book — so decode and prefill contend for one accelerator
        # instead of running on independent streams. None = legacy
        # dedicated-prefill-stream semantics (bit-identical timing).
        self.compute_chan = None
        self.compute_stats: Optional[Dict[str, float]] = None
        # Sarathi-style per-tick prefill token budget (unified-compute
        # mode only): > 0 holds ready prefill chunks in a priority queue
        # and releases at most ``token_budget`` prefill tokens per
        # decode tick, fused ahead of the decode step — so a prefill
        # storm delays each decode tick by at most the budgeted chunk
        # time instead of the whole backlog. 0 = legacy FIFO interleave
        # (chunks book the channel the moment they are ready).
        self.token_budget = 0
        # heap of (priority, n_new_tokens, t_enqueue, fire) — priority
        # is supplied by the caller (tenant tier, deadline, seq) and
        # fire(now) performs the actual channel booking + event push
        self.chunk_queue: List[Tuple[Any, int, float, Callable]] = []

    def submit_chunk(self, priority, n_new: int, fire: Callable,
                     now: float, loop: Optional[EventLoop] = None) -> None:
        """Budgeted-mode chunk admission: chunks queue in priority order
        and the tick chain drains them within the token budget — armed
        on demand, so even with no decode running the backlog releases
        at paced chunk boundaries instead of dumping onto the channel (a
        lane admitted mid-storm then waits at most ~one budget of chunk
        time, never the whole backlog). Budget off books immediately
        (legacy FIFO interleave)."""
        if self.token_budget <= 0 or loop is None:
            fire(now)
            return
        heapq.heappush(self.chunk_queue, (priority, n_new, now, fire))
        if self.compute_stats is not None:
            self.compute_stats["chunks_deferred"] += 1
        self.ensure_tick(loop, now)

    def _drain_chunks(self, now: float,
                      budget: Optional[int]) -> Optional[float]:
        """Fire queued chunks in priority order; ``budget`` caps the
        released prefill tokens (None = unbounded drain). Returns the
        latest completion time ``fire`` reported, so an idle chain can
        re-arm at the released chunks' boundary."""
        t_last: Optional[float] = None
        while self.chunk_queue:
            if budget is not None and self.chunk_queue[0][1] > budget:
                break
            _, n_new, t_enq, fire = heapq.heappop(self.chunk_queue)
            if budget is not None:
                budget -= n_new
            if self.compute_stats is not None:
                self.compute_stats["defer_wait_s"] += now - t_enq
            end = fire(now)
            if end is not None:
                t_last = end if t_last is None else max(t_last, end)
        return t_last

    def free_lanes(self) -> List[int]:
        return [i for i in self.batcher.free_lanes()
                if i not in self.reserved]

    def occupancy(self) -> int:
        return (len(self.waiting) + len(self.reserved)
                + sum(s.active for s in self.batcher.slots))

    def admit(self, lane: int, req: Request, kv: KVData, orig_len: int,
              now: float, kv_frac: float = 1.0) -> None:
        trace.set_request(req.req_id)
        self.reserved.discard(lane)
        self.batcher.admit(lane, req, kv, orig_len, now, kv_frac=kv_frac)

    def issue(self, now: float,
              dispatch: Callable[[int, Request, float], None]) -> None:
        """Reserve free lanes for waiting requests in FIFO order;
        ``dispatch(lane, req, now)`` books the load/prefill and schedules
        the completion event that will ``admit`` into the lane."""
        free = self.free_lanes()
        while free and self.waiting:
            lane, req = free.pop(0), self.waiting.popleft()
            self.reserved.add(lane)
            dispatch(lane, req, now)

    def ensure_tick(self, loop: EventLoop, now: float) -> None:
        if not self._tick_scheduled:
            self._tick_scheduled = True
            loop.push(now, EV_TICK, self)

    def tick(self, loop: EventLoop, now: float
             ) -> Optional[List[ScheduledResult]]:
        """Run one guarded decode tick and chain the next one. Returns
        the finished results, or None when all lanes are idle (the chain
        stops until the next admission re-arms it)."""
        if not any(s.active for s in self.batcher.slots):
            # no decode to protect, but the queue must still make
            # progress or the jobs waiting on chunk completions would
            # deadlock: release one budget's worth and re-arm the chain
            # at the released chunks' boundary, keeping the channel
            # backlog at most one budget deep for any lane admitted
            # mid-drain
            if self.token_budget > 0 and self.chunk_queue:
                t_next = self._drain_chunks(now, self.token_budget)
                if self.chunk_queue and t_next is not None \
                        and t_next > now:
                    loop.push(t_next, EV_TICK, self)
                    return None
            # chunks are clamped to the budget so the paced drain always
            # progresses; an un-paceable leftover (fire with no
            # completion time) falls back to the unbounded dump
            self._drain_chunks(now, None)
            self._tick_scheduled = False
            return None
        if self.compute_chan is not None:
            # budgeted mode: release up to token_budget queued prefill
            # tokens FIRST — they book the channel at ``now``, so the
            # decode step lands right behind exactly the budgeted chunk
            # time (the Sarathi fused step), never the whole backlog
            if self.token_budget > 0:
                self._drain_chunks(now, self.token_budget)
            # unified compute: reserve the decode step on the shared
            # channel first — a prefill chunk already holding it pushes
            # the step (and every result it stamps) past the chunk
            dt = self.batcher.next_dt()
            if dt is None or dt <= 0.0:
                raise RuntimeError("decode tick made no time progress")
            start, end = self.compute_chan.book(now, dt)
            if self.compute_stats is not None and start > now:
                self.compute_stats["ticks_delayed"] += 1
                self.compute_stats["tick_delay_s"] += start - now
                self.compute_stats["tick_delay_max_s"] = max(
                    self.compute_stats.get("tick_delay_max_s", 0.0),
                    start - now)
            done, _ = self.batcher.tick(start)
            loop.push(end, EV_TICK, self)
            return done
        done, dt = self.batcher.tick(now)
        if dt <= 0.0:
            raise RuntimeError("decode tick made no time progress")
        loop.push(now + dt, EV_TICK, self)
        return done


def run_continuous(batcher: ContinuousBatcher, requests: Sequence[Request],
                   load_fn: Callable[[Request, float], Tuple[KVData, int,
                                                             float]],
                   ) -> List[ScheduledResult]:
    """Single-batcher event harness: loads overlap decode.

    load_fn(req, now) -> (kv entry for the context, original token length,
    load/prefill delay seconds) — the AdaptCache lookup/prefill path. The
    load is *issued* when a lane frees up and completes ``load_s`` later;
    decode ticks keep running for already-admitted lanes in the meantime
    (the seed version advanced the global clock by ``load_s``, stalling
    every active lane behind each fetch, and could livelock when idle
    with a past arrival).
    """
    loop = EventLoop()
    lanes = LaneSet(batcher)
    results: List[ScheduledResult] = []
    for req in requests:
        # a workload may stamp arrivals before the clock start; they
        # land immediately (push rejects past-time scheduling outright)
        loop.push(max(loop.now, req.arrival_s), EV_ARRIVAL, req)

    def dispatch(lane: int, req: Request, now: float) -> None:
        kv, orig_len, load_s = load_fn(req, now)
        loop.push(now + load_s, EV_LOAD_DONE, (lane, req, kv, orig_len))

    while loop:
        now, kind, payload = loop.pop()
        if kind == EV_ARRIVAL:
            lanes.waiting.append(payload)
            lanes.issue(now, dispatch)
        elif kind == EV_LOAD_DONE:
            lane, req, kv, orig_len = payload
            lanes.admit(lane, req, kv, orig_len, now)
            lanes.ensure_tick(loop, now)
        elif kind == EV_TICK:
            done = lanes.tick(loop, now)
            if done is not None:
                results.extend(done)
                lanes.issue(now, dispatch)  # freed lanes take new loads
    return results
