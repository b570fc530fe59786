"""The port's tracer: spans and counters recorded where the serving path
does its work, off unless ``enable()`` is called.

Off, a span site costs one module-level flag check and returns the one
shared no-op context: nothing is recorded, no clock is read, nothing
reaches ``torch.profiler`` and the device is never synchronised. A
counter site is a flag check (``if trace.ON``) in front of the count.

On, a span is a ``Span``: name, start and end on ``time.perf_counter_ns``,
the index of its parent, the request it serves and a small dict of
attributes. Spans never synchronise the device, so a span around a
blocking host read times the wait itself. ``take()`` hands back every
span and counter recorded since ``enable()`` (or the last ``take``) and
clears them. One clock with the device trace:

* while a ``torch.profiler`` records, each span (``serve.request``
  aside, which is not a lexical scope) also opens
  ``torch.profiler.record_function(<its name>)``, so the chrome trace
  carries it on the kernels' timeline;
* ``enable()`` records one anchor pair ``(perf_counter_ns, time_ns)``;
  a chrome trace's ``ts`` is (CLOCK_REALTIME ns - its
  ``baseTimeNanoseconds``) / 1000, so ``Records.wall_ns`` places any
  span on that clock, inside a profiled stretch or not.

Request identity: the engine calls ``begin_request`` at dispatch, which
opens the request's ``serve.request`` span, and ``set_request`` at admit
and before each decode tick (with every request the tick serves). A span
opened with no span open above it takes the current request's
``serve.request`` as parent. No value of this module enters the engine's
simulated time.

Spans (name: where it sits; its attrs):

- ``serve.request``: a request's dispatch to its first answer token on
  the host (``RequestResult.wall_first_token_s``)
- ``serve.fetch``: ``AdaptCacheController.fetch``'s body; ``key``
- ``tier.get``: ``DRAMTier.get`` / ``SSDTier.get`` (the SSD's read,
  unframe and CRC); ``tier``, ``bytes``
- ``codec.decompress``: a compression method's ``decompress``;
  ``method``, ``bytes`` (as stored)
- ``policy.rescore``: the indexed selector's re-score of one entry
  (``entry_best_move``, its size estimates included); ``key``
- ``policy.admit``: the policy's placement of a new entry under
  ``insert``; ``key``
- ``lane.write``: ``write_kvdata``, an entry into a cache lane;
  ``lane``, ``bytes``
- ``model.prefill``: ``Model.prefill``; ``tokens``
- ``model.step``: the batcher's decode step (its ``Model.decode_step``
  call) and its one token read; ``lanes``, ``ctx`` (each lane's context
  length)
- ``moe.route``: ``moe_fwd``'s routing: router and top-k; outside a
  decode step (prefill, training) also the dispatch and the host read of
  the per-expert counts
- ``moe.host_read``: that read (``per_expert.tolist()``); a decode step
  has none
- ``mamba.step``: one Mamba layer's decode step in ``mamba_fwd`` (its
  projections and the update of its conv window and state)

A decode step replayed from its CUDA graph (``models/decode_graph.py``)
runs no Python below ``Model.decode_step``, so it records no
``moe.route`` or ``mamba.step`` span.

Counters, kept in total and per request:

- ``h2d_bytes``: bytes copied host to device: the lane copy
  (``write_kvdata``) and KIVI's uploads (``_on_device``); a tick's
  per-lane token, slot and position indices (20 bytes a lane) are left
  out
- ``d2h_bytes``: bytes copied device to host: KIVI's results,
  ``cache_to_kvdata``'s entry, a tick's tokens, a prefill's MoE counts
- ``state_h2d_bytes``: the Mamba layers' ``ssm`` and ``conv`` bytes of
  the lane copy, a part of ``h2d_bytes``
- ``host_reads``: blocking device-to-host reads of the serving path:
  one a tick (its argmax), and in a prefill one a MoE layer (its counts)
- ``moe.routed_slots``, ``moe.held_slots``: the (token, expert) slots a
  MoE layer kept, and those of them that went to experts this chip holds
  (``MoEConfig.n_held_experts``): in a prefill from the counts of its
  read; in a decode step, which keeps all T·k slots and reads nothing,
  counted on the host, held slots only where the chip holds every expert
  (they are then all of them)
- ``decode.graph_captures``, ``decode.graph_replays``,
  ``decode.eager_steps``: decode steps captured into a CUDA graph,
  replayed from one, and run eagerly (``Model.decode_step``)
- ``policy.estimates``: the policy's ``estimate_nbytes`` calls

Bytes count what the code copies toward or from the model's device,
whatever that device is (on the CPU the copies are no-ops)."""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch

#: the one flag every site checks; set by ``enable`` and ``disable``
ON = False

#: the program's span names (``serve.request`` aside): each is also a
#: ``record_function`` while a profiler records
SPANS = ("serve.fetch", "tier.get", "codec.decompress", "policy.rescore",
         "policy.admit", "lane.write", "model.prefill", "model.step",
         "moe.route", "moe.host_read", "mamba.step")

Req = Union[int, Tuple[int, ...], None]


@dataclasses.dataclass
class Span:
    name: str
    t0_ns: int
    t1_ns: int
    parent: Optional[int]
    req: Req
    attrs: Dict[str, Any]

    @property
    def dur_s(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e9


@dataclasses.dataclass
class Records:
    """What ``take`` hands back. ``by_request`` is keyed by request id (a
    tuple of ids for a tick that served several)."""
    spans: List[Span]
    counters: Dict[str, int]
    by_request: Dict[Req, Dict[str, int]]
    anchor_ns: Tuple[int, int]       # (perf_counter_ns, time_ns) at enable

    def wall_ns(self, t_ns: int) -> int:
        """A ``perf_counter_ns`` reading as CLOCK_REALTIME ns."""
        return self.anchor_ns[1] + (t_ns - self.anchor_ns[0])

    def chrome_trace(self, base_ns: int = 0) -> Dict[str, Any]:
        """The spans as chrome-trace events on a profiler trace's clock:
        pass its ``baseTimeNanoseconds`` to lay them beside it."""
        events = [{"ph": "X", "cat": "program", "name": s.name,
                   "pid": "repro_torch", "tid": f"req {s.req}",
                   "ts": (self.wall_ns(s.t0_ns) - base_ns) / 1e3,
                   "dur": (s.t1_ns - s.t0_ns) / 1e3,
                   "args": dict(s.attrs, req=s.req, parent=s.parent)}
                  for s in self.spans]
        return {"traceEvents": events, "baseTimeNanoseconds": base_ns,
                "counters": self.counters}


class _Null:
    """The shared context of every span site while tracing is off."""
    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


NULL = _Null()


class _Tracer:
    def __init__(self, anchor_ns: Tuple[int, int]):
        self.spans: List[Span] = []
        self.stack: List[int] = []
        self.req: Req = None
        self.open_req: Dict[int, int] = {}     # request id -> span index
        self.counters: Dict[str, int] = {}
        self.by_request: Dict[Req, Dict[str, int]] = {}
        self.anchor_ns = anchor_ns

    def top_parent(self) -> Optional[int]:
        if self.stack:
            return self.stack[-1]
        return self.open_req.get(self.req) if isinstance(self.req, int) \
            else None


_T = _Tracer((0, 0))


class _Open:
    __slots__ = ("tr", "span", "idx", "rf")

    def __init__(self, tr: _Tracer, name: str):
        self.tr = tr
        self.span = Span(name, 0, 0, tr.top_parent(), tr.req, {})
        self.rf = None

    def __enter__(self) -> Span:
        tr = self.tr
        if torch._C._autograd._profiler_enabled():
            self.rf = torch.profiler.record_function(self.span.name)
            self.rf.__enter__()
        self.idx = len(tr.spans)
        tr.spans.append(self.span)
        tr.stack.append(self.idx)
        self.span.t0_ns = time.perf_counter_ns()  # simcheck: ignore[wallclock]
        return self.span

    def __exit__(self, *exc) -> bool:
        self.span.t1_ns = time.perf_counter_ns()  # simcheck: ignore[wallclock]
        stack = self.tr.stack
        if stack and stack[-1] == self.idx:
            stack.pop()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def span(name: str):
    """``with trace.span(name) as sp:`` times the block; ``sp`` is the
    ``Span`` (set ``sp.attrs`` under ``if sp:``) or None when off."""
    if not ON:
        return NULL
    return _Open(_T, name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name``, in total and for the current
    request. Call it under ``if trace.ON:`` where ``n`` costs work."""
    if not ON:
        return
    t = _T
    t.counters[name] = t.counters.get(name, 0) + n
    if t.req is not None:
        mine = t.by_request.setdefault(t.req, {})
        mine[name] = mine.get(name, 0) + n


@contextlib.contextmanager
def paused():
    """Tracing off inside (a decode graph's warm-up and capture, whose
    steps serve no request), back as it was after."""
    global ON
    was, ON = ON, False
    try:
        yield
    finally:
        ON = was


def set_request(req: Union[int, Sequence[int], None]) -> None:
    """The request(s) the next spans and counts serve: one id, the ids a
    batched tick serves, or None."""
    if not ON:
        return
    if isinstance(req, (list, tuple)):
        req = int(req[0]) if len(req) == 1 else tuple(int(r) for r in req)
    _T.req = req


def begin_request(req_id: int) -> None:
    """Open request ``req_id``'s ``serve.request`` span and make it the
    current request (the engine's dispatch)."""
    if not ON:
        return
    t = _T
    t.req = int(req_id)
    t.open_req[t.req] = len(t.spans)
    t.spans.append(Span("serve.request",
                        time.perf_counter_ns(),  # simcheck: ignore[wallclock]
                        0, None, t.req, {}))


def end_request(req_id: int) -> Optional[float]:
    """Close request ``req_id``'s ``serve.request`` span (its first answer
    token is on the host); returns its seconds, None when off or when
    the request has no open span."""
    if not ON:
        return None
    idx = _T.open_req.pop(int(req_id), None)
    if idx is None:
        return None
    s = _T.spans[idx]
    s.t1_ns = time.perf_counter_ns()  # simcheck: ignore[wallclock]
    return s.dur_s


def enable() -> None:
    """Start recording into a fresh store, anchored to the wall clock."""
    global ON, _T
    _T = _Tracer((time.perf_counter_ns(),  # simcheck: ignore[wallclock]
                  time.time_ns()))  # simcheck: ignore[wallclock]
    ON = True


def disable() -> None:
    global ON
    ON = False


def take() -> Records:
    """Every span and counter recorded since ``enable`` or the last
    ``take``; clears them (tracing stays as it was). A request span still
    open is handed back with ``t1_ns`` 0."""
    global _T
    t = _T
    _T = _Tracer(t.anchor_ns)
    return Records(t.spans, t.counters, t.by_request, t.anchor_ns)
