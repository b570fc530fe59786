"""Spans around the port's layers, recorded from the benchmark's own
wrappers, and the reduction of a ``torch.profiler`` trace.

A span is (name, start, end, attrs, parent) on the host's clock. In the
traced run each wrapped call is synchronised with the device before and
after, and runs inside ``torch.profiler.record_function(name)`` so the
profiler's timeline carries the same names."""
from __future__ import annotations

import dataclasses
import functools
import json
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch


@dataclasses.dataclass
class Span:
    name: str
    t0: float
    t1: float
    attrs: Dict[str, Any]
    parent: Optional[int]
    req: Optional[int]

    @property
    def dur(self) -> float:
        return self.t1 - self.t0


class Spans:
    def __init__(self, sync: bool):
        self.sync = sync and torch.cuda.is_available()
        self.spans: List[Span] = []
        self._stack: List[int] = []
        self.req: Optional[int] = None

    def wrap(self, obj, attr: str, name: str,
             attrs: Optional[Callable[..., Dict]] = None) -> None:
        """Replace ``obj.attr`` (an instance attribute is set, also on a
        frozen dataclass) by a timed call."""
        fn = getattr(obj, attr)

        @functools.wraps(fn)
        def timed(*args, **kwargs):
            if self.sync:
                torch.cuda.synchronize()
            idx = len(self.spans)
            parent = self._stack[-1] if self._stack else None
            span = Span(name, time.perf_counter(), 0.0, {}, parent, self.req)
            self.spans.append(span)
            self._stack.append(idx)
            try:
                with torch.profiler.record_function(name):
                    out = fn(*args, **kwargs)
                    if self.sync:
                        torch.cuda.synchronize()
            finally:
                self._stack.pop()
                span.t1 = time.perf_counter()
            if attrs is not None:
                span.attrs = attrs(out, *args, **kwargs)
            return out

        object.__setattr__(obj, attr, timed)


def merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def reduce_profile(path: str, span_names: List[str]) -> Dict[str, Any]:
    """Device busy time, the device's operations by total time and the
    longest idle gaps (each named by the innermost harness span open at
    its middle), over the window from the first to the last
    ``engine.process`` annotation of a chrome trace. Times in seconds."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    dev, ann = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            dev.append((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                        e.get("name", "?"), cat))
        elif cat == "user_annotation" and e.get("name") in span_names:
            ann.append((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                        e["name"]))
    proc = [a for a in ann if a[2] == "engine.process"]
    if not proc or not dev:
        return {}
    w0, w1 = min(a[0] for a in proc), max(a[1] for a in proc)
    inside = [(max(a, w0), min(b, w1), n, c) for a, b, n, c in dev
              if b > w0 and a < w1]
    busy = merge([(a, b) for a, b, _, _ in inside])
    busy_us = sum(b - a for a, b in busy)
    by_name: Dict[str, float] = {}
    for a, b, n, _ in inside:
        by_name[n] = by_name.get(n, 0.0) + (b - a)
    gaps = []
    edges = [(w0, w0)] + busy + [(w1, w1)]
    for (_, e0), (s1, _) in zip(edges, edges[1:]):
        if s1 > e0:
            mid = (e0 + s1) / 2
            open_ = [a for a in ann if a[0] <= mid <= a[1]]
            label = (min(open_, key=lambda a: a[1] - a[0])[2] if open_
                     else "waiting for a request")
            gaps.append((label, (s1 - e0) / 1e6))
    gaps.sort(key=lambda g: -g[1])
    return {"busy_s": busy_us / 1e6, "window_s": (w1 - w0) / 1e6,
            "device_ops": sorted(((n, t / 1e6) for n, t in by_name.items()),
                                 key=lambda x: -x[1]),
            "idle_gaps": gaps,
            "kernel_s": {n: t / 1e6 for n, t in by_name.items()},
            "t0_us": w0, "t1_us": w1,
            "annotations": [(a, b, n) for a, b, n in ann if b > w0 and a < w1]}
