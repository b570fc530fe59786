"""Fault-tolerance runtime: heartbeats, straggler detection, elastic plans.

A copy of ``repro.runtime.fault_tolerance`` (standard library only).

Control-plane machinery designed for a 1000+-node deployment and exercised
here with simulated clocks (tests) and by the train/serve drivers:

  * HeartbeatMonitor — workers check in; silence past a deadline marks the
    worker dead and triggers the registered callback (training: restore
    from the last checkpoint onto the surviving mesh; serving: re-dispatch
    the worker's in-flight requests).
  * StragglerDetector — rolling median step-time; a worker slower than
    ``threshold x median`` over a window is flagged (mitigation: shrink its
    data shard / drop from the mesh at the next elastic boundary).
  * elastic_plan — given surviving device count, pick the largest
    (data, model) mesh not exceeding it while preserving the model axis
    (TP degree is fixed by memory), for checkpoint-resharded restart.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, Deque, Dict, List, Optional, Tuple


@dataclasses.dataclass
class WorkerState:
    last_beat: float
    alive: bool = True
    step_times: Deque[float] = dataclasses.field(
        default_factory=lambda: collections.deque(maxlen=32))


class HeartbeatMonitor:
    def __init__(self, deadline_s: float = 60.0,
                 on_death: Optional[Callable[[str], None]] = None,
                 clock: Callable[[], float] = time.monotonic,  # simcheck: ignore[wallclock]
                 ):
        self.deadline = deadline_s
        self.on_death = on_death
        self.clock = clock
        self.workers: Dict[str, WorkerState] = {}

    def register(self, worker_id: str) -> None:
        self.workers[worker_id] = WorkerState(self.clock())

    def beat(self, worker_id: str) -> None:
        w = self.workers.setdefault(worker_id, WorkerState(self.clock()))
        w.last_beat = self.clock()
        if not w.alive:
            w.alive = True          # rejoin after transient outage

    def sweep(self) -> List[str]:
        """Mark silent workers dead; returns newly-dead ids."""
        now = self.clock()
        dead = []
        for wid, w in self.workers.items():
            if w.alive and now - w.last_beat > self.deadline:
                w.alive = False
                dead.append(wid)
                if self.on_death:
                    self.on_death(wid)
        return dead

    def alive_workers(self) -> List[str]:
        return [w for w, s in self.workers.items() if s.alive]


class StragglerDetector:
    def __init__(self, threshold: float = 2.0, min_samples: int = 8):
        self.threshold = threshold
        self.min_samples = min_samples
        self.times: Dict[str, Deque[float]] = collections.defaultdict(
            lambda: collections.deque(maxlen=32))

    def record(self, worker_id: str, step_time_s: float) -> None:
        self.times[worker_id].append(step_time_s)

    def stragglers(self) -> List[str]:
        medians = {}
        for wid, ts in self.times.items():
            if len(ts) >= self.min_samples:
                s = sorted(ts)
                medians[wid] = s[len(s) // 2]
        if len(medians) < 2:
            return []
        # lower median: with few workers the upper median IS the straggler
        global_med = sorted(medians.values())[(len(medians) - 1) // 2]
        return [wid for wid, m in medians.items()
                if m > self.threshold * global_med]


def elastic_plan(n_devices: int, model_parallel: int,
                 pods: int = 1) -> Tuple[int, ...]:
    """Largest (pods, data, model) mesh fitting the surviving devices.

    TP degree is preserved (weight shards must fit HBM); the data axis
    absorbs the loss. Raises if fewer than one model group survives."""
    per_pod = n_devices // max(pods, 1)
    data = per_pod // model_parallel
    if data < 1:
        raise ValueError(
            f"cannot keep model_parallel={model_parallel} with "
            f"{n_devices} devices")
    if pods > 1:
        return (pods, data, model_parallel)
    return (data, model_parallel)


@dataclasses.dataclass
class RecoveryLog:
    """Structured record of failures/recoveries for post-mortems (tests
    assert on it; a deployment would ship it to the cluster logger)."""
    events: List[Dict] = dataclasses.field(default_factory=list)

    def record(self, kind: str, **info) -> None:
        self.events.append({"kind": kind, "t": time.time(),  # simcheck: ignore[wallclock]
                            **info})
