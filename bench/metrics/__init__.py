"""One reader a metric, found by the metric's name: ``<name>.py`` holds
``read(run) -> float | None``. ``run`` is ``bench.run.Run``. A reader
that finds nothing to read returns None and the metric is left out of
the line."""
from __future__ import annotations

import importlib.util
from pathlib import Path
from typing import Callable, List, Optional

import numpy as np


def load(directory: Path, name: str) -> Callable:
    path = Path(directory) / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def percentile(values: List[float], q: float) -> float:
    """The q-th percentile (0..100) by linear interpolation between the
    two nearest ranks (numpy's default)."""
    v = sorted(values)
    if not v:
        raise ValueError("no samples")
    pos = (len(v) - 1) * q / 100.0
    lo = int(np.floor(pos))
    hi = min(lo + 1, len(v) - 1)
    if pos == lo:
        return v[lo]
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def mean(values) -> Optional[float]:
    values = list(values)
    return float(sum(values) / len(values)) if values else None


def span_durs(run, name: str, parent: Optional[str] = None,
              ancestor: Optional[str] = None) -> List[float]:
    """Durations (s) of the spans called ``name`` of the requests whose
    spans count (those outside the profiled stretch), optionally only
    those directly under a ``parent`` span or anywhere under an
    ``ancestor``."""
    spans = run.spans
    out = []
    for s in spans:
        if s.name != name or s.req not in run.span_reqs:
            continue
        if parent is not None and (s.parent is None
                                   or spans[s.parent].name != parent):
            continue
        if ancestor is not None:
            p = s.parent
            while p is not None and spans[p].name != ancestor:
                p = spans[p].parent
            if p is None:
                continue
        out.append(s.dur)
    return out
