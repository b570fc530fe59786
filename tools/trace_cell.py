"""One traced run of a benchmark cell with the port's own tracer on.

    python3 tools/trace_cell.py --workload <cell> --seed <n> --seconds <s> \
        [--program 0|1]

Runs ``bench/run.py --trace 1`` unchanged, except that the window runs
with ``repro_torch.runtime.trace`` enabled (``--program 1``, the
default) and the profile's idle gaps are named by the program's spans as
well as the benchmark's wrappers. After the benchmark's own lines it
prints one more, ``program {...}``, read from the program's spans and
counters of the requests outside the profiled stretch, as the
benchmark's readers count them:

- ``fetch_rescore_ms``: ``policy.rescore`` under ``serve.fetch``, a
  request
- ``lane_write_ms``: ``lane.write``, a request
- ``moe_host_read_ms``: ``moe.host_read`` within a ``model.step``, a step
  (0 since a decode step's MoE reads nothing to the host)
- ``h2d_mb``: ``h2d_bytes`` / 1e6, a request
- ``fetch_covered``: the share of ``serve.fetch``'s wall its children
  cover
- ``spans_ms``: each span name's mean wall; ``counters``: the window's
  totals; ``wall_first_token_p50_s``: ``serve.request``'s median

``--program 0`` runs the same traced benchmark with the program's tracer
off, for its cost (the ``stats`` line's ``service_mean_s``).
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parents[1]
for _p in (ROOT / "src", ROOT):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

from repro_torch.runtime import trace  # noqa: E402

def _mean(xs: List[float]) -> Optional[float]:
    return sum(xs) / len(xs) if xs else None


def _ms(x: Optional[float]) -> Optional[float]:
    return None if x is None else 1e3 * x


def summarize(records: trace.Records, reqs: set) -> Dict:
    """The program's numbers over the requests in ``reqs``."""
    spans = records.spans

    def under(i: int, name: str) -> bool:
        p = spans[i].parent
        while p is not None:
            if spans[p].name == name:
                return True
            p = spans[p].parent
        return False

    per_req: Dict[int, Dict[str, float]] = {r: {} for r in reqs}
    steps: Dict[int, float] = {}
    fetch_wall = fetch_kids = 0.0
    by_name: Dict[str, List[float]] = {}
    for i, s in enumerate(spans):
        if s.t1_ns == 0:
            continue
        mine = s.req in reqs if isinstance(s.req, int) \
            else isinstance(s.req, tuple) and set(s.req) <= reqs
        if not mine:
            continue
        by_name.setdefault(s.name, []).append(s.dur_s)
        acc = per_req[s.req] if isinstance(s.req, int) else None
        if s.name == "policy.rescore" and acc is not None \
                and under(i, "serve.fetch"):
            acc["rescore"] = acc.get("rescore", 0.0) + s.dur_s
        elif s.name == "lane.write" and acc is not None:
            acc["lane"] = acc.get("lane", 0.0) + s.dur_s
        elif s.name == "model.step":
            steps.setdefault(i, 0.0)
        elif s.name == "moe.host_read":
            p = s.parent
            while p is not None and spans[p].name != "model.step":
                p = spans[p].parent
            if p is not None:
                steps[p] = steps.get(p, 0.0) + s.dur_s
        elif s.name == "serve.fetch":
            fetch_wall += s.dur_s
        if s.parent is not None and spans[s.parent].name == "serve.fetch":
            fetch_kids += s.dur_s
    served = sorted(reqs)
    first = [s.dur_s for s in spans if s.name == "serve.request"
             and s.req in reqs and s.t1_ns]
    return {
        "fetch_rescore_ms": _ms(_mean([per_req[r].get("rescore", 0.0)
                                      for r in served])),
        "lane_write_ms": _ms(_mean([per_req[r].get("lane", 0.0)
                                    for r in served])),
        "moe_host_read_ms": _ms(_mean(list(steps.values()))),
        "h2d_mb": _mean([records.by_request.get(r, {}).get("h2d_bytes", 0)
                         / 1e6 for r in served]),
        "fetch_covered": fetch_kids / fetch_wall if fetch_wall else None,
        "wall_first_token_p50_s": statistics.median(first) if first
        else None,
        "spans_ms": {n: _ms(_mean(v)) for n, v in sorted(by_name.items())},
        "counters": records.counters,
        "requests": len(served),
    }


def main(argv=None, **run_kwargs) -> int:
    """``run_kwargs`` go to ``bench.run.main`` (the CPU tests pass a
    device and a smoke spec)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--program", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    from bench import run

    box: Dict = {}
    serve, names = run.serve, run.SPAN_NAMES

    def traced_serve(rig, tracing, setup_s, cell):
        if args.program:
            trace.enable()
        try:
            box["run"] = serve(rig, tracing, setup_s, cell)
        finally:
            box["records"] = trace.take()
            trace.disable()
        return box["run"]

    run.serve, run.SPAN_NAMES = traced_serve, names + list(trace.SPANS)
    try:
        rc = run.main(["--workload", args.workload, "--seed", str(args.seed),
                       "--seconds", str(args.seconds), "--trace", "1"],
                      **run_kwargs)
    finally:
        run.serve, run.SPAN_NAMES = serve, names
    if rc == 0 and args.program:
        out = summarize(box["records"], box["run"].span_reqs)
        print("program " + json.dumps(out), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
