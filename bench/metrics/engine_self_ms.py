"""Wall of each ``ServingEngine.process`` call minus the part its child
spans cover, mean a request, in ms."""
from bench.tracing import merge


def read(run):
    spans = run.spans
    vals = []
    for i, s in enumerate(spans):
        if s.name != "engine.process" or s.req not in run.span_reqs:
            continue
        kids = merge([(c.t0, c.t1) for c in spans if c.parent == i])
        vals.append(s.dur - sum(b - a for a, b in kids))
    return 1e3 * sum(vals) / len(vals) if vals else None
