"""Mean wall of a compression method's ``decompress`` on the hit path,
host round trip included, in ms."""
from bench.metrics import mean, span_durs


def read(run):
    m = mean(span_durs(run, "compression.decompress",
                       ancestor="controller.fetch"))
    return None if m is None else 1e3 * m
