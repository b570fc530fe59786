"""Mean wall of a tier's ``get`` on the hit path (under
``AdaptCacheController.fetch``), in ms."""
from bench.metrics import mean, span_durs


def read(run):
    m = mean(span_durs(run, "storage.get", ancestor="controller.fetch"))
    return None if m is None else 1e3 * m
