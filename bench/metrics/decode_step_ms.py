"""Mean wall of ``Model.decode_step``, in ms."""
from bench.metrics import mean, span_durs


def read(run):
    m = mean(span_durs(run, "model.decode_step"))
    return None if m is None else 1e3 * m
