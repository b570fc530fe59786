from bench.metrics import percentile


def read(run):
    return percentile(run.ttfts(), 90)
