"""Share of requests served from a DRAM tier (``RequestResult.hit_tier``)."""


def read(run):
    recs = run.records
    if not recs:
        return None
    return sum(1 for r in recs if (r["hit_tier"] or "").startswith("dram")) \
        / len(recs)
