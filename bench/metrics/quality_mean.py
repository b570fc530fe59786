"""Mean task score of each served answer against the uncompressed answer
to the same (document, question); a failed request scores 0."""


def read(run):
    q = [r["quality"] for r in run.records]
    if not q or any(v is None for v in q):
        return None
    return float(sum(q) / len(q))
