"""Generation-quality metrics (paper footnote 1: similarity between the
generated answer after compression and the original prefill answer),
plus the latency-distribution helper shared by serving summaries.

token_f1   — unigram F1 (the QA metric family)
rouge_l    — LCS-based F-measure (summarization)
codebleu_proxy — weighted n-gram overlap (coding; full CodeBLEU needs ASTs,
                 we use its n-gram core as the proxy at token level)
percentile_summary — mean/p50/p90/p99 of a latency sample under stable
                 key names ("<prefix>_mean_s", ...)
safe_mean  — mean of a possibly-empty sample (0.0 when empty); used for
                 the write-back queue/transfer and prefetch breakdowns
"""
from __future__ import annotations

import collections
from typing import Dict, List, Sequence

import numpy as np


def percentile_summary(prefix: str, values: Sequence[float]
                       ) -> Dict[str, float]:
    arr = np.asarray(list(values), dtype=np.float64)
    if arr.size == 0:
        # schema-stable empty sample: CSV writers key columns off the
        # first row, so dropping p50/p90/p99 here would silently shift
        # every later row's fields
        return {f"{prefix}_mean_s": 0.0, f"{prefix}_p50_s": 0.0,
                f"{prefix}_p90_s": 0.0, f"{prefix}_p99_s": 0.0}
    return {
        f"{prefix}_mean_s": float(arr.mean()),
        f"{prefix}_p50_s": float(np.percentile(arr, 50)),
        f"{prefix}_p90_s": float(np.percentile(arr, 90)),
        f"{prefix}_p99_s": float(np.percentile(arr, 99)),
    }


def safe_mean(values: Sequence[float]) -> float:
    vals = list(values)
    return float(np.mean(vals)) if vals else 0.0


def token_f1(pred: Sequence[int], ref: Sequence[int]) -> float:
    if not pred or not ref:
        return 1.0 if list(pred) == list(ref) else 0.0
    pc, rc = collections.Counter(pred), collections.Counter(ref)
    overlap = sum((pc & rc).values())
    if overlap == 0:
        return 0.0
    p = overlap / len(pred)
    r = overlap / len(ref)
    return 2 * p * r / (p + r)


def _lcs_len(a: Sequence[int], b: Sequence[int]) -> int:
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0]
        for j, y in enumerate(b, 1):
            cur.append(prev[j - 1] + 1 if x == y else max(prev[j], cur[-1]))
        prev = cur
    return prev[-1]


def rouge_l(pred: Sequence[int], ref: Sequence[int]) -> float:
    if not pred or not ref:
        return 1.0 if list(pred) == list(ref) else 0.0
    lcs = _lcs_len(list(pred), list(ref))
    if lcs == 0:
        return 0.0
    p, r = lcs / len(pred), lcs / len(ref)
    return 2 * p * r / (p + r)


def _ngrams(seq: Sequence[int], n: int):
    return collections.Counter(tuple(seq[i:i + n]) for i in range(len(seq) - n + 1))


def codebleu_proxy(pred: Sequence[int], ref: Sequence[int],
                   max_n: int = 4) -> float:
    if not pred or not ref:
        return 1.0 if list(pred) == list(ref) else 0.0
    scores = []
    for n in range(1, max_n + 1):
        pn, rn = _ngrams(pred, n), _ngrams(ref, n)
        if not rn or not pn:
            continue
        overlap = sum((pn & rn).values())
        scores.append(overlap / max(1, sum(pn.values())))
    return sum(scores) / len(scores) if scores else 0.0


METRIC_FOR_TASK = {"qa": token_f1, "summarization": rouge_l,
                   "coding": codebleu_proxy}

PAD_ID = 0


def _strip_pad(seq: Sequence[int]) -> List[int]:
    s = list(seq)
    while s and s[-1] == PAD_ID:
        s.pop()
    return s


def quality_score(task_type: str, pred: Sequence[int],
                  ref: Sequence[int]) -> float:
    """Task metric on pad-stripped sequences: generations end in PAD runs
    (the recall format), which would otherwise inflate every overlap
    metric toward 1."""
    return METRIC_FOR_TASK.get(task_type, token_f1)(_strip_pad(pred),
                                                    _strip_pad(ref))
