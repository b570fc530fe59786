"""The port's task metric (``serving/metrics.py`` ``quality_score``), a
frozen copy: unigram F1 for qa, ROUGE-L for summarization, the n-gram
core of CodeBLEU for coding, on pad-stripped token sequences."""
from __future__ import annotations

import collections
from typing import List, Sequence

PAD_ID = 0


def token_f1(pred: Sequence[int], ref: Sequence[int]) -> float:
    if not pred or not ref:
        return 1.0 if list(pred) == list(ref) else 0.0
    pc, rc = collections.Counter(pred), collections.Counter(ref)
    overlap = sum((pc & rc).values())
    if overlap == 0:
        return 0.0
    p, r = overlap / len(pred), overlap / len(ref)
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
    return collections.Counter(tuple(seq[i:i + n])
                               for i in range(len(seq) - n + 1))


def codebleu_proxy(pred: Sequence[int], ref: Sequence[int],
                   max_n: int = 4) -> float:
    if not pred or not ref:
        return 1.0 if list(pred) == list(ref) else 0.0
    scores = []
    for n in range(1, max_n + 1):
        pn, rn = _ngrams(pred, n), _ngrams(ref, n)
        if not rn or not pn:
            continue
        scores.append(sum((pn & rn).values()) / max(1, sum(pn.values())))
    return sum(scores) / len(scores) if scores else 0.0


METRIC_FOR_TASK = {"qa": token_f1, "summarization": rouge_l,
                   "coding": codebleu_proxy}


def _strip_pad(seq: Sequence[int]) -> List[int]:
    s = list(seq)
    while s and s[-1] == PAD_ID:
        s.pop()
    return s


def score(task_type: str, pred: Sequence[int], ref: Sequence[int]) -> float:
    return METRIC_FOR_TASK.get(task_type, token_f1)(_strip_pad(pred),
                                                    _strip_pad(ref))
