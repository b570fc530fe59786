"""The one traffic generator: documents, questions and an open-loop
arrival schedule from a mix file (``traffic/<mix>.json``) and a seed.

The per-task document generators are frozen copies of the port's
``serving/workload.py`` (``_qa_context``, ``_summary_context``,
``_coding_context``), kept here so that a change to the program cannot
move the traffic. One departure: a summarization question is two tokens
(the port's is one), so that every request takes the same two decode
steps and a cell's TTFT is one group, not two.

Every seed gets the same work in another order: the document lengths are
the mix's list, the request count is ``round(rate * seconds)``, the gaps
between due times are the exponential distribution's quantiles at
(i + 1/2) / n shuffled by the seed and scaled to fill the window, and the
number of requests a document of popularity rank r gets is its share of
Zipf(a) taken modulo the number of documents (as ``poisson_requests``
draws it), rounded by largest remainder. The seed draws the tokens, the
order of gaps and requests, and each request's question.

Mix keys:
  kind            "reuse": requests return to ``len(doc_lengths)``
                  documents
  doc_lengths     document lengths, one a popularity rank
  tasks           task families, cycled over the ranks
  probes_per_doc  questions a document carries
  zipf_a          popularity exponent
  max_new_tokens  answer tokens a request asks for
  dram_entries, ssd_entries
                  tier capacities in mean uncompressed entries
                  (``build_engine``'s unit)
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np


def _qa_context(rng, vocab: int, length: int, n_probes: int):
    sep = 5
    n_facts = length // 4
    keys = rng.randint(vocab // 4, vocab // 2, n_facts)
    vals = rng.randint(vocab // 2, vocab - 8, (n_facts, 2))
    toks = np.stack([np.full(n_facts, sep), keys, vals[:, 0], vals[:, 1]],
                    axis=1).reshape(-1)[:length]
    probes = []
    for _ in range(n_probes):
        i = rng.randint(n_facts - 1)
        probes.append(np.array([6, keys[i]], dtype=np.int32))
    return toks.astype(np.int32), probes


def _summary_context(rng, vocab: int, length: int, n_probes: int):
    motif = rng.randint(8, vocab // 2, rng.randint(8, 16))
    reps = length // len(motif) + 1
    noise = rng.randint(8, vocab - 8, length)
    toks = np.tile(motif, reps)[:length]
    mask = rng.rand(length) < 0.15
    toks = np.where(mask, noise, toks)
    # two tokens, as every other task's question has: the task's marker
    # and the motif's first token, drawn already (no new draw, so the
    # documents are those of a one-token question)
    probes = [np.array([7, motif[0]], dtype=np.int32)
              for _ in range(n_probes)]
    return toks.astype(np.int32), probes


def _coding_context(rng, vocab: int, length: int, n_probes: int):
    toks, names = [], []
    while len(toks) < length:
        name = int(rng.randint(vocab // 4, vocab // 2))
        names.append(name)
        body = rng.randint(vocab // 2, vocab - 8, rng.randint(6, 12)).tolist()
        toks += [3, name] + body + [4, int(names[rng.randint(len(names))])]
    toks = np.array(toks[:length], dtype=np.int32)
    probes = [np.array([4, names[rng.randint(len(names))]], dtype=np.int32)
              for _ in range(n_probes)]
    return toks, probes


GEN = {"qa": _qa_context, "summarization": _summary_context,
       "coding": _coding_context}


@dataclasses.dataclass
class Traffic:
    contexts: list            # repro_torch Context, one a document
    requests: list            # repro_torch Request, in due order
    due_s: np.ndarray         # due time of each request, from the window start
    mix: Dict


def rng_for(seed: int, stream: int) -> np.random.RandomState:
    """A numpy RandomState for any whole-number seed (numpy's legacy
    seeding takes 32 bits) and a named sub-stream."""
    state = np.random.SeedSequence([seed % (1 << 64), stream]).generate_state(1)
    return np.random.RandomState(int(state[0]))


def zipf_mod_shares(a: float, n: int, terms: int = 1 << 20) -> np.ndarray:
    """P(zipf(a) % n == i) for i in [0, n): the rank index
    ``poisson_requests`` takes."""
    k = np.arange(1, terms + 1, dtype=np.float64)
    w = k ** -a
    return np.bincount((k.astype(np.int64)) % n, weights=w, minlength=n) / w.sum()


def largest_remainder(shares: np.ndarray, total: int) -> np.ndarray:
    raw = shares * total
    out = np.floor(raw).astype(np.int64)
    rest = total - int(out.sum())
    out[np.argsort(-(raw - out), kind="stable")[:rest]] += 1
    return out


def due_times(n: int, seconds: float, rng) -> np.ndarray:
    """n due times in [0, seconds): shuffled exponential quantile gaps,
    scaled so the n gaps sum to ``seconds``; the first is due at 0."""
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n)
    gaps = gaps[rng.permutation(n)]
    gaps *= seconds / gaps.sum()
    return np.concatenate([[0.0], np.cumsum(gaps)[:-1]])


def generate(mix: Dict, vocab: int, rate_hz: float, seconds: float,
             seed: int) -> Traffic:
    from repro_torch.serving.workload import Context, Request

    lengths, tasks = list(mix["doc_lengths"]), list(mix["tasks"])
    n_probes = int(mix["probes_per_doc"])
    n_req = max(1, int(round(rate_hz * seconds)))
    tok_rng, order_rng = rng_for(seed, 0), rng_for(seed, 1)
    due = due_times(n_req, seconds, order_rng)

    def doc(key: str, slot: int) -> Context:
        task = tasks[slot % len(tasks)]
        toks, probes = GEN[task](tok_rng, vocab, lengths[slot], n_probes)
        return Context(key, task, toks, probes)

    if mix["kind"] != "reuse":
        raise ValueError(f"unknown traffic kind {mix['kind']!r}")
    contexts = [doc(f"doc{r}", r) for r in range(len(lengths))]
    counts = largest_remainder(
        zipf_mod_shares(float(mix["zipf_a"]), len(lengths)), n_req)
    ranks = np.repeat(np.arange(len(lengths)), counts)
    picks = ranks[order_rng.permutation(n_req)]
    requests = []
    for i, ci in enumerate(picks):
        ctx = contexts[int(ci)]
        q = ctx.probes[int(order_rng.randint(len(ctx.probes)))]
        requests.append(Request(i, ctx.key, q, float(due[i]), ctx.task_type,
                                int(mix["max_new_tokens"])))
    return Traffic(contexts, requests, due, mix)


def max_prompt(mix: Dict) -> int:
    """The most tokens a lane holds: the longest document, its longest
    question (two tokens at most) and the answer."""
    return max(mix["doc_lengths"]) + 2 + int(mix["max_new_tokens"])
