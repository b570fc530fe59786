"""Deterministic, shardable synthetic data pipeline.

A copy of ``repro.training.data`` (numpy only): the same seed gives the
same batches, bit for bit.

Two streams:
  * lm_stream      — generic structured token stream (markov-ish motifs) for
                     throughput-oriented training;
  * recall_stream  — the serving workload's context+probe format packed as
                     (context, question, answer) documents, so a trained
                     model learns to COPY from its context — exactly the
                     capability lossy KV compression degrades, making the
                     quality axis of the paper measurable in-repo.

Sharding contract: ``Pipeline(host_id, n_hosts)`` draws disjoint per-host
streams (seed-offset), and ``state()/restore()`` expose the RNG cursor so a
restarted job resumes mid-epoch bit-exactly (checkpoint.py stores it).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from repro_torch.serving import workload


@dataclasses.dataclass
class PipelineConfig:
    vocab_size: int
    seq_len: int
    batch_per_host: int
    kind: str = "recall"            # "recall" | "lm"
    seed: int = 0


class Pipeline:
    def __init__(self, cfg: PipelineConfig, host_id: int = 0,
                 n_hosts: int = 1):
        self.cfg = cfg
        self.host_id = host_id
        self.n_hosts = n_hosts
        self._rng = np.random.RandomState(cfg.seed * 9973 + host_id)
        self._count = 0

    # -- checkpointable cursor -------------------------------------------------
    def state(self) -> Dict:
        return {"count": self._count, "rng": self._rng.get_state()}

    def restore(self, state: Dict) -> None:
        self._count = state["count"]
        self._rng.set_state(state["rng"])

    # -- batch generation --------------------------------------------------------
    N_PROBES = 6   # retrieval probes per doc: dense supervision signal

    def _doc_recall(self) -> np.ndarray:
        c = self.cfg
        ctx_len = int(self._rng.randint(c.seq_len // 2,
                                        c.seq_len - 4 * self.N_PROBES - 4))
        toks, _ = workload._qa_context(self._rng, c.vocab_size, ctx_len, 0)
        # append probes: [6, key, val0, val1] for random facts — multiple
        # probes per doc densify the retrieval gradient (one probe gives
        # only ~2 supervised tokens per 160-token doc and the induction
        # circuit never forms).
        n_facts = ctx_len // 4
        parts = [toks]
        for _ in range(self.N_PROBES):
            i = int(self._rng.randint(max(n_facts - 1, 1)))
            key = toks[i * 4 + 1]
            vals = toks[i * 4 + 2: i * 4 + 4]
            parts.append(np.concatenate([[6, key], vals]))
        return np.concatenate(parts)

    def _motif_bank(self):
        if not hasattr(self, "_bank"):
            bank_rng = np.random.RandomState(self.cfg.seed * 131 +
                                             self.host_id)
            self._bank = [bank_rng.randint(8, self.cfg.vocab_size - 8,
                                           int(bank_rng.randint(6, 20)))
                          for _ in range(4)]
        return self._bank

    def _doc_lm(self) -> np.ndarray:
        # motifs come from a small per-pipeline bank so the stream is
        # WEIGHT-learnable (memorizable): the fast-convergence smoke signal
        # for optimizer tests. (Per-doc random motifs would need an
        # in-context induction circuit — that's the "recall" stream's job.)
        c = self.cfg
        motif = self._motif_bank()[int(self._rng.randint(4))]
        reps = c.seq_len // len(motif) + 2
        return np.tile(motif, reps)

    def next_batch(self) -> Dict[str, np.ndarray]:
        c = self.cfg
        toks = np.zeros((c.batch_per_host, c.seq_len), np.int32)
        labels = np.full((c.batch_per_host, c.seq_len), -1, np.int32)
        for b in range(c.batch_per_host):
            doc = self._doc_recall() if c.kind == "recall" else self._doc_lm()
            raw_len = min(len(doc), c.seq_len + 1)   # pre-padding length!
            doc = doc[: c.seq_len + 1]
            if len(doc) < c.seq_len + 1:
                doc = np.pad(doc, (0, c.seq_len + 1 - len(doc)))
            toks[b] = doc[:-1]
            labels[b] = doc[1:]
            if c.kind == "recall":
                # next-token loss ONLY on the probe region of the REAL doc
                # (masking relative to the padded length would supervise
                # padding zeros and destroy the recall signal).
                labels[b, : max(0, raw_len - 4 * self.N_PROBES)] = -1
                labels[b, raw_len - 1:] = -1
        self._count += 1
        return {"tokens": toks, "labels": labels}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next_batch()
