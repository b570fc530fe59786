"""Synthetic serving workloads mirroring the paper's evaluation setup (§3):
contexts from three task families (QA / summarization / coding), reused by
requests arriving as a Poisson process at a configurable rate.

Contexts are token sequences with task-dependent structure so that lossy KV
compression has a *measurable*, task-dependent quality effect on a small
trained model:
  qa            — key/value fact lists; probes ask for a value mid-context
                  (middle tokens matter -> token dropping is harmful,
                  quantization mild: the paper's 'new information' case)
  summarization — highly redundant repeated motifs (drop-friendly: only the
                  start/end matter, the paper's sink+recent case)
  coding        — structured def/call patterns with long-range references
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Tenant:
    """One serving tenant: a scheduling priority tier, a resident-KV
    token quota, and an arrival-rate profile.

    ``tier`` orders deadline-based chunk scheduling (0 = highest
    priority); ``quota_tokens`` caps the tenant's RESIDENT cache
    footprint across the whole hierarchy (0 = unlimited — the
    controller converts tokens to bytes at its KV entry density);
    ``ttft_slo_s`` stamps the per-request deadline used to order queued
    prefill chunks (0 = no deadline, FIFO within the tier).
    ``rate_scale`` / ``phase`` shape the tenant's diurnal arrival rate
    in ``make_tenant_workload``."""
    name: str
    tier: int = 0
    quota_tokens: int = 0
    ttft_slo_s: float = 0.0
    rate_scale: float = 1.0
    phase: float = 0.0           # diurnal phase offset, fraction of period
    tasks: Tuple[str, ...] = ("qa",)


# the paper-style production mix: interactive chat (latency-critical,
# hot small contexts), RAG search (long shared documents), and batch
# agents (code-heavy, throughput traffic) — offset diurnal peaks so one
# tenant's storm hits another's steady state
DEFAULT_TENANTS: Tuple[Tenant, ...] = (
    Tenant("chat", tier=0, quota_tokens=4096, ttft_slo_s=0.05,
           rate_scale=1.0, phase=0.0, tasks=("qa",)),
    Tenant("rag", tier=1, quota_tokens=2048, ttft_slo_s=0.25,
           rate_scale=0.7, phase=0.33, tasks=("qa", "summarization")),
    Tenant("agent", tier=2, quota_tokens=1024, ttft_slo_s=0.0,
           rate_scale=0.5, phase=0.66, tasks=("coding",)),
)


@dataclasses.dataclass
class Context:
    key: str
    task_type: str
    tokens: np.ndarray           # (T,) int32
    probes: List[np.ndarray]     # question token seqs
    tenant: Optional[str] = None  # owning tenant name (None = untenanted)


@dataclasses.dataclass
class Request:
    req_id: int
    context_key: str
    question: np.ndarray
    arrival_s: float
    task_type: str
    max_new_tokens: int = 24
    tenant: Optional[str] = None  # owning tenant name (None = untenanted)


def _qa_context(rng, vocab: int, length: int, n_probes: int):
    # fact layout: [SEP key val val] repeated; keys/vals from disjoint ranges
    sep = 5
    n_facts = length // 4
    keys = rng.randint(vocab // 4, vocab // 2, n_facts)
    vals = rng.randint(vocab // 2, vocab - 8, (n_facts, 2))
    toks = np.stack([np.full(n_facts, sep), keys, vals[:, 0], vals[:, 1]],
                    axis=1).reshape(-1)[:length]
    probes = []
    for _ in range(n_probes):
        i = rng.randint(n_facts - 1)
        probes.append(np.array([6, keys[i]], dtype=np.int32))  # "what is key?"
    return toks.astype(np.int32), probes


def _summary_context(rng, vocab: int, length: int, n_probes: int):
    motif = rng.randint(8, vocab // 2, rng.randint(8, 16))
    reps = length // len(motif) + 1
    noise = rng.randint(8, vocab - 8, length)
    toks = np.tile(motif, reps)[:length]
    mask = rng.rand(length) < 0.15
    toks = np.where(mask, noise, toks)
    probes = [np.array([7], dtype=np.int32) for _ in range(n_probes)]
    return toks.astype(np.int32), probes


def _coding_context(rng, vocab: int, length: int, n_probes: int):
    # def <name> <body...> ... call sites reference earlier names
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


_GEN = {"qa": _qa_context, "summarization": _summary_context,
        "coding": _coding_context}


def make_contexts(rng: np.random.RandomState, vocab: int, n_per_task: int,
                  min_len: int = 192, max_len: int = 768,
                  n_probes: int = 4,
                  tasks: Sequence[str] = ("qa", "summarization", "coding"),
                  ) -> List[Context]:
    out = []
    for task in tasks:
        for i in range(n_per_task):
            length = int(rng.randint(min_len, max_len))
            toks, probes = _GEN[task](rng, vocab, length, n_probes)
            out.append(Context(f"{task}-{i}", task, toks, probes))
    return out


def make_prefix_sharing_contexts(rng: np.random.RandomState, vocab: int,
                                 n_docs: int, n_variants: int,
                                 prefix_len: int = 256,
                                 suffix_len: int = 64,
                                 n_probes: int = 2,
                                 tasks: Sequence[str] = (
                                     "qa", "summarization", "coding"),
                                 ) -> List[Context]:
    """Prefix-sharing corpus for the page-granular serving path.

    Each *document* is a task-structured context of ``prefix_len +
    suffix_len`` tokens; its ``n_variants`` variants share the
    document's first ``prefix_len`` tokens verbatim and diverge in a
    freshly generated ``suffix_len`` tail (think: many user sessions
    over one shared document, each with its own follow-up). Tasks cycle
    across documents so the per-task mix survives. Whole-context caching
    sees ``n_docs * n_variants`` unrelated keys; page-granular caching
    sees ``n_docs`` shared page runs plus short divergent suffixes.

    Variants are keyed ``{task}-doc{d}-v{v}``; probes come from the
    base document (they reference its shared-prefix structure)."""
    out = []
    for d in range(n_docs):
        task = tasks[d % len(tasks)]
        base, probes = _GEN[task](rng, vocab, prefix_len + suffix_len,
                                  n_probes)
        # task generators may truncate to their own granularity (qa emits
        # 4-token facts), so splice by the ACTUAL tail length and
        # over-generate the divergent suffix before slicing
        tail = len(base) - prefix_len
        for v in range(n_variants):
            toks = base.copy()
            if v > 0 and tail > 0:
                sfx, _ = _GEN[task](rng, vocab, tail + 8, 1)
                toks[prefix_len:] = sfx[:tail]
            out.append(Context(f"{task}-doc{d}-v{v}", task, toks, probes))
    return out


def make_heavy_traffic_contexts(rng: np.random.RandomState, vocab: int,
                                n_docs: int, n_variants: int = 2,
                                prefix_len: int = 64,
                                suffix_len: int = 48,
                                n_probes: int = 1,
                                tasks: Sequence[str] = (
                                    "qa", "summarization", "coding"),
                                ) -> List[Context]:
    """Heavy-traffic corpus: the prefix-sharing generator at population
    scale (thousands of contexts) with SHORT contexts, so a serving run
    is dominated by cache-population effects (insert/enforce/readahead
    placement work) rather than model compute. Same keying and task
    cycling as ``make_prefix_sharing_contexts``."""
    return make_prefix_sharing_contexts(
        rng, vocab, n_docs, n_variants, prefix_len=prefix_len,
        suffix_len=suffix_len, n_probes=n_probes, tasks=tasks)


def bursty_requests(rng: np.random.RandomState, contexts: List[Context],
                    n_requests: int, burst_size: int = 8,
                    burst_gap_s: float = 0.25,
                    intra_gap_s: float = 0.004,
                    zipf_a: float = 1.3,
                    max_new_tokens: int = 4) -> List[Request]:
    """Bursty skewed arrivals for the heavy-traffic scale benchmark:
    requests land in bursts of ``burst_size`` (``intra_gap_s`` apart)
    separated by ``burst_gap_s``, and context popularity is Zipf over a
    seeded permutation — a few hot documents absorb most traffic while
    a long cold tail churns the cache. Fully determined by ``rng``."""
    reqs = []
    order = rng.permutation(len(contexts))
    for i in range(n_requests):
        burst, pos = divmod(i, burst_size)
        t = burst * burst_gap_s + pos * intra_gap_s
        ci = order[int(rng.zipf(zipf_a)) % len(contexts)]
        ctx = contexts[ci]
        q = ctx.probes[int(rng.randint(len(ctx.probes)))]
        reqs.append(Request(i, ctx.key, q, t, ctx.task_type,
                            max_new_tokens))
    return reqs


def round_robin_requests(contexts: List[Context], n_requests: int,
                         interarrival_s: float, max_new_tokens: int = 24,
                         start_s: float = 0.0) -> List[Request]:
    """Deterministic workload: fixed inter-arrival gap, contexts visited
    round-robin, probes cycled per context. No RNG — identical inputs
    give an identical request stream, which the event-engine determinism
    tests and the overlap benchmark rely on."""
    reqs = []
    for i in range(n_requests):
        ctx = contexts[i % len(contexts)]
        q = ctx.probes[(i // len(contexts)) % len(ctx.probes)]
        reqs.append(Request(i, ctx.key, q, start_s + i * interarrival_s,
                            ctx.task_type, max_new_tokens))
    return reqs


def make_tenant_workload(rng: np.random.RandomState, vocab: int,
                         n_docs_per_tenant: int,
                         tenants: Sequence[Tenant] = DEFAULT_TENANTS,
                         base_rate_hz: float = 40.0,
                         duration_s: float = 4.0,
                         period_s: float = 2.0,
                         diurnal_amp: float = 0.8,
                         n_variants: int = 2,
                         prefix_len: int = 64,
                         suffix_len: int = 48,
                         n_probes: int = 1,
                         zipf_a: float = 1.3,
                         max_new_tokens: int = 4,
                         ) -> Tuple[List[Context], List[Request]]:
    """Multi-tenant heavy-traffic workload: each tenant owns a private
    heavy-traffic corpus (keys prefixed ``{tenant}:``) and an
    inhomogeneous-Poisson arrival stream whose rate follows a diurnal
    sinusoid — ``rate_scale * base_rate_hz * (1 + amp*sin(...))`` with a
    per-tenant ``phase`` offset, so tenants peak at different times and
    one tenant's storm lands on another's steady state. Arrivals are
    drawn by thinning against the per-tenant peak rate; context
    popularity is Zipf within the tenant. Fully determined by ``rng``
    (tenant order is the order given). Returns the merged contexts and
    the arrival-sorted, re-numbered request stream."""
    contexts: List[Context] = []
    reqs: List[Request] = []
    amp = min(max(diurnal_amp, 0.0), 1.0)
    for ten in tenants:
        own = make_heavy_traffic_contexts(
            rng, vocab, n_docs_per_tenant, n_variants=n_variants,
            prefix_len=prefix_len, suffix_len=suffix_len,
            n_probes=n_probes, tasks=ten.tasks)
        for c in own:
            c.key = f"{ten.name}:{c.key}"
            c.tenant = ten.name
        contexts.extend(own)
        peak_hz = ten.rate_scale * base_rate_hz * (1.0 + amp)
        if peak_hz <= 0.0:
            continue
        order = rng.permutation(len(own))
        t = 0.0
        while True:
            t += rng.exponential(1.0 / peak_hz)
            u = rng.rand()          # thin even past the horizon: the
            #                         draw count stays rate-independent
            if t >= duration_s:
                break
            lam = ten.rate_scale * base_rate_hz * (
                1.0 + amp * math.sin(2.0 * math.pi
                                     * (t / period_s + ten.phase)))
            if u * peak_hz > lam:
                continue
            ctx = own[order[int(rng.zipf(zipf_a)) % len(own)]]
            q = ctx.probes[int(rng.randint(len(ctx.probes)))]
            reqs.append(Request(0, ctx.key, q, t, ctx.task_type,
                                max_new_tokens, tenant=ten.name))
    reqs.sort(key=lambda r: (r.arrival_s, r.context_key))
    for i, r in enumerate(reqs):
        r.req_id = i
    return contexts, reqs


def poisson_requests(rng: np.random.RandomState, contexts: List[Context],
                     rate_hz: float, duration_s: float,
                     zipf_a: float = 1.2, max_new_tokens: int = 24,
                     ) -> List[Request]:
    """Poisson arrivals; context popularity ~ Zipf (multi-turn reuse)."""
    reqs, t, rid = [], 0.0, 0
    order = rng.permutation(len(contexts))
    while t < duration_s:
        t += rng.exponential(1.0 / rate_hz)
        ci = order[int(rng.zipf(zipf_a)) % len(contexts)]
        ctx = contexts[ci]
        q = ctx.probes[int(rng.randint(len(ctx.probes)))]
        reqs.append(Request(rid, ctx.key, q, t, ctx.task_type,
                            max_new_tokens))
        rid += 1
    return reqs
