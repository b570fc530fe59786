"""Page-granular prefix caching (DESIGN.md §4 adaptation #2).

The paper stores one KV entry per context; production stores (LMCache,
vLLM prefix caching) page the context into fixed-token chunks keyed by a
rolling prefix hash, so a request whose context shares only a PREFIX with
a cached one still loads the matched pages and prefills just the suffix.

    keys = chain_hash(pages of 256 tokens)       # key_i commits to pages<=i
    match_prefix(tokens) -> FetchPlan            # longest cached page run
    split_kv / join_kv / tail_kv                 # KVData <-> page KVData

Pages are ordinary AdaptCache entries: the policy compresses/places/evicts
each page independently (popular early pages of a hot document stay in
DRAM at high quality; deep-tail pages compress harder or spill to SSD —
finer-grained utility than whole-context entries, a beyond-paper
extension).

``match_prefix`` is a *planner*, not a loader: it returns one
``PageFetch`` per matched page (owning tier, bytes, cross-replica link
and decompress prices) so the serving engine can book each page read on
the owning tier's ``IOChannel`` — partial-prefix loads contend with
write-back and prefetch traffic like every other byte movement. The
synchronous ``total_delay_s`` sum is kept as a property for the
serialized baseline and unit tests.

Non-token arrays (SSM states) summarize the whole prefix and cannot be
paged — they ride the sub-page remainder. By default the remainder is
NOT stored and ``insert_context`` reports kept/remainder token counts
(and whether state was dropped) so callers account for suffix
re-prefill. With ``remainder=True`` the ``T mod page_tokens`` tail
(including any SSM state) is stored as a per-context REMAINDER entry
keyed by the full-context hash (``remainder_key``): an exact repeat then
matches pages + remainder and recomputes nothing, while any divergence
— or a missing base page — falls back to the page run alone, so a
remainder is implicitly invalidated the moment its base run breaks.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.compression.base import KVData
from repro_torch.core.controller import AdaptCacheController, FetchResult, Transfer
from repro_torch.core.estimator import QualityEstimator

PAGE_TOKENS = 256
TOKEN_ARRAYS = ("k", "v", "ckv", "krope", "positions")


def page_keys(tokens: np.ndarray, page_tokens: int = PAGE_TOKENS
              ) -> List[str]:
    """Rolling prefix-hash chain: key_i identifies pages[0..i] content."""
    keys = []
    h = hashlib.sha1()
    n_pages = len(tokens) // page_tokens
    for i in range(n_pages):
        h.update(np.ascontiguousarray(
            tokens[i * page_tokens:(i + 1) * page_tokens]).tobytes())
        keys.append(f"pg-{h.hexdigest()[:16]}-{i}")
    return keys


def remainder_key(tokens: np.ndarray, page_tokens: int = PAGE_TOKENS
                  ) -> Optional[str]:
    """Storage key of the sub-page remainder of ``tokens``: a hash of
    the FULL context (so only an exact repeat can match it), suffixed
    with the page count so the LRU depth tie-break (``_page_depth``)
    orders it deeper than every base page. None when the context is
    page-aligned (no remainder)."""
    n_pages = len(tokens) // page_tokens
    if len(tokens) - n_pages * page_tokens <= 0:
        return None
    h = hashlib.sha1(np.ascontiguousarray(tokens).tobytes())
    return f"rem-{h.hexdigest()[:16]}-{n_pages}"


def split_kv(kv: KVData, page_tokens: int = PAGE_TOKENS
             ) -> Tuple[List[KVData], KVData]:
    """Split a context entry into page entries (+ the sub-page remainder).

    Non-token arrays (SSM states) are NOT paged — they summarize the whole
    prefix and stay with the final page (remainder)."""
    t = kv["k" if "k" in kv else "ckv"].shape[1] if (
        "k" in kv or "ckv" in kv) else 0
    n_pages = t // page_tokens
    pages = []
    for i in range(n_pages):
        lo, hi = i * page_tokens, (i + 1) * page_tokens
        page: KVData = {}
        for name, a in kv.items():
            if name == "positions":
                page[name] = np.asarray(a[lo:hi])
            elif name in TOKEN_ARRAYS:
                page[name] = np.ascontiguousarray(a[:, lo:hi])
        pages.append(page)
    rem = tail_kv(kv, n_pages * page_tokens)
    return pages, rem


def tail_kv(kv: KVData, start: int) -> KVData:
    """Slice token arrays from source-token ``start`` on; non-token
    arrays (whole-prefix SSM state) pass through untouched."""
    out: KVData = {}
    for name, a in kv.items():
        if name == "positions":
            out[name] = np.asarray(a[start:])
        elif name in TOKEN_ARRAYS:
            out[name] = np.ascontiguousarray(a[:, start:])
        else:
            out[name] = np.asarray(a)          # ssm state stays whole
    return out


def join_kv(pages: Sequence[KVData]) -> KVData:
    """Concatenate page entries back into one KVData (token order).

    Token arrays concatenate over the pieces that carry them; non-token
    arrays (SSM state — whole-prefix summaries) are taken from the LAST
    piece holding one, so ``join_kv(pages + [remainder])`` reconstructs
    the original entry including state that only lives in the remainder."""
    assert pages
    names = []
    for p in pages:
        for name in p:
            if name not in names:
                names.append(name)
    out: KVData = {}
    for name in names:
        parts = [p[name] for p in pages if name in p]
        if name == "positions":
            out[name] = np.concatenate(parts)
        elif name in TOKEN_ARRAYS:
            out[name] = np.concatenate(parts, axis=1)
        else:
            out[name] = parts[-1]
    return out


@dataclasses.dataclass(frozen=True)
class PageFetch:
    """One matched page of a prefix run: everything the engine needs to
    book the read on the owning tier's channel."""
    key: str
    tier: str
    nbytes: int
    method: str
    rate: float
    kv: KVData
    remote: bool                     # owned by a sibling replica's DRAM
    xlink_delay_s: float
    decompress_delay_s: float
    load_delay_s: float              # unqueued tier read estimate
    orig_nbytes: int = 0             # uncompressed footprint (0: unknown)
    n_tokens: int = 0                # source tokens this piece covers

    @property
    def total_delay_s(self) -> float:
        return self.load_delay_s + self.xlink_delay_s \
            + self.decompress_delay_s

    @property
    def resident_frac(self) -> float:
        """Stored-over-dense byte ratio of this piece (1.0 when the
        uncompressed footprint is unknown or the piece is lossless)."""
        if self.orig_nbytes <= 0:
            return 1.0
        return min(1.0, self.nbytes / self.orig_nbytes)


@dataclasses.dataclass
class FetchPlan:
    """Longest-cached-prefix fetch plan for one request.

    ``src_tokens`` is the SOURCE-token coverage (matched pages, plus the
    remainder when one matched): the suffix to prefill starts there.
    ``n_tokens`` counts the rows the matched pieces actually kept (lossy
    pages shrink). A matched remainder entry rides ``pages`` as the
    final ``PageFetch`` (it is booked on a tier channel like any page)
    and reports its source-token length in ``remainder_tokens``."""
    pages: List[PageFetch]
    src_tokens: int
    n_tokens: int
    kv: Optional[KVData]            # joined matched pages (decompressed)
    remainder_tokens: int = 0       # sub-page tail covered by a matched
    #                                 remainder entry (0: none matched)
    quality: float = 1.0            # composed run quality: per-piece
    #                                 estimates (QualityEstimator) folded
    #                                 by the token-weighted geometric
    #                                 mean — one lossy page taxes the
    #                                 whole request's answer

    @property
    def n_pages(self) -> int:
        return len(self.pages)

    @property
    def total_delay_s(self) -> float:
        """Serialized (unqueued) page-load sum — the legacy synchronous
        cost; the event engine books pages on channels instead."""
        return sum(p.total_delay_s for p in self.pages)

    @property
    def tiers(self) -> List[str]:
        return [p.tier for p in self.pages]

    @property
    def nbytes(self) -> int:
        return sum(p.nbytes for p in self.pages)

    def kv_bytes_frac(self, fused_methods=frozenset()) -> float:
        """Token-weighted fraction of dense KV bytes the attention kernel
        actually streams for the matched run.

        Pieces compressed with a fused-eligible method stay packed in HBM
        (the kernel dequantizes in VREGs), so they cost their RESIDENT
        bytes; every other piece is dequantized to dense KV before
        attention and costs full bytes. 1.0 when nothing is fused."""
        if not self.pages:
            return 1.0
        tok_sum = 0
        weighted = 0.0
        for p in self.pages:
            n = p.n_tokens if p.n_tokens > 0 else 1
            frac = p.resident_frac if p.method in fused_methods else 1.0
            tok_sum += n
            weighted += n * frac
        return weighted / tok_sum if tok_sum else 1.0


@dataclasses.dataclass(frozen=True)
class InsertOutcome:
    """What ``insert_context`` stored vs dropped."""
    inserted: int                    # pages newly admitted this call
    pages: int                       # total pages the context splits into
    kept_tokens: int                 # source tokens covered by pages
    remainder_tokens: int            # sub-page suffix tokens; stored only
    #                                  when the cache runs remainder=True
    dropped_state: bool              # the remainder carried non-token
    #                                  (SSM) arrays that were discarded
    remainder_stored: bool = False   # the tail (incl. any state) was
    #                                  admitted as a remainder entry


class PagedPrefixCache:
    """Page-granular front-end over an AdaptCacheController.

    Contract: ``insert_context`` and ``match_prefix`` are *placement and
    planning* calls — they move no simulated time themselves. All
    returned delays are unqueued per-piece estimates in SECONDS and all
    sizes are stored BYTES; the serving engine books the actual queueing
    on the tier ``IOChannel``s. ``now`` is the simulated timestamp used
    for hit accounting and frequency estimates (falls back to the
    controller's clock). With ``remainder=True`` the sub-page tail is
    stored/matched as a per-context remainder entry (see module doc);
    the remainder only ever matches after a FULL page run."""

    def __init__(self, controller: AdaptCacheController,
                 page_tokens: int = PAGE_TOKENS,
                 remainder: bool = False):
        self.controller = controller
        self.page_tokens = page_tokens
        self.remainder = remainder

    def insert_context(self, tokens: np.ndarray, kv: KVData,
                       task_type: str, now: Optional[float] = None,
                       transfers: Optional[List[Transfer]] = None,
                       replica: Optional[int] = None,
                       keys: Optional[List[str]] = None,
                       tenant: Optional[str] = None) -> InsertOutcome:
        """Admit the pageable prefix of ``kv`` as page entries.

        Pages are stamped with the inserting replica (``home_replica``)
        so topology-aware placement keeps a document's page run local to
        the replica that prefilled it; page write-backs are emitted into
        ``transfers`` like any other insert. The sub-page remainder —
        including any SSM state, which only lives there — is stored as a
        full-context-keyed remainder entry when the cache runs
        ``remainder=True`` and discarded otherwise; the returned
        ``InsertOutcome`` reports exactly how many tokens were kept vs
        left for suffix re-prefill, and whether the tail was stored."""
        keys = page_keys(tokens, self.page_tokens) if keys is None else keys
        t_kv = kv["k" if "k" in kv else "ckv"].shape[1] if (
            "k" in kv or "ckv" in kv) else 0
        n_pages = t_kv // self.page_tokens
        rem_tokens = t_kv - n_pages * self.page_tokens
        # residency check BEFORE slicing: the common warm path (every
        # page already cached, only the remainder re-prefilled) must not
        # pay an O(context bytes) split/copy just to discard it
        missing = [i for i in range(min(n_pages, len(keys)))
                   if self.controller.lookup(keys[i]) is None]
        if missing:
            pages, _rem = split_kv(kv, self.page_tokens)
            for i in missing:
                self.controller.insert(keys[i], pages[i], task_type,
                                       now=now, transfers=transfers,
                                       replica=replica, tenant=tenant)
        rem_stored = False
        if self.remainder and rem_tokens > 0:
            rkey = remainder_key(tokens, self.page_tokens)
            if rkey is not None:
                if self.controller.lookup(rkey) is None:
                    self.controller.insert(
                        rkey, tail_kv(kv, n_pages * self.page_tokens),
                        task_type, now=now, transfers=transfers,
                        replica=replica, tenant=tenant)
                rem_stored = True
        return InsertOutcome(
            inserted=len(missing), pages=n_pages,
            kept_tokens=n_pages * self.page_tokens,
            remainder_tokens=rem_tokens,
            dropped_state=(not rem_stored
                           and any(name not in TOKEN_ARRAYS for name in kv)),
            remainder_stored=rem_stored)

    def match_prefix(self, tokens: np.ndarray,
                     now: Optional[float] = None,
                     replica: Optional[int] = None,
                     keys: Optional[List[str]] = None) -> FetchPlan:
        """Plan the longest cached page run for ``tokens``.

        Each resident page is fetched through the controller (hit
        accounting, frequency updates, remote-hit pricing for pages homed
        on a sibling replica's DRAM) and reported as a ``PageFetch``; the
        run stops at the first non-resident page. When the FULL run
        matched and the cache stores remainders, the full-context
        remainder entry is looked up too — a hit appends it as the final
        ``PageFetch`` and extends ``src_tokens`` to the whole context
        (an exact repeat recomputes nothing); a broken run never
        consults the remainder, so evicting any base page implicitly
        invalidates it. The caller books the piece reads on the owning
        tiers' I/O channels."""
        keys = page_keys(tokens, self.page_tokens) if keys is None else keys
        rkey = (remainder_key(tokens, self.page_tokens)
                if self.remainder else None)
        fetched: List[Tuple[str, FetchResult]] = []
        for key in keys:
            if self.controller.lookup(key) is None:
                break
            r = self.controller.fetch(key, now=now, replica=replica)
            if r is None:
                break
            fetched.append((key, r))
        rem_tokens = 0
        if self.remainder and len(fetched) == len(keys):
            if rkey is not None and self.controller.lookup(rkey) is not None:
                r = self.controller.fetch(rkey, now=now, replica=replica)
                if r is not None:
                    fetched.append((rkey, r))
                    rem_tokens = (len(tokens)
                                  - len(keys) * self.page_tokens)
        self.controller.note_page_run(
            len(fetched) - (1 if rem_tokens else 0), len(keys),
            run_key=keys[0] if keys else None, keys=keys, now=now,
            rem_hit=rem_tokens > 0, rem_key=rkey)
        if not fetched:
            return FetchPlan([], 0, 0, None)
        kv = join_kv([f.kv for _, f in fetched])
        # dropped pages shrink; count ACTUAL kept tokens
        n_tokens = kv["k" if "k" in kv else "ckv"].shape[1]
        n_page_hits = len(fetched) - (1 if rem_tokens else 0)
        pages = [PageFetch(key, f.tier, f.nbytes, f.method, f.rate, f.kv,
                           f.remote, f.xlink_delay_s, f.decompress_delay_s,
                           f.load_delay_s, orig_nbytes=f.orig_nbytes,
                           n_tokens=(rem_tokens
                                     if (rem_tokens and i == len(fetched) - 1)
                                     else self.page_tokens))
                 for i, (key, f) in enumerate(fetched)]
        return FetchPlan(pages, n_page_hits * self.page_tokens + rem_tokens,
                         n_tokens, kv, remainder_tokens=rem_tokens,
                         quality=self._compose_quality(fetched, rem_tokens))

    def _compose_quality(self, fetched: List[Tuple[str, FetchResult]],
                         rem_tokens: int) -> float:
        """Composed quality of the matched run: each piece's
        (method, rate) priced through the quality estimator — the one
        the policy optimizes with, falling back to the controller's
        serving-rig estimator — and folded by the token-weighted
        geometric mean (``QualityEstimator.compose``). Without any
        estimator, lossless pieces score 1.0 and the composition is
        degenerate-exact (all-\"none\" runs always compose to 1.0)."""
        if not fetched:
            return 1.0
        qe = (self.controller.quality_est
              or getattr(self.controller.policy, "quality", None))
        quals, weights = [], []
        for i, (key, f) in enumerate(fetched):
            meta = self.controller.meta.get(key)
            if f.method == "none":
                q = 1.0
            elif qe is not None:
                q = qe.predict(meta.task_type if meta else "qa",
                               f.method, f.rate,
                               meta.redundancy if meta else 0.5)
            else:
                q = 1.0
            quals.append(q)
            is_rem = rem_tokens > 0 and i == len(fetched) - 1
            weights.append(rem_tokens if is_rem else self.page_tokens)
        return QualityEstimator.compose(quals, weights)

    def local_run(self, tokens: np.ndarray, dram_tier: str,
                  keys: Optional[List[str]] = None) -> int:
        """Length of the leading page run resident in ``dram_tier`` —
        the prefix-affinity routing score (no counters touched)."""
        keys = page_keys(tokens, self.page_tokens) if keys is None else keys
        run = 0
        for key in keys:
            if self.controller.lookup(key) != dram_tier:
                break
            run += 1
        return run
