"""AdaptCache Estimator (paper §2): offline profiling of

  1. device transfer delays + decompression overhead (dummy-payload probes),
  2. quality–compression-rate curves per (task type, method)   — built by
     running the real model on sampled entries with probe questions, the
     in-repo analogue of the paper's GPT-4o-generated probes,
  3. per-entry future hit frequency from historical hits (EWMA).

The policy optimizer consumes only this module's three predictors, so a
deployment can swap any of them (e.g. learned frequency models) without
touching the MCKP solver.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import time
from typing import Callable, Dict, FrozenSet, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.compression.base import CompressionMethod, KVData
from repro_torch.storage.tier import Tier


# ---------------------------------------------------------------------------
# 1. delay estimation
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DelayProfile:
    # decompression throughput (bytes/s of COMPRESSED input) per method
    decompress_bps: Dict[str, float]
    # Methods whose decode happens inside the attention kernel itself
    # (kernels/fused_prefill dequantizes packed KV in VREGs): their
    # standalone decompress pass disappears from the serving path, except
    # for a measured residual — the calibrated fraction of the dequant
    # cost the fused kernel still pays over attention on dense KV.
    # Empty by default so existing profiles price exactly as before.
    fused_methods: FrozenSet[str] = frozenset()
    fused_residual_frac: float = 0.0

    def decompress_delay_s(self, method: str, nbytes: int) -> float:
        bps = self.decompress_bps.get(method, float("inf"))
        if bps <= 0:
            return 0.0
        delay_s = nbytes / bps
        if method in self.fused_methods:
            delay_s *= self.fused_residual_frac
        return delay_s


# Methods the fused kernel can consume directly (KIVI-packed uint8 planes).
# Entropy-coded / zstd-framed formats still need a standalone decode pass.
FUSED_COMPUTE_METHODS = frozenset({"kivi", "drop_kivi"})


# Defaults calibrated to accelerator-side dequant kernels (the fused Pallas
# path dequantizes at HBM-read speed; CPU-side numpy profiling would not be
# representative of the serving device).
DEFAULT_DECOMPRESS_BPS = {
    "none": float("inf"),
    "kivi": 50e9,
    "streaming_llm": float("inf"),      # token dropping: no decode cost
    "drop_kivi": 50e9,
}


@dataclasses.dataclass
class FusedCalibration:
    """Measured cost split of the fused kernel vs the two-pass pipeline
    (``benchmarks/kernel_bench.py`` writes one of these as JSON).

    ``fused_s`` is one fused-kernel call; ``dequant_s`` + ``attn_s`` are
    the standalone dequantize pass and the attention-on-dense-KV call it
    replaces. The residual fraction is how much of the dequant cost the
    fused kernel still pays — ~0 on TPU where dequant rides the HBM
    stream, close to 1 on the CPU fallback, which dequantizes anyway.
    """
    fused_s: float
    dequant_s: float
    attn_s: float

    @property
    def residual_frac(self) -> float:
        if self.dequant_s <= 0:
            return 0.0
        frac = (self.fused_s - self.attn_s) / self.dequant_s
        return float(np.clip(frac, 0.0, 1.0))

    @property
    def speedup(self) -> float:
        """Two-pass time over fused time (>= 1 when fusion wins)."""
        return (self.dequant_s + self.attn_s) / max(self.fused_s, 1e-12)


def load_fused_calibration(path: str) -> FusedCalibration:
    with open(path) as f:
        d = json.load(f)
    return FusedCalibration(fused_s=float(d["fused_s"]),
                            dequant_s=float(d["dequant_s"]),
                            attn_s=float(d["attn_s"]))


def profile_decompression(methods: Dict[str, CompressionMethod],
                          sample_kv: KVData,
                          repeats: int = 3) -> DelayProfile:
    """Measure actual decompress throughput on this host (estimator probe)."""
    out: Dict[str, float] = {}
    for name, m in methods.items():
        if not m.applicable(sample_kv):
            continue
        rate = list(m.rates(sample_kv))[-1]
        entry = m.compress(sample_kv, rate)
        # offline calibration probe: measures REAL decompress
        # throughput on this host  # simcheck: ignore[wallclock]
        t0 = time.perf_counter()  # simcheck: ignore[wallclock]
        for _ in range(repeats):
            m.decompress(entry)
        dt = (time.perf_counter() - t0) / repeats  # simcheck: ignore[wallclock]
        out[name] = entry.nbytes / max(dt, 1e-9)
    out.setdefault("none", float("inf"))
    return DelayProfile(out)


def load_delay_s(tier: Tier, nbytes: int, profile: DelayProfile,
               method: str) -> float:
    return tier.load_delay_s(nbytes) + profile.decompress_delay_s(method, nbytes)


# ---------------------------------------------------------------------------
# 2. quality estimation
# ---------------------------------------------------------------------------

QualityProbe = Callable[[KVData, str, float], float]
# (kv, method, rate) -> similarity score in [0, 1] vs uncompressed output.


class QualityEstimator:
    """Per-(task_type, method) quality–rate curves with per-entry features.

    ``fit`` profiles sampled entries through a probe (the serving engine's
    generate-and-compare); ``predict`` interpolates the curve, adjusted by
    an entry redundancy feature (longer/high-redundancy contexts compress
    better — paper §3 'Understanding AdaptCache's improvements').
    """

    def __init__(self):
        # curves[(task, method)] = sorted [(rate, mean quality), ...]
        self.curves: Dict[Tuple[str, str], List[Tuple[float, float]]] = {}

    def fit(self, task_type: str, methods: Dict[str, CompressionMethod],
            samples: Sequence[KVData], probe: QualityProbe) -> None:
        for mname, m in methods.items():
            pts: Dict[float, List[float]] = collections.defaultdict(list)
            for kv in samples:
                if not m.applicable(kv):
                    continue
                for rate in m.rates(kv):
                    pts[round(rate, 4)].append(probe(kv, mname, rate))
            if pts:
                curve = sorted((r, float(np.mean(q))) for r, q in pts.items())
                self.curves[(task_type, mname)] = curve

    def set_curve(self, task_type: str, method: str,
                  curve: Sequence[Tuple[float, float]]) -> None:
        self.curves[(task_type, method)] = sorted(curve)

    @staticmethod
    def compose(qualities: Sequence[float],
                weights: Optional[Sequence[float]] = None) -> float:
        """Compose per-piece qualities along a matched page run into one
        request-level score: the token-weighted GEOMETRIC mean (CacheGen's
        per-piece rate choices multiply along the context — losing half
        the signal in ANY page hurts the whole answer, so the composition
        must punish a weak link harder than an arithmetic mean would).

        Properties the policy relies on (tested via hypothesis):
        ``compose([q]*n) == q`` (uniform runs keep the per-page score),
        monotone non-DEcreasing in every piece, and 0 the moment any
        weighted piece is 0. Empty runs compose to 1.0 (nothing was
        approximated)."""
        qs = np.asarray(list(qualities), dtype=np.float64)
        if qs.size == 0:
            return 1.0
        w = (np.ones_like(qs) if weights is None
             else np.asarray(list(weights), dtype=np.float64))
        tot = w.sum()
        if tot <= 0:
            return 1.0
        w = w / tot
        if np.any((qs <= 0.0) & (w > 0)):
            return 0.0
        return float(np.exp(np.sum(w * np.log(np.clip(qs, 1e-12, 1.0)))))

    def predict(self, task_type: str, method: str, rate: float,
                redundancy: float = 0.5) -> float:
        if method == "none":
            return 1.0
        curve = self.curves.get((task_type, method))
        if curve is None:
            curve = self.curves.get((task_type, "kivi"))
        if not curve:
            # uncalibrated fallback: optimistic linear decay
            base = max(0.0, min(1.0, 0.5 + rate))
        else:
            rates = np.array([c[0] for c in curve])
            quals = np.array([c[1] for c in curve])
            base = float(np.interp(rate, rates, quals))
        # redundancy in [0,1]: redundant entries lose less quality.
        adj = base + (redundancy - 0.5) * 0.2 * (1.0 - base)
        return float(np.clip(adj, 0.0, 1.0))


def redundancy_feature(kv: KVData) -> float:
    """Cheap information-redundancy proxy in [0, 1]: how concentrated the
    spectrum of K is (highly redundant context -> top singular directions
    dominate). Sampled for cost: one layer, token-subsampled."""
    if "k" not in kv:
        return 0.5
    k = kv["k"][0]
    t = k.shape[0]
    sub = k[:: max(1, t // 128)].astype(np.float32)
    if sub.shape[0] < 4:
        return 0.5
    sub = sub - sub.mean(0, keepdims=True)
    s = np.linalg.svd(sub, compute_uv=False)
    e = s ** 2
    tot = e.sum() + 1e-9
    top = e[: max(1, len(e) // 8)].sum() / tot
    return float(np.clip(top, 0.0, 1.0))


# ---------------------------------------------------------------------------
# 3. frequency estimation
# ---------------------------------------------------------------------------

class FrequencyEstimator:
    """EWMA of per-entry hit rate (hits/s), the paper's 'historical hit
    frequency' predictor. New entries get an optimistic prior so they are
    not instantly evicted (standard admission treatment)."""

    def __init__(self, halflife_s: float = 300.0, prior_hz: float = 0.02):
        self.halflife = halflife_s
        self.prior_hz = prior_hz
        self._rate: Dict[str, float] = {}
        self._last: Dict[str, float] = {}

    def seen(self, key: str) -> bool:
        """True when the key has EWMA state (insert/hit history). The
        controller skips the optimistic-prior reset on re-inserts of
        such keys so eviction does not wipe learned hit rates."""
        return key in self._rate

    def on_insert(self, key: str, now: float) -> None:
        self._rate[key] = self.prior_hz
        self._last[key] = now

    def on_hit(self, key: str, now: float) -> None:
        last = self._last.get(key, now)
        dt = max(now - last, 1e-3)
        inst = 1.0 / dt
        alpha = 1.0 - 0.5 ** (dt / self.halflife)
        self._rate[key] = (1 - alpha) * self._rate.get(key, self.prior_hz) \
            + alpha * inst
        self._last[key] = now

    def decay_factor(self, dt_s: float) -> float:
        """Multiplier ``predict`` applies over an idle span of ``dt_s``
        seconds. Every key of this estimator shares it, which is what
        lets the incremental placement selector cache scores normalized
        to a fixed reference time (see ``repro_torch.core.selector``)."""
        return 0.5 ** (dt_s / self.halflife)

    def predict(self, key: str, now: float) -> float:
        rate = self._rate.get(key, self.prior_hz)
        idle = max(0.0, now - self._last.get(key, now))
        return rate * self.decay_factor(idle)         # decay while cold

    def forget(self, key: str) -> None:
        self._rate.pop(key, None)
        self._last.pop(key, None)


class RunFrequencyEstimator(FrequencyEstimator):
    """Run-level frequency: one EWMA per page RUN instead of per entry.

    A *run* is the ordered page chain of one context
    (``serving.chunking.page_keys``), identified by its FIRST page key —
    contexts sharing a prefix share the run identity, so the estimate
    aggregates all variants of a document. ``note_run`` folds one
    prefix-match observation (a ``match_prefix`` call) into the run's
    hit-rate EWMA (Hz, sim-time seconds); how far a hot run extends is
    the controller's business (it registers each run's latest page-key
    chain alongside this estimator). Inherits the per-key decay and
    optimistic-prior semantics of ``FrequencyEstimator``.
    """

    def note_run(self, run_key: str, now: float) -> None:
        """Record one prefix match against the run (a hit-rate sample
        at sim time ``now``; the first observation seeds the prior)."""
        if self.seen(run_key):
            self.on_hit(run_key, now)
        else:
            self.on_insert(run_key, now)
