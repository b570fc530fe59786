"""Compression method interface for KV cache entries.

A *KV entry* is the cacheable artifact of one context chunk:
  attention archs: {"k": (L, T, F), "v": (L, T, F)}  (+ "positions": (T,))
  ssm archs:       {"ssm": (L, D, N), "conv": (L, C, D)}  (fixed-size state)

Methods expose a discrete ladder of compression RATES (r = compressed
bytes / original bytes); the AdaptCache policy optimizer picks (method,
rate) per entry via marginal utility (core/policy.py). ``estimate_nbytes``
is analytic — the policy never has to compress to evaluate a candidate.
"""
from __future__ import annotations

import abc
import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.runtime import trace

KVData = Dict[str, np.ndarray]


def kv_nbytes(kv: KVData) -> int:
    return int(sum(a.nbytes for a in kv.values()))


def kv_num_tokens(kv: KVData) -> int:
    if "k" in kv:
        return int(kv["k"].shape[1])
    return 0  # ssm state: no token axis


@dataclasses.dataclass
class CompressedEntry:
    method: str
    rate: float                       # nominal compressed/original byte ratio
    arrays: Dict[str, np.ndarray]     # method-specific payload
    meta: Dict[str, Any]              # method-specific (bits, kept idx, ...)

    @property
    def nbytes(self) -> int:
        return int(sum(a.nbytes for a in self.arrays.values()))

    def tobytes(self) -> bytes:
        """Serialized page payload for the SSD tier."""
        import io
        buf = io.BytesIO()
        np.savez(buf, **self.arrays)
        return buf.getvalue()

    @classmethod
    def frombytes(cls, raw: bytes, method: str, rate: float,
                  meta: Dict[str, Any]) -> "CompressedEntry":
        import io
        with np.load(io.BytesIO(raw)) as z:
            arrays = {k: z[k] for k in z.files}
        return cls(method, rate, arrays, meta)


class CompressionMethod(abc.ABC):
    name: str = "base"

    @abc.abstractmethod
    def rates(self, kv: Optional[KVData] = None) -> Sequence[float]:
        """Supported rate ladder, descending (1.0 first if lossless point)."""

    @abc.abstractmethod
    def compress(self, kv: KVData, rate: float) -> CompressedEntry:
        ...

    def decompress(self, entry: CompressedEntry) -> KVData:
        """The entry's KVData, inside a ``codec.decompress`` span."""
        with trace.span("codec.decompress") as sp:
            if sp:
                sp.attrs.update(method=self.name, bytes=entry.nbytes)
            return self._decompress(entry)

    @abc.abstractmethod
    def _decompress(self, entry: CompressedEntry) -> KVData:
        ...

    @abc.abstractmethod
    def estimate_nbytes(self, kv: KVData, rate: float) -> int:
        """Analytic compressed size — no compression performed."""

    def applicable(self, kv: KVData) -> bool:
        return True

    def closest_rate(self, kv: KVData, rate: float) -> float:
        ladder = list(self.rates(kv))
        return min(ladder, key=lambda r: abs(r - rate))


class NoCompression(CompressionMethod):
    """Identity 'method' — the paper's Without-Compression arm."""
    name = "none"

    def rates(self, kv=None):
        return (1.0,)

    def compress(self, kv: KVData, rate: float) -> CompressedEntry:
        return CompressedEntry("none", 1.0, dict(kv), {})

    def _decompress(self, entry: CompressedEntry) -> KVData:
        return dict(entry.arrays)

    def estimate_nbytes(self, kv: KVData, rate: float) -> int:
        return kv_nbytes(kv)
