"""StreamingLLM compression method (token-dropping arm of AdaptCache).

arXiv:2309.17453: keep the first ``n_sink`` attention-sink tokens plus the
most recent window; drop the middle. The decompressed entry is the SHORTER
kept sequence together with its original ``positions`` (K rows carry their
original RoPE phases, so attention over the kept set remains consistent).

Rate ladder: keep fraction ∈ {1.0, 0.5, 0.25, 0.125}.

Inapplicable to SSM state entries (no token axis) — ``applicable`` returns
False and the policy optimizer never proposes it (DESIGN.md §6).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from repro_torch.core.compression.base import (
    CompressedEntry, CompressionMethod, KVData, kv_nbytes,
)

KEEP_LADDER = (1.0, 0.5, 0.25, 0.125)


class StreamingLLMCompression(CompressionMethod):
    name = "streaming_llm"

    def __init__(self, n_sink: int = 4):
        self.n_sink = n_sink

    # token-major arrays (dropped along axis 1); MLA latents included —
    # the dropping arm operates on the latent sequence (DESIGN.md §6)
    TOKEN_ARRAYS = ("k", "v", "ckv", "krope")

    def applicable(self, kv: KVData) -> bool:
        return ("k" in kv and "v" in kv) or "ckv" in kv

    def rates(self, kv: Optional[KVData] = None) -> Sequence[float]:
        return KEEP_LADDER

    def _keep_indices(self, t: int, keep_frac: float) -> np.ndarray:
        n_keep = max(self.n_sink + 1, int(round(t * keep_frac)))
        n_keep = min(n_keep, t)
        n_recent = n_keep - self.n_sink
        if n_recent <= 0:
            return np.arange(n_keep)
        return np.concatenate([np.arange(self.n_sink),
                               np.arange(t - n_recent, t)])

    def _token_dim(self, kv: KVData) -> int:
        return kv["k" if "k" in kv else "ckv"].shape[1]

    def compress(self, kv: KVData, rate: float) -> CompressedEntry:
        keep = self.closest_rate(kv, rate)
        t = self._token_dim(kv)
        idx = self._keep_indices(t, keep)
        arrays = {}
        for name, a in kv.items():
            if name == "positions":
                arrays[name] = np.asarray(a)[idx]
            elif name in self.TOKEN_ARRAYS:
                arrays[name] = np.ascontiguousarray(a[:, idx])
            else:
                arrays[name] = np.asarray(a)     # ssm-like: pass through
        if "positions" not in kv:
            arrays["positions"] = idx.astype(np.int32)
        true_rate = sum(v.nbytes for v in arrays.values()) / max(kv_nbytes(kv), 1)
        return CompressedEntry(self.name, true_rate, arrays,
                               {"orig_tokens": t, "keep_frac": keep})

    def decompress(self, entry: CompressedEntry) -> KVData:
        return dict(entry.arrays)

    def estimate_nbytes(self, kv: KVData, rate: float) -> int:
        keep = self.closest_rate(kv, rate)
        t = self._token_dim(kv)
        n_keep = len(self._keep_indices(t, keep))
        total = 0
        for name, a in kv.items():
            if name in self.TOKEN_ARRAYS or name == "positions":
                total += a.nbytes * n_keep // t
            else:
                total += a.nbytes
        return int(total) + (0 if "positions" in kv else 4 * n_keep)
