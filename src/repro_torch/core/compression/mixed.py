"""Beyond-paper method: token dropping THEN quantization ("drop+kivi").

Extends the paper's two-arm design with a composed arm reaching rates the
individual methods cannot (e.g. keep 50% at 4-bit ≈ 0.065 of original).
The policy optimizer treats it as just another (method, rate) ladder.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from repro_torch.core.compression.base import CompressedEntry, CompressionMethod, KVData
from repro_torch.core.compression.kivi import KIVICompression
from repro_torch.core.compression.streaming_llm import StreamingLLMCompression


class DropQuantCompression(CompressionMethod):
    name = "drop_kivi"

    def __init__(self, group_size: int = 64, n_sink: int = 4,
                 device="cuda"):
        self.kivi = KIVICompression(group_size, device)
        self.stream = StreamingLLMCompression(n_sink)
        # (keep_frac, bits) grid, deduplicated by achieved rate
        self.grid = [(k, b) for k in (0.5, 0.25) for b in (8, 4, 2)]

    def applicable(self, kv: KVData) -> bool:
        return self.stream.applicable(kv)

    def rates(self, kv: Optional[KVData] = None) -> Sequence[float]:
        if kv is None:
            return tuple(k * (b / 32 + 8 / (64 * 4)) for k, b in self.grid)
        return self._ladder(kv)[1]

    def _ladder(self, kv: KVData):
        """Each grid point's compressed bytes and rate on ``kv``, from shapes
        alone: the dropped entry's stand-ins (one a keep fraction) hold no
        rows."""
        kept = {k: self.stream.kept_proxy(kv, k)
                for k in {k for k, _ in self.grid}}
        sizes = [self.kivi.estimate_quantized_nbytes(kept[k], b)
                 for k, b in self.grid]
        orig = max(1, sum(a.nbytes for a in kv.values()))
        return sizes, tuple(n / orig for n in sizes)

    def _pick(self, kv: KVData, rate: float):
        """The grid point whose rate on ``kv`` is closest to ``rate``, and
        its estimated bytes."""
        sizes, ladder = self._ladder(kv)
        i = int(np.argmin([abs(r - rate) for r in ladder]))
        return self.grid[i], sizes[i]

    def compress(self, kv: KVData, rate: float) -> CompressedEntry:
        (keep, bits), _ = self._pick(kv, rate)
        dropped = self.stream.compress(kv, keep)
        inner = self.kivi.compress(dropped.arrays, 0.0, bits=bits)
        orig = max(1, sum(a.nbytes for a in kv.values()))
        return CompressedEntry(self.name, inner.nbytes / orig, inner.arrays,
                               {"kivi": inner.meta, "stream": dropped.meta,
                                "keep": keep, "bits": bits})

    def _decompress(self, entry: CompressedEntry) -> KVData:
        inner = CompressedEntry("kivi", 0.0, entry.arrays, entry.meta["kivi"])
        return self.kivi._decompress(inner)

    def estimate_nbytes(self, kv: KVData, rate: float) -> int:
        return self._pick(kv, rate)[1]
