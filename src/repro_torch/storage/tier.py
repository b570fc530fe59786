"""Storage tiers for the KV cache hierarchy.

Two concrete tiers matching the paper's evaluation (DRAM + SSD) plus the
device spec abstraction so the same policy runs with TPU-host constants
(DESIGN.md §4). Realism requirements honored:

  * DRAMTier holds real numpy buffers (bytes are resident);
  * SSDTier serializes entries to real files (codec-framed, CRC-checked)
    under a spool directory — bytes genuinely leave memory;
  * delay accounting is a calibrated model (default: the paper's 1 GB/s
    disk; DRAM->device 16 GB/s PCIe-class) so benchmark numbers are
    host-independent, while ``measure=True`` uses actual wall-clock I/O.

``zstandard`` is an optional dependency: when absent, SSD frames fall
back to ``zlib``. The codec is recorded in each entry's header so frames
are self-describing regardless of which codec wrote them.
"""
from __future__ import annotations

import dataclasses
import os
import struct
import tempfile
import time
import zlib
from typing import Any, Dict, Iterable, Optional, Tuple

import numpy as np

try:                                    # optional transport codec
    import zstandard
except ImportError:                     # pragma: no cover - env dependent
    zstandard = None

from repro_torch.core.compression.base import CompressedEntry


@dataclasses.dataclass(frozen=True)
class DeviceSpec:
    name: str
    capacity_bytes: int
    read_bps: float          # bytes/s toward the accelerator
    write_bps: float
    latency_s: float = 0.0


# Paper constants: 100 GB DRAM, 400 GB SSD @ 1 GB/s (A100 box, §3).
PAPER_DRAM = DeviceSpec("dram", 100 << 30, 16e9, 16e9, 20e-6)
PAPER_SSD = DeviceSpec("ssd", 400 << 30, 1e9, 1e9, 100e-6)


class Tier:
    """Base tier: capacity accounting + load/store delay models.

    ``load_delay_s`` prices the read path (fetch toward the accelerator);
    ``store_delay_s`` prices the write path and is the service time the
    event engine books on the tier's write ``IOChannel`` for insert
    write-back, MCKP demotions, and prefetch promotions — writes queue
    and contend in simulated time instead of landing instantly.
    ``written_bytes`` counts every byte that entered the tier via
    ``put`` (write-traffic accounting — under a half-duplex topology
    these writes share the read direction's bandwidth budget).

    Tier identity is ``(level, replica)``: ``name`` follows the
    ``StorageTopology`` convention (``dram`` / ``dram:<r>`` / ``ssd``),
    so a per-replica DRAM tier knows which replica owns it and the
    shared SSD has no owner.
    """

    def __init__(self, spec: DeviceSpec, name: Optional[str] = None):
        self.spec = spec
        self.name = spec.name if name is None else name
        self.used_bytes = 0
        self.written_bytes = 0
        self._meta: Dict[str, Dict[str, Any]] = {}

    @property
    def identity(self) -> "Tuple[int, Optional[int]]":
        """``(level, replica)`` per the StorageTopology naming scheme."""
        from repro_torch.storage.topology import StorageTopology
        return StorageTopology.ident(self.name)

    @property
    def replica(self) -> Optional[int]:
        return self.identity[1]

    # -- delay model --------------------------------------------------------
    def load_delay_s(self, nbytes: int) -> float:
        return self.spec.latency_s + nbytes / self.spec.read_bps

    def store_delay_s(self, nbytes: int) -> float:
        return self.spec.latency_s + nbytes / self.spec.write_bps

    # -- inventory ----------------------------------------------------------
    def has(self, key: str) -> bool:
        return key in self._meta

    def keys(self) -> Iterable[str]:
        return self._meta.keys()

    def entry_nbytes(self, key: str) -> int:
        return self._meta[key]["nbytes"]

    def entry_info(self, key: str) -> Dict[str, Any]:
        return self._meta[key]

    @property
    def free_bytes(self) -> int:
        return self.spec.capacity_bytes - self.used_bytes

    def __len__(self) -> int:
        return len(self._meta)


class DRAMTier(Tier):
    def __init__(self, spec: DeviceSpec = PAPER_DRAM,
                 name: Optional[str] = None):
        super().__init__(spec, name=name)
        self._store: Dict[str, CompressedEntry] = {}

    def put(self, key: str, entry: CompressedEntry) -> int:
        if key in self._store:
            self.evict(key)
        nb = entry.nbytes
        self._store[key] = entry
        self._meta[key] = {"nbytes": nb, "method": entry.method,
                           "rate": entry.rate}
        self.used_bytes += nb
        self.written_bytes += nb
        return nb

    def get(self, key: str) -> CompressedEntry:
        return self._store[key]

    def evict(self, key: str) -> None:
        self.used_bytes -= self._meta.pop(key)["nbytes"]
        del self._store[key]


_MAGIC = b"ADKV"
_HEADER = struct.Struct("<BIQ")          # codec id, CRC32(raw), raw length
CODEC_ZLIB = 0
CODEC_ZSTD = 1


def _default_codec() -> int:
    return CODEC_ZSTD if zstandard is not None else CODEC_ZLIB


class SSDTier(Tier):
    """File-backed tier: one codec-framed, CRC-checked file per entry.

    Frames are zstd when ``zstandard`` is importable, zlib otherwise; the
    codec id in the header makes every frame self-describing.
    """

    def __init__(self, spec: DeviceSpec = PAPER_SSD,
                 root: Optional[str] = None, measure: bool = False,
                 codec: Optional[int] = None, name: Optional[str] = None):
        super().__init__(spec, name=name)
        self.root = root or tempfile.mkdtemp(prefix="adaptcache_ssd_")
        self.measure = measure
        self.codec = _default_codec() if codec is None else codec
        if self.codec == CODEC_ZSTD and zstandard is None:
            raise RuntimeError("zstd codec requested but zstandard is "
                               "not installed")
        if zstandard is not None:
            self._cctx = zstandard.ZstdCompressor(level=1)
            self._dctx = zstandard.ZstdDecompressor()
        os.makedirs(self.root, exist_ok=True)

    def _path(self, key: str) -> str:
        return os.path.join(self.root, key.replace("/", "_") + ".kv")

    def _frame(self, raw: bytes) -> bytes:
        if self.codec == CODEC_ZSTD:
            return self._cctx.compress(raw)
        return zlib.compress(raw, 1)

    def _unframe(self, codec: int, data: bytes, orig_len: int) -> bytes:
        if codec == CODEC_ZSTD:
            if zstandard is None:
                raise IOError("entry framed with zstd but zstandard is "
                              "not installed")
            return self._dctx.decompress(data, max_output_size=orig_len)
        if codec == CODEC_ZLIB:
            d = zlib.decompressobj()
            raw = d.decompress(data, orig_len)   # bound expansion
            if len(raw) != orig_len or d.unconsumed_tail:
                raise IOError("zlib frame length mismatch — corrupt SSD "
                              "page")
            return raw
        raise IOError(f"unknown SSD frame codec id {codec}")

    def put(self, key: str, entry: CompressedEntry) -> int:
        if key in self._meta:
            self.evict(key)
        raw = entry.tobytes()
        framed = self._frame(raw)
        crc = zlib.crc32(raw)
        path = self._path(key)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(_MAGIC)
            f.write(_HEADER.pack(self.codec, crc, len(raw)))
            f.write(framed)
        os.replace(tmp, path)                       # atomic
        # capacity accounting uses the LOGICAL entry size (policy view);
        # frame compression is transparent transport compression.
        nb = entry.nbytes
        self._meta[key] = {"nbytes": nb, "method": entry.method,
                           "rate": entry.rate, "meta": entry.meta,
                           "disk_bytes": len(framed) + 4 + _HEADER.size,
                           "path": path}
        self.used_bytes += nb
        self.written_bytes += nb
        return nb

    def get(self, key: str) -> CompressedEntry:
        info = self._meta[key]
        # measure=True times REAL host I/O (calibration aid), not
        # simulated time  # simcheck: ignore[wallclock]
        t0 = time.perf_counter()  # simcheck: ignore[wallclock]
        with open(info["path"], "rb") as f:
            assert f.read(4) == _MAGIC, f"corrupt frame for {key}"
            codec, crc, orig_len = _HEADER.unpack(f.read(_HEADER.size))
            raw = self._unframe(codec, f.read(), orig_len)
        if zlib.crc32(raw) != crc:
            raise IOError(f"CRC mismatch for entry {key} — corrupt SSD page")
        entry = CompressedEntry.frombytes(raw, info["method"], info["rate"],
                                          info["meta"])
        if self.measure:
            info["last_read_s"] = (time.perf_counter()  # simcheck: ignore[wallclock]
                                   - t0)
        return entry

    def evict(self, key: str) -> None:
        info = self._meta.pop(key)
        self.used_bytes -= info["nbytes"]
        try:
            os.unlink(info["path"])
        except FileNotFoundError:
            pass
