"""Device time model: maps workload shapes to serving-device compute time.

The benchmarks run smoke-scale models on CPU, so wall-clock is not
representative; TTFT accounting uses this calibrated analytic model at the
FULL architecture scale (the paper's A100 + Llama-3.1-8B by default, TPU
v5e constants available for the dry-run configs).

    prefill_s(T)  = 2 * N_active * T / (peak_flops * mfu)
    decode_step_s(B, T_ctx) = max(flops-bound, HBM-bound KV+weight reads)

``IOChannel`` adds the per-tier I/O *service* model used by the
event-driven engine: each storage device exposes a fixed number of
parallel streams at a fixed bandwidth, and loads queue FIFO behind the
earliest-free stream. DRAM exposes many streams (concurrent loads are
near-free), an SSD exposes one (loads serialize at 1 GB/s) — this is
what makes overlapping loads against decode worth measuring.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class DeviceModel:
    name: str
    peak_flops: float          # /s
    hbm_bps: float              # bytes/s
    mfu_prefill: float = 0.45
    mfu_decode: float = 0.08


A100 = DeviceModel("a100", 312e12, 2.0e12)
TPU_V5E = DeviceModel("tpu_v5e", 197e12, 819e9)


@dataclasses.dataclass
class TimeModel:
    cfg: ModelConfig                  # FULL-scale architecture
    device: DeviceModel
    n_active_params: int

    def prefill_s(self, n_tokens: int) -> float:
        flops = 2.0 * self.n_active_params * n_tokens
        return flops / (self.device.peak_flops * self.device.mfu_prefill)

    def decode_step_s(self, batch: int, ctx_tokens: int,
                      kv_bytes_per_token: float = None) -> float:
        kvb = (self.cfg.kv_bytes_per_token()
               if kv_bytes_per_token is None else kv_bytes_per_token)
        flops = 2.0 * self.n_active_params * batch
        t_flops = flops / (self.device.peak_flops * self.device.mfu_decode)
        # weights read once per step + per-seq KV reads
        read_bytes = 2.0 * self.n_active_params + batch * ctx_tokens * kvb
        t_mem = read_bytes / self.device.hbm_bps
        return max(t_flops, t_mem)

    def chunk_prefill_s(self, n_new: int, n_past: int,
                        kv_bytes_per_token: float = None) -> float:
        """One Sarathi-style prefill chunk: ``n_new`` fresh tokens
        appended to an ``n_past``-token cached prefix.

        Linear + attention FLOPs for the new tokens run at prefill MFU;
        on top, every chunk streams the already-cached prefix KV out of
        HBM once (cross-attention of the chunk against the prefix) —
        the per-chunk overhead that makes chunked prefill slightly more
        expensive in total than one monolithic pass, in exchange for
        interleaving with decode."""
        kvb = (self.cfg.kv_bytes_per_token()
               if kv_bytes_per_token is None else kv_bytes_per_token)
        flops = 2.0 * self.n_active_params * n_new
        t_flops = flops / (self.device.peak_flops * self.device.mfu_prefill)
        t_mem = (n_past * kvb) / self.device.hbm_bps
        return t_flops + t_mem


# ---------------------------------------------------------------------------
# I/O service model (event-driven engine)
# ---------------------------------------------------------------------------

class IOChannel:
    """FIFO bandwidth queue for one storage device.

    ``submit(now, nbytes)`` books a transfer onto the earliest-free of
    ``concurrency`` parallel streams and returns its completion time; a
    stream busy past ``now`` queues the transfer behind the in-flight one.
    Shared across engine replicas, so replicas contend for the same SSD.
    Every byte movement in the engine arbitrates here — serving fetches,
    per-page partial-prefix loads, insert write-backs, MCKP moves, and
    the speculative prefetch / page-readahead promotions (which check
    ``queue_depth`` first so background traffic rides idle time only).
    """

    def __init__(self, name: str, bandwidth_bps: float, latency_s: float,
                 concurrency: int = 1):
        if concurrency < 1:
            raise ValueError("IOChannel needs at least one stream")
        self.name = name
        self.bandwidth_bps = bandwidth_bps
        self.latency_s = latency_s
        self._free_at: List[float] = [0.0] * concurrency
        self.busy_s = 0.0               # total occupied stream-seconds

    def book_service(self, now: float, service_s: float
                     ) -> "Tuple[float, float]":
        """Book an externally-priced service time (e.g. a tier's
        ``store_delay_s``) and return ``(start, done)``: queue wait is
        ``start - now``, pure transfer time is ``done - start``."""
        i = min(range(len(self._free_at)), key=self._free_at.__getitem__)
        start = max(now, self._free_at[i])
        self._free_at[i] = start + service_s
        self.busy_s += service_s
        return start, start + service_s

    def book(self, now: float, nbytes: int) -> "Tuple[float, float]":
        return self.book_service(now, self.latency_s
                                 + nbytes / self.bandwidth_bps)

    def submit(self, now: float, nbytes: int) -> float:
        return self.book(now, nbytes)[1]

    def queue_depth(self, now: float) -> int:
        return sum(1 for t in self._free_at if t > now)

    def next_free(self, now: float) -> float:
        """Earliest sim time a new booking could start (peek, no book)."""
        return max(now, min(self._free_at))


def build_tier_channels(tiers, io_streams, duplex_for):
    """(read, write) ``IOChannel`` maps for a tier dict.

    ``duplex_for(name)`` decides the direction model per tier: duplex
    tiers get an independent write channel (the PR-2 model); half-duplex
    tiers REUSE the read channel object for writes, so reads,
    write-backs, and prefetch transfers all queue on one shared
    bandwidth budget — the single-queue arbitration real SSDs impose.
    ``io_streams`` is keyed by tier name with a level-prefix fallback
    (``dram:1`` falls back to the ``dram`` entry).
    """
    def streams(name: str) -> int:
        return io_streams.get(name,
                              io_streams.get(name.partition(":")[0], 1))

    channels, wchannels = {}, {}
    for name, tier in tiers.items():
        rc = IOChannel(name, tier.spec.read_bps, tier.spec.latency_s,
                       streams(name))
        if duplex_for(name):
            wc = IOChannel(f"{name}_w", tier.spec.write_bps,
                           tier.spec.latency_s, streams(name))
        else:
            wc = rc                      # one pool, both directions
        channels[name], wchannels[name] = rc, wc
    return channels, wchannels


class ComputeChannel:
    """Single-stream FIFO for a replica's compute.

    Two roles: the legacy dedicated prefill stream (prefills queue behind
    each other but never behind decode), and — in chunked-prefill mode —
    the replica's UNIFIED compute channel, where decode ticks and prefill
    chunks book the same single stream, so prefill chunks interleave with
    decode steps instead of running on a phantom second accelerator."""

    def __init__(self, name: str):
        self.name = name
        self._free_at = 0.0
        self.busy_s = 0.0

    def book(self, now: float, service_s: float) -> "Tuple[float, float]":
        """Book ``service_s`` of compute; returns ``(start, done)`` —
        queue wait is ``start - now``."""
        start = max(now, self._free_at)
        self._free_at = start + service_s
        self.busy_s += service_s
        return start, self._free_at

    def submit(self, now: float, service_s: float) -> float:
        return self.book(now, service_s)[1]
