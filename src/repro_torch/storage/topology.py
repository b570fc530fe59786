"""StorageTopology: who owns each tier and how directions share bandwidth.

The PR-2 hierarchy was topology-blind: one global DRAM tier over one SSD
tier, each with an independent (full-duplex) read/write channel pair.
Real multi-host deployments look different — every serving replica has
its *own* DRAM (KV bytes in host memory are only cheap for the replica
holding them), while the slow tier (disaggregated SSD / blob store) is
shared, and an SSD's read and write directions draw from one bandwidth
budget (half-duplex).

``StorageTopology`` makes that structure explicit and is consumed by all
four layers:

  * ``storage``  — tier identity becomes ``(level, replica)``; per-replica
    DRAM tiers are named ``dram:0 .. dram:{N-1}`` (level 0), the shared
    SSD stays ``ssd`` (level 1);
  * ``core.policy`` — MCKP placement choices expand from
    {DRAM, SSD, evict} x codec to *per-replica* DRAM placements: placing
    an entry in a sibling replica's DRAM prices in the replica-to-replica
    copy every cross-replica hit will pay;
  * ``core.controller`` — fetches from another replica's DRAM report the
    cross-link delay and count as remote hits; promotions target a
    specific replica's DRAM;
  * ``serving.engine`` — each replica gets its own DRAM read/write
    channels, and when ``duplex_ssd=False`` the SSD's reads, write-backs
    and prefetches all arbitrate in ONE shared-budget queue.

The degenerate ``StorageTopology()`` (one replica, shared DRAM, duplex
SSD) reproduces the PR-2 tier names and semantics exactly, so existing
benchmarks and tests keep their meaning.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

FAST_LEVEL = "dram"
SLOW_LEVEL = "ssd"


@dataclasses.dataclass(frozen=True)
class StorageTopology:
    """Shape of the storage hierarchy seen by policy + engine.

    ``replicas``     number of serving replicas (engine instances).
    ``shared_dram``  True: one global DRAM tier named ``dram`` (the PR-2
                     model); False: one DRAM tier per replica, named
                     ``dram:<r>`` — capacity multiplies with replicas
                     because each host brings its own memory.
    ``duplex_ssd``   True: SSD read and write directions have independent
                     channels (PR-2); False: both directions share one
                     bandwidth budget (a single ``IOChannel`` pool).
    ``xlink_bps``    replica-to-replica copy bandwidth: the price a hit
                     pays when the entry lives in a *sibling* replica's
                     DRAM (NIC/interconnect, not PCIe).
    ``xlink_latency_s``  per-copy latency of that link.

    Contract: the topology is immutable (frozen dataclass) and purely
    descriptive — it books no time and owns no bytes. Bandwidths are
    BYTES/SECOND, latencies SECONDS, ``cross_delay_s`` returns seconds for
    a stored-byte count; naming/identity helpers are total functions
    over the tier names they themselves generate and raise ValueError
    on anything else.
    """

    replicas: int = 1
    shared_dram: bool = True
    duplex_ssd: bool = True
    xlink_bps: float = 8e9
    xlink_latency_s: float = 25e-6

    def __post_init__(self):
        if self.replicas < 1:
            raise ValueError("topology needs at least one replica")
        if self.xlink_bps <= 0:
            raise ValueError("xlink_bps must be positive")

    # -- tier naming --------------------------------------------------------
    @property
    def dram_names(self) -> List[str]:
        if self.shared_dram:
            return [FAST_LEVEL]
        return [f"{FAST_LEVEL}:{r}" for r in range(self.replicas)]

    @property
    def tier_names(self) -> List[str]:
        return self.dram_names + [SLOW_LEVEL]

    def dram_for(self, replica: int) -> str:
        """Name of the DRAM tier local to ``replica``."""
        if self.shared_dram:
            return FAST_LEVEL
        if not 0 <= replica < self.replicas:
            raise ValueError(f"replica {replica} outside topology "
                             f"({self.replicas} replicas)")
        return f"{FAST_LEVEL}:{replica}"

    # -- tier identity ------------------------------------------------------
    @staticmethod
    def ident(tier_name: str) -> Tuple[int, Optional[int]]:
        """``(level, replica)``: level 0 = DRAM, 1 = SSD; replica is None
        for shared tiers (global DRAM, the SSD)."""
        if tier_name == SLOW_LEVEL:
            return 1, None
        if tier_name == FAST_LEVEL:
            return 0, None
        level, _, rep = tier_name.partition(":")
        if level != FAST_LEVEL or not rep.isdigit():
            raise ValueError(f"unknown tier name {tier_name!r}")
        return 0, int(rep)

    @classmethod
    def level(cls, tier_name: str) -> int:
        return cls.ident(tier_name)[0]

    @classmethod
    def replica_of(cls, tier_name: str) -> Optional[int]:
        return cls.ident(tier_name)[1]

    def next_tier(self, tier_name: str) -> Optional[str]:
        """Demotion target: every DRAM tier demotes to the shared SSD;
        the SSD demotes to nothing (eviction)."""
        return SLOW_LEVEL if self.level(tier_name) == 0 else None

    def is_local_hit(self, tier_name: str, replica: Optional[int]) -> bool:
        """A hit is local when the tier is shared (global DRAM, SSD) or
        owned by the fetching replica."""
        owner = self.replica_of(tier_name)
        return owner is None or replica is None or owner == replica

    # -- cross-replica pricing ---------------------------------------------
    def cross_delay_s(self, nbytes: int) -> float:
        """Delay of copying an entry from a sibling replica's DRAM."""
        return self.xlink_latency_s + nbytes / self.xlink_bps

    # -- degenerate check ---------------------------------------------------
    @property
    def is_degenerate(self) -> bool:
        """True when this topology is exactly the PR-2 model."""
        return self.shared_dram and self.duplex_ssd
