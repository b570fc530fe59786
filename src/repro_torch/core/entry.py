"""Per-entry metadata tracked by the AdaptCache controller."""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class EntryMeta:
    key: str
    task_type: str
    n_tokens: int
    orig_bytes: int
    redundancy: float               # estimator feature in [0, 1]
    created_at: float
    # current placement
    tier: Optional[str] = None      # "dram" | "dram:<r>" | "ssd" | None
    method: str = "none"
    rate: float = 1.0
    nbytes: int = 0
    # locality: the replica whose requests created (and mostly hit) this
    # entry — per-replica DRAM placement prices cross-replica copies for
    # any other replica's DRAM; None means topology-blind (shared DRAM)
    home_replica: Optional[int] = None
    # owning tenant name: per-tenant resident-byte ledgers and quota
    # enforcement key off it; None = untenanted (single-tenant runs)
    tenant: Optional[str] = None
    # stats
    hits: int = 0
    last_hit: float = 0.0
    # monotone insertion sequence, assigned by the executor on first
    # store and stable across re-inserts (the surviving meta keeps its
    # dict position): heap tie-breaks on it reproduce the reference
    # scan's first-seen-wins ordering exactly
    seq: int = -1
