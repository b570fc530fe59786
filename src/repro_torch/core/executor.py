"""AdaptCache Executor (paper §2): applies policy decisions to the tiers.

Owns the mechanical half of the system: compressing entries, moving bytes
between tiers, evicting, and keeping lightweight *shape proxies* so the
policy can evaluate candidate states without touching stored bytes.
"""
from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.compression.base import (
    CompressedEntry, CompressionMethod, KVData,
)
from repro_torch.core.entry import EntryMeta
from repro_torch.core.policy import Move, Placement
from repro_torch.storage.tier import Tier


def shape_proxy(kv: KVData) -> KVData:
    """Zero-storage stand-in with identical shapes/dtypes (for estimates)."""
    return {k: np.broadcast_to(np.zeros((), a.dtype), a.shape)
            for k, a in kv.items()}


class Executor:
    def __init__(self, methods: Dict[str, CompressionMethod],
                 tiers: Dict[str, Tier], tier_order):
        self.methods = methods
        self.tiers = tiers
        self.tier_order = list(tier_order)
        self.proxies: Dict[str, KVData] = {}
        self.stats = {"recompress": 0, "demote": 0, "evict": 0,
                      "promote": 0, "bytes_moved": 0}
        # per-tier resident index, maintained on every placement
        # mutation (store/promote/apply): key -> live EntryMeta. Replaces
        # the controller's full meta scan for candidate listing, and the
        # SimSanitizer audits it against meta + tier inventories.
        self.tier_index: Dict[str, Dict[str, EntryMeta]] = {
            name: {} for name in tiers}
        # per-tenant resident-byte ledger: tier -> tenant -> stored
        # bytes, updated at every placement mutation alongside the tier
        # index (untenanted entries bucket under ""). Quota enforcement
        # reads it instead of scanning meta; the SimSanitizer audits it
        # against the per-tier inventories after every event.
        self.tenant_ledger: Dict[str, Dict[str, int]] = {
            name: {} for name in tiers}
        self._seq = itertools.count()

    # -- per-tier index -------------------------------------------------------
    def _index_move(self, meta: EntryMeta, old_tier: Optional[str]) -> None:
        if old_tier is not None:
            self.tier_index.get(old_tier, {}).pop(meta.key, None)
        if meta.tier is not None:
            self.tier_index.setdefault(meta.tier, {})[meta.key] = meta

    # -- per-tenant ledger ----------------------------------------------------
    def _ledger_move(self, meta: EntryMeta, old_tier: Optional[str],
                     old_nbytes: int) -> None:
        """Mirror a placement mutation into the tenant ledger: remove
        the entry's OLD bytes from its old tier bucket, add its current
        bytes to its current one (zeroed buckets are dropped so the
        ledger only lists live tenants)."""
        ten = meta.tenant or ""
        if old_tier is not None and old_nbytes:
            bucket = self.tenant_ledger.setdefault(old_tier, {})
            left = bucket.get(ten, 0) - old_nbytes
            if left:
                bucket[ten] = left
            else:
                bucket.pop(ten, None)
        if meta.tier is not None and meta.nbytes:
            bucket = self.tenant_ledger.setdefault(meta.tier, {})
            bucket[ten] = bucket.get(ten, 0) + meta.nbytes

    def tenant_resident_bytes(self, tenant: str) -> int:
        """The tenant's resident footprint summed across all tiers."""
        ten = tenant or ""
        return sum(bucket.get(ten, 0)
                   for bucket in self.tenant_ledger.values())

    def entries_in(self, tier_name: str) -> List[EntryMeta]:
        """Tier residents in insertion-sequence order — exactly the
        order the reference scan sees them in ``controller.meta`` (metas
        are never removed from that dict and re-inserts reuse the
        surviving meta, so seq order equals dict iteration order)."""
        return sorted(self.tier_index.get(tier_name, {}).values(),
                      key=lambda m: m.seq)

    def iter_entries(self, tier_name: str) -> List[EntryMeta]:
        """Tier residents without the seq sort, for rankings that impose
        their own total order (candidate top-k selection)."""
        return list(self.tier_index.get(tier_name, {}).values())

    # -- store ---------------------------------------------------------------
    def store(self, meta: EntryMeta, kv: KVData, placement: Placement) -> int:
        if meta.seq < 0:
            meta.seq = next(self._seq)
        m = self.methods[placement.method]
        entry = m.compress(kv, placement.rate)
        nb = self.tiers[placement.tier].put(meta.key, entry)
        old_tier, old_nb = meta.tier, meta.nbytes
        meta.tier = placement.tier
        meta.method = placement.method
        meta.rate = entry.rate
        meta.nbytes = nb
        self._index_move(meta, old_tier)
        self._ledger_move(meta, old_tier, old_nb)
        self.proxies[meta.key] = shape_proxy(self._decompressed_view(entry, m))
        return nb

    def _decompressed_view(self, entry: CompressedEntry,
                           m: CompressionMethod) -> KVData:
        """Shapes of the entry after decompression, without decompressing.

        For drop-based methods the kept-token count lives in the stored
        arrays themselves; we reconstruct shape-only views cheaply."""
        if entry.method == "none":
            return dict(entry.arrays)
        if entry.method == "streaming_llm":
            return dict(entry.arrays)
        # kivi / drop_kivi: meta["shape"] holds decompressed shapes
        meta_shape = entry.meta["kivi"]["shape"] if "kivi" in entry.meta \
            else entry.meta["shape"]
        out = {k: np.broadcast_to(np.zeros((), np.float32), s)
               for k, s in meta_shape.items()}
        if "positions" in entry.arrays:
            out["positions"] = entry.arrays["positions"]
        return out

    # -- fetch ---------------------------------------------------------------
    def fetch(self, meta: EntryMeta) -> Tuple[KVData, CompressedEntry]:
        tier = self.tiers[meta.tier]
        entry = tier.get(meta.key)
        kv = self.methods[meta.method].decompress(entry)
        return kv, entry

    # -- promotion (speculative prefetch) ------------------------------------
    def promote(self, meta: EntryMeta, dst_name: str) -> int:
        """Move an entry's bytes from its current tier into ``dst_name``
        (a faster tier) without changing its compression state; returns
        the bytes written into the destination."""
        src = self.tiers[meta.tier]
        entry = src.get(meta.key)
        src.evict(meta.key)
        self.tiers[dst_name].put(meta.key, entry)
        old_tier = meta.tier
        meta.tier = dst_name
        self._index_move(meta, old_tier)
        self._ledger_move(meta, old_tier, meta.nbytes)
        self.stats["promote"] += 1
        self.stats["bytes_moved"] += entry.nbytes
        return entry.nbytes

    # -- moves ---------------------------------------------------------------
    def apply(self, move: Move, meta: EntryMeta) -> Optional[str]:
        """Returns the name of a tier whose capacity may now be violated."""
        tier = self.tiers[move.tier]
        if move.kind == "evict":
            tier.evict(meta.key)
            old_tier, old_nb = meta.tier, meta.nbytes
            meta.tier = None
            meta.nbytes = 0
            self._index_move(meta, old_tier)
            self._ledger_move(meta, old_tier, old_nb)
            self.proxies.pop(meta.key, None)
            self.stats["evict"] += 1
            return None

        if move.kind == "demote":
            dst_name = move.dst_tier
            if dst_name is None:        # older Move producers: next tier
                t_idx = self.tier_order.index(move.tier)
                dst_name = self.tier_order[t_idx + 1]
            entry = tier.get(meta.key)
            tier.evict(meta.key)
            self.tiers[dst_name].put(meta.key, entry)
            old_tier = meta.tier
            meta.tier = dst_name
            self._index_move(meta, old_tier)
            self._ledger_move(meta, old_tier, meta.nbytes)
            self.stats["demote"] += 1
            self.stats["bytes_moved"] += entry.nbytes
            return meta.tier

        if move.kind == "recompress":
            entry = tier.get(meta.key)
            kv = self.methods[meta.method].decompress(entry)
            m = self.methods[move.method]
            new_entry = m.compress(kv, move.rate)
            tier.evict(meta.key)
            nb = tier.put(meta.key, new_entry)
            old_nb = meta.nbytes
            meta.method = move.method
            meta.rate = new_entry.rate
            meta.nbytes = nb
            self._ledger_move(meta, meta.tier, old_nb)
            self.proxies[meta.key] = shape_proxy(
                self._decompressed_view(new_entry, m))
            self.stats["recompress"] += 1
            return None

        raise ValueError(move.kind)
