"""SimSanitizer: opt-in runtime invariant checker for the event engine.

Enabled via ``ServingEngine(sanitize=True)``, ``--sanitize`` on the
serving driver, or ``SIMCHECK=1`` in the environment. The sanitizer is
STRICTLY read-only — it observes controller/tier/channel state and the
event stream and never mutates them — so a sanitized run is bit-for-bit
identical to an unsanitized one (CI proves this on the fig7 smoke
replay).

Invariants asserted (``SanitizerError`` names the offending event/key):

* **byte conservation** — after every event, each tier's ``used_bytes``
  equals the sum of its resident entries' stored sizes, and the
  controller's ``meta`` placement map agrees with tier inventories both
  ways. The controller's decision-vs-movement contract makes placement
  instantaneous (bytes land at decision time; the queued ``Transfer``
  only carries the TIME cost), so conservation is exact at every event
  — in-flight transfers contribute zero bytes by construction.
* **causality** — no event fires before the current simulated time
  (``EventLoop.pop`` consults ``on_pop`` before clamping its clock;
  ``EventLoop.push`` independently rejects past-time scheduling), and
  no channel's cumulative busy time ever decreases.
* **write fencing** — a fetch of a key whose bytes are still being
  written (insert write-back / demotion / promotion in flight) must not
  start before the write's completion time.
* **transfer accounting** — every booked ``Transfer`` is matched by
  exactly one ``EV_WRITE_DONE``; at end-of-run no transfer is leaked.
* **index consistency** — the executor's per-tier resident index (the
  incremental selector's ground set) agrees with ``controller.meta``
  and every tier inventory after every event.
* **tenant ledger** — the executor's per-tenant resident-byte ledger
  (the ground truth quota enforcement reads) agrees with a recount
  over the resident metas per (tier, tenant), and each tier's buckets
  sum to its ``used_bytes``, after every event.

Sanitized runs additionally arm the indexed selector's cross-check
(``IndexedSelector.crosscheck_every``): sampled ``pick_move`` calls
re-run the reference scan and assert the identical move — see
``repro_torch.core.selector`` and docs/perf.md.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

#: slack for float comparisons on simulated timestamps
EPS = 1e-9


class SanitizerError(AssertionError):
    """A simulation invariant was violated (message names the offender)."""


class SimSanitizer:
    """Read-only invariant checks over a running ``ServingEngine``.

    The engine wires the hooks; tests may also drive them directly
    (fault injection). ``event_names`` maps event-kind ints to strings
    for diagnostics (``repro_torch.serving.scheduler.EVENT_NAMES``).
    """

    def __init__(self, controller, event_names: Optional[Dict[int, str]]
                 = None):
        self.controller = controller
        self.event_names = dict(event_names or {})
        self._channels: List[object] = []
        self._busy_s: Dict[int, float] = {}
        self._fences_s: Dict[str, float] = {}
        self._outstanding: Dict[str, int] = {}
        self.events_checked = 0
        self.violations = 0

    def _name(self, kind: int) -> str:
        return self.event_names.get(kind, f"kind={kind}")

    def _fail(self, msg: str) -> None:
        self.violations += 1
        raise SanitizerError(f"simcheck sanitizer: {msg}")

    # -- channel registration ------------------------------------------------
    def watch_channels(self, channels: Iterable[object]) -> None:
        """Track IOChannel/ComputeChannel objects: their ``busy_s``
        must never move backward."""
        for ch in channels:
            if id(ch) not in self._busy_s:     # half-duplex aliases once
                self._channels.append(ch)
                self._busy_s[id(ch)] = ch.busy_s

    # -- causality -----------------------------------------------------------
    def on_pop(self, now_s: float, when_s: float, kind: int) -> None:
        """Called by ``EventLoop.pop`` BEFORE the monotonic clamp."""
        if when_s < now_s - EPS:
            self._fail(
                f"event '{self._name(kind)}' fires at t={when_s:.9f} "
                f"before current sim time t={now_s:.9f} (scheduled in "
                f"the past)")

    # -- write fencing / transfer accounting --------------------------------
    def note_write(self, key: str, done_s: float) -> None:
        """A write of ``key``'s bytes completes at ``done_s``."""
        self._fences_s[key] = max(self._fences_s.get(key, 0.0), done_s)

    def note_read(self, key: str, start_s: float) -> None:
        """A fetch of ``key`` starts its channel read at ``start_s``."""
        fence_s = self._fences_s.get(key, 0.0)
        if start_s < fence_s - EPS:
            self._fail(
                f"fetch of key '{key}' starts at t={start_s:.9f} before "
                f"the in-flight write it fences on completes at "
                f"t={fence_s:.9f} (unfenced read)")

    def note_transfer_booked(self, tr, done_s: float) -> None:
        self._outstanding[tr.key] = self._outstanding.get(tr.key, 0) + 1
        self.note_write(tr.key, done_s)

    def note_transfer_done(self, tr, now_s: float) -> None:
        n = self._outstanding.get(tr.key, 0)
        if n <= 0:
            self._fail(
                f"write_done for key '{tr.key}' ({tr.kind} -> "
                f"{tr.dst_tier}) without a matching booked transfer")
        self._outstanding[tr.key] = n - 1

    # -- per-event state audit ----------------------------------------------
    def after_event(self, now_s: float, kind: int) -> None:
        """Full conservation + channel-monotonicity audit, run after
        every handled event."""
        self.events_checked += 1
        ev = self._name(kind)
        placed: Dict[Tuple[str, str], int] = {}
        for key, meta in self.controller.meta.items():
            if meta.tier:
                placed[(meta.tier, key)] = meta.nbytes
        for tname, tier in self.controller.tiers.items():
            resident = {k: tier.entry_nbytes(k) for k in tier.keys()}
            total = sum(resident.values())
            if total != tier.used_bytes:
                self._fail(
                    f"after '{ev}' at t={now_s:.9f}: tier '{tname}' "
                    f"accounts used_bytes={tier.used_bytes} but resident "
                    f"entries sum to {total} (byte leak of "
                    f"{tier.used_bytes - total})")
            for k, nb in resident.items():
                want = placed.pop((tname, k), None)
                if want is None:
                    self._fail(
                        f"after '{ev}' at t={now_s:.9f}: tier '{tname}' "
                        f"holds key '{k}' the controller does not place "
                        f"there")
                elif want != nb:
                    self._fail(
                        f"after '{ev}' at t={now_s:.9f}: key '{k}' in "
                        f"tier '{tname}' stores {nb} bytes but the "
                        f"controller's meta says {want}")
        for (tname, k) in placed:
            self._fail(
                f"after '{ev}' at t={now_s:.9f}: controller places key "
                f"'{k}' in tier '{tname}' but the tier does not hold it")
        self._check_tier_index(now_s, ev)
        self._check_tenant_ledger(now_s, ev)
        for ch in self._channels:
            prev_s = self._busy_s[id(ch)]
            if ch.busy_s < prev_s - EPS:
                self._fail(
                    f"after '{ev}' at t={now_s:.9f}: channel "
                    f"'{getattr(ch, 'name', ch)}' busy time moved "
                    f"backward ({prev_s:.9f} -> {ch.busy_s:.9f})")
            self._busy_s[id(ch)] = ch.busy_s

    def _check_tier_index(self, now_s: float, ev: str) -> None:
        """Index-consistency invariant: the executor's per-tier resident
        index (the incremental placement selector's ground set) must
        agree with both ``controller.meta`` placements and each tier's
        inventory after every event — an index drifting out of sync
        would silently change selection decisions. Fault-injection
        controllers without an executor are exempt."""
        executor = getattr(self.controller, "executor", None)
        index = getattr(executor, "tier_index", None)
        if index is None:
            return
        for tname, tier in self.controller.tiers.items():
            indexed = index.get(tname, {})
            resident = set(tier.keys())
            if set(indexed) != resident:
                extra = sorted(set(indexed) - resident)
                missing = sorted(resident - set(indexed))
                self._fail(
                    f"after '{ev}' at t={now_s:.9f}: tier '{tname}' "
                    f"index disagrees with the tier inventory "
                    f"(index-only: {extra[:5]}, tier-only: {missing[:5]})")
            for k, m in indexed.items():
                if self.controller.meta.get(k) is not m:
                    self._fail(
                        f"after '{ev}' at t={now_s:.9f}: tier '{tname}' "
                        f"index holds a stale meta object for key '{k}'")
                if m.tier != tname:
                    self._fail(
                        f"after '{ev}' at t={now_s:.9f}: key '{k}' sits "
                        f"in tier '{tname}' index but its meta says "
                        f"tier={m.tier!r}")

    def _check_tenant_ledger(self, now_s: float, ev: str) -> None:
        """Per-tenant ledger invariant: the executor's per-tier tenant
        byte ledger must agree with a fresh recount over the resident
        metas after every event, and each tier's buckets must sum to
        its ``used_bytes`` — a drifting ledger would silently enforce
        the wrong quota against the wrong tenant. Fault-injection
        controllers without an executor ledger are exempt."""
        executor = getattr(self.controller, "executor", None)
        ledger = getattr(executor, "tenant_ledger", None)
        if ledger is None:
            return
        index = getattr(executor, "tier_index", None)
        for tname, tier in self.controller.tiers.items():
            want: Dict[str, int] = {}
            metas = (index.get(tname, {}).values() if index is not None
                     else (m for m in self.controller.meta.values()
                           if m.tier == tname))
            for m in metas:
                if m.nbytes:
                    ten = m.tenant or ""
                    want[ten] = want.get(ten, 0) + m.nbytes
            have = ledger.get(tname, {})
            for ten in sorted(set(want) | set(have)):
                label = ten or "<untenanted>"
                if want.get(ten, 0) != have.get(ten, 0):
                    self._fail(
                        f"after '{ev}' at t={now_s:.9f}: tenant "
                        f"'{label}' ledger in tier '{tname}' says "
                        f"{have.get(ten, 0)} bytes but resident entries "
                        f"sum to {want.get(ten, 0)} (tenant ledger "
                        f"leak)")
            total = sum(have.values())
            if total != tier.used_bytes:
                self._fail(
                    f"after '{ev}' at t={now_s:.9f}: tier '{tname}' "
                    f"tenant ledger sums to {total} bytes but the tier "
                    f"accounts used_bytes={tier.used_bytes}")

    # -- end-of-run ----------------------------------------------------------
    def finish(self, now_s: float) -> None:
        leaked = sorted(k for k, n in self._outstanding.items() if n > 0)
        if leaked:
            self._fail(
                f"end of run at t={now_s:.9f}: {len(leaked)} transfer(s) "
                f"booked but never completed (no EV_WRITE_DONE): "
                f"{', '.join(leaked[:5])}"
                f"{' ...' if len(leaked) > 5 else ''}")
