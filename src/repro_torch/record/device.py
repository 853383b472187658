"""DeviceProxy — the "hardware" half of the CODY recording session.

Counterpart of ``repro/record/device.py``.  The paper's record phase is
two-party: the mobile device owns the GPU
*hardware*, the cloud dryrun service owns the GPU *software* stack.  The
DeviceProxy models the device side of that split: it executes committed
register-access batches in program order (it IS the ``CommitQueue``
channel), holds the readback values the driver observes, and mirrors the
state the cloud syncs down after each GPU job — either a full memory image
(naive) or a metastate-only compressed delta (paper §5).

Register semantics mirror the paper's Mali trace classes:

  * ordinary registers read back a stable per-site value (speculatable —
    the paper's "constant across jobs" class);
  * ``latest_flush_id`` advances on every read (the paper's documented
    non-speculatable register: history never converges, so the speculator
    correctly falls back to a blocking commit for it);
  * polls execute device-side and return the loop trip count (§4.3).

``snapshot()/restore()`` are the metastate-only checkpoints speculation
rolls back to on a mispredict (§4.2 / §7.3).
"""
from __future__ import annotations

import collections
import zlib
from typing import Any, Dict

from repro_torch.core.metasync import DeltaSync

POLL_TRIPS = 3


def stable_register_value(site: str) -> int:
    """Deterministic per-register readback (hash() is process-salted)."""
    return zlib.crc32(site.encode()) % 997


class DeviceProxy:
    """Executes the device side of a recording session."""

    def __init__(self):
        self.regs: Dict[str, Any] = {}
        self.flush_id = 0
        self.exec_log = []                 # (kind, site) in committed order
        self.meta_mirror: Dict[str, Any] = {}   # metastate-delta syncs (§5)
        self.state_mirror = None                # full-image syncs (naive)
        self.jobs_synced = 0
        self.stats = collections.Counter()

    # ------------------------------------------------------- op execution --
    def channel(self, op) -> Any:
        """In-order executor for one committed ``deferral.Op``."""
        self.exec_log.append((op.kind, op.site))
        self.stats["ops"] += 1
        if op.kind == "write":
            self.regs[op.site] = op.payload
            return None
        if op.kind == "poll":
            self.stats["polls_offloaded"] += 1
            return POLL_TRIPS
        return self.read_value(op.site)

    def read_value(self, site: str) -> Any:
        if site in self.regs:
            return self.regs[site]
        if site.endswith("latest_flush_id"):
            self.flush_id += 1             # nondeterministic register class
            return self.flush_id
        return stable_register_value(site)

    # ----------------------------------------------- speculation rollback --
    def snapshot(self):
        """Metastate-only checkpoint (cheap — regs + counters, never
        program data): what speculation restores on a mispredict."""
        return (dict(self.regs), self.flush_id)

    def restore(self, snap) -> None:
        regs, flush_id = snap
        self.regs = dict(regs)
        self.flush_id = flush_id
        self.stats["rollbacks"] += 1

    # --------------------------------------------------------- state sync --
    def apply_full_sync(self, state) -> None:
        """Naive MemSync: the cloud ships the whole memory image."""
        self.state_mirror = state
        self.jobs_synced += 1
        self.stats["full_syncs"] += 1

    def apply_meta_sync(self, wire: bytes) -> None:
        """Metastate-only delta sync: unpack against the mirrored base —
        the device-side half of ``metasync.DeltaSync`` (§5)."""
        self.meta_mirror = DeltaSync.unpack(wire, self.meta_mirror)
        self.jobs_synced += 1
        self.stats["meta_syncs"] += 1


class FlakyRegisterDevice(DeviceProxy):
    """Test double: one register returns ``value_a`` for the first
    ``flip_after`` reads, then ``value_b`` — builds a predictable history
    and then breaks it, forcing a speculation mispredict + rollback."""

    def __init__(self, site: str, flip_after: int,
                 value_a: int = 1, value_b: int = 2):
        super().__init__()
        self._site = site
        self._flip_after = flip_after
        self._values = (value_a, value_b)
        self._reads = 0

    def read_value(self, site: str) -> Any:
        if site == self._site:
            self._reads += 1
            return self._values[self._reads > self._flip_after]
        return super().read_value(site)


__all__ = ["DeviceProxy", "FlakyRegisterDevice", "POLL_TRIPS",
           "stable_register_value"]
