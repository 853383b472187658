"""Recording registry: content-addressed store + collaborative
record-on-miss service + netem-billed device client (counterpart of
``repro/registry``).

Recordings are produced once in the trusted cloud (CODY §3) and replayed
by fleets of clients; this package is the distribution layer between
``recorder.record()`` and ``Replayer.load``:

    store.py    content-addressed chunk store, signed index, LRU cache, GC
    service.py  fetch-by-key, single-flight record-on-miss, delta publish
    client.py   chunked resumable fetch over NetworkEmulator, verify-then-
                replay handoff into Replayer/Engine
    replica.py  regional read-replicas with chunk caches (CDN fan-out)

``key_for`` is THE recording identity: record, serve, and the replayer's
program cache all key by it (one helper instead of three naming schemes).
"""
from __future__ import annotations

from repro_torch.core.attest import SplitViewError, fingerprint
from repro_torch.registry.client import FetchInterrupted, RegistryClient
from repro_torch.registry.replica import RegistryReadReplica
from repro_torch.registry.service import (RegistryService, VariantLeaseSet,
                                          parts_to_recording_bytes,
                                          recording_to_parts)
from repro_torch.registry.store import (LRUBytes, RecordingStore,
                                        RegistryIntegrityError,
                                        RegistryMissError)


def key_arch(arch: str) -> str:
    """Canonical architecture id.  Smoke-shrunk configs record AND replay
    under the base arch name (both sides shrink identically), so the
    ``-smoke`` suffix is identity-irrelevant and stripped here — this is
    the one place that normalization lives."""
    return arch[:-len("-smoke")] if arch.endswith("-smoke") else arch


def key_for(arch: str, kind: str, shapes, mesh_fp: str) -> str:
    """Canonical registry key for a recording: one key scheme shared by
    the record launcher (publish), the serve launcher (fetch), and the
    replayer's program cache (load name).

    ``shapes`` is any JSON-serializable description of the recorded
    shapes/static config (e.g. a manifest's static meta); ``mesh_fp``
    fingerprints the mesh the program was recorded for.
    """
    return f"{key_arch(arch)}/{kind}/{fingerprint(shapes, mesh_fp)[:16]}"


__all__ = [
    "FetchInterrupted", "LRUBytes", "RecordingStore", "RegistryClient",
    "RegistryIntegrityError", "RegistryMissError", "RegistryReadReplica",
    "RegistryService", "SplitViewError", "VariantLeaseSet", "key_arch",
    "key_for", "parts_to_recording_bytes", "recording_to_parts",
]
