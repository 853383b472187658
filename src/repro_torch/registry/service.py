"""Registry service — the CODY cloud side of the recording registry.

Responsibilities:
  * fetch-by-key: reassemble a published recording from the
    content-addressed store (integrity re-verified by the store);
  * record-on-miss with SINGLE-FLIGHT leases: N concurrent clients
    requesting the same (arch, kind, shapes, mesh) key trigger exactly one
    ``recorder.record()`` — the first requester takes the lease and
    records, the rest block on it and reuse the published result (the
    whole point of record-once/replay-everywhere: the expensive dryrun
    happens once per key, fleet-wide);
  * delta publishing: consecutive versions of a key go through one
    ``metasync.DeltaSync`` instance per key, so a re-record after a config
    tweak ships only the changed parts (typically manifest + signature —
    the payload chunks dedupe by content address in the store too).

Counterpart of ``repro/registry/service.py``: for the same ``Recording``
bytes its parts, publish wire bytes, log leaves, roots and proofs equal
the reference's.  A record-on-miss runs a ``repro_torch.record``
``RecordingSession``, whose export is the port's ``torch.export`` step.
"""
from __future__ import annotations

import collections
import inspect
import json
import threading
import time
from typing import Callable, Dict, Optional

import numpy as np

from repro_torch.attest.keys import KeySchedule
from repro_torch.attest.log import TransparencyLog, leaf_data
from repro_torch.attest.verifier import head_signable
from repro_torch.core import _msgpack
from repro_torch.core.attest import (AttestationError,
                                     TamperedRecordingError, fingerprint,
                                     verify)
from repro_torch.core.metasync import DeltaSync
from repro_torch.core.recording import Recording
from repro_torch.obs.trace import NULL, traced
from repro_torch.registry.store import (RecordingStore, RegistryMissError,
                                        split_chunks)


def recording_to_parts(rec: Recording, chunk_size: int) -> Dict[str, bytes]:
    """Recording -> ordered, path-keyed byte sections.  The payload is
    pre-split at chunk boundaries so a payload-local change invalidates
    only its own chunks (chunking the whole serialized blob would let a
    one-byte manifest edit shift — and re-address — every payload chunk)."""
    parts = {"manifest": _msgpack.packb(rec.manifest)}
    for i, chunk in enumerate(split_chunks(rec.payload, chunk_size)):
        parts[f"payload/{i:06d}"] = chunk
    parts["trees"] = rec.trees
    parts["signature"] = rec.signature.encode()
    return parts


def parts_to_recording_bytes(parts: Dict[str, bytes]) -> bytes:
    """Inverse of ``recording_to_parts`` — a wire-format recording blob
    (the caller still verifies its HMAC before trusting it)."""
    missing = [k for k in ("manifest", "trees", "signature")
               if k not in parts]
    if missing:
        raise RegistryMissError(f"incomplete parts, missing {missing}")
    try:
        manifest = _msgpack.unpackb(parts["manifest"])
        payload = b"".join(parts[k] for k in sorted(parts)
                           if k.startswith("payload/"))
        rec = Recording(manifest, payload, parts["trees"],
                        parts["signature"].decode())
    except Exception as e:
        raise TamperedRecordingError(f"unparseable registry parts: {e}")
    return rec.to_bytes()


class RegistryService:
    """Cloud registry front end over a ``RecordingStore``.

    ``record_profile`` selects the device<->cloud link a record-on-miss
    session runs over (None = in-process degenerate session): the paper's
    record phase is two-party, so a miss recorded for a wifi-attached
    device bills the distributed protocol's real round trips and bytes
    into the recording's manifest, and clients are charged that recorded
    cost on the cold fetch.
    """

    def __init__(self, store: RecordingStore, *, signing_key: bytes,
                 record_profile=None, record_passes="all", tracer=None,
                 keys: Optional[KeySchedule] = None):
        self._store = store
        self._key = signing_key
        self._record_profile = record_profile
        self._record_passes = record_passes
        self.tracer = tracer if tracer is not None else NULL
        self._delta: Dict[str, DeltaSync] = {}
        self._lock = threading.Lock()
        self._leases: Dict[str, threading.Event] = {}
        self.stats = collections.Counter()
        # transparency log over the index: one leaf per publish, heads
        # signed by the epoch key schedule (shared with clients through
        # the Workspace; a bare service derives one from the signing key
        # so directly-built service/client pairs agree at epoch 0)
        self.keys = keys if keys is not None else KeySchedule(signing_key)
        self.log = TransparencyLog()
        self._log_index: Dict[str, int] = {}    # key -> latest leaf index
        self._bootstrap_log()

    # --------------------------------------------------- transparency log --
    def _leaf_of(self, key: str, rec: Recording) -> dict:
        """The log leaf a publish of ``rec`` under ``key`` commits to.
        ``payload_digest`` doubles as the recording's executable
        fingerprint, so an offline verifier can bind a replay quote to
        this leaf without ever seeing the payload."""
        return {"key": key, "manifest_fp": fingerprint(rec.manifest),
                "payload_digest": fingerprint(rec.payload),
                "epoch": self.keys.epoch}

    def _append_leaf(self, leaf: dict) -> int:
        idx = self.log.append(leaf_data(leaf["key"], leaf["manifest_fp"],
                                        leaf["payload_digest"],
                                        leaf["epoch"]))
        self._log_index[leaf["key"]] = idx
        self.stats["log_appends"] += 1
        return idx

    def _bootstrap_log(self) -> None:
        """Rebuild the log view from a pre-populated store (a fresh
        service handle over an existing root): every entry's stored leaf
        re-appends in its original publish order, so proofs keep working
        across process restarts.  Clients pinned to heads of the ORIGINAL
        process only see consistent extensions as long as the rebuilt
        prefix matches — which it does when the store kept every key's
        latest leaf in index order."""
        rows = []
        for key in self._store.keys():
            att = (self._store.entry(key).get("meta") or {}).get("attest")
            if att:
                rows.append((int(att.get("index", 0)), att["leaf"]))
        for _idx, leaf in sorted(rows, key=lambda r: (r[0], r[1]["key"])):
            self._append_leaf(leaf)

    def _adopt(self, key: str) -> int:
        """Fold a key published through ANOTHER service handle on the
        shared store into this handle's log (read-modify-write stores
        merge entries across handles; the log view follows)."""
        att = (self._store.entry(key).get("meta") or {}).get("attest")
        if not att:
            raise AttestationError(
                f"'{key}' is in the store but was never published through "
                "the transparency log — refusing to serve a proof for it")
        return self._append_leaf(att["leaf"])

    def signed_head(self) -> dict:
        """The current signed tree head: ``{size, root, epoch,
        signature}``, signature epoch-bound under the key schedule."""
        size, root = self.log.size, self.log.root()
        return {"size": size, "root": root, "epoch": self.keys.epoch,
                "signature": self.keys.sign(
                    head_signable({"size": size, "root": root}))}

    def proof_for(self, key: str) -> dict:
        """Inclusion-proof bundle for ``key``'s latest published leaf
        against the current signed head: ``{key, leaf, index, head,
        path}``.  Served on every verified fetch."""
        if key not in self._log_index:
            self._adopt(key)
        idx = self._log_index[key]
        head = self.signed_head()
        self.stats["proofs_served"] += 1
        return {"key": key, "leaf": dict(self.log_leaf(idx)), "index": idx,
                "head": head,
                "path": self.log.inclusion_proof(idx, head["size"])}

    def log_leaf(self, index: int) -> dict:
        """Decode the raw leaf at ``index`` back into its field dict."""
        return json.loads(self.log.entries[index].decode())

    def consistency_between(self, old_size: int, new_size: int) -> dict:
        """Consistency proof between two signed tree sizes (clients call
        this with their pinned head's size on every later fetch)."""
        self.stats["consistency_proofs_served"] += 1
        return {"old_size": old_size, "new_size": new_size,
                "proof": self.log.consistency_proof(old_size, new_size)}

    def _run_record_fn(self, record_fn: Callable) -> Recording:
        """Run a record-on-miss through a ``RecordingSession`` when the
        callable accepts one (the CODY two-party record over the
        configured link); zero-arg record_fns keep working and record
        through the in-process degenerate session themselves."""
        try:
            takes_session = "session" in \
                inspect.signature(record_fn).parameters
        except (TypeError, ValueError):
            takes_session = False
        if not takes_session:
            return record_fn()
        from repro_torch.record import RecordingSession
        if self._record_profile is not None:
            session = RecordingSession.for_profile(
                self._record_profile, passes=self._record_passes,
                tracer=self.tracer)
        else:
            session = RecordingSession.local(passes=self._record_passes,
                                             tracer=self.tracer)
        with traced(self.tracer, "registry.record_session", "registry",
                    passes=str(self._record_passes)):
            rec = record_fn(session=session)
        self.stats["record_virtual_s"] += \
            session.report()["virtual_time_s"]
        return rec

    # ------------------------------------------------------------ publish --
    def publish(self, key: str, rec: Recording) -> dict:
        """Publish a SIGNED recording under ``key``; returns wire stats.
        ``wire_bytes`` is what a delta upload ships (DeltaSync: only parts
        whose digest changed since the last version of this key);
        ``full_bytes`` is the naive full publish."""
        if not rec.signature:
            raise ValueError("publish requires a signed recording "
                             "(call rec.sign_with(key) first)")
        if not verify(rec.signable(), rec.signature, self._key):
            raise TamperedRecordingError(
                f"refusing to publish '{key}': signature does not verify "
                "under the registry key")
        parts = recording_to_parts(rec, self._store.chunk_size)
        ds = self._delta.setdefault(key, DeltaSync())
        sent_before = ds.stats["leaves_sent"]
        with traced(self.tracer, "registry.publish", "registry", key=key):
            wire = ds.pack({p: np.frombuffer(b, np.uint8) for p, b in
                            parts.items()})
        # transparency-log leaf: committed to the tree AND stored in the
        # entry meta, so a fresh service handle over this store rebuilds
        # the same log (and a store-level swap that bypasses publish()
        # leaves the log pointing at the ORIGINAL bytes — exactly what
        # clients detect as a silent swap)
        leaf = self._leaf_of(key, rec)
        entry = self._store.put(key, parts, meta={
            "attest": {"leaf": leaf, "index": self.log.size},
            "name": rec.manifest.get("name", key),
            "static": rec.manifest.get("static", {}),
            # identity fields clients filter alternates by: a recording is
            # only substitutable on matching hardware and model config
            "topology": rec.manifest.get("topology", ""),
            "config_fingerprint": rec.manifest.get("config_fingerprint", ""),
            "record_wall_s": rec.manifest.get("record_wall_s", 0.0),
            # distributed-session record cost (zero for local records):
            # what a cold record-on-miss fetch bills on top of wall time
            "record_virtual_s": rec.manifest.get("record_virtual_s", 0.0),
            "published_s": time.time()})
        idx = self._append_leaf(leaf)
        self.stats["publishes"] += 1
        return {"key": key, "version": entry["version"],
                "full_bytes": sum(len(b) for b in parts.values()),
                "wire_bytes": len(wire),
                "parts_sent": ds.stats["leaves_sent"] - sent_before,
                "chunks_new": entry["chunks_new"],
                "chunks_reused": entry["chunks_reused"],
                "log_index": idx, "log_size": self.log.size,
                "root": self.log.root()}

    # -------------------------------------------------------------- fetch --
    def fetch_bytes(self, key: str) -> bytes:
        self.stats["fetches"] += 1
        return parts_to_recording_bytes(self._store.get(key))

    def ensure(self, key: str,
               record_fn: Optional[Callable[[], Recording]] = None) -> None:
        """Make ``key`` present, running ``record_fn`` under a
        single-flight lease on miss: concurrent missers block on the
        leaseholder's event and reuse the published result — exactly one
        record() per key no matter how many clients race.  Does NOT
        reassemble the recording (clients pull chunks themselves)."""
        with self._lock:
            # only the hit/lease decision happens under the global lock;
            # publishing/fetching must not serialize unrelated clients —
            # the store has its own lock
            if self._store.has(key):
                self.stats["hits"] += 1
                return
            lease = self._leases.get(key)
            if lease is None:
                lease = self._leases[key] = threading.Event()
                owner = True
            else:
                owner = False
        if not owner:
            self.stats["lease_waits"] += 1
            if self.tracer:
                self.tracer.instant("registry.lease_wait", "registry",
                                    key=key)
            lease.wait()
            if not self._store.has(key):
                raise RegistryMissError(
                    f"record-on-miss for '{key}' failed on the leaseholder")
            return
        try:
            if record_fn is None:
                raise RegistryMissError(
                    f"'{key}' not in registry and no record_fn provided")
            rec = self._run_record_fn(record_fn)
            if not rec.signature:
                rec.sign_with(self._key)
            self.stats["records"] += 1
            self.publish(key, rec)
        finally:
            with self._lock:
                self._leases.pop(key, None)
            lease.set()

    def get_or_record(self, key: str,
                      record_fn: Optional[Callable[[], Recording]] = None
                      ) -> bytes:
        self.ensure(key, record_fn)
        return self.fetch_bytes(key)

    # ------------------------------------------------- multi-variant lease --
    def variant_lease(self, group: str, keys) -> "VariantLeaseSet":
        """Multi-variant lease fan-out for recording campaigns.

        ``ensure()`` single-flights ONE key: N missers of the same key
        produce one record.  A campaign populating a key's shape variants
        wants the dual: N workers each claim a DIFFERENT variant and
        record concurrently.  The returned set's ``claim(key)`` takes the
        per-key lease under the same ``self._leases`` table ``ensure()``
        uses, so a plain client missing on a variant mid-campaign becomes
        a waiter on the campaign worker's lease — the two mechanisms
        compose instead of racing."""
        self.stats["variant_lease_groups"] += 1
        return VariantLeaseSet(self, group, list(keys))

    # ------------------------------------------------- store passthroughs --
    @property
    def chunk_size(self) -> int:
        return self._store.chunk_size

    def has(self, key: str) -> bool:
        return self._store.has(key)

    def entry(self, key: str) -> dict:
        return self._store.entry(key)

    def find(self, prefix: str):
        return self._store.find(prefix)

    def read_chunk(self, digest: str) -> bytes:
        return self._store.read_chunk(digest)


class VariantLeaseSet:
    """A campaign's claims over one key-group's variants.

    Each ``claim(key)`` either takes that key's single-flight lease (the
    SAME per-key ``threading.Event`` table ``RegistryService.ensure``
    blocks on, so concurrent plain missers become waiters of the
    campaign worker) or reports why not: ``"published"`` (someone already
    has it) / ``"leased"`` (another worker is recording it right now).
    ``complete(key, rec)`` publishes and releases; ``fail(key)`` releases
    without publishing, waking waiters into their own miss handling."""

    def __init__(self, service: RegistryService, group: str,
                 keys: list):
        self.service = service
        self.group = group
        self.keys = keys
        self.owned: set = set()
        self.stats = collections.Counter()

    def claim(self, key: str) -> Optional[str]:
        """Try to take ``key``'s lease.  Returns None on success, else
        the skip reason ("published" / "leased")."""
        svc = self.service
        with svc._lock:
            if svc._store.has(key):
                svc.stats["hits"] += 1
                self.stats["skipped_published"] += 1
                return "published"
            if key in svc._leases:
                self.stats["skipped_leased"] += 1
                return "leased"
            svc._leases[key] = threading.Event()
            self.owned.add(key)
        svc.stats["variant_claims"] += 1
        self.stats["claims"] += 1
        if svc.tracer:
            svc.tracer.instant("registry.variant_claim", "registry",
                               group=self.group, key=key)
        return None

    def _release(self, key: str) -> None:
        svc = self.service
        with svc._lock:
            lease = svc._leases.pop(key, None)
        self.owned.discard(key)
        if lease is not None:
            lease.set()

    def complete(self, key: str, rec: Recording) -> dict:
        """Publish the finished variant (delta-packed per key) and wake
        its waiters.  The lease is released even if publish raises —
        waiters then re-check the store and surface the miss themselves,
        exactly as ``ensure()``'s failure path behaves."""
        if key not in self.owned:
            raise KeyError(f"variant '{key}' is not leased by this "
                           f"campaign ('{self.group}')")
        try:
            if not rec.signature:
                rec.sign_with(self.service._key)
            out = self.service.publish(key, rec)
            self.service.stats["records"] += 1
            self.stats["completed"] += 1
            return out
        finally:
            self._release(key)

    def fail(self, key: str) -> None:
        """Give up a claimed variant without publishing (no-op for keys
        this set does not own)."""
        if key in self.owned:
            self.stats["failed"] += 1
            self._release(key)

    def outstanding(self) -> set:
        return set(self.owned)
