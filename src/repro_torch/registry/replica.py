"""Registry read-replicas — CDN-style regional fan-out for recordings.

A ``RegistryReadReplica`` fronts a primary ``RegistryService`` with a
regional chunk cache: the first fetch of a popular key in a region pulls
its chunks from the primary ONCE, every later fetch in that region is
served from the regional ``LRUBytes`` — the primary's
``stats['chunk_reads']`` stays flat no matter how many replicas boot
(the read-replica effectiveness test pins exactly that).

It duck-types the client-facing surface of ``RegistryService``
(``chunk_size`` / ``has`` / ``entry`` / ``find`` / ``ensure`` /
``read_chunk``), so a ``RegistryClient`` built against it needs no code
changes; writes (``ensure`` record-on-miss leases) pass through to the
primary — read-replicas replicate reads, never take leases themselves.

Integrity is unchanged: a regionally cached chunk is re-verified against
its content address on every hit (same rule as the store), and clients
still HMAC-verify the assembled recording before loading it — a
compromised regional cache can only cause a detected integrity error,
never bad replay bytes.

Counterpart of ``repro/registry/replica.py``.
"""
from __future__ import annotations

import collections
from typing import Optional

from repro_torch.attest.log import verify_consistency
from repro_torch.core.attest import SplitViewError
from repro_torch.registry.service import RegistryService
from repro_torch.registry.store import (LRUBytes, RegistryIntegrityError,
                                        chunk_digest)


class RegistryReadReplica:
    """One region's read path onto a primary registry service."""

    def __init__(self, primary: RegistryService, *, region: str,
                 cache_bytes: int = 32 << 20, metrics=None):
        self._primary = primary
        self.region = region
        self.cache = LRUBytes(cache_bytes, metrics=metrics, region=region)
        self.stats = collections.Counter()
        self._sth: Optional[dict] = None    # region-pinned {size, root}

    # ----------------------------------------------- read-path overrides --
    def read_chunk(self, digest: str) -> bytes:
        hit = self.cache.get(digest)
        if hit is not None:
            if chunk_digest(hit) != digest:    # re-verify EVERY read
                raise RegistryIntegrityError(
                    f"regional chunk {digest[:12]}... corrupted in "
                    f"'{self.region}' cache")
            return hit
        raw = self._primary.read_chunk(digest)
        self.cache.put(digest, raw)
        self.stats["chunk_pulls"] += 1
        self.stats["chunk_pull_bytes"] += len(raw)
        return raw

    # ------------------------------------------------ primary passthrough --
    @property
    def chunk_size(self) -> int:
        return self._primary.chunk_size

    def has(self, key: str) -> bool:
        return self._primary.has(key)

    def entry(self, key: str) -> dict:
        return self._primary.entry(key)

    def find(self, prefix: str):
        return self._primary.find(prefix)

    def ensure(self, key: str, record_fn=None) -> None:
        # record-on-miss is a WRITE: it goes to the primary's single-flight
        # lease; the resulting chunks then replicate here on first read
        self.stats["ensure_passthrough"] += 1
        return self._primary.ensure(key, record_fn)

    # --------------------------------------------------- transparency log --
    @property
    def keys(self):
        return self._primary.keys

    def proof_for(self, key: str) -> dict:
        """Relay the primary's proof bundle, CROSS-CHECKING it against the
        replica's own pinned tree head first: a primary that shows one
        log to region A and another to region B (a split view across
        regions) is caught at the replica, before any client in the
        region sees the forked head."""
        bundle = self._primary.proof_for(key)
        head = bundle["head"]
        if self._sth is not None and self._sth["size"] > 0:
            old_size, old_root = self._sth["size"], self._sth["root"]
            if head["size"] < old_size:
                raise SplitViewError(
                    f"primary log shrank ({old_size} -> {head['size']}) "
                    f"behind region '{self.region}'")
            cp = self._primary.consistency_between(old_size, head["size"])
            if not verify_consistency(old_size, old_root, head["size"],
                                      head["root"], cp["proof"]):
                raise SplitViewError(
                    f"primary served region '{self.region}' a forked log: "
                    f"consistency {old_size} -> {head['size']} failed")
        self._sth = {"size": head["size"], "root": head["root"]}
        self.stats["proofs_relayed"] += 1
        return bundle

    def consistency_between(self, old_size: int, new_size: int) -> dict:
        return self._primary.consistency_between(old_size, new_size)

    # ---------------------------------------------------------- reporting --
    def summary(self) -> dict:
        return {"region": self.region,
                "chunk_pulls": int(self.stats["chunk_pulls"]),
                "chunk_pull_bytes": int(self.stats["chunk_pull_bytes"]),
                "ensure_passthrough": int(self.stats["ensure_passthrough"]),
                "proofs_relayed": int(self.stats["proofs_relayed"]),
                "cache": self.cache.summary()}


__all__ = ["RegistryReadReplica"]
