"""Content-addressed recording store — the registry's durable format.

A recording is stored as *parts* (named byte sections: manifest, payload
chunks, trees, signature), each split at ``chunk_size`` and addressed by
the SHA-256 of its raw bytes.  Chunks are zlib-compressed at rest and
deduplicated across recordings and versions: re-publishing a recording
whose payload did not change writes no new payload chunks, which is what
makes delta publishing (service.py) and delta fetching (client.py) cheap.

The index (registry key -> ordered chunk list + metadata) is HMAC-signed
with the registry key; the signature and every chunk digest are
re-verified on EVERY read — a flipped bit anywhere in the store surfaces
as ``RegistryIntegrityError`` (a ``TamperedRecordingError``), never as
silently corrupt replay bytes.

Backends: in-memory (``root=None``, used by benchmarks/tests) or a
filesystem directory (``root=path``: ``chunks/<aa>/<digest>`` +
``index.msgpack``), suitable as an on-disk registry mirror.

Counterpart of ``repro/registry/store.py``.  The index is framed by
``repro_torch.core._msgpack``, whose bytes are ``msgpack``'s, so chunk
digests, index bytes and index signatures equal the reference's for the
same parts, and either package opens a root the other wrote.
"""
from __future__ import annotations

import collections
import hashlib
import os
import threading
import time
import zlib
from typing import Dict, Iterable, List, Optional

from repro_torch.core import _msgpack
from repro_torch.core.attest import TamperedRecordingError, sign, verify

CHUNK_SIZE = 64 * 1024
_INDEX_FILE = "index.msgpack"


class RegistryIntegrityError(TamperedRecordingError):
    """Store content does not match its digests / index signature."""


class RegistryMissError(KeyError):
    """No recording published under this registry key."""


class LRUBytes:
    """Byte-budgeted LRU map of chunk digest -> raw chunk bytes.  Used as
    the client-side chunk cache (bounded so a device never holds more than
    ``max_bytes`` of recording chunks) and as the regional chunk cache of
    registry read-replicas.

    When a ``repro_torch.obs.metrics.Metrics`` registry is attached, every
    hit/miss/eviction also increments ``registry_cache_{hits,misses,
    evictions}`` counters under the given labels (e.g. ``scope="store"``
    or ``region="eu"``), so cache effectiveness is observable fleet-wide
    without reaching into each cache's local counter."""

    def __init__(self, max_bytes: int, *, metrics=None, **labels):
        self.max_bytes = max_bytes
        self._d: "collections.OrderedDict[str, bytes]" = \
            collections.OrderedDict()
        self.nbytes = 0
        self.stats = collections.Counter()
        self._metrics = metrics
        self._labels = labels

    def _count(self, event: str):
        self.stats[event] += 1
        if self._metrics is not None:
            self._metrics.counter(f"registry_cache_{event}",
                                  **self._labels).inc()

    def get(self, digest: str) -> Optional[bytes]:
        blob = self._d.get(digest)
        if blob is None:
            self._count("misses")
            return None
        self._d.move_to_end(digest)
        self._count("hits")
        return blob

    def put(self, digest: str, blob: bytes):
        if digest in self._d:
            self._d.move_to_end(digest)
            return
        self._d[digest] = blob
        self.nbytes += len(blob)
        while self.nbytes > self.max_bytes and len(self._d) > 1:
            _old, dropped = self._d.popitem(last=False)
            self.nbytes -= len(dropped)
            self._count("evictions")

    def summary(self) -> dict:
        """Pinned cache accounting for reports: budget, occupancy, and
        the hit/miss/eviction counters."""
        return {"max_bytes": self.max_bytes, "nbytes": self.nbytes,
                "entries": len(self._d),
                "hits": int(self.stats["hits"]),
                "misses": int(self.stats["misses"]),
                "evictions": int(self.stats["evictions"])}

    def __contains__(self, digest: str) -> bool:
        return digest in self._d

    def __len__(self) -> int:
        return len(self._d)


def chunk_digest(raw: bytes) -> str:
    return hashlib.sha256(raw).hexdigest()


def split_chunks(blob: bytes, chunk_size: int) -> List[bytes]:
    if not blob:
        return [b""]
    return [blob[i:i + chunk_size] for i in range(0, len(blob), chunk_size)]


class RecordingStore:
    """Chunked, deduplicated, integrity-checked map of
    registry key -> {part name -> bytes}."""

    def __init__(self, root: Optional[str] = None, *, key: bytes,
                 chunk_size: int = CHUNK_SIZE, cache_bytes: int = 0,
                 metrics=None):
        self._root = root
        self._key = key
        self.chunk_size = chunk_size
        self._lock = threading.Lock()
        self.cache = LRUBytes(cache_bytes, metrics=metrics,
                              scope="store") if cache_bytes > 0 else None
        self.stats = collections.Counter()
        self._mem_chunks: Dict[str, bytes] = {}
        self._entries: Dict[str, dict] = {}
        self._index_sig = ""
        self._index_mtime = None
        if root is not None:
            os.makedirs(os.path.join(root, "chunks"), exist_ok=True)
            self._load_index()
        if self._index_mtime is None:
            # no index on disk (or in-memory backend): create a fresh
            # signed one.  Opening an EXISTING root is a read, not a
            # mutation — rewriting here would clobber entries another
            # process published since our snapshot.
            self._resign_index()

    # ----------------------------------------------------------- index ----
    def _index_signable(self) -> bytes:
        return _msgpack.packb(sorted(self._entries.items()))

    def _resign_index(self):
        self._index_sig = sign(self._index_signable(), self._key)
        if self._root is not None:
            blob = _msgpack.packb(
                {"entries": self._entries, "signature": self._index_sig})
            tmp = os.path.join(self._root, _INDEX_FILE + ".tmp")
            with open(tmp, "wb") as f:
                f.write(blob)
            path = os.path.join(self._root, _INDEX_FILE)
            os.replace(tmp, path)
            self._index_mtime = os.stat(path).st_mtime_ns

    def _load_index(self):
        path = os.path.join(self._root, _INDEX_FILE)
        if not os.path.exists(path):
            return
        try:
            with open(path, "rb") as f:
                d = _msgpack.unpackb(f.read())
            self._entries = d.get("entries", {})
            self._index_sig = d.get("signature", "")
        except Exception as e:   # corrupted framing == tampering
            raise RegistryIntegrityError(f"unparseable registry index: {e}")
        self._index_mtime = os.stat(path).st_mtime_ns
        self._check_index()

    def _maybe_reload(self):
        """Pick up index changes another process wrote to a shared root
        (e.g. the record CLI publishing while a serve process holds the
        registry open).  Callers hold ``self._lock``.  This makes
        read-modify-write the rule for mutations, not last-writer-wins;
        truly simultaneous writers would still need file locking."""
        if self._root is None:
            return
        path = os.path.join(self._root, _INDEX_FILE)
        try:
            mtime = os.stat(path).st_mtime_ns
        except FileNotFoundError:
            return
        if mtime != self._index_mtime:
            self._load_index()

    def _check_index(self):
        if not verify(self._index_signable(), self._index_sig, self._key):
            raise RegistryIntegrityError("registry index signature invalid")

    # ---------------------------------------------------------- chunk IO ----
    def _chunk_path(self, digest: str) -> str:
        return os.path.join(self._root, "chunks", digest[:2], digest)

    def _write_chunk(self, digest: str, raw: bytes) -> int:
        """Store one chunk (zlib at rest); returns compressed size."""
        comp = zlib.compress(raw, 6)
        if self._root is None:
            self._mem_chunks[digest] = comp
        else:
            path = self._chunk_path(digest)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(comp)
            os.replace(tmp, path)
        return len(comp)

    def _has_chunk(self, digest: str) -> bool:
        if self._root is None:
            return digest in self._mem_chunks
        return os.path.exists(self._chunk_path(digest))

    def _stored_chunk_len(self, digest: str) -> int:
        """Compressed size of an already-stored chunk — the dedup path
        must not recompress just to learn the length."""
        if self._root is None:
            return len(self._mem_chunks[digest])
        return os.path.getsize(self._chunk_path(digest))

    def read_chunk(self, digest: str) -> bytes:
        """Fetch + decompress + RE-VERIFY one chunk (every read, not just
        the first: at-rest corruption must never reach the replayer)."""
        if self.cache is not None:
            hit = self.cache.get(digest)
            if hit is not None:
                if chunk_digest(hit) != digest:   # re-verify EVERY read
                    raise RegistryIntegrityError(
                        f"cached chunk {digest[:12]}... corrupted in memory")
                return hit
        if self._root is None:
            comp = self._mem_chunks.get(digest)
            if comp is None:
                raise RegistryMissError(f"chunk {digest[:12]}... not in store")
        else:
            path = self._chunk_path(digest)
            if not os.path.exists(path):
                raise RegistryMissError(f"chunk {digest[:12]}... not in store")
            with open(path, "rb") as f:
                comp = f.read()
        try:
            raw = zlib.decompress(comp)
        except zlib.error as e:
            raise RegistryIntegrityError(
                f"chunk {digest[:12]}... undecompressable: {e}")
        if chunk_digest(raw) != digest:
            raise RegistryIntegrityError(
                f"chunk {digest[:12]}... content does not match its address")
        if self.cache is not None:
            self.cache.put(digest, raw)
        self.stats["chunk_reads"] += 1
        return raw

    # ------------------------------------------------------------ public ----
    def put(self, key: str, parts: Dict[str, bytes],
            meta: Optional[dict] = None) -> dict:
        """Publish (or re-publish) a recording's parts under ``key``.
        Unchanged chunks are deduplicated by content address; the index
        entry is replaced and the version bumped."""
        with self._lock:
            self._maybe_reload()
            chunks, new, reused, total = [], 0, 0, 0
            for part, blob in parts.items():
                for seq, raw in enumerate(split_chunks(blob, self.chunk_size)):
                    d = chunk_digest(raw)
                    if self._has_chunk(d):
                        reused += 1
                        comp_len = self._stored_chunk_len(d)
                    else:
                        comp_len = self._write_chunk(d, raw)
                        new += 1
                    chunks.append({"part": part, "seq": seq, "d": d,
                                   "n": len(raw), "c": comp_len})
                    total += len(raw)
            prev = self._entries.get(key)
            entry = {"version": (prev["version"] + 1) if prev else 1,
                     "total": total, "chunks": chunks, "meta": meta or {}}
            self._entries[key] = entry
            self._resign_index()
            self.stats["puts"] += 1
            return {**entry, "chunks_new": new, "chunks_reused": reused}

    def entry(self, key: str) -> dict:
        with self._lock:
            self._maybe_reload()
            self._check_index()
            if key not in self._entries:
                raise RegistryMissError(key)
            return self._entries[key]

    def get(self, key: str) -> Dict[str, bytes]:
        """Reassemble all parts of ``key``, verifying the index signature
        and every chunk digest.  Chunks are read outside the lock, so a
        concurrent re-publish + gc can invalidate our entry snapshot
        mid-read — in that case the key is still live under a NEW entry,
        and one retry against the fresh snapshot resolves it."""
        for attempt in (0, 1):
            entry = self.entry(key)
            parts: Dict[str, List[bytes]] = {}
            try:
                for c in entry["chunks"]:
                    raw = self.read_chunk(c["d"])
                    if len(raw) != c["n"]:
                        raise RegistryIntegrityError(
                            f"chunk {c['d'][:12]}... length {len(raw)} != "
                            f"indexed {c['n']}")
                    parts.setdefault(c["part"], []).append(raw)
            except RegistryMissError:
                if attempt:
                    raise
                continue
            self.stats["gets"] += 1
            return {part: b"".join(pieces) for part, pieces in parts.items()}

    def summary(self) -> dict:
        """Store accounting for ``Workspace.report()``: operation counters
        plus the LRU chunk-cache summary (None when the cache is off)."""
        return {"chunk_reads": int(self.stats["chunk_reads"]),
                "puts": int(self.stats["puts"]),
                "gets": int(self.stats["gets"]),
                "cache": self.cache.summary()
                if self.cache is not None else None}

    def has(self, key: str) -> bool:
        with self._lock:
            self._maybe_reload()
            return key in self._entries

    def find(self, prefix: str) -> List[str]:
        """Keys under a key prefix (e.g. ``"qwen2.5-3b/decode/"``)."""
        with self._lock:
            self._maybe_reload()
            return sorted(k for k in self._entries if k.startswith(prefix))

    def keys(self) -> List[str]:
        with self._lock:
            self._maybe_reload()
            return sorted(self._entries)

    def delete(self, key: str):
        with self._lock:
            self._maybe_reload()
            self._entries.pop(key, None)
            self._resign_index()

    def _referenced(self) -> set:
        return {c["d"] for e in self._entries.values() for c in e["chunks"]}

    def referenced_digests(self) -> Iterable[str]:
        with self._lock:
            return self._referenced()

    GC_TMP_AGE_S = 300   # in-flight .tmp files younger than this survive

    def gc(self) -> int:
        """Remove chunks referenced by no index entry (e.g. after a
        re-publish replaced them or a key was deleted).  The live set is
        computed under the same lock as the deletions, so an in-process
        concurrent put() can never have its freshly indexed chunks
        collected.  The lock is per-process: on a SHARED root, run gc
        from the publishing/admin role only — stale ``.tmp`` files are
        aged before removal so another process's in-flight chunk write is
        not broken, but a publisher whose chunks land before its index
        write could still race a foreign gc."""
        removed = 0
        now = time.time()
        with self._lock:
            self._maybe_reload()
            live = self._referenced()
            if self._root is None:
                for d in [d for d in self._mem_chunks if d not in live]:
                    del self._mem_chunks[d]
                    removed += 1
            else:
                cdir = os.path.join(self._root, "chunks")
                for sub in os.listdir(cdir):
                    subdir = os.path.join(cdir, sub)
                    for d in os.listdir(subdir):
                        path = os.path.join(subdir, d)
                        if d.endswith(".tmp"):
                            # only collect ABANDONED temp files; a young
                            # one is another process mid-_write_chunk
                            try:
                                if now - os.path.getmtime(path) > \
                                        self.GC_TMP_AGE_S:
                                    os.remove(path)
                                    removed += 1
                            except FileNotFoundError:
                                pass
                        elif d not in live:
                            os.remove(path)
                            removed += 1
            self.stats["gc_removed"] += removed
        return removed
