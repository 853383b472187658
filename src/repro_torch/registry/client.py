"""Registry client — the device (TEE) side of the recording registry.

All traffic is billed to a ``NetworkEmulator`` so the benchmarks report
the real byte/RTT cost per profile (wifi/cellular):

  * one blocking round trip for the index/lease RPC;
  * a miss with record-on-miss blocks on the cloud's single-flight lease:
    the recorder's wall time is added to virtual time (this is the cold
    cost a warm hit avoids) and counted in ``stats['recording_round_trips']``;
  * chunk downloads go through ``NetworkEmulator.transfer`` — pipelined,
    ack-accounted, billed only for chunks the client does not already
    hold (the chunk cache is content-addressed, so after a delta
    re-publish a refetch downloads only the changed chunks).

Fetches are RESUMABLE: received chunks live in a byte-bounded LRU keyed
by content address, so an interrupted fetch retries with only the
missing remainder.

Security: the client verifies the recording HMAC (``Recording.from_bytes``
with a key — never ``allow_unsigned``) BEFORE the bytes can reach
``torch.export.load``; the store additionally re-verifies every chunk
digest and the signed index on each read.  On top of that, every fetch demands
a transparency-log INCLUSION proof (the fetched bytes are the published
bytes, committed under a signed tree head) and a CONSISTENCY proof
against the head pinned on the previous fetch (the log only ever grew) —
``SplitViewError`` on a silent swap or forked log, still before any load.

Counterpart of ``repro/registry/client.py``: for the same ``Recording``
bytes its stats and the emulator's totals (wire bytes, round trips,
virtual seconds) equal the reference's.  ``into_replayer`` warms every
name it preloads, as the reference does; on a CUDA device the port's
``Replayer.warm`` arms a CUDA-graph capture at the next ``execute``, so
a registry boot captures the prefill as well as the decode block.
"""
from __future__ import annotations

import collections
from typing import Callable, Dict, Iterable, List, Optional, Tuple, Union

from repro_torch.attest.keys import KeySchedule
from repro_torch.attest.log import (PROOF_HASH_BYTES, leaf_data,
                                    proof_wire_bytes, verify_consistency,
                                    verify_inclusion)
from repro_torch.attest.verifier import head_signable
from repro_torch.core.attest import (FutureEpochError, SplitViewError,
                                     fingerprint)
from repro_torch.core.recording import Recording
from repro_torch.obs.trace import NULL, traced
from repro_torch.registry.service import (RegistryService,
                                          parts_to_recording_bytes)
from repro_torch.registry.store import LRUBytes, RegistryMissError

_INDEX_RPC_SEND = 96          # key + auth token
_INDEX_RPC_RECV_BASE = 64     # entry header
_INDEX_RPC_RECV_PER_CHUNK = 48  # digest + sizes per chunk row


class FetchInterrupted(RuntimeError):
    """A chunked fetch was cut off mid-stream; already-received chunks are
    cached, so retrying the fetch resumes where it stopped."""


class RegistryClient:
    def __init__(self, service: RegistryService, netem=None, *, key: bytes,
                 cache_bytes: int = 32 << 20, tracer=None,
                 keys: Optional[KeySchedule] = None,
                 verify_proofs: bool = True):
        if not key:
            raise ValueError("RegistryClient requires the registry signing "
                             "key: fetched bytes are verified before use")
        self._svc = service
        self._net = netem
        self._key = key
        self.tracer = tracer if tracer is not None else NULL
        self.chunks = LRUBytes(cache_bytes)   # digest -> raw chunk
        self.stats = collections.Counter()
        # transparency-log verification: the client pins the last signed
        # tree head it accepted and demands (inclusion + consistency)
        # proofs on every fetch.  ``keys`` shares the Workspace's epoch
        # schedule; a bare client derives one from the signing key (same
        # derivation the service uses, so epoch 0 agrees by construction)
        self._keys = keys if keys is not None else KeySchedule(key)
        self._verify_proofs = verify_proofs
        self._sth: Optional[dict] = None      # pinned {size, root}

    # ---------------------------------------------------------- internals --
    def _bill_index_rpc(self, n_chunks: int):
        if self._net is not None:
            self._net.round_trip(
                send_bytes=_INDEX_RPC_SEND,
                recv_bytes=_INDEX_RPC_RECV_BASE +
                _INDEX_RPC_RECV_PER_CHUNK * n_chunks)

    def _missing_rows(self, entry: dict) -> List[dict]:
        """Chunk rows not in the local cache, deduplicated by digest — a
        digest repeated across index rows (e.g. identical zero pages)
        crosses the wire once."""
        seen, rows = set(), []
        for c in entry["chunks"]:
            if c["d"] not in self.chunks and c["d"] not in seen:
                seen.add(c["d"])
                rows.append(c)
        return rows

    def _download(self, chunk_rows: List[dict],
                  stat_key: str = "chunks_fetched",
                  cache: bool = True) -> Dict[str, bytes]:
        """Pull the given chunks, billing ONE pipelined transfer for their
        total compressed size.  ``cache=False`` keeps the result out of
        the LRU (refetches of evicted chunks must not thrash it) and
        returns the raw bytes instead."""
        out: Dict[str, bytes] = {}
        if not chunk_rows:
            return out
        with traced(self.tracer, "registry.download", "registry",
                    chunks=len(chunk_rows),
                    bytes=sum(c["c"] for c in chunk_rows), kind=stat_key):
            if self._net is not None:
                self._net.transfer(sum(c["c"] for c in chunk_rows),
                                   chunk_size=self._svc.chunk_size,
                                   direction="recv")
        for c in chunk_rows:
            raw = self._svc.read_chunk(c["d"])
            if cache:
                self.chunks.put(c["d"], raw)
            else:
                out[c["d"]] = raw
            self.stats[stat_key] += 1
            self.stats["chunk_bytes_fetched"] += c["c"]
        return out

    # ------------------------------------------------------------- public --
    def fetch(self, key: str,
              record_fn: Optional[Callable[[], Recording]] = None,
              interrupt_after: Optional[int] = None) -> bytes:
        """Fetch-and-verify a recording; returns the verified wire bytes.

        ``record_fn`` enables record-on-miss (single-flight on the cloud
        side).  ``interrupt_after=k`` aborts after k newly received chunks
        with ``FetchInterrupted`` — the test/demo hook for resumability.
        """
        with self.tracer.clock_scope(self._net), \
                traced(self.tracer, "registry.fetch", "registry", key=key):
            return self._fetch(key, record_fn, interrupt_after)

    def _fetch(self, key, record_fn, interrupt_after) -> bytes:
        tr = self.tracer
        if not self._svc.has(key):
            if record_fn is None:
                self._bill_index_rpc(0)
                raise RegistryMissError(key)
            if tr:
                tr.instant("registry.miss", "registry", key=key)
            # blocking record-on-miss RPC: the client stalls for the
            # cloud's record (or for another client's in-flight lease);
            # ensure() publishes without reassembling — the chunks cross
            # the wire exactly once, in the billed download below
            self._svc.ensure(key, record_fn)
            entry = self._svc.entry(key)
            self._bill_index_rpc(len(entry["chunks"]))
            self.stats["recording_round_trips"] += 1
            if self._net is not None:
                # the cold cost a warm hit avoids: the cloud's export wall
                # time PLUS the distributed record session's virtual time
                # (the device<->cloud protocol round trips; zero when the
                # recording was made by a local in-process session)
                with traced(tr, "registry.record_on_miss", "registry",
                            key=key):
                    self._net.virtual_time_s += \
                        float(entry["meta"].get("record_wall_s", 0.0)) + \
                        float(entry["meta"].get("record_virtual_s", 0.0))
        else:
            entry = self._svc.entry(key)
            self._bill_index_rpc(len(entry["chunks"]))
            self.stats["registry_hits"] += 1
            if tr:
                tr.instant("registry.hit", "registry", key=key)

        missing = self._missing_rows(entry)
        if interrupt_after is not None and len(missing) > interrupt_after:
            self._download(missing[:interrupt_after])
            raise FetchInterrupted(
                f"fetch of '{key}' interrupted: "
                f"{interrupt_after}/{len(missing)} missing chunks received "
                f"(resume by fetching again)")
        self._download(missing)

        # chunks the LRU evicted mid-fetch (cache smaller than the
        # recording) must cross the wire AGAIN — billed, and kept out of
        # the cache to avoid thrashing it
        extra = self._download(self._missing_rows(entry),
                               stat_key="chunks_refetched", cache=False)

        parts: Dict[str, List[bytes]] = {}
        for c in entry["chunks"]:
            raw = extra.get(c["d"])
            if raw is None:
                raw = self.chunks.get(c["d"])
            if raw is None:
                # evicted between the refetch scan and here (only possible
                # with a concurrently shared cache) — still billed
                raw = self._download([c], stat_key="chunks_refetched",
                                     cache=False)[c["d"]]
            parts.setdefault(c["part"], []).append(raw)
        blob = parts_to_recording_bytes(
            {p: b"".join(pieces) for p, pieces in parts.items()})
        # HMAC verification BEFORE the blob can reach torch.export.load
        rec = Recording.from_bytes(blob, self._key)
        # ... and transparency-log verification before the bytes are
        # TRUSTED: inclusion of exactly these bytes under a signed root,
        # consistency of that root with the head pinned on the previous
        # fetch.  A silently swapped recording or a forked log raises
        # SplitViewError here — still before any load.
        if self._verify_proofs and hasattr(self._svc, "proof_for"):
            self._verify_published(key, rec)
        self.stats["verified_fetches"] += 1
        if self.tracer:
            self.tracer.instant("registry.verified", "registry", key=key,
                                bytes=len(blob))
        return blob

    def _verify_published(self, key: str, rec: Recording) -> None:
        """Verify the fetched recording against the transparency log:
        signed head -> leaf == fetched bytes -> inclusion -> consistency
        with the pinned head.  Proof bytes are billed as ASYNC wire bytes
        (they piggyback on the chunk stream; no extra blocking RTT — the
        <=5% warm-fetch overhead gate depends on this)."""
        bundle = self._svc.proof_for(key)
        head, leaf = bundle["head"], bundle["leaf"]
        try:
            head_ok = self._keys.verify(head_signable(head),
                                        head["signature"])
        except FutureEpochError as e:
            raise SplitViewError(f"tree head for '{key}': {e}")
        if not head_ok:
            raise SplitViewError(
                f"signed tree head for '{key}' does not verify under the "
                "epoch key schedule")
        if (leaf["key"] != key
                or leaf["manifest_fp"] != fingerprint(rec.manifest)
                or leaf["payload_digest"] != fingerprint(rec.payload)):
            raise SplitViewError(
                f"registry served bytes for '{key}' that do not match its "
                "published log leaf: silent recording swap detected")
        data = leaf_data(leaf["key"], leaf["manifest_fp"],
                         leaf["payload_digest"], leaf["epoch"])
        if not verify_inclusion(data, bundle["index"], head["size"],
                                bundle["path"], head["root"]):
            raise SplitViewError(
                f"inclusion proof for '{key}' does not fold up to the "
                "signed root")
        cons_hashes = 0
        if self._sth is not None and self._sth["size"] > 0:
            old_size, old_root = self._sth["size"], self._sth["root"]
            if head["size"] < old_size:
                raise SplitViewError(
                    f"log shrank from {old_size} to {head['size']} "
                    "entries: append-only violation")
            cp = self._svc.consistency_between(old_size, head["size"])
            if not verify_consistency(old_size, old_root, head["size"],
                                      head["root"], cp["proof"]):
                raise SplitViewError(
                    f"consistency proof {old_size} -> {head['size']} "
                    "failed: the registry is serving a forked (split-view) "
                    "log")
            cons_hashes = len(cp["proof"])
        self._sth = {"size": head["size"], "root": head["root"]}
        pb = proof_wire_bytes(bundle["path"]) + \
            cons_hashes * PROOF_HASH_BYTES
        if self._net is not None:
            self._net.async_trip(send_bytes=0, recv_bytes=pb)
        self.stats["proof_bytes"] += pb
        self.stats["proofs_verified"] += 1
        if self.tracer:
            self.tracer.instant("registry.proof_verified", "registry",
                                key=key, log_size=head["size"],
                                proof_bytes=pb)

    def into_channel(self, replayer, prefill_item, decode_item,
                     warm: bool = True):
        """Warm handoff targeting an ``ExecutionChannel``: fetch + verify
        the prefill/decode recordings, preload them into ``replayer``, and
        return a ready ``ReplayChannel`` — the serving stack never sees the
        Replayer.  Items are ``key`` or ``(key, record_fn)`` as in
        ``into_replayer``."""
        from repro_torch.core.channel import ReplayChannel
        pre, dec = self.into_replayer(replayer, [prefill_item, decode_item],
                                      warm=warm)
        return ReplayChannel(replayer, pre, dec)

    def into_replayer(self, replayer,
                      keys: Iterable[Union[str, Tuple[str, Optional[
                          Callable[[], Recording]]]]],
                      warm: bool = True) -> List[str]:
        """Warm handoff: fetch + verify each key, preload into a
        ``Replayer`` under the registry key as the executable-cache name,
        and (optionally) warm-execute so a replica boots from a registry
        hit without re-exporting — the first real request pays neither
        export nor cold-start cost."""
        items = []
        for it in keys:
            key, record_fn = it if isinstance(it, tuple) else (it, None)
            items.append((self.fetch(key, record_fn), key))
        names = replayer.preload(items)
        if warm:
            for name in names:
                replayer.warm(name)
        return names
