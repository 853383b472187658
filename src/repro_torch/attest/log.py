"""Transparency log — an RFC 6962/9162-style Merkle tree over the
registry index.

Counterpart of ``repro/attest/log.py``: the same leaf encoding, roots
and proofs, byte for byte.

Every ``RegistryService.publish`` appends one leaf
``(key, manifest_fingerprint, payload_digest, epoch)``; the tree head is
signed per epoch by the service's ``KeySchedule``.  Clients verify

  * INCLUSION: the recording they fetched hashes to a leaf the signed
    root commits to (a silently swapped recording fails here — the log
    says X, the bytes are Y);
  * CONSISTENCY: the new signed root is an append-only extension of the
    root they pinned on a previous fetch (a forked / rewritten log — a
    split view — fails here).

Hashing follows RFC 6962: ``leaf = SHA256(0x00 || data)``,
``node = SHA256(0x01 || left || right)``, and MTH splits at the largest
power of two smaller than n.  Proof generation/verification implement
RFC 9162 §2.1.3 (PATH / inclusion) and §2.1.4 (SUBPROOF / consistency).
Pure data structure: no registry, model, or network imports — the
offline verifier (``repro_torch.attest.verifier``) reuses the verification
half as-is.
"""
from __future__ import annotations

import hashlib
from typing import List, Optional

from repro_torch.core.attest import AttestationError, canonical

# wire-size model for proof billing: each audit-path entry is one 32-byte
# digest; a signed head rides along as root(32) + size(8) + epoch(8) +
# HMAC signature(64, hex-decoded 32 but shipped hex)
PROOF_HASH_BYTES = 32
HEAD_WIRE_BYTES = 112


def leaf_data(key: str, manifest_fp: str, payload_digest: str,
              epoch: int) -> bytes:
    """Canonical byte encoding of one log leaf (strict encoder — the
    same one registry keys fingerprint through)."""
    return canonical({"key": key, "manifest_fp": manifest_fp,
                      "payload_digest": payload_digest, "epoch": epoch})


def leaf_hash(data: bytes) -> bytes:
    return hashlib.sha256(b"\x00" + data).digest()


def node_hash(left: bytes, right: bytes) -> bytes:
    return hashlib.sha256(b"\x01" + left + right).digest()


def _largest_power_of_two_below(n: int) -> int:
    k = 1
    while k * 2 < n:
        k *= 2
    return k


class TransparencyLog:
    """Append-only Merkle tree over raw leaf byte strings."""

    EMPTY_ROOT = hashlib.sha256(b"").hexdigest()

    def __init__(self):
        self._leaves: List[bytes] = []      # leaf HASHES, append order
        self.entries: List[bytes] = []      # raw leaf data, append order

    @property
    def size(self) -> int:
        return len(self._leaves)

    def append(self, data: bytes) -> int:
        """Append one leaf; returns its index."""
        self.entries.append(data)
        self._leaves.append(leaf_hash(data))
        return len(self._leaves) - 1

    # ------------------------------------------------------------ hashing --
    def _mth(self, lo: int, hi: int) -> bytes:
        """Merkle tree hash over leaves [lo, hi) — RFC 6962 §2.1."""
        n = hi - lo
        if n == 1:
            return self._leaves[lo]
        k = _largest_power_of_two_below(n)
        return node_hash(self._mth(lo, lo + k), self._mth(lo + k, hi))

    def root(self, size: Optional[int] = None) -> str:
        """Hex root over the first ``size`` leaves (default: all)."""
        n = self.size if size is None else size
        if not 0 <= n <= self.size:
            raise AttestationError(f"log has {self.size} leaves, "
                                   f"no root at size {n}")
        if n == 0:
            return self.EMPTY_ROOT
        return self._mth(0, n).hex()

    # ------------------------------------------------------------- proofs --
    def inclusion_proof(self, index: int,
                        size: Optional[int] = None) -> List[str]:
        """Audit path for leaf ``index`` in the first ``size`` leaves
        (RFC 9162 §2.1.3.1 PATH), bottom-up, hex digests."""
        n = self.size if size is None else size
        if not 0 <= index < n <= self.size:
            raise AttestationError(
                f"no inclusion proof for index {index} at size {n} "
                f"(log has {self.size} leaves)")
        return [h.hex() for h in self._path(index, 0, n)]

    def _path(self, m: int, lo: int, hi: int) -> List[bytes]:
        n = hi - lo
        if n == 1:
            return []
        k = _largest_power_of_two_below(n)
        if m - lo < k:
            return self._path(m, lo, lo + k) + [self._mth(lo + k, hi)]
        return self._path(m, lo + k, hi) + [self._mth(lo, lo + k)]

    def consistency_proof(self, old_size: int,
                          new_size: Optional[int] = None) -> List[str]:
        """Proof that the first ``new_size`` leaves extend the first
        ``old_size`` (RFC 9162 §2.1.4.1 SUBPROOF), hex digests."""
        n = self.size if new_size is None else new_size
        if not 0 < old_size <= n <= self.size:
            raise AttestationError(
                f"no consistency proof {old_size} -> {n} "
                f"(log has {self.size} leaves)")
        if old_size == n:
            return []
        return [h.hex() for h in self._subproof(old_size, 0, n, True)]

    def _subproof(self, m: int, lo: int, hi: int,
                  whole: bool) -> List[bytes]:
        n = hi - lo
        if m == n:
            return [] if whole else [self._mth(lo, hi)]
        k = _largest_power_of_two_below(n)
        if m <= k:
            return self._subproof(m, lo, lo + k, whole) + \
                [self._mth(lo + k, hi)]
        return self._subproof(m - k, lo + k, hi, False) + \
            [self._mth(lo, lo + k)]


# ----------------------------------------------- stateless verification --
# Pure functions over hex digests: the offline verifier and the clients
# share these; neither needs a TransparencyLog instance.

def verify_inclusion(data: bytes, index: int, size: int, path: List[str],
                     root: str) -> bool:
    """RFC 9162 §2.1.3.2: fold the audit path from ``data``'s leaf hash
    up to the root and compare."""
    if not 0 <= index < size:
        return False
    fn, sn = index, size - 1
    r = leaf_hash(data)
    for p in path:
        sib = bytes.fromhex(p)
        if sn == 0:
            return False
        if fn % 2 == 1 or fn == sn:
            r = node_hash(sib, r)
            while fn % 2 == 0 and fn != 0:
                fn //= 2
                sn //= 2
        else:
            r = node_hash(r, sib)
        fn //= 2
        sn //= 2
    return sn == 0 and r.hex() == root


def verify_consistency(old_size: int, old_root: str, new_size: int,
                       new_root: str, proof: List[str]) -> bool:
    """RFC 9162 §2.1.4.2: the tree at ``new_size`` is an append-only
    extension of the tree at ``old_size``."""
    if old_size > new_size or old_size == 0:
        return False
    if old_size == new_size:
        return not proof and old_root == new_root
    if not proof:
        return False
    hashes = [bytes.fromhex(p) for p in proof]
    fn, sn = old_size - 1, new_size - 1
    while fn % 2 == 1:
        fn //= 2
        sn //= 2
    if fn == 0:             # old tree is a complete subtree: seed with its root
        fr = nr = bytes.fromhex(old_root)
    else:
        fr = nr = hashes[0]
        hashes = hashes[1:]
    for c in hashes:
        if sn == 0:
            return False
        if fn % 2 == 1 or fn == sn:
            fr = node_hash(c, fr)
            nr = node_hash(c, nr)
            while fn % 2 == 0 and fn != 0:
                fn //= 2
                sn //= 2
        else:
            nr = node_hash(nr, c)
        fn //= 2
        sn //= 2
    return sn == 0 and fr.hex() == old_root and nr.hex() == new_root


def proof_wire_bytes(path: List[str], with_head: bool = True) -> int:
    """Deterministic wire-size model for billing a served proof."""
    return PROOF_HASH_BYTES * len(path) + (HEAD_WIRE_BYTES if with_head
                                           else 0)


__all__ = ["TransparencyLog", "leaf_data", "leaf_hash", "node_hash",
           "verify_inclusion", "verify_consistency", "proof_wire_bytes",
           "PROOF_HASH_BYTES", "HEAD_WIRE_BYTES"]
