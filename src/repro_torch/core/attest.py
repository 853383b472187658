"""Signing and fingerprints for recordings (paper §3.2: the cloud signs
recordings; the TEE replayer only accepts signed ones).

Counterpart of ``repro/core/attest.py``: the same canonical encoding,
SHA-256 fingerprints and HMAC-SHA256 signatures, so a digest or a
signature made by either package equals the other's on the same inputs,
and the same error taxonomy (the epoch keys, transparency log and quotes
that raise the attest-level errors come with a later slice).
"""
from __future__ import annotations

import hashlib
import hmac
import json


def _reject_unknown(obj):
    """Strict ``json.dumps`` default: refuse to fingerprint types the
    canonical encoding does not cover, instead of collapsing distinct
    objects with equal ``str()`` into one fingerprint."""
    raise TypeError(
        f"fingerprint: no canonical encoding for {type(obj).__name__!r} "
        f"({obj!r}); pass JSON-clean values (dict/list/str/int/float/bool/"
        "None) or raw bytes")


def canonical(part) -> bytes:
    """The canonical byte encoding one fingerprinted part hashes as: raw
    bytes pass through, everything else must be JSON-clean (unknown types
    raise ``TypeError``)."""
    if isinstance(part, bytes):
        return part
    return json.dumps(part, sort_keys=True,
                      default=_reject_unknown).encode()


def fingerprint(*parts) -> str:
    h = hashlib.sha256()
    for p in parts:
        h.update(canonical(p))
    return h.hexdigest()


def sign(payload: bytes, key: bytes) -> str:
    return hmac.new(key, payload, hashlib.sha256).hexdigest()


def verify(payload: bytes, signature: str, key: bytes) -> bool:
    return hmac.compare_digest(sign(payload, key), signature)


class TamperedRecordingError(Exception):
    pass


class UnverifiedRecordingError(ValueError):
    """A recording was about to be deserialized without HMAC verification
    and the caller did not opt in (``allow_unsigned=True``).  An unsigned
    load hands untrusted bytes to ``torch.export.load``, the attack the
    paper's signing step exists to prevent."""


class TopologyMismatchError(Exception):
    """Replay on hardware that does not match the recording (paper §2.4:
    recordings are only valid for the exact GPU they were made for)."""


class AttestationError(TamperedRecordingError):
    """A transparency-log / attestation check failed.  Subclasses
    ``TamperedRecordingError`` so every catch-site that treats a failed
    integrity check as tampering keeps working."""


class SplitViewError(AttestationError):
    """The registry served bytes the transparency log does not vouch for:
    a swapped recording, a forked (split-view) log, or an unverifiable
    signed tree head.  Raised before the fetched bytes reach any loader."""


class QuoteVerificationError(AttestationError):
    """A replay attestation quote failed offline verification (bad
    signature, unbound field, or a root the verifier does not trust)."""


class FutureEpochError(AttestationError):
    """A signature claims a key epoch that does not exist yet: a forged
    epoch tag or a verifier whose key schedule is behind the signer's."""


class RotatedKeyError(ValueError):
    """A raw epoch key from an already-rotated-away epoch was offered
    where a current credential is required."""
