"""Recording format: the port's counterpart of the paper's CPU/GPU
interaction log, and of ``repro/core/recording.py``.

A recording is a signed, self-describing artifact:

  * manifest   — workload/config fingerprints, the input shapes and
                 dtypes, the donation map, cost/memory figures, creation
                 info;
  * payload    — the ``torch.export.save`` bytes of the step: the exact
                 program the device will execute;
  * trees      — the program's (in, out) pytree specs as
                 ``torch.utils._pytree.treespec_dumps`` JSON (never a
                 pickle);
  * signature  — HMAC-SHA256 over manifest + payload + trees.

The framing is the reference's, byte for byte (MessagePack, format
version 2, through ``_msgpack``), so each package verifies the other's
bytes.  The replayer (``repro_torch.core.replay``) verifies the signature,
the payload fingerprint and the topology before anything is loaded.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

from repro_torch.core import _msgpack
from repro_torch.core.attest import (TamperedRecordingError,
                                     UnverifiedRecordingError, sign, verify)

FORMAT_VERSION = 2


@dataclasses.dataclass
class Recording:
    manifest: Dict[str, Any]
    payload: bytes                 # torch.export.save bytes of the step
    trees: bytes                   # JSON (in_spec, out_spec) treespecs
    signature: str = ""

    def signable(self) -> bytes:
        return _msgpack.packb({"m": self.manifest}) + self.payload + \
            self.trees

    def sign_with(self, key: bytes) -> "Recording":
        self.signature = sign(self.signable(), key)
        return self

    def to_bytes(self) -> bytes:
        return _msgpack.packb({
            "v": FORMAT_VERSION, "manifest": self.manifest,
            "payload": self.payload, "trees": self.trees,
            "signature": self.signature})

    @staticmethod
    def from_bytes(blob: bytes, key: Optional[bytes] = None, *,
                   allow_unsigned: bool = False) -> "Recording":
        """Parse and verify a recording.  HMAC verification is not
        optional: loading without a key requires ``allow_unsigned=True``
        as an explicit, greppable opt-in."""
        if key is None and not allow_unsigned:
            raise UnverifiedRecordingError(
                "Recording.from_bytes without a signing key skips HMAC "
                "verification before untrusted deserialization; pass "
                "key=... or opt in explicitly with allow_unsigned=True")
        try:
            d = _msgpack.unpackb(blob)
            if d.get("v") != FORMAT_VERSION:
                raise TamperedRecordingError(f"format version {d.get('v')}")
            rec = Recording(d["manifest"], d["payload"], d["trees"],
                            d["signature"])
        except TamperedRecordingError:
            raise
        except Exception as e:  # corrupted framing == tampering
            raise TamperedRecordingError(f"unparseable recording: {e}")
        if key is not None and not verify(rec.signable(), rec.signature, key):
            raise TamperedRecordingError("signature verification failed")
        return rec

    def save(self, path: str, key: bytes):
        self.sign_with(key)
        with open(path, "wb") as f:
            f.write(self.to_bytes())

    @staticmethod
    def load(path: str, key: Optional[bytes] = None, *,
             allow_unsigned: bool = False) -> "Recording":
        with open(path, "rb") as f:
            return Recording.from_bytes(f.read(), key,
                                        allow_unsigned=allow_unsigned)
