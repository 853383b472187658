"""Per-epoch signing-key rotation — an HKDF-style forward ratchet.

Counterpart of ``repro/attest/keys.py``: the same labels and chain, so
both packages derive the same epoch keys and signatures from one root.

A ``KeySchedule`` owns a root secret and derives one signing key per
epoch by chaining HMAC states::

    state_0   = HMAC(root,    "repro-attest/state")
    state_e+1 = HMAC(state_e, "repro-attest/ratchet")
    key_e     = HMAC(state_e, "repro-attest/sign")

Signatures are BOUND to their epoch (``"{epoch}:{hexmac}"``): a verifier
holding the same schedule re-derives ``key_e`` for any already-existing
epoch — old recordings stay verifiable after rotation — while an epoch
beyond the schedule's current one raises ``FutureEpochError`` (a forged
epoch tag, or a verifier that must catch up before trusting anything).

The schedule is the ``Workspace``-owned credential the transparency log
and replay quotes sign under; the raw recording HMAC
(``core.attest.sign``) is unchanged — this layer is additive.  No
model/registry/network imports: the offline verifier ships this module.
"""
from __future__ import annotations

import dataclasses
import hashlib
import hmac
from typing import List

from repro_torch.core.attest import FutureEpochError, fingerprint

_STATE_LABEL = b"repro-attest/state"
_RATCHET_LABEL = b"repro-attest/ratchet"
_SIGN_LABEL = b"repro-attest/sign"


def _hkdf_step(key: bytes, label: bytes) -> bytes:
    return hmac.new(key, label, hashlib.sha256).digest()


@dataclasses.dataclass(frozen=True)
class EpochKey:
    """One epoch's signing material, pinned to the schedule that issued
    it.  Becomes STALE the moment the schedule rotates past its epoch —
    ``Workspace`` refuses stale epoch keys at construction."""
    epoch: int
    material: bytes
    schedule: "KeySchedule"

    @property
    def stale(self) -> bool:
        return self.epoch < self.schedule.epoch


class KeySchedule:
    """Root secret -> per-epoch signing keys, forward-ratcheted."""

    def __init__(self, root: bytes):
        if not root:
            raise ValueError("KeySchedule requires a non-empty root secret")
        self.root = bytes(root)
        self._states: List[bytes] = [_hkdf_step(self.root, _STATE_LABEL)]

    # ---------------------------------------------------------- rotation --
    @property
    def epoch(self) -> int:
        return len(self._states) - 1

    def rotate(self) -> int:
        """Advance to the next epoch; returns the new epoch number.
        Every already-derived epoch stays verifiable (states are kept —
        verification of history is the schedule's whole job)."""
        self._states.append(_hkdf_step(self._states[-1], _RATCHET_LABEL))
        return self.epoch

    def key_for_epoch(self, epoch: int) -> bytes:
        if not isinstance(epoch, int) or epoch < 0:
            raise FutureEpochError(f"invalid epoch {epoch!r}")
        if epoch > self.epoch:
            raise FutureEpochError(
                f"epoch {epoch} does not exist yet (schedule is at epoch "
                f"{self.epoch}); refusing to verify under a future key")
        return _hkdf_step(self._states[epoch], _SIGN_LABEL)

    def current(self) -> EpochKey:
        """This epoch's key as a first-class credential object."""
        return EpochKey(self.epoch, self.key_for_epoch(self.epoch), self)

    # ----------------------------------------------------------- signing --
    def sign(self, payload: bytes, epoch: int | None = None) -> str:
        """Epoch-bound signature ``"{epoch}:{hexmac}"`` under the current
        (or an explicit existing) epoch key."""
        e = self.epoch if epoch is None else epoch
        mac = hmac.new(self.key_for_epoch(e), payload,
                       hashlib.sha256).hexdigest()
        return f"{e}:{mac}"

    def verify(self, payload: bytes, signature: str) -> bool:
        """Verify an epoch-bound signature.  Old epochs verify after
        rotation; a future epoch raises ``FutureEpochError`` (it is a
        protocol violation, not a mere mismatch)."""
        epoch_s, _, mac = signature.partition(":")
        try:
            epoch = int(epoch_s)
        except ValueError:
            return False
        want = hmac.new(self.key_for_epoch(epoch), payload,
                        hashlib.sha256).hexdigest()
        return hmac.compare_digest(want, mac)

    # --------------------------------------------------------- reporting --
    def describe(self) -> dict:
        return {"epoch": self.epoch,
                "root_fingerprint": fingerprint(self.root)[:16]}


__all__ = ["KeySchedule", "EpochKey"]
