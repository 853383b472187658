"""Offline quote verifier — the remote-verifier half of attested replay.

Counterpart of ``repro/attest/verifier.py``.

Like ``ReplayChannel``'s trust boundary, this module imports NO model,
registry, serving, or record code (a test scans its source): a verifier
needs only the quote, a signed tree head, optionally the recording's log
leaf + inclusion proof, and the shared ``KeySchedule`` — everything a
remote party would hold, nothing a replica could lie about.

Checks, in order (each failure is a distinct ``QuoteVerificationError``):

  1. the signed head verifies under the key schedule (epoch-bound);
  2. the quote's signature covers exactly its bound fields;
  3. the quote binds THIS head (root + log size match);
  4. with ``leaf``/``proof``: the leaf names the quoted recording key and
     executable digest, and its inclusion proof folds up to the head's
     root — the replayed bytes are the published bytes.
"""
from __future__ import annotations

from typing import List, Optional

from repro_torch.core.attest import (FutureEpochError,
                                     QuoteVerificationError, canonical)
from repro_torch.attest.keys import KeySchedule
from repro_torch.attest.log import leaf_data, verify_inclusion
from repro_torch.attest.quote import quote_signable

HEAD_FIELDS = ("size", "root", "epoch", "signature")


def head_signable(head: dict) -> bytes:
    """Canonical bytes a signed tree head's signature covers."""
    return canonical({"size": int(head["size"]), "root": head["root"]})


def verify_head(head: dict, keys: KeySchedule) -> dict:
    missing = [f for f in HEAD_FIELDS if f not in head]
    if missing:
        raise QuoteVerificationError(f"tree head missing fields {missing}")
    try:
        ok = keys.verify(head_signable(head), head["signature"])
    except FutureEpochError as e:
        raise QuoteVerificationError(f"tree head: {e}")
    if not ok:
        raise QuoteVerificationError(
            f"tree head signature does not verify (size={head['size']}, "
            f"root={head['root'][:12]}...)")
    return head


def verify_quote(quote: dict, *, head: dict, keys: KeySchedule,
                 leaf: Optional[dict] = None,
                 proof: Optional[List[str]] = None,
                 leaf_index: Optional[int] = None) -> dict:
    """Full offline verification; returns a report dict on success,
    raises ``QuoteVerificationError`` on any failed binding."""
    verify_head(head, keys)
    try:
        ok = keys.verify(quote_signable(quote), quote.get("signature", ""))
    except FutureEpochError as e:
        raise QuoteVerificationError(f"quote: {e}")
    except ValueError as e:
        raise QuoteVerificationError(str(e))
    if not ok:
        raise QuoteVerificationError(
            "quote signature does not verify: a bound field was altered "
            "or the quote was signed under a different key schedule")
    if quote["root"] != head["root"] or \
            int(quote["log_size"]) != int(head["size"]):
        raise QuoteVerificationError(
            f"quote binds log view (size={quote['log_size']}, "
            f"root={str(quote['root'])[:12]}...) but the supplied head is "
            f"(size={head['size']}, root={head['root'][:12]}...)")
    checked_inclusion = False
    if leaf is not None:
        if proof is None or leaf_index is None:
            raise QuoteVerificationError(
                "leaf supplied without its inclusion proof/index")
        if leaf.get("key") != quote["recording_key"]:
            raise QuoteVerificationError(
                f"log leaf is for key {leaf.get('key')!r}, quote claims "
                f"{quote['recording_key']!r}")
        if leaf.get("payload_digest") != quote["exec_fingerprint"]:
            raise QuoteVerificationError(
                "quoted executable fingerprint does not match the "
                "published leaf's payload digest: the replica replayed "
                "bytes the log never vouched for")
        data = leaf_data(leaf["key"], leaf["manifest_fp"],
                         leaf["payload_digest"], leaf["epoch"])
        if not verify_inclusion(data, int(leaf_index), int(head["size"]),
                                proof, head["root"]):
            raise QuoteVerificationError(
                f"inclusion proof for leaf {leaf_index} does not fold up "
                f"to the signed root {head['root'][:12]}...")
        checked_inclusion = True
    return {"ok": True, "recording_key": quote["recording_key"],
            "epoch": quote["epoch"], "log_size": int(head["size"]),
            "root": head["root"], "inclusion_checked": checked_inclusion}


__all__ = ["verify_quote", "verify_head", "head_signable", "HEAD_FIELDS"]
