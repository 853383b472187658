"""Replay attestation quotes.

Counterpart of ``repro/attest/quote.py``: a quote built by either
package verifies under the other's ``verify_quote``.

A quote is a replica's signed claim "I replayed THIS recording, through
THIS plan, with THIS observable effect, against THIS published log
view".  Bound fields::

    recording_key     the registry key that was replayed
    exec_fingerprint  fingerprint of the executable payload (== the
                      transparency-log leaf's payload_digest, so the
                      verifier can bind quote -> log leaf offline)
    plan_fingerprint  the compacted replay plan's identity (source
                      fingerprint + pass stack + dispatch structure)
    frontier_digest   digest of the committed write frontier — the
                      replay's observable device effect
    root / log_size   the signed tree head the replica fetched under
    epoch             the key epoch the quote is signed in

``quote_signable`` canonicalizes exactly these fields, so perturbing ANY
one of them invalidates the signature — the offline verifier checks the
whole binding with no model or registry imports.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core.attest import canonical, fingerprint
from repro_torch.attest.keys import KeySchedule

BOUND_FIELDS = ("recording_key", "exec_fingerprint", "plan_fingerprint",
                "frontier_digest", "root", "log_size", "epoch")


def quote_signable(quote: dict) -> bytes:
    """Canonical bytes of the bound fields (and ONLY those — extra
    annotation keys never enter the signature)."""
    missing = [f for f in BOUND_FIELDS if f not in quote]
    if missing:
        raise ValueError(f"quote is missing bound fields {missing}")
    return canonical({f: quote[f] for f in BOUND_FIELDS})


def build_quote(keys: KeySchedule, *, recording_key: str,
                exec_fingerprint: str, plan_fingerprint: str,
                frontier_digest: str, head: dict,
                annotations: Optional[dict] = None) -> dict:
    """Assemble and sign a quote against a signed tree ``head``
    (``{"size", "root", "epoch", "signature"}`` as served by
    ``RegistryService.signed_head``)."""
    quote = {"recording_key": recording_key,
             "exec_fingerprint": exec_fingerprint,
             "plan_fingerprint": plan_fingerprint,
             "frontier_digest": frontier_digest,
             "root": head["root"], "log_size": int(head["size"]),
             "epoch": keys.epoch}
    if annotations:
        quote.update({k: v for k, v in annotations.items()
                      if k not in BOUND_FIELDS and k != "signature"})
    quote["signature"] = keys.sign(quote_signable(quote))
    return quote


def plan_fingerprint_of(plan) -> str:
    """A ``ReplayPlan``'s identity: the source executable it was derived
    from, the pass stack that compacted it, and the resulting dispatch
    structure (group labels + op counts) — a different compaction of the
    same recording is a DIFFERENT claim."""
    return fingerprint(plan.source_fingerprint, list(plan.passes),
                       plan.jobs,
                       [[g.label, len(g.ops)] for g in plan.groups])


def frontier_digest_of(write_log) -> str:
    """Digest of the committed ``(site, payload)`` write sequence — the
    bit-exactness witness the replay tests already pin, reused as the
    quote's observable-effect binding."""
    return fingerprint([[site, payload] for site, payload in write_log])


__all__ = ["BOUND_FIELDS", "quote_signable", "build_quote",
           "plan_fingerprint_of", "frontier_digest_of"]
