"""repro_torch.attest — transparency log, key rotation and replay
attestation (counterpart of ``repro/attest``).

The trust chain over the record -> publish -> fetch -> replay lifecycle:

    log.py       RFC 6962/9162 Merkle tree over the registry index:
                 signed tree heads, inclusion + consistency proofs
    keys.py      per-epoch signing keys (HKDF-style ratchet), owned by
                 ``Workspace``; old epochs verifiable, future rejected
    quote.py     replay quotes binding (recording key, program
                 fingerprint, plan fingerprint, commit-frontier digest,
                 signed root)
    verifier.py  offline quote verification — imports no model, registry
                 or record code (tested by source scan)

``RegistryService`` appends a leaf per publish and serves proofs;
``RegistryClient`` / ``RegistryReadReplica`` verify inclusion and
consistency before trusting fetched bytes (``SplitViewError`` on a
swapped recording or forked log, before ``torch.export.load``).  Roots,
proofs, keys, signatures and quotes equal the reference's on the same
inputs, so each package verifies the other's.
"""
from repro_torch.core.attest import (AttestationError, FutureEpochError,
                                     QuoteVerificationError, RotatedKeyError,
                                     SplitViewError)
from repro_torch.attest.keys import EpochKey, KeySchedule
from repro_torch.attest.log import (TransparencyLog, leaf_data, leaf_hash,
                                    proof_wire_bytes, verify_consistency,
                                    verify_inclusion)
from repro_torch.attest.quote import (BOUND_FIELDS, build_quote,
                                      frontier_digest_of,
                                      plan_fingerprint_of, quote_signable)
from repro_torch.attest.verifier import (head_signable, verify_head,
                                         verify_quote)

__all__ = [
    "AttestationError", "BOUND_FIELDS", "EpochKey", "FutureEpochError",
    "KeySchedule", "QuoteVerificationError", "RotatedKeyError",
    "SplitViewError", "TransparencyLog", "build_quote",
    "frontier_digest_of", "head_signable", "leaf_data", "leaf_hash",
    "plan_fingerprint_of", "proof_wire_bytes", "quote_signable",
    "verify_consistency", "verify_head", "verify_inclusion",
    "verify_quote",
]
