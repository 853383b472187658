"""The port's attestation layer (``repro_torch.attest``) against the JAX
reference's on the CPU: transparency-log roots, inclusion and
consistency proofs and leaf bytes equal exhaustively up to 16 leaves,
per-epoch keys and signatures equal, quotes made by either package
verify under the other's ``verify_quote`` (and a plan replay's quote is
the reference's to the signature), and the trust boundary: a validly
signed swap is refused as a split view before ``torch.export.load``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("msgpack")

from repro import attest as JA  # noqa: E402
from repro.attest import verifier as JV  # noqa: E402
from repro.core.recording import Recording as JaxRecording  # noqa: E402
from repro.core.replay_passes import PlanExecutor as JaxExecutor  # noqa: E402
from repro.core.replay_passes import plan_for as jax_plan_for  # noqa: E402
from repro_torch import attest as A  # noqa: E402
from repro_torch.api import Workspace  # noqa: E402
from repro_torch.attest.quote import BOUND_FIELDS  # noqa: E402
from repro_torch.attest.verifier import head_signable  # noqa: E402
from repro_torch.core.attest import (AttestationError,  # noqa: E402
                                     FutureEpochError,
                                     QuoteVerificationError, RotatedKeyError,
                                     SplitViewError, TamperedRecordingError,
                                     fingerprint)
from repro_torch.core.recording import Recording  # noqa: E402
from repro_torch.core.replay_passes import PlanExecutor, plan_for  # noqa: E402
from repro_torch.registry import recording_to_parts  # noqa: E402

KEY = b"attest-test-key"


def synthetic_recording(payload_bytes=50_000, seed=0, name="synthetic",
                        trees=b"[]", sign=KEY) -> Recording:
    rng = np.random.default_rng(seed)
    payload = rng.bytes(payload_bytes)
    manifest = {"name": name, "static": {}, "record_wall_s": 2.0,
                "exec_fingerprint": fingerprint(payload)}
    rec = Recording(manifest, payload, trees)
    return rec.sign_with(sign) if sign else rec


def _logs(n):
    mine, ref = A.TransparencyLog(), JA.TransparencyLog()
    for i in range(n):
        data = A.leaf_data(f"k/{i}", f"m{i}", f"p{i}", i % 3)
        assert data == JA.leaf_data(f"k/{i}", f"m{i}", f"p{i}", i % 3)
        mine.append(data)
        ref.append(data)
    return mine, ref


# ---------------------------------------------------------- merkle log ----
@pytest.mark.parametrize("n", range(1, 17))
def test_log_roots_and_inclusion_proofs_equal_the_reference(n):
    mine, ref = _logs(n)
    assert A.TransparencyLog.EMPTY_ROOT == JA.TransparencyLog.EMPTY_ROOT
    for size in range(1, n + 1):
        assert mine.root(size) == ref.root(size)
        for i in range(size):
            path = mine.inclusion_proof(i, size)
            assert path == ref.inclusion_proof(i, size)
            data = mine.entries[i]
            assert A.verify_inclusion(data, i, size, path, mine.root(size))
            assert JA.verify_inclusion(data, i, size, path, mine.root(size))
            assert A.proof_wire_bytes(path) == JA.proof_wire_bytes(path)
            if path:          # a perturbed path folds to another root
                bad = [path[0][:-1] + ("0" if path[0][-1] != "0" else "1")]
                assert not A.verify_inclusion(data, i, size,
                                              bad + path[1:],
                                              mine.root(size))
            assert not A.verify_inclusion(data + b"x", i, size, path,
                                          mine.root(size))


@pytest.mark.parametrize("n", range(1, 17))
def test_log_consistency_proofs_equal_the_reference(n):
    mine, ref = _logs(n)
    for old in range(1, n + 1):
        proof = mine.consistency_proof(old, n)
        assert proof == ref.consistency_proof(old, n)
        args = (old, mine.root(old), n, mine.root(n), proof)
        assert A.verify_consistency(*args) and JA.verify_consistency(*args)
        if old < n:         # a forked old root is not extended
            assert not A.verify_consistency(old, mine.root(n), n,
                                            mine.root(n), proof)
    with pytest.raises(AttestationError):
        mine.consistency_proof(n + 1)
    with pytest.raises(AttestationError):
        mine.inclusion_proof(n, n)


# ---------------------------------------------------------------- keys ----
def test_epoch_keys_and_signatures_equal_the_reference():
    mine, ref = A.KeySchedule(KEY), JA.KeySchedule(KEY)
    for epoch in range(6):
        assert mine.epoch == ref.epoch == epoch
        assert mine.key_for_epoch(epoch) == ref.key_for_epoch(epoch)
        sig = mine.sign(b"payload")
        assert sig == ref.sign(b"payload") and sig.startswith(f"{epoch}:")
        assert ref.verify(b"payload", sig) and mine.verify(b"payload", sig)
        assert mine.describe() == ref.describe()
        mine.rotate()
        ref.rotate()
    # old epochs verify after rotation; a future epoch is a typed error
    assert mine.verify(b"payload", ref.sign(b"payload", epoch=1))
    with pytest.raises(FutureEpochError):
        mine.verify(b"payload", "99:" + "ab" * 32)
    assert not mine.verify(b"payload", "not-an-epoch:ab")


def test_workspace_refuses_a_rotated_away_epoch_key():
    sched = A.KeySchedule(KEY)
    stale = sched.current()
    sched.rotate()
    with pytest.raises(RotatedKeyError):
        Workspace(key=stale, device="cpu")
    ws = Workspace(registry=":memory:", key=sched.current(), device="cpu")
    assert ws.keys is sched and ws.key == KEY


# -------------------------------------------------------------- quotes ----
def _head(keys, log):
    size, root = log.size, log.root()
    return {"size": size, "root": root, "epoch": keys.epoch,
            "signature": keys.sign(head_signable({"size": size,
                                                  "root": root}))}


@pytest.mark.parametrize("maker", ["port", "reference"])
def test_quotes_verify_across_the_packages(maker):
    mine, _ = _logs(5)
    keys = (A if maker == "port" else JA).KeySchedule(KEY)
    head = _head(keys, mine)
    assert head_signable(head) == JV.head_signable(head)
    build = (A if maker == "port" else JA).build_quote
    quote = build(keys, recording_key="k/2", exec_fingerprint="p2",
                  plan_fingerprint="plan", frontier_digest="f", head=head,
                  annotations={"note": 1})
    leaf = {"key": "k/2", "manifest_fp": "m2", "payload_digest": "p2",
            "epoch": 2}
    kw = dict(head=head, leaf=leaf, proof=mine.inclusion_proof(2),
              leaf_index=2)
    for verify, sched in ((A.verify_quote, A.KeySchedule(KEY)),
                          (JA.verify_quote, JA.KeySchedule(KEY))):
        rep = verify(quote, keys=sched, **kw)
        assert rep["ok"] and rep["inclusion_checked"]
    assert A.quote_signable(quote) == JA.quote_signable(quote)
    for field in BOUND_FIELDS:
        bad = dict(quote)
        bad[field] = 999 if isinstance(quote[field], int) \
            else quote[field] + "x"
        with pytest.raises(QuoteVerificationError):
            A.verify_quote(bad, head=head, keys=A.KeySchedule(KEY))
    with pytest.raises(QuoteVerificationError):
        A.verify_quote(quote, head=head, keys=A.KeySchedule(b"other"))


def test_plan_replay_quote_equals_the_reference():
    """The same recording bytes, plan and head: the port's
    ``PlanExecutor.quote`` is the reference's, signature included."""
    rec = synthetic_recording(seed=3)
    jrec = JaxRecording.from_bytes(rec.to_bytes(), KEY)
    mine, _ = _logs(3)
    head = _head(A.KeySchedule(KEY), mine)
    ex = PlanExecutor()
    with pytest.raises(RuntimeError, match="before run"):
        ex.quote(A.KeySchedule(KEY), recording_key="q", head=head)
    ex.run(plan_for(rec, "all", jobs=4))
    jex = JaxExecutor()
    jex.run(jax_plan_for(jrec, "all", jobs=4))
    q = ex.quote(A.KeySchedule(KEY), recording_key="q", head=head)
    assert q == jex.quote(JA.KeySchedule(KEY), recording_key="q", head=head)
    assert q["exec_fingerprint"] == fingerprint(rec.payload)
    assert JA.verify_quote(q, head=head, keys=JA.KeySchedule(KEY))["ok"]


# ------------------------------------------------------ trust boundary ----
@pytest.fixture
def no_export_load(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("torch.export.load reached")
    monkeypatch.setattr(torch.export, "load", refuse)


def test_publish_appends_leaves_the_client_verifies():
    ws = Workspace(registry=":memory:", key=KEY, net="wifi", device="cpu")
    stats = [ws.service.publish(f"k/{i}", synthetic_recording(4_000, seed=i))
             for i in range(5)]
    assert [s["log_index"] for s in stats] == list(range(5))
    bundle = ws.service.proof_for("k/2")
    head, leaf = bundle["head"], bundle["leaf"]
    assert JA.KeySchedule(KEY).verify(JV.head_signable(head),
                                      head["signature"])
    assert JA.verify_inclusion(
        JA.leaf_data(leaf["key"], leaf["manifest_fp"],
                     leaf["payload_digest"], leaf["epoch"]),
        bundle["index"], head["size"], bundle["path"], head["root"])
    cl = ws.new_client(netem=ws.fresh_netem())
    cl.fetch("k/1")
    ws.service.publish("k/5", synthetic_recording(4_000, seed=5))
    cl.fetch("k/5")                 # consistency 5 -> 6 verified
    assert cl.stats["proofs_verified"] == 2 and cl._sth["size"] == 6
    assert ws.service.stats["consistency_proofs_served"] == 1


def test_unrotated_client_rejects_a_future_epoch_head():
    from repro_torch.registry import RegistryClient
    ws = Workspace(registry=":memory:", key=KEY, device="cpu")
    ws.rotate_epoch()
    ws.service.publish("k", synthetic_recording())
    stale = RegistryClient(ws.service, key=KEY, keys=A.KeySchedule(KEY))
    with pytest.raises(SplitViewError):
        stale.fetch("k")


def _mutants(good):
    """Each part of a published recording swapped: validly re-signed
    mutants die at the transparency leaf, the rest at the HMAC."""
    m = dict(good.manifest, static={"swapped": True})
    yield "manifest", Recording(m, good.payload, good.trees).sign_with(KEY)
    p = bytes(good.payload[:-1]) + b"\x00"
    yield "payload", Recording(dict(good.manifest,
                                    exec_fingerprint=fingerprint(p)),
                               p, good.trees).sign_with(KEY)
    yield "trees", Recording(dict(good.manifest), good.payload, b"[1]",
                             good.signature)
    yield "signature", Recording(dict(good.manifest), good.payload,
                                 good.trees, "0:" + "ab" * 32)
    yield "another recording", synthetic_recording(seed=9, name="evil")


@pytest.mark.parametrize("part", ["manifest", "payload", "trees",
                                  "signature", "another recording"])
def test_swapped_parts_are_refused_before_load(part, no_export_load):
    good = synthetic_recording(seed=7)
    mutant = dict(_mutants(good))[part]
    ws = Workspace(registry=":memory:", key=KEY, net="wifi", device="cpu")
    lease = ws.service.variant_lease("campaign", ["k"])
    assert lease.claim("k") is None
    assert lease.complete("k", good)["log_index"] == 0
    meta = ws.store.entry("k")["meta"]
    ws.store.put("k", recording_to_parts(mutant, ws.store.chunk_size),
                 meta=meta)
    signed = mutant.signature and part in ("manifest", "payload",
                                           "another recording")
    with pytest.raises(SplitViewError if signed else TamperedRecordingError):
        ws.client.fetch("k")


def test_a_store_entry_without_a_leaf_gets_no_proof():
    ws = Workspace(registry=":memory:", key=KEY, device="cpu")
    ws.store.put("rogue", recording_to_parts(synthetic_recording(seed=9),
                                             ws.store.chunk_size),
                 meta={"name": "rogue"})        # bypassed publish()
    with pytest.raises(AttestationError):
        ws.service.proof_for("rogue")
    with pytest.raises(AttestationError):
        ws.client.fetch("rogue")


def test_replica_relays_proofs_and_catches_a_regional_fork():
    ws = Workspace(registry=":memory:", key=KEY, net="wifi", device="cpu")
    ws.service.publish("k", synthetic_recording())
    cl = ws.new_client(netem=ws.fresh_netem(), region="eu")
    cl.fetch("k")
    rr = ws.read_replica("eu")
    assert rr.stats["proofs_relayed"] == 1 and cl.stats["proofs_verified"]
    # the primary forks its log behind the region's pinned head
    ws.service.log = A.TransparencyLog()
    ws.service._log_index.clear()
    ws.service.publish("k2", synthetic_recording(seed=2))
    with pytest.raises(SplitViewError):
        rr.proof_for("k2")


def test_quote_survives_epoch_rotation():
    ws = Workspace(registry=":memory:", key=KEY, net="wifi", device="cpu")
    ws.service.publish("q", synthetic_recording(seed=4))
    from repro_torch.core.replay_passes import verified_plan
    plan, _ = verified_plan(ws.client.fetch("q"), KEY, "all", jobs=4)
    ex = PlanExecutor(netem=ws.fresh_netem())
    ex.run(plan)
    head = ws.service.signed_head()
    quote = ex.quote(ws.keys, recording_key="q", head=head)
    assert ws.rotate_epoch() == 1
    verifier = A.KeySchedule(KEY)
    verifier.rotate()
    assert A.verify_quote(quote, head=head, keys=verifier)["ok"]
    assert quote["epoch"] == 0
