"""The port's recording registry (``repro_torch.registry``) against the
JAX reference's on the CPU, fed the same ``Recording`` bytes (a
synthetic recording of many chunks, and the port's own cody-mnist
recordings): chunk digests, index bytes and index signature, publish
wire bytes, log roots and proof bundles equal; a root written by either
package opens in the other and returns the same verified bytes; client
stats and the emulator's totals equal for a cold record-on-miss fetch, a
warm hit, a delta republish, an interrupted-then-resumed fetch and a
fetch that outgrows the chunk cache; ``key_for``'s golden values; the
single-flight lease records once for eight racing clients."""
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("msgpack")

from repro.core.netem import CELLULAR as J_CELLULAR  # noqa: E402
from repro.core.netem import WIFI as J_WIFI  # noqa: E402
from repro.core.netem import NetworkEmulator as JaxNetem  # noqa: E402
from repro.core.recording import Recording as JaxRecording  # noqa: E402
from repro import registry as JR  # noqa: E402
from repro_torch import registry as R  # noqa: E402
from repro_torch.api import Workspace  # noqa: E402
from repro_torch.core.attest import (SplitViewError,  # noqa: E402
                                     TamperedRecordingError, fingerprint)
from repro_torch.core.netem import CELLULAR, WIFI, NetworkEmulator  # noqa: E402
from repro_torch.core.recording import Recording  # noqa: E402

KEY = b"registry-test-key"
CHUNK = 32 * 1024
PROFILES = {"wifi": (WIFI, J_WIFI), "cellular": (CELLULAR, J_CELLULAR)}


def synthetic_recording(payload_bytes=200_000, seed=0, static=None):
    """Signed recording with an incompressible payload: several chunks at
    32 KiB, no export cost."""
    rng = np.random.default_rng(seed)
    payload = rng.bytes(payload_bytes)
    manifest = {"name": "synthetic", "static": static or {},
                "record_wall_s": 2.0, "record_virtual_s": 0.5,
                "exec_fingerprint": fingerprint(payload)}
    return Recording(manifest, payload, b"[]").sign_with(KEY)


@pytest.fixture(scope="module")
def cody():
    """The port's cody-mnist smoke recordings, both kinds, signed."""
    ws = Workspace(key=KEY, net="wifi", device="cpu")
    wl = ws.workload("cody-mnist", cache_len=32, block_k=4, batch=2, seq=8)
    return {kind: wl.record(kind).sign_with(KEY)
            for kind in ("prefill", "decode")}


@pytest.fixture
def recording(request, cody):
    return synthetic_recording() if request.param == "synthetic" \
        else cody[request.param]


RECORDINGS = pytest.mark.parametrize(
    "recording", ["synthetic", "prefill", "decode"], indirect=True)


def _both(root_mine=None, root_ref=None, chunk_size=CHUNK):
    mine = R.RecordingStore(root_mine, key=KEY, chunk_size=chunk_size)
    ref = JR.RecordingStore(root_ref, key=KEY, chunk_size=chunk_size)
    return ((mine, R.RegistryService(mine, signing_key=KEY)),
            (ref, JR.RegistryService(ref, signing_key=KEY)))


def _jax(rec):
    return JaxRecording.from_bytes(rec.to_bytes(), KEY)


@pytest.fixture
def frozen_clock(monkeypatch):
    """Entry meta carries ``published_s``: pin it so index bytes compare."""
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.25)


# ------------------------------------------------------------- key_for ----
def test_key_for_golden_values_equal_the_reference():
    """The literals of the reference's ``tests/test_api.py`` golden test."""
    for mod in (R, JR):
        assert mod.key_for("qwen2.5-3b", "decode",
                           {"kind": "decode", "cache_len": 128, "block_k": 8,
                            "batch": 4, "config_fp": "cfgfp"},
                           "meshfp") == "qwen2.5-3b/decode/c7bd577923f2d89f"
        assert mod.key_for("qwen2.5-3b", "prefill",
                           {"kind": "prefill", "cache_len": 128,
                            "block_k": 8, "batch": 1, "seq": 16,
                            "config_fp": "cfgfp"},
                           "meshfp") == "qwen2.5-3b/prefill/65e8b35e1789427b"
    assert R.key_arch("qwen2.5-3b-smoke") == "qwen2.5-3b"
    assert R.key_for("qwen2.5-3b-smoke", "prefill", {}, "m") == \
        R.key_for("qwen2.5-3b", "prefill", {}, "m")


# --------------------------------------------------------------- store ----
@RECORDINGS
def test_store_and_log_equal_the_reference(recording, frozen_clock,
                                           tmp_path):
    """Chunk files, index bytes and signature, publish stats (delta wire
    bytes included), roots, signed heads and proof bundles."""
    (store, svc), (jstore, jsvc) = _both(str(tmp_path / "mine"),
                                         str(tmp_path / "ref"))
    tweaked = Recording(dict(recording.manifest, static=dict(
        recording.manifest["static"], revision=2)), recording.payload,
        recording.trees).sign_with(KEY)
    for key, rec in (("a/prefill/0", recording), ("b/decode/1", recording),
                     ("a/prefill/0", tweaked)):
        assert svc.publish(key, rec) == jsvc.publish(key, _jax(rec))
    assert store._index_signable() == jstore._index_signable()
    assert store._index_sig == jstore._index_sig
    files = sorted(p.relative_to(tmp_path / "mine")
                   for p in (tmp_path / "mine").rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(tmp_path / "ref")
                           for p in (tmp_path / "ref").rglob("*")
                           if p.is_file())
    assert len(files) > 4 and files[-1].name == "index.msgpack"
    for f in files:
        assert (tmp_path / "mine" / f).read_bytes() == \
            (tmp_path / "ref" / f).read_bytes()
    assert svc.signed_head() == jsvc.signed_head()
    for key in ("a/prefill/0", "b/decode/1"):
        assert svc.proof_for(key) == jsvc.proof_for(key)
        assert svc.fetch_bytes(key) == jsvc.fetch_bytes(key)
    assert svc.consistency_between(1, 3) == jsvc.consistency_between(1, 3)
    assert dict(svc.stats) == dict(jsvc.stats)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_a_root_written_by_one_package_opens_in_the_other(writer, cody,
                                                          tmp_path):
    rec = cody["decode"]
    root = str(tmp_path)
    if writer == "port":
        R.RegistryService(R.RecordingStore(root, key=KEY),
                          signing_key=KEY).publish("k/decode/0", rec)
        other = JR.RegistryService(JR.RecordingStore(root, key=KEY),
                                   signing_key=KEY)
        client = JR.RegistryClient(other, key=KEY)
    else:
        JR.RegistryService(JR.RecordingStore(root, key=KEY),
                           signing_key=KEY).publish("k/decode/0", _jax(rec))
        other = R.RegistryService(R.RecordingStore(root, key=KEY),
                                  signing_key=KEY)
        client = R.RegistryClient(other, key=KEY)
    assert other.fetch_bytes("k/decode/0") == rec.to_bytes()
    assert client.fetch("k/decode/0") == rec.to_bytes()   # proofs verified
    assert client.stats["proofs_verified"] == 1


def test_store_dedups_reverifies_and_collects(tmp_path):
    rec = synthetic_recording()
    store = R.RecordingStore(str(tmp_path), key=KEY, chunk_size=CHUNK)
    svc = R.RegistryService(store, signing_key=KEY)
    s1 = svc.publish("a/b/c", rec)
    s2 = svc.publish("a/b/c", rec)
    assert s2["chunks_new"] == 0 and s2["chunks_reused"] == s1["chunks_new"]
    assert s2["version"] == 2
    digest = store.entry("a/b/c")["chunks"][1]["d"]
    path = tmp_path / "chunks" / digest[:2] / digest
    good = path.read_bytes()
    path.write_bytes(good[:-1] + bytes([good[-1] ^ 0x5A]))
    with pytest.raises(R.RegistryIntegrityError):
        R.RecordingStore(str(tmp_path), key=KEY).get("a/b/c")
    path.write_bytes(good)
    with pytest.raises(R.RegistryIntegrityError):   # wrong index key
        R.RecordingStore(str(tmp_path), key=b"other")
    store.delete("a/b/c")
    assert store.gc() == s1["chunks_new"]
    with pytest.raises(R.RegistryMissError):
        store.get("a/b/c")


def test_lru_chunk_cache_equals_the_reference():
    mine, ref = R.LRUBytes(100), JR.LRUBytes(100)
    ops = [("put", "a", 40), ("put", "b", 40), ("get", "a", 0),
           ("put", "c", 40), ("get", "b", 0), ("get", "c", 0),
           ("put", "d", 90), ("get", "a", 0), ("put", "d", 90)]
    for op, d, n in ops:
        if op == "put":
            mine.put(d, b"x" * n)
            ref.put(d, b"x" * n)
        else:
            assert mine.get(d) == ref.get(d)
    assert mine.summary() == ref.summary() and len(mine) == len(ref)


# -------------------------------------------------------------- client ----
def _client_runs(profile, rec, cache_bytes=32 << 20):
    """The same client scenarios through each package: returns per
    package the (client stats, emulator totals, service stats) after
    each scenario."""
    out = []
    for pkg, netem_cls, prof, r in (
            (R, NetworkEmulator, profile[0], rec),
            (JR, JaxNetem, profile[1], _jax(rec))):
        store = pkg.RecordingStore(None, key=KEY, chunk_size=CHUNK)
        svc = pkg.RegistryService(store, signing_key=KEY)
        rows = []
        net = netem_cls(prof)
        cold = pkg.RegistryClient(svc, net, key=KEY, cache_bytes=cache_bytes)
        calls = []
        blob = cold.fetch("k", record_fn=lambda: calls.append(1) or r)
        rows.append((dict(cold.stats), net.snapshot(), len(calls)))
        net = netem_cls(prof)
        warm = pkg.RegistryClient(svc, net, key=KEY)
        assert warm.fetch("k") == blob
        rows.append((dict(warm.stats), net.snapshot()))
        tweaked = type(r)(dict(r.manifest, static={"revision": 2}),
                          r.payload, r.trees).sign_with(KEY)
        rows.append(svc.publish("k", tweaked))
        warm.fetch("k")           # holds v1's chunks: pulls the delta only
        rows.append((dict(warm.stats), net.snapshot()))
        net = netem_cls(prof)
        resumed = pkg.RegistryClient(svc, net, key=KEY)
        with pytest.raises(pkg.FetchInterrupted):
            resumed.fetch("k", interrupt_after=2)
        rows.append((dict(resumed.stats), net.snapshot()))
        assert resumed.fetch("k") == warm.fetch("k")
        rows.append((dict(resumed.stats), net.snapshot(),
                     dict(svc.stats)))
        out.append(rows)
    return out


@pytest.mark.parametrize("net", ["wifi", "cellular"])
@RECORDINGS
def test_client_stats_and_link_totals_equal_the_reference(net, recording,
                                                          frozen_clock):
    mine, ref = _client_runs(PROFILES[net], recording)
    assert mine == ref
    cold = mine[0]
    assert cold[0]["recording_round_trips"] == 1 and cold[2] == 1
    assert mine[1][0]["registry_hits"] == 1
    assert "recording_round_trips" not in mine[1][0]


def test_chunks_evicted_mid_fetch_are_billed_again_as_the_reference():
    mine, ref = _client_runs(PROFILES["wifi"], synthetic_recording(),
                             cache_bytes=2 * CHUNK)
    assert mine == ref and mine[0][0]["chunks_refetched"] > 0


def test_miss_without_record_fn_and_tampered_bytes():
    svc = R.RegistryService(R.RecordingStore(None, key=KEY),
                            signing_key=KEY)
    with pytest.raises(R.RegistryMissError):
        R.RegistryClient(svc, key=KEY).fetch("absent")
    with pytest.raises(ValueError):
        R.RegistryClient(svc, key=b"")
    with pytest.raises(TamperedRecordingError):   # publish verifies too
        svc.publish("k", synthetic_recording().sign_with(b"other"))
    svc.publish("k", synthetic_recording())
    with pytest.raises(TamperedRecordingError):
        R.RegistryClient(svc, key=b"other").fetch("k")


# ------------------------------------------------------- single flight ----
def test_single_flight_eight_racing_misses_record_once():
    """Eight clients miss the same key at once: one records, the seven
    others block on its lease (no second record, no export racing on the
    device) and fetch the published bytes."""
    svc = R.RegistryService(R.RecordingStore(None, key=KEY),
                            signing_key=KEY)
    rec = synthetic_recording()
    calls, started = [], threading.Event()

    def record_fn():
        calls.append(threading.get_ident())
        started.set()
        time.sleep(0.2)         # the leaseholder records; others wait
        return rec

    results, errors = [None] * 8, []

    def fetch(i):
        try:
            results[i] = R.RegistryClient(svc, key=KEY).fetch(
                "k", record_fn=record_fn)
        except Exception as e:      # surfaced by the assert below
            errors.append(e)

    threads = [threading.Thread(target=fetch, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads) and not errors
    assert len(calls) == 1 and started.is_set()
    assert results == [rec.to_bytes()] * 8
    assert svc.stats["records"] == 1
    assert svc.stats["lease_waits"] + svc.stats["hits"] == 7


def test_a_failed_record_on_miss_reaches_every_waiter():
    svc = R.RegistryService(R.RecordingStore(None, key=KEY),
                            signing_key=KEY)
    gate = threading.Event()

    def failing():
        gate.wait(5)
        raise RuntimeError("export failed")

    errs = []

    def miss():
        try:
            svc.ensure("k", failing)
        except (RuntimeError, R.RegistryMissError) as e:
            errs.append(type(e).__name__)

    threads = [threading.Thread(target=miss) for _ in range(3)]
    for t in threads:
        t.start()
    time.sleep(0.1)
    gate.set()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    assert sorted(errs) == ["RegistryMissError"] * 2 + ["RuntimeError"]
    assert not svc._leases


def test_variant_lease_claims_compose_with_ensure():
    svc = R.RegistryService(R.RecordingStore(None, key=KEY),
                            signing_key=KEY)
    svc.publish("done", synthetic_recording(seed=1))
    lease = svc.variant_lease("g", ["done", "a", "b"])
    assert lease.claim("done") == "published"
    assert lease.claim("a") is None and lease.claim("a") == "leased"
    assert lease.claim("b") is None
    lease.fail("b")
    assert lease.complete("a", synthetic_recording(seed=2))["version"] == 1
    assert lease.outstanding() == set() and svc.has("a")
    with pytest.raises(KeyError):
        lease.complete("b", synthetic_recording(seed=3))
    assert dict(lease.stats) == {"skipped_published": 1, "skipped_leased": 1,
                                 "claims": 2, "failed": 1, "completed": 1}


def test_read_replica_pulls_each_chunk_from_the_primary_once():
    ws = Workspace(registry=":memory:", key=KEY, net="wifi", device="cpu")
    ws.service.publish("k", synthetic_recording())
    reads0 = ws.store.stats["chunk_reads"]
    for _ in range(3):
        ws.new_client(region="eu").fetch("k")
    rr = ws.read_replica("eu")
    n = len(ws.store.entry("k")["chunks"])
    assert rr.stats["chunk_pulls"] == n
    assert ws.store.stats["chunk_reads"] - reads0 == n
    with pytest.raises(SplitViewError):        # a client pinned to a
        cl = ws.new_client(region="eu")        # future head
        cl._sth = {"size": 5, "root": "0" * 64}
        cl.fetch("k")
