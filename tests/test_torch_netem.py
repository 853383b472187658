"""The port's network emulator, the ``CommitQueue``'s netem billing and the
tracer's ``clock_scope`` against the JAX package: the same call sequence
gives the same counters, spans and stamps, exactly (integers and
deterministic float sums in the same order)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import deferral as JD  # noqa: E402
from repro.core import netem as JN  # noqa: E402
from repro.obs import trace as JT  # noqa: E402
from repro_torch.core import deferral as D  # noqa: E402
from repro_torch.core import netem as N  # noqa: E402
from repro_torch.obs import trace as T  # noqa: E402


def test_profiles_equal_the_reference():
    assert sorted(N.PROFILES) == sorted(JN.PROFILES)
    for name, p in N.PROFILES.items():
        q = JN.PROFILES[name]
        assert (p.name, p.rtt_s, p.bw_bytes_s) == \
            (q.name, q.rtt_s, q.bw_bytes_s)


def _drive(mod, profile_name):
    """One mixed call sequence; returns (snapshot, deltas, chunks)."""
    em = mod.NetworkEmulator(mod.PROFILES[profile_name])
    deltas, chunks = [], []
    em.round_trip()
    outer = em.checkpoint()
    em.round_trip(send_bytes=1000, recv_bytes=7)
    em.async_trip()
    inner = em.checkpoint()
    em.async_trip(send_bytes=3, recv_bytes=0)
    em.collapse_spins(2)
    em.one_way(5000)
    em.one_way(123, direction="recv")
    em.one_way_recv(77)
    deltas.append(em.delta(inner))
    chunks.append(em.transfer(200_000))
    chunks.append(em.transfer(70_000, chunk_size=4096, direction="send"))
    chunks.append(em.transfer(0))
    deltas.append(em.delta(outer))
    deltas.append(em.delta({}))
    return em.snapshot(), deltas, chunks


@pytest.mark.parametrize("profile", ["local", "wifi", "cellular"])
def test_same_calls_give_the_same_snapshot_and_deltas(profile):
    assert _drive(N, profile) == _drive(JN, profile)


@pytest.mark.parametrize("call", [
    lambda em: em.one_way(1, direction="up"),
    lambda em: em.transfer(10, chunk_size=0),
    lambda em: em.transfer(10, direction="sideways")])
def test_bad_arguments_raise_as_in_the_reference(call):
    for mod in (N, JN):
        with pytest.raises(ValueError):
            call(mod.NetworkEmulator(mod.WIFI))


def test_reset_zeroes_every_counter():
    em = N.NetworkEmulator(N.CELLULAR)
    _ = [em.round_trip(), em.async_trip(), em.collapse_spins(3)]
    em.reset()
    assert em.snapshot() == JN.NetworkEmulator(JN.CELLULAR).snapshot()


def _payloads(tensor):
    arr = np.arange(12, dtype=np.float32)
    return [None, b"abc", bytearray(9), [b"x", None, 3], {"a": b"yy"}, 7,
            torch.from_numpy(arr) if tensor else arr]


@pytest.mark.parametrize("profile", ["wifi", "cellular"])
def test_commit_queue_bills_the_bytes_of_the_reference(profile):
    """``commit`` bills a blocking round trip and ``commit_async`` an
    async trip of the same bytes; a torch tensor payload bills its
    ``nbytes`` as a numpy array does."""
    snaps = []
    for mod, em_mod, tensor in ((D, N, True), (JD, JN, False)):
        em = em_mod.NetworkEmulator(em_mod.PROFILES[profile])
        q = mod.CommitQueue(lambda op: 5, netem=em, name="t")
        for i, p in enumerate(_payloads(tensor)):
            q.write(f"w{i}", p)
            q.read(f"r{i}")
            if i % 2:
                q.commit()
            else:
                q.commit_async(approx_bytes=32)
        q.poll("p")
        q.commit(approx_bytes=4096)
        assert q.commit() == [] and q.commit_async() == []
        snaps.append((em.snapshot(), q.commits, q.async_commits))
    assert snaps[0] == snaps[1]


def test_commit_queue_without_netem_bills_nothing():
    q = D.CommitQueue(lambda op: 1)
    q.read("a")
    assert q.commit() == [1] and q.netem is None


class _Clock:
    virtual_time_s = 0.0


def _traced_sessions(mod, tmod):
    """Two sessions on private emulators stamped through clock_scope, one
    span between them on the base clock."""
    base = _Clock()
    tr = tmod.Tracer(clock=lambda: base.virtual_time_s)
    for rtt in (3, 5):
        em = mod.NetworkEmulator(mod.WIFI)
        with tr.clock_scope(em):
            with tr.span("session", "record", rtt=rtt):
                for _ in range(rtt):
                    with tr.span("rt", "record"):
                        em.round_trip()
                tr.instant("mid", "record")
        base.virtual_time_s += 0.001
        with tr.span("between", "main"):
            base.virtual_time_s += 0.002
    with tr.clock_scope(None):
        tr.instant("none-scope", "main")
    assert not tmod.NULL and tmod.NULL.clock_scope(None) is not None
    return [{k: v for k, v in ev.items() if not k.startswith("wall")}
            for ev in tr.events]


def test_clock_scope_stamps_equal_the_reference():
    got, want = _traced_sessions(N, T), _traced_sessions(JN, JT)
    assert got == want
    starts = [ev["ts"] for ev in got if ev["name"] == "session"]
    assert starts[1] >= starts[0] + 3 * N.WIFI.rtt_s   # laid end to end
