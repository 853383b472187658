"""The port's fleet (``repro_torch.fleet``, ``Workspace.fleet``) against the
JAX reference on the CPU: open-loop arrivals equal the reference's
element for element; the balancer places and reports as the reference's
does under every policy; a live two-tenant fleet (qwen2.5-3b and
xlstm-350m smoke, fp32, the reference's params carried across) gives
the reference's outputs, pool stats and per-tenant latency quantiles,
and its own solo serving's tokens; load shedding, autoscaling and
cross-replica migration give the reference's counters and tokens; a
registry fleet boots each replica through its own client and link span
with the reference's client stats and emulator totals for the same
``Recording`` bytes; ``Workspace.report()`` carries the pool."""
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("msgpack")

import jax  # noqa: E402

from repro import fleet as JF  # noqa: E402
from repro.api import Workspace as JaxWorkspace  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import smoke_shrink as jax_smoke_shrink  # noqa: E402
from repro.core.recording import Recording as JaxRecording  # noqa: E402
from repro.obs import schema as JS  # noqa: E402
from repro_torch import fleet as F  # noqa: E402
from repro_torch.api import Workspace  # noqa: E402
from repro_torch.configs import get_config, smoke_shrink  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.obs import schema as S  # noqa: E402

KEY = b"fleet-test-key"
SHAPES = dict(cache_len=64, block_k=4, batch=2, prefill_batch=1, seq=8)
ARCHS = ("qwen2.5-3b", "xlstm-350m")


def strip_nondeterministic(obj):
    """Every dict field whose key mentions ``wall`` or ``boot`` dropped
    (the reference's ``benchmarks/fleet_bench.py`` rule): a registry
    replica's boot bills the fetched bytes, which differ between a
    ``torch.export`` payload and an XLA executable."""
    if isinstance(obj, dict):
        return {k: strip_nondeterministic(v) for k, v in obj.items()
                if "wall" not in k and "boot" not in k}
    if isinstance(obj, list):
        return [strip_nondeterministic(v) for v in obj]
    return obj


# ------------------------------------------------------------ traffic ----
MIXES = {
    "fixed": [("a", 8.0, 8, 12)],
    "ranges": [("a", 8.0, (4, 12), (2, 10)), ("b", 5.0, 8, 6)],
    "three": [("q", 20.0, (1, 3), (1, 40)), ("x", 0.5, 16, 4),
              ("z", 7.0, (8, 8), (3, 5))],
}


def _mixes(pkg, rows, vocab=256):
    return [pkg.TenantMix(t, r, prompt_len=p, max_new=m, vocab=vocab)
            for t, r, p, m in rows]


@pytest.mark.parametrize("burst", [None, (1.0, 0.25, 4.0), (0.5, 0.1, 3.0)],
                         ids=["poisson", "burst4", "burst3"])
@pytest.mark.parametrize("mix", sorted(MIXES))
@pytest.mark.parametrize("seed", [0, 7])
def test_arrivals_equal_the_reference(seed, mix, burst):
    kw = {} if burst is None else dict(zip(
        ("burst_every_s", "burst_len_s", "burst_x"), burst))
    got = F.OpenLoopTraffic(_mixes(F, MIXES[mix]), seed=seed,
                            **kw).generate(3.0)
    want = JF.OpenLoopTraffic(_mixes(JF, MIXES[mix]), seed=seed,
                              **kw).generate(3.0)
    assert got and [tuple(vars(a).values()) for a in got] == \
        [tuple(vars(a).values()) for a in want]


def test_traffic_same_seed_identical_and_ordered():
    mixes = _mixes(F, MIXES["ranges"])
    kw = dict(seed=7, burst_every_s=1.0, burst_len_s=0.25, burst_x=4.0)
    one = F.OpenLoopTraffic(mixes, **kw).generate(5.0)
    assert one == F.OpenLoopTraffic(mixes, **kw).generate(5.0)
    assert one != F.OpenLoopTraffic(mixes, **dict(kw, seed=8)).generate(5.0)
    assert all(0.0 <= a.t < 5.0 for a in one)
    assert [a.gid for a in one] == list(range(len(one)))
    assert sorted(one, key=lambda a: (a.t, a.tenant)) == one


def test_traffic_poisson_rate_and_burst_density():
    tr = F.OpenLoopTraffic([F.TenantMix("a", 50.0)], seed=0,
                           burst_every_s=1.0, burst_len_s=0.25, burst_x=4.0)
    arrivals = tr.generate(40.0)
    assert 3000 < len(arrivals) < 4000          # 40 s * (0.75*50 + 0.25*200)
    burst = sum(1 for a in arrivals if tr.in_burst(a.t))
    ratio = (burst / 10.0) / ((len(arrivals) - burst) / 30.0)
    assert 3.0 < ratio < 5.0
    plain = F.OpenLoopTraffic([F.TenantMix("a", 50.0)], seed=0).generate(40.0)
    assert 1700 < len(plain) < 2300


def test_traffic_tenant_substreams_independent():
    a_only = F.OpenLoopTraffic([F.TenantMix("a", 10.0)], seed=3).generate(4.0)
    both = F.OpenLoopTraffic([F.TenantMix("a", 10.0), F.TenantMix("b", 7.0)],
                             seed=3).generate(4.0)
    assert [(x.t, x.prompt, x.max_new) for x in a_only] == \
        [(x.t, x.prompt, x.max_new) for x in both if x.tenant == "a"]


def test_traffic_validates_inputs():
    with pytest.raises(ValueError, match="at least one"):
        F.OpenLoopTraffic([])
    with pytest.raises(ValueError, match="duplicate"):
        F.OpenLoopTraffic([F.TenantMix("a", 1.0), F.TenantMix("a", 2.0)])
    with pytest.raises(ValueError, match="burst_x"):
        F.OpenLoopTraffic([F.TenantMix("a", 1.0)], burst_x=0.5)


# ----------------------------------------------------------- balancer ----
class _FakeReplica:
    def __init__(self, name, cap=2, tenants=("a", "b"), load=0):
        self.name = name
        self.cap = cap
        self._tenants = tenants
        self.placed = []
        self._load = load

    def can_accept(self, tenant):
        return tenant in self._tenants and \
            self._load + len(self.placed) < self.cap

    def load(self):
        return self._load + len(self.placed)

    def submit(self, arrival):
        self.placed.append(arrival)


def _arr(pkg, gid, tenant="a", t=0.0):
    return pkg.Arrival(gid, t, tenant, (3, 4, 5), 4)


def _balance(pkg, policy, queue_limit=None):
    """One script of offers and dispatches: a mixed-load fleet, a full
    replica, a tenant only one replica serves, a retired replica's pins
    dropped.  Returns the placements (gid, replica) and snapshots."""
    lb = pkg.LoadBalancer(policy, queue_limit=queue_limit)
    reps = [_FakeReplica("r0", cap=3, load=1), _FakeReplica("r1", cap=4),
            _FakeReplica("r2", cap=2, tenants=("b",))]
    trace = []
    for g, tenant in enumerate("aabababbaa"):
        lb.offer(_arr(pkg, g, tenant))
        if g % 3 == 2:
            trace.append([(a.gid, r.name) for a, r in lb.dispatch(reps)])
    trace.append([(a.gid, r.name) for a, r in lb.dispatch(reps[1:])])
    lb.forget("r0")
    reps[1].placed.clear()
    trace.append([(a.gid, r.name) for a, r in lb.dispatch(reps[1:])])
    return trace, lb.snapshot(), [a.gid for a in lb.queue]


@pytest.mark.parametrize("queue_limit", [None, 4])
@pytest.mark.parametrize("policy", F.POLICIES)
def test_balancer_placements_equal_the_reference(policy, queue_limit):
    assert F.POLICIES == JF.POLICIES
    got = _balance(F, policy, queue_limit)
    assert got == _balance(JF, policy, queue_limit)
    assert got[1]["policy"] == policy and got[1]["offered"] == 10


@pytest.mark.parametrize("policy", F.POLICIES)
def test_balancer_cases_of_the_reference(policy):
    """The reference's ``_FakeReplica`` cases, under every policy."""
    # rotation / least-load / first pin over two empty replicas
    lb = F.LoadBalancer(policy)
    reps = [_FakeReplica("r0", cap=9), _FakeReplica("r1", cap=9)]
    for g in range(4):
        lb.offer(_arr(F, g))
    lb.dispatch(reps)
    want = {"round_robin": [[0, 2], [1, 3]],
            "least_loaded": [[0, 2], [1, 3]],
            "cache_affinity": [[0, 1, 2, 3], []]}[policy]
    assert [[a.gid for a in r.placed] for r in reps] == want
    # least load with a name tie-break
    lb = F.LoadBalancer(policy)
    reps = [_FakeReplica("r0", cap=9, load=3),
            _FakeReplica("r1", cap=9, load=1),
            _FakeReplica("r2", cap=9, load=1)]
    lb.offer(_arr(F, 0))
    lb.dispatch(reps)
    assert [len(r.placed) for r in reps] == (
        [1, 0, 0] if policy == "round_robin" else [0, 1, 0])
    # admission at the queue limit
    lb = F.LoadBalancer(policy, queue_limit=2)
    assert [lb.offer(_arr(F, g)) for g in range(5)] == \
        [True, True, False, False, False]
    snap = lb.snapshot()
    assert snap["offered"] == 5 and snap["rejected"] == 3
    assert snap["queue_depth"] == 2 == snap["queue_hwm"]
    # FIFO with skip: no head-of-line blocking
    lb = F.LoadBalancer(policy)
    only_b = _FakeReplica("r0", cap=4, tenants=("b",))
    lb.offer(_arr(F, 0, "a"))
    lb.offer(_arr(F, 1, "b"))
    assert [(a.gid, r.name) for a, r in lb.dispatch([only_b])] == \
        [(1, "r0")]
    assert [a.gid for a in lb.queue] == [0]


def test_balancer_cache_affinity_sticky_waits_and_repins():
    lb = F.LoadBalancer("cache_affinity")
    r0, r1 = _FakeReplica("r0", cap=2), _FakeReplica("r1", cap=2)
    lb.offer(_arr(F, 0, "a"))
    lb.dispatch([r0, r1])
    lb.offer(_arr(F, 1, "a"))
    lb.dispatch([r0, r1])
    assert len(r0.placed) == 2 and not r1.placed
    lb.offer(_arr(F, 2, "a"))
    lb.dispatch([r0, r1])
    assert lb.queue_depth() == 1 and not r1.placed
    lb.forget("r0")
    lb.dispatch([r1])
    assert len(r1.placed) == 1 and lb.queue_depth() == 0
    with pytest.raises(ValueError, match="unknown policy"):
        F.LoadBalancer("random")


# ----------------------------------------------------- live fleet e2e ----
@pytest.fixture(scope="module")
def live():
    """Both packages' live workspaces with qwen2.5-3b and xlstm-350m smoke
    in fp32; the reference's params for seeds 0 and 1 (tenant i serves on
    seed i) carried into the port's params memo."""
    ws, jws = Workspace(device="cpu"), JaxWorkspace()
    wls, jwls = [], []
    for arch in ARCHS:
        jwl = jws.workload(jax_smoke_shrink(jax_get_config(arch),
                                            dtype="float32"), **SHAPES)
        wl = ws.workload(smoke_shrink(get_config(arch), dtype="float32"),
                         **SHAPES)
        for seed in (0, 1):
            wl._params[seed] = params_from_jax(
                wl.cfg, jax.tree.map(np.asarray, jwl.params(seed)),
                device="cpu")
        wls.append(wl)
        jwls.append(jwl)
    return ws, wls, jws, jwls


def _solo_outputs(workloads, arrivals, seed=0):
    """Each arrival served ALONE through the same channel and params the
    fleet's stream uses (stream i gets seed + i)."""
    out = {}
    for i, wl in enumerate(workloads):
        eng = wl.engine(seed=seed + i)
        for a in arrivals:
            if a.tenant != wl.cfg.name:
                continue
            rid = eng.submit(list(a.prompt), a.max_new)
            out[a.gid] = list(eng.run()[rid])
    return out


def _quantiles(ws, pool, wls):
    return {wl.cfg.name: ws.metrics.quantiles(
        "fleet_request_latency_s", pool=pool.name, tenant=wl.cfg.name)
        for wl in wls}


def _run_both(live, tenants, arrivals_of, **fleet_kw):
    """The same fleet in both packages over the same arrivals: (port's
    pool, outputs) and the reference's."""
    ws, wls, jws, jwls = live
    out = []
    for pkg, w, ws_ in ((F, [wls[i] for i in tenants], ws),
                        (JF, [jwls[i] for i in tenants], jws)):
        pool, _ = ws_.fleet(w, **fleet_kw)
        out.append((pool, pool.run(arrivals_of(pkg, w)), _quantiles(
            ws_, pool, w)))
    return out


def test_live_fleet_equals_the_reference_and_solo(live):
    ws, wls, _, _ = live

    def arrivals(pkg, w):
        return pkg.OpenLoopTraffic(
            [pkg.TenantMix(wl.cfg.name, 8.0, prompt_len=(4, 12),
                           max_new=(4, 12), vocab=min(wl.cfg.vocab_size, 256))
             for wl in w], seed=11, burst_every_s=0.5, burst_len_s=0.1,
            burst_x=3.0).generate(1.0)
    (pool, outs, q), (jpool, jouts, jq) = _run_both(
        live, (0, 1), arrivals, replicas=2, policy="least_loaded", name="lb")
    arr = arrivals(F, wls)
    assert len(outs) == len(arr) and not pool.failed
    assert outs == jouts
    assert outs == _solo_outputs(wls, arr)
    assert pool.stats() == jpool.stats()        # live: boot bills nothing
    assert q == jq and all(v is not None for v in q.values())
    assert all(r.served > 0 for r in pool.replicas)
    stats = S.check_fleet_stats(pool.stats())
    assert stats["served"] == stats["balancer"]["placed"] == len(arr)
    rep = S.check_workspace_report(ws.report())
    JS.check_workspace_report(rep)
    assert [f["name"] for f in rep["fleet"]] == ["lb"]
    with pytest.raises(S.SchemaError, match="missing fields"):
        S.check_fleet_stats({"name": "broken"})


def _shed(pkg, wl):
    return pkg.OpenLoopTraffic(
        [pkg.TenantMix(wl.cfg.name, 200.0, prompt_len=(4, 8), max_new=8,
                       vocab=min(wl.cfg.vocab_size, 256))],
        seed=5).generate(0.2)


def _burst(pkg, wl):
    rng = np.random.default_rng(9)

    def prompt():
        return tuple(int(x) for x in rng.integers(
            3, min(wl.cfg.vocab_size, 256), 6))
    arrivals = [pkg.Arrival(g, 0.0, wl.cfg.name, prompt(), 32)
                for g in range(6)]
    return arrivals + [pkg.Arrival(6 + g, 0.0, wl.cfg.name, prompt(), 2)
                       for g in range(8)]


SCENARIOS = {
    "shed": (_shed, dict(replicas=1, policy="round_robin", pending_limit=2,
                         queue_limit=3)),
    "autoscale": (_burst, dict(replicas=1, policy="round_robin",
                               pending_limit=6, autoscale=True, queue_high=4,
                               sustain_ticks=2, idle_ticks=2, boot_ticks=2,
                               min_replicas=1, max_replicas=3)),
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_admission_and_autoscale_equal_the_reference(live, scenario):
    make, kw = SCENARIOS[scenario]
    (pool, outs, _), (jpool, jouts, _) = _run_both(
        live, (0,), lambda pkg, w: make(pkg, w[0]), name=scenario, **kw)
    assert outs == jouts and pool.stats() == jpool.stats()
    stats = S.check_fleet_stats(pool.stats())
    arrivals = make(F, live[1][0])
    admitted = [a for a in arrivals if a.gid in outs]
    assert outs == _solo_outputs(live[1][:1], admitted)
    if scenario == "shed":
        snap = stats["balancer"]
        assert snap["rejected"] > 0 and len(outs) == snap["placed"]
        assert snap["placed"] + snap["rejected"] == snap["offered"] == \
            len(arrivals)
    else:
        assert len(outs) == len(arrivals) and not pool.failed
        assert stats["autoscale"]["scale_ups"] >= 1
        assert stats["autoscale"]["retired"] >= 1
        scaled = pool.replicas[1]
        assert scaled.ready_at > 0.0 and scaled.served > 0 and scaled.retired
        assert not pool.replicas[0].retired


def _migrate(pkg, ws, wl):
    """Three requests decode partly on replica A, move to B, finish
    there; returns what can be compared across the packages."""
    pool, _ = ws.fleet([wl], replicas=2, policy="round_robin", name="mig")
    tenant = wl.cfg.name
    a, b = pool.replicas
    rng = np.random.default_rng(13)
    arrivals = [pkg.Arrival(g, 0.0, tenant, tuple(int(x) for x in rng.integers(
        3, min(wl.cfg.vocab_size, 256), 5)), 16) for g in range(3)]
    for x in arrivals:
        a.submit(x)
    for _ in range(3):
        a.step()
    assert a.load() == 3
    moved = pool.migrate(tenant, a.name, b.name)
    assert moved == 3 and a.load() == 0 and b.load() == 3
    assert not a.has_work()
    steps = 0
    while b.has_work():
        b.step()
        steps += 1
        assert steps < 500
    b.finish()
    done = {gid: toks for gid, _, toks, failed in b.collect_done()
            if not failed}
    ex_a, ex_b = (r.scheduler.streams[tenant] for r in (a, b))
    return (done, pool.stats(), dict(a.stats), dict(b.stats),
            dict(ex_a.stats), dict(ex_b.stats)), arrivals


def test_migration_resumes_bit_exact_as_the_reference(live):
    ws, wls, jws, jwls = live
    got, arrivals = _migrate(F, ws, wls[0])
    want, _ = _migrate(JF, jws, jwls[0])
    assert got == want
    done, stats, sa, sb, ex_a, _ = got
    assert done == _solo_outputs(wls[:1], arrivals)
    assert stats["migrations"] == 1
    assert sb["adopted"] == 3 and sa["released"] == 3
    assert ex_a["released_requests"] == 3


def _release_adopt(ws, wl, request_cls):
    """Three queued requests released in order from one stream and
    adopted by another (one of them with a committed tail)."""
    src = ws.scheduler([wl])[0].streams[wl.cfg.name]
    dst = ws.scheduler([wl])[0].streams[wl.cfg.name]
    rids = [src.submit([5, 6, 7 + i], 4) for i in range(3)]
    dst.submit([3, 4], 2)
    moved = src.release_pending()
    assert [r.rid for r in moved] == rids and not src.requests
    assert src.release_pending() == []
    moved[1].generated, moved[1].committed = [9, 10], 2
    new = [dst.adopt(r) for r in moved]
    tail = request_cls(41, [8], 4, generated=[11], committed=1)
    new.append(dst.adopt(tail))
    return (new, [(r.rid, r.prompt, r.prefix()) for r in moved + [tail]],
            list(dst.pending), dict(src.stats), dict(dst.stats))


def test_executor_release_and_adopt_equal_the_reference(live):
    from repro.serving.executor import Request as JaxRequest
    from repro_torch.serving.executor import Request
    ws, wls, jws, jwls = live
    got = _release_adopt(ws, wls[0], Request)
    assert got == _release_adopt(jws, jwls[0], JaxRequest)
    new, reqs, pending, src_stats, _ = got
    assert new == [1, 2, 3, 4] and pending == [0, 1, 2, 3, 4]
    assert reqs[1][2] == [5, 6, 8, 9] and src_stats["released_requests"] == 3


# --------------------------------------------- registry-backed fleets ----
@pytest.fixture(scope="module")
def cody_recs():
    """The port's cody-mnist smoke recordings (both kinds), signed."""
    wl = Workspace(key=KEY, net="wifi", device="cpu").workload(
        "cody-mnist", **SHAPES)
    return wl.cfg, {kind: wl.record(kind).sign_with(KEY)
                    for kind in ("prefill", "decode")}


@pytest.fixture
def registries(cody_recs, monkeypatch):
    """Both packages' in-memory registries holding the same recording
    bytes under the port's keys (``time.time`` pinned: entry meta carries
    ``published_s``)."""
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.25)
    cfg, recs = cody_recs
    ws = Workspace(registry=":memory:", key=KEY, net="wifi", device="cpu")
    jws = JaxWorkspace(registry=":memory:", key=KEY, net="wifi")
    wl = ws.workload(cfg, **SHAPES)
    for kind, rec in recs.items():
        assert wl.publish(rec)["key"] == wl.key(kind)
        jws.service.publish(wl.key(kind),
                            JaxRecording.from_bytes(rec.to_bytes(), KEY))
    return ws, wl, jws


def _fetches(ws, keys, region=None):
    """A fresh client on its own emulator fetches ``keys``: (client stats,
    emulator totals)."""
    net = ws.fresh_netem()
    c = ws.new_client(netem=net, region=region)
    for k in keys:
        c.fetch(k)
    return dict(c.stats), net.snapshot()


def test_per_replica_billing_isolation_equals_the_reference(registries):
    ws, wl, jws = registries
    for w in (ws, jws):
        n1, n2 = w.fresh_netem(), w.fresh_netem()
        c1, c2 = w.new_client(netem=n1), w.new_client(netem=n2)
        c1.fetch(wl.key("prefill"))
        assert c1.stats["registry_hits"] == 1 and n1.virtual_time_s > 0
        assert c2.stats["chunks_fetched"] == 0 and n2.virtual_time_s == 0.0
        c2.fetch(wl.key("prefill"))
        assert c2.stats["chunks_fetched"] == c1.stats["chunks_fetched"]
        assert w.report()["registry_client"] == {}
    assert _fetches(ws, [wl.key("decode")]) == \
        _fetches(jws, [wl.key("decode")])


def test_read_replica_absorbs_regional_traffic_as_the_reference(registries):
    ws, wl, jws = registries
    keys = [wl.key("prefill")]
    got, want = [], []
    for w, out in ((ws, got), (jws, want)):
        for region in ("r0", "r0", "r1"):
            out.append((_fetches(w, keys, region), w.store.summary(),
                        w.read_replica(region).summary()))
    assert got == want
    pulls = got[0][2]["chunk_pulls"]
    assert pulls > 0 and got[1][2]["chunk_pulls"] == pulls
    assert got[1][1]["chunk_reads"] == got[0][1]["chunk_reads"]
    assert got[2][1]["chunk_reads"] == got[0][1]["chunk_reads"]
    assert got[2][1]["cache"]["hits"] > got[1][1]["cache"]["hits"]
    store = S.check_registry_store_stats(ws.report()["registry_store"])
    assert [r["region"] for r in store["read_replicas"]] == ["r0", "r1"]


def test_registry_fleet_boots_warm_per_replica_spans(registries,
                                                     monkeypatch):
    """Each replica boots through its OWN client and emulator (warm:
    registry hits, no recording), in its region; the boot's client stats
    and emulator totals equal the reference's clients fetching the same
    keys in the same order; the fleet serves bit-exactly against solo and
    the report carries it."""
    ws, wl, jws = registries
    clients = []
    new_client = ws.new_client

    def spy(*a, **k):
        clients.append(new_client(*a, **k))
        return clients[-1]
    monkeypatch.setattr(ws, "new_client", spy)
    unique = len({c["d"] for kind in ("prefill", "decode")
                  for c in ws.store.entry(wl.key(kind))["chunks"]})
    reads0 = ws.store.summary()["chunk_reads"]
    pool, _ = ws.fleet([wl], replicas=2, policy="cache_affinity",
                       regions=2, name="warm")
    assert [r.region for r in pool.replicas] == [0, 1]
    assert ws.store.summary()["chunk_reads"] - reads0 <= unique
    keys = [wl.key("prefill"), wl.key("decode")]
    for i, (r, c) in enumerate(zip(pool.replicas, clients)):
        want = _fetches(jws, keys, region=f"r{i}")
        assert (dict(c.stats), r.netem.snapshot()) == want
        assert r.boot_virtual_s == want[1]["time_s"] > 0.0
        assert c.stats["registry_hits"] == 2 and \
            c.stats["recording_round_trips"] == 0
    monkeypatch.setattr(ws, "new_client", new_client)
    arrivals = F.OpenLoopTraffic(
        [F.TenantMix(wl.cfg.name, 10.0, prompt_len=SHAPES["seq"], max_new=8,
                     vocab=min(wl.cfg.vocab_size, 256))],
        seed=2).generate(0.8)
    outputs = pool.run(arrivals)
    assert len(outputs) == len(arrivals) and not pool.failed
    assert outputs == _solo_outputs((wl,), arrivals)
    jarr = JF.OpenLoopTraffic(
        [JF.TenantMix(wl.cfg.name, 10.0, prompt_len=SHAPES["seq"],
                      max_new=8, vocab=min(wl.cfg.vocab_size, 256))],
        seed=2).generate(0.8)
    assert [(a.t, a.prompt) for a in jarr] == \
        [(a.t, a.prompt) for a in arrivals]
    # the reference's registry fleet on its own recordings of the same
    # workload: the same pool accounting but for the boot's billed bytes
    ref = JaxWorkspace(registry=":memory:", key=KEY, net="wifi")
    rwl = ref.workload("cody-mnist", **SHAPES)
    for kind in ("prefill", "decode"):
        rwl.publish(rwl.record(kind))
    jpool, _ = ref.fleet([rwl], replicas=2, policy="cache_affinity",
                         regions=2, name="warm")
    jpool.run(jarr)
    assert strip_nondeterministic(pool.stats()) == \
        strip_nondeterministic(jpool.stats())
    rep = S.check_workspace_report(ws.report())
    JS.check_workspace_report(rep)
    assert [f["name"] for f in rep["fleet"]] == ["warm"]
    assert all(x["boot_virtual_s"] > 0 for x in rep["fleet"][0]["replicas"])
