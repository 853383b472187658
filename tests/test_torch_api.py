"""The port's public API (``repro_torch.api``: ``Workspace``,
``Workload``) on the CPU, against the JAX reference where both run:
``publish(record(kind))`` files under ``key(kind)``; record -> publish ->
fetch -> verify -> replay on cody-mnist smoke gives the tokens of the
port's live Engine and of the JAX Engine on the same (converted) params;
record-on-miss records once through the service's session; the report
has the reference's keys and passes both packages' schema checks; a
campaign publishes through the variant lease as the reference's does;
the launchers (``record --registry``, ``serve --from-registry``,
``attest``) and the ported examples run."""
import json
import os
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("msgpack")

import jax  # noqa: E402

from repro.api import Workspace as JaxWorkspace  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import smoke_shrink as jax_smoke_shrink  # noqa: E402
from repro.core.recording import Recording as JaxRecording  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.obs import schema as JS  # noqa: E402
from repro.record import VariantSpec as JaxVariantSpec  # noqa: E402
from repro_torch.api import Workspace  # noqa: E402
from repro_torch.attest import KeySchedule, verify_quote  # noqa: E402
from repro_torch.configs import get_config, smoke_shrink  # noqa: E402
from repro_torch.core.channel import ReplayChannel  # noqa: E402
from repro_torch.core.recorder import mesh_descriptor  # noqa: E402
from repro_torch.launch import record as record_cli  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.obs import schema as S  # noqa: E402
from repro_torch.record import VariantSpec  # noqa: E402
from repro_torch.registry import key_for  # noqa: E402
from repro_torch.core.attest import fingerprint  # noqa: E402

KEY = b"api-test-key"
SHAPES = dict(cache_len=32, block_k=4, batch=2, prefill_batch=1, seq=8)
KINDS = ("prefill", "decode")


@pytest.fixture(scope="module")
def lifecycle():
    """cody-mnist smoke (fp32) recorded by the cloud role and published
    into an in-memory registry; the reference's params carried over."""
    jcfg = jax_smoke_shrink(jax_get_config("cody-mnist"), dtype="float32")
    cfg = smoke_shrink(get_config("cody-mnist"), dtype="float32")
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    ws = Workspace(registry=":memory:", key=KEY, net="wifi", device="cpu")
    wl = ws.workload(cfg, **SHAPES)
    recs = {kind: wl.record(kind) for kind in KINDS}
    pubs = {kind: wl.publish(recs[kind]) for kind in KINDS}
    return dict(jcfg=jcfg, cfg=cfg, jp=jp, tp=tp, ws=ws, wl=wl, recs=recs,
                pubs=pubs)


def _prompts(vocab, n=3, seed=7):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(3, vocab, SHAPES["seq"])))
            for _ in range(n)]


def _serve(eng, prompts, max_new=10):
    for p in prompts:
        eng.submit(p, max_new)
    return eng.run(), dict(eng.stats)


# ------------------------------------------------------------ identity ----
@pytest.mark.parametrize("kind", KINDS)
def test_publish_files_each_kind_under_its_key(kind, lifecycle):
    wl, rec, pub = lifecycle["wl"], lifecycle["recs"][kind], \
        lifecycle["pubs"][kind]
    assert pub["key"] == wl.key(kind) == rec.manifest["name"]
    assert wl._key_of(rec) == wl.key(kind)
    assert rec.manifest["mesh"] == mesh_descriptor() == wl.mesh
    static = dict(wl.static_meta(kind), backend="torch")
    assert rec.manifest["static"] == static
    assert wl.key(kind) == key_for(wl.cfg.name, kind, {
        **static, "config_fp": wl.cfg.fingerprint()}, fingerprint(wl.mesh))
    assert wl.key(kind).startswith(f"cody-mnist/{kind}/")
    # another workload of the same shapes derives the same key; decode's
    # identity ignores seq
    other = Workspace(key=KEY, device="cpu").workload(
        lifecycle["cfg"], **dict(SHAPES, seq=SHAPES["seq"] + 1))
    assert (other.key(kind) == wl.key(kind)) == (kind == "decode")


def test_variants_cover_the_prefill_buckets(lifecycle):
    wl = lifecycle["wl"]
    items = wl.variants(seqs=[8, 16])
    assert [(w.seq, k) for w, k in items] == [(8, "prefill"),
                                              (16, "prefill"),
                                              (8, "decode")]
    assert items[0][0] is wl and items[2][0] is wl
    keys = [w.key(k) for w, k in items]
    assert len(set(keys)) == 3 and items[1][0].key("decode") == keys[2]


# ----------------------------------------------------------- lifecycle ----
def test_registry_replay_equals_live_and_the_jax_engine(lifecycle):
    cfg, tp, ws, wl = (lifecycle[k] for k in ("cfg", "tp", "ws", "wl"))
    prompts = _prompts(cfg.vocab_size)
    eng = wl.engine(params=tp)
    assert isinstance(eng.channel, ReplayChannel)
    assert eng.registry_client is ws.client
    assert eng.fixed_prompt_len == SHAPES["seq"]
    got, st = _serve(eng, prompts)
    assert ws.client.stats["proofs_verified"] >= 2
    rstats = wl.replayer_stats()
    assert rstats["loads"] == 2 and rstats["executions"] == \
        2 + st["prefill_dispatches"] + st["blocks_dispatched"]  # warm both
    live = Workspace(device="cpu").workload(cfg, **SHAPES).engine(params=tp)
    want, live_st = _serve(live, prompts)
    assert got == want and st["host_syncs"] == live_st["host_syncs"]
    jwl = JaxWorkspace(key=KEY).workload(lifecycle["jcfg"], **SHAPES)
    jwant, jst = _serve(jwl.engine(params=lifecycle["jp"]), prompts)
    assert got == jwant and st["host_syncs"] == jst["host_syncs"]


def test_fetch_verifies_and_record_on_miss_records_once():
    ws = Workspace(registry=":memory:", key=KEY, net="wifi", device="cpu")
    wl = ws.workload("cody-mnist", cache_len=16, block_k=2, batch=1, seq=4)
    blob = wl.fetch("prefill", record_on_miss=True)
    svc, cl = ws.service.stats, ws.client.stats
    assert svc["records"] == 1 and svc["record_virtual_s"] > 0
    assert cl["recording_round_trips"] == 1 and cl["proofs_verified"] == 1
    rec = JaxRecording.from_bytes(blob, KEY)       # the reference verifies
    assert rec.manifest["name"] == wl.key("prefill")
    assert rec.manifest["record_session"]["net"] == "wifi"
    assert wl.fetch("prefill") == blob and svc["records"] == 1
    assert ws.client.stats["registry_hits"] == 1


def test_channel_sources_are_exclusive_and_fleet_waits():
    ws = Workspace(registry=":memory:", key=KEY, device="cpu")
    wl = ws.workload("cody-mnist", **SHAPES)
    with pytest.raises(ValueError, match="exactly one source"):
        wl.channel(recordings_dir="somewhere")
    with pytest.raises(ValueError, match="requires the signing key"):
        Workspace(registry=":memory:", device="cpu")
    with pytest.raises(NotImplementedError, match="item 10"):
        ws.fleet(["cody-mnist"])
    with pytest.raises(ValueError, match="unknown net profile"):
        Workspace(net="dialup", device="cpu")


# -------------------------------------------------------- attestation ----
def test_attested_replay_quotes_verify_offline_in_both_packages(lifecycle):
    from repro.attest import KeySchedule as JaxKeySchedule
    from repro.attest import verify_quote as jax_verify_quote
    ws, wl = lifecycle["ws"], lifecycle["wl"]
    rep, quote, bundle = wl.attested_replay("decode", jobs=8)
    assert rep["dispatches"] > 0 and ws.quotes[-1] is quote
    kw = dict(head=bundle["head"], leaf=bundle["leaf"],
              proof=bundle["path"], leaf_index=bundle["index"])
    assert verify_quote(quote, keys=KeySchedule(KEY), **kw)["ok"]
    assert jax_verify_quote(quote, keys=JaxKeySchedule(KEY), **kw)["ok"]
    assert quote["exec_fingerprint"] == bundle["leaf"]["payload_digest"]


# ---------------------------------------------------------- reporting ----
def _key_tree(d):
    return {k: _key_tree(v) if isinstance(v, dict) and k in (
        "attest", "registry_store") else None for k, v in d.items()}


def test_report_has_the_reference_keys_and_passes_both_schemas(lifecycle):
    ws = Workspace(registry=":memory:", key=KEY, net="wifi", device="cpu")
    wl = ws.workload(lifecycle["cfg"], **SHAPES)
    for kind in KINDS:
        wl.record(kind, artifact=lifecycle["recs"][kind], jobs=8)
        wl.publish(lifecycle["recs"][kind])
    wl.replay("decode", artifact=lifecycle["recs"]["decode"], jobs=8)
    wl.attested_replay("prefill", jobs=8)
    sched, _ = ws.scheduler([wl])
    for p in _prompts(wl.cfg.vocab_size, 2):
        sched.submit(wl.cfg.name, p, 4)
    sched.run()
    ws.new_client(region="eu").fetch(wl.key("prefill"))
    rep = ws.report()
    S.check_workspace_report(rep)
    JS.check_workspace_report(rep)
    assert len(rep["sessions"]) == 2 and len(rep["replays"]) == 2
    assert rep["fleet"] == [] and rep["attest"]["quotes"] == 1
    assert rep["registry_store"]["read_replicas"][0]["region"] == "eu"
    jws = JaxWorkspace(registry=":memory:", key=KEY, net="wifi")
    jws.service.publish("k", JaxRecording.from_bytes(
        lifecycle["recs"]["prefill"].to_bytes(), KEY))
    jws.client.fetch("k")
    jws.read_replica("eu")
    assert _key_tree(rep) == _key_tree(jws.report())
    with pytest.raises(S.SchemaError):
        S.check_workspace_report(dict(rep, attest={"epoch": 0}))


@pytest.mark.parametrize("path", sorted(
    p for p in os.listdir(os.path.join(os.path.dirname(__file__), ".."))
    if p.startswith(("BENCH_", "TRACE_")) and p.endswith(".json")))
def test_schema_checks_of_the_bench_files_equal_the_reference(path):
    full = os.path.join(os.path.dirname(__file__), "..", path)
    assert S.check_bench_file(full) == JS.check_bench_file(full)


def test_campaign_publishes_through_the_variant_lease_as_the_reference(
        lifecycle):
    """Both packages fan the same artifacts out over two devices into
    their registries: equal campaign stats, service stats and proofs."""
    out = []
    for ws, spec, conv in (
            (Workspace(registry=":memory:", key=KEY, net="wifi",
                       device="cpu"), VariantSpec, lambda r: r),
            (JaxWorkspace(registry=":memory:", key=KEY, net="wifi"),
             JaxVariantSpec, lambda r: JaxRecording.from_bytes(
                 r.to_bytes(), KEY))):
        arts = {r.manifest["name"]: conv(r)
                for r in lifecycle["recs"].values()}
        ws.service.publish("taken", conv(lifecycle["recs"]["prefill"]))
        c = ws.campaign([spec(k, None) for k in list(arts) + ["taken"]],
                        devices=2, artifacts=arts, jobs=8)
        recs = c.run()
        assert sorted(recs) == sorted(arts)
        out.append((c.stats(), dict(ws.service.stats),
                    [ws.service.proof_for(k)["path"] for k in arts]))
    assert out[0] == out[1]
    assert out[0][0]["publishes"] == 2 and out[0][0]["skipped_published"] == 1


# ---------------------------------------------------------- launchers ----
def test_record_registry_then_serve_from_registry_equals_the_api(capsys):
    with tempfile.TemporaryDirectory() as d:
        reg = os.path.join(d, "reg")
        record_cli.main(["--arch", "cody-mnist", "--smoke", "--device", "cpu",
                         "--out", d, "--registry", reg, "--key", "k2",
                         "--cache-len", "32", "--block-k", "4", "--batch",
                         "2", "--seq", "8", "--net", "wifi"])
        outs, eng = serve.main(["--arch", "cody-mnist", "--smoke",
                                "--device", "cpu", "--requests", "3",
                                "--max-new", "6", "--slots", "2",
                                "--cache-len", "32", "--block-k", "4",
                                "--from-registry", reg, "--key", "k2",
                                "--net", "wifi"])
        assert eng.channel.kind == "signed-replay"
        assert eng.registry_client.stats["proofs_verified"] == 2
        # the API on the same registry, shapes and seed-0 params
        ws = Workspace(registry=reg, key=b"k2", net="wifi", device="cpu")
        wl = ws.workload("cody-mnist", cache_len=32, block_k=4, batch=2,
                         seq=serve.REC_SEQ)
        api = wl.engine()
        rng = np.random.default_rng(0)
        for _ in range(3):
            api.submit(list(rng.integers(3, wl.cfg.vocab_size,
                                         api.fixed_prompt_len)), 6)
        assert api.run() == outs and dict(api.stats) == dict(eng.stats)
        assert dict(ws.client.stats) == dict(eng.registry_client.stats)
        with pytest.raises(ValueError, match="exactly one source"):
            serve.main(["--arch", "cody-mnist", "--smoke", "--device", "cpu",
                        "--cache-len", "32", "--block-k", "4", "--slots",
                        "2", "--from-recordings", d, "--from-registry", reg,
                        "--key", "k2"])
        flat = os.path.join(d, "flat")
        record_cli.main(["--arch", "cody-mnist", "--smoke", "--device", "cpu",
                         "--out", flat, "--no-registry", "--kinds",
                         "prefill", "--cache-len", "32", "--seq", "8"])
        assert os.listdir(flat) == ["cody-mnist_prefill.codyrec"]
    out = capsys.readouterr().out
    assert "published cody-mnist/decode/" in out
    assert "registry net (boot, wifi, emulated)" in out


def test_attest_launcher_emits_a_bundle_that_verifies_offline(tmp_path):
    from repro_torch.launch import attest
    path = str(tmp_path / "quote.json")
    assert attest.main(["--arch", "cody-mnist", "--device", "cpu",
                        "--cache-len", "16", "--seq", "4", "--jobs", "8",
                        "--rotate", "--out", path]) == 0
    bundle = json.loads(open(path).read())
    # published in epoch 0, quoted after the rotation in epoch 1
    assert bundle["leaf"]["epoch"] == 0 and bundle["quote"]["epoch"] == 1
    assert attest.main(["--verify", path]) == 0


@pytest.mark.parametrize("name", ["quickstart", "secure_inference"])
def test_ported_examples_run(name, capsys):
    import importlib
    importlib.import_module(f"repro_torch.examples.{name}").main(
        ["--device", "cpu"])
    out = capsys.readouterr().out
    assert ("served from verified recordings" in out
            if name == "quickstart" else "inclusion proof ok" in out)
