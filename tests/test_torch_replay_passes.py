"""The port's replay-plan compaction against the JAX package on the CPU:
for the same ``Recording`` bytes, ``plan_for`` gives the reference's
dispatch groups, ops and per-pass accounting for every replay-pass subset,
``PlanExecutor`` the reference's report, write log and consumed
readbacks; ``verified_plan`` refuses tampered bytes before any plan is
built; the ablation rows of ``BENCH_replay.json`` are met at ``jobs=32``.
Exact everywhere."""
import itertools
import json
import pathlib

import pytest

torch = pytest.importorskip("torch")

from repro.core import netem as JN  # noqa: E402
from repro.core import replay_passes as JRP  # noqa: E402
from repro.core.recording import Recording as JaxRecording  # noqa: E402
from repro_torch.api.workload import build_step, static_meta_for  # noqa: E402
from repro_torch.configs import get_config, smoke_shrink  # noqa: E402
from repro_torch.core import netem as N  # noqa: E402
from repro_torch.core import replay_passes as RP  # noqa: E402
from repro_torch.core.attest import (TamperedRecordingError,  # noqa: E402
                                     fingerprint)
from repro_torch.core.recorder import compile_artifact  # noqa: E402
from repro_torch.core.recording import Recording  # noqa: E402
from repro_torch.record import REPLAY_CONSUMED_SITES  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
KEY = b"replay-pass-test-key"
SHAPES = dict(cache_len=32, block_k=4, batch=2, seq=8)
SUBSETS = [s for n in range(4)
           for s in itertools.combinations(RP.REPLAY_PASS_NAMES, n)]
STACKS = [("naive", ()), ("+dead-elim", ("dead",)),
          ("+poll-collapse", ("dead", "poll")),
          ("+coalesce", ("dead", "poll", "coalesce"))]


@pytest.fixture(scope="module", params=["prefill", "decode"])
def rec(request):
    cfg = smoke_shrink(get_config("cody-mnist"))
    kind = request.param
    fn, args, donate = build_step(cfg, kind, device="cpu", **SHAPES)
    r = compile_artifact(f"{cfg.name}_{kind}", fn, args,
                         donate_argnums=donate,
                         config_fingerprint=cfg.fingerprint(),
                         static_meta=static_meta_for(kind, **SHAPES))
    return r.sign_with(KEY)


def _jax(rec):
    return JaxRecording(dict(rec.manifest), rec.payload, rec.trees,
                        rec.signature)


def _groups(plan):
    return [(g.label, list(g.ops)) for g in plan.groups]


def test_resolve_replay_passes_equals_the_reference():
    for spec in ("all", None, "none", "naive", "coalesce,dead", ["poll"]):
        assert RP.resolve_replay_passes(spec) == \
            JRP.resolve_replay_passes(spec)
    with pytest.raises(ValueError, match="unknown replay passes"):
        RP.resolve_replay_passes("dead,bogus")


@pytest.mark.parametrize("jobs", [None, 8, 32])
@pytest.mark.parametrize("passes", SUBSETS,
                         ids=lambda p: "+".join(p) or "naive")
def test_plan_and_execution_equal_the_reference(rec, passes, jobs):
    plan = RP.plan_for(rec, passes, jobs=jobs)
    jplan = JRP.plan_for(_jax(rec), passes, jobs=jobs)
    assert _groups(plan) == _groups(jplan)
    assert (plan.name, plan.source_fingerprint, plan.jobs, plan.passes,
            plan.acct, plan.n_ops) == \
        (jplan.name, jplan.source_fingerprint, jplan.jobs, jplan.passes,
         jplan.acct, jplan.n_ops)
    ex = RP.PlanExecutor(netem=N.NetworkEmulator(N.WIFI))
    jex = JRP.PlanExecutor(netem=JN.NetworkEmulator(JN.WIFI))
    assert ex.run(plan) == jex.run(jplan)
    assert ex.write_log() == jex.write_log()
    assert ex.readback_log() == jex.readback_log()
    assert ex.consumed_log(REPLAY_CONSUMED_SITES) == \
        jex.consumed_log(REPLAY_CONSUMED_SITES)


def test_compaction_keeps_writes_and_consumed_readbacks(rec):
    """Every stack shrinks virtual replay time and leaves the committed
    write sequence and the consumed completion values as the naive
    plan's."""
    witness, prev_t = None, None
    for _label, passes in STACKS:
        ex = RP.PlanExecutor(netem=N.NetworkEmulator(N.WIFI))
        rep = ex.run(RP.plan_for(rec, passes, jobs=8))
        w = (ex.write_log(), ex.consumed_log(REPLAY_CONSUMED_SITES))
        witness = witness or w
        assert w == witness, passes
        assert prev_t is None or rep["virtual_time_s"] < prev_t
        prev_t = rep["virtual_time_s"]
    flush_ids = [v for s, v in witness[1] if s == "latest_flush_id"]
    assert flush_ids == list(range(1, 9))


def test_verified_plan_refuses_a_tampered_blob(rec):
    blob = rec.to_bytes()
    plan, r = RP.verified_plan(blob, KEY, "all", jobs=8)
    assert plan.source_fingerprint == fingerprint(r.payload) == \
        r.manifest["exec_fingerprint"]
    jplan, _ = JRP.verified_plan(blob, KEY, "all", jobs=8)
    assert _groups(plan) == _groups(jplan)
    bad = bytearray(blob)
    bad[len(bad) // 2] ^= 0xFF
    flipped = bytearray(rec.payload)
    flipped[0] ^= 1
    stale = Recording(dict(rec.manifest), bytes(flipped), rec.trees)
    for b, k in ((bytes(bad), KEY), (blob, b"wrong-key"),
                 (stale.sign_with(KEY).to_bytes(), KEY)):
        with pytest.raises(TamperedRecordingError):
            RP.verified_plan(b, k, "all", jobs=8)


def test_plan_executor_is_single_use_and_the_report_call_agrees(rec):
    plan = RP.plan_for(rec, "all", jobs=8)
    ex = RP.PlanExecutor(netem=N.NetworkEmulator(N.CELLULAR))
    rep = ex.run(plan)
    with pytest.raises(RuntimeError, match="single-use"):
        ex.run(plan)
    assert RP.replay_plan_report(rec, "all", jobs=8,
                                 netem=N.NetworkEmulator(N.CELLULAR)) == rep
    assert rep == JRP.replay_plan_report(
        _jax(rec), "all", jobs=8, netem=JN.NetworkEmulator(JN.CELLULAR))
    assert RP.replay_plan_report(rec, "none", jobs=8)["virtual_time_s"] == 0


def test_ablation_meets_bench_replay(rec):
    """``BENCH_replay.json``'s ablation at ``jobs=32`` over wifi: blocking
    round trips 768 / 384 / 320 / 8, dispatches 704 / 320 / 320 / 8,
    collapsed spins 0 / 0 / 64 / 64; the write log and the consumed
    readbacks those of the naive plan."""
    bench = json.loads((ROOT / "BENCH_replay.json").read_text())
    rows = {r["stack"]: r for r in bench["ablation"]["rows"]}
    witness = None
    for label, passes in STACKS:
        ex = RP.PlanExecutor(netem=N.NetworkEmulator(N.WIFI))
        rep = ex.run(RP.plan_for(rec, passes, jobs=32))
        want = rows[label]
        assert (rep["blocking_round_trips"], rep["dispatches"],
                rep["collapsed_spins"], rep["jobs"], rep["passes"]) == \
            (want["blocking_rts"], want["dispatches"],
             want["collapsed_spins"], want["jobs"], want["passes"]), label
        w = (ex.write_log(), ex.consumed_log(REPLAY_CONSUMED_SITES))
        witness = witness or w
        assert w == witness, label
