"""The port's CODY recording session against the JAX package on the CPU.

Both packages run over ``Recording``s with identical manifest and payload
bytes (the port's export; the session reads only its size and memory
figures), so the interaction plan, the job states and the session report
must be equal field by field, ``per_pass`` included, for every pass
subset, on wifi, cellular and with no emulator, at the default and a
pinned job count.  The round-trip columns of ``BENCH_recording.json`` are
met at ``jobs=32`` on cody-mnist's published config.  Exact everywhere.
"""
import itertools
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import netem as JN  # noqa: E402
from repro.core.recording import Recording as JaxRecording  # noqa: E402
from repro.record import CloudDryrun as JaxCloud  # noqa: E402
from repro.record import FlakyRegisterDevice as JaxFlaky  # noqa: E402
from repro.record import RecordingSession as JaxSession  # noqa: E402
from repro_torch.api.workload import (build_step,  # noqa: E402
                                      format_session_report, static_meta_for)
from repro_torch.configs import get_config, smoke_shrink  # noqa: E402
from repro_torch.core import netem as N  # noqa: E402
from repro_torch.core.recorder import compile_artifact, record  # noqa: E402
from repro_torch.core.recording import Recording  # noqa: E402
from repro_torch.launch import record as record_cli  # noqa: E402
from repro_torch.record import (PASS_NAMES, CloudDryrun,  # noqa: E402
                                FlakyRegisterDevice, RecordingSession,
                                SessionReusedError, resolve_passes)

ROOT = pathlib.Path(__file__).resolve().parents[1]
KEY = b"session-test-key"
SHAPES = dict(cache_len=64, block_k=4, batch=1, seq=16)   # the bench's
STACKS = [("naive", ()), ("+deferral", ("deferral",)),
          ("+speculation", ("deferral", "speculation")),
          ("+metasync", ("deferral", "speculation", "metasync"))]
SUBSETS = [s for n in range(4) for s in itertools.combinations(PASS_NAMES, n)]


def _export(cfg, kind="prefill"):
    fn, args, donate = build_step(cfg, kind, device="cpu", **SHAPES)
    return compile_artifact(f"{cfg.name}_{kind}", fn, args,
                            donate_argnums=donate,
                            config_fingerprint=cfg.fingerprint(),
                            static_meta=static_meta_for(kind, **SHAPES))


@pytest.fixture(scope="module")
def artifact():
    return _export(smoke_shrink(get_config("cody-mnist")))


@pytest.fixture(scope="module")
def published():
    """cody-mnist's published config (full width) at the bench's shapes."""
    return _export(get_config("cody-mnist"))


def _copy(rec):
    return Recording(dict(rec.manifest), rec.payload, rec.trees)


def _jax_copy(rec):
    return JaxRecording(dict(rec.manifest), rec.payload, rec.trees)


def _sessions(net, passes, jobs, device=None, jax_device=None):
    port = RecordingSession(
        netem=N.NetworkEmulator(N.PROFILES[net]) if net else None,
        passes=passes, cloud=CloudDryrun(jobs=jobs), device=device)
    ref = JaxSession(
        netem=JN.NetworkEmulator(JN.PROFILES[net]) if net else None,
        passes=passes, cloud=JaxCloud(jobs=jobs), device=jax_device)
    return port, ref


def _log(session):
    return [(o.kind, o.site, o.payload, o.symbol.sid if o.symbol else None)
            for o in session.q.log]


@pytest.mark.parametrize("jobs", [None, 32])
@pytest.mark.parametrize("net", ["wifi", "cellular", None])
@pytest.mark.parametrize("passes", SUBSETS,
                         ids=lambda p: "+".join(p) or "naive")
def test_report_equals_the_reference(artifact, passes, net, jobs):
    port, ref = _sessions(net, passes, jobs)
    rec = port.finalize(_copy(artifact))
    jrec = ref.finalize(_jax_copy(artifact))
    got, want = port.report(), ref.report()
    assert got.keys() == want.keys()
    for field in want:
        assert got[field] == want[field], field
    assert rec.manifest["record_session"] == jrec.manifest["record_session"]
    assert rec.manifest["record_virtual_s"] == \
        jrec.manifest["record_virtual_s"]
    assert port.device.exec_log == ref.device.exec_log
    assert _log(port) == _log(ref)
    assert rec.payload == artifact.payload and rec.trees == artifact.trees


@pytest.mark.parametrize("jobs", [None, 32])
def test_interaction_plan_and_job_state_equal_the_reference(artifact, jobs):
    cloud, jcloud = CloudDryrun(jobs=jobs), JaxCloud(jobs=jobs)
    rec, jrec = _copy(artifact), _jax_copy(artifact)
    assert cloud.plan_jobs(rec) == jcloud.plan_jobs(jrec)
    assert list(cloud.interaction_plan(rec)) == \
        list(jcloud.interaction_plan(jrec))
    assert cloud.data_bytes(rec) == jcloud.data_bytes(jrec)
    assert rec.manifest["memory"]["temp_bytes"] is None   # reads as 0
    assert cloud.consumed_readbacks() == jcloud.consumed_readbacks()
    for j in (0, 5, cloud.plan_jobs(rec) - 1):
        got, want = cloud.job_state(rec, j), jcloud.job_state(jrec, j)
        assert got.keys() == want.keys()
        for part in want:
            if isinstance(want[part], dict):
                assert list(got[part]) == list(want[part])
                for k, v in want[part].items():
                    assert got[part][k].dtype == v.dtype
                    np.testing.assert_array_equal(got[part][k], v)
            else:
                assert got[part].dtype == want[part].dtype
                np.testing.assert_array_equal(got[part], want[part])


def test_mispredict_rolls_back_as_the_reference(artifact):
    """A register that breaks its own history forces a mispredict: equal
    ``mispredicts`` and ``rollback_s``, and the device converges to the
    state of a mispredict-free run."""
    dev = FlakyRegisterDevice("job_irq_status", flip_after=10)
    port, ref = _sessions("wifi", "all", 24, device=dev,
                          jax_device=JaxFlaky("job_irq_status",
                                              flip_after=10))
    port.finalize(_copy(artifact))
    ref.finalize(_jax_copy(artifact))
    spec, jspec = (s.report()["per_pass"]["speculation"]
                   for s in (port, ref))
    assert spec["mispredicts"] >= 1 and spec["rollback_s"] > 0
    assert spec == jspec
    assert port.report() == ref.report()
    assert dev.stats == ref.device.stats
    clean = RecordingSession.for_profile(N.WIFI, cloud=CloudDryrun(jobs=24))
    clean.finalize(_copy(artifact))
    assert dev.regs == clean.device.regs
    assert dev.jobs_synced == clean.device.jobs_synced == 24


def test_a_session_is_single_use(artifact):
    s = RecordingSession.for_profile(N.WIFI, cloud=CloudDryrun(jobs=12))
    s.finalize(_copy(artifact))
    with pytest.raises(SessionReusedError, match="single-use") as e:
        s.exercise(_copy(artifact))
    assert __file__ in e.value.first_use_site
    assert isinstance(e.value, RuntimeError)


def test_resolve_passes_equals_the_reference():
    from repro.record import resolve_passes as jax_resolve
    for spec in ("all", None, "none", "naive", "metasync,deferral",
                 ["speculation"], " deferral , speculation "):
        assert resolve_passes(spec) == jax_resolve(spec)
    with pytest.raises(ValueError):
        resolve_passes("deferral,warp")


def test_record_without_a_session_is_the_local_degenerate(artifact):
    """``record()`` is the in-process session: the payload is the one
    ``compile_artifact`` builds, every billed counter is zero."""
    cfg = smoke_shrink(get_config("cody-mnist"))
    fn, args, donate = build_step(cfg, "prefill", device="cpu", **SHAPES)
    rec = record(f"{cfg.name}_prefill", fn, args, donate_argnums=donate,
                 config_fingerprint=cfg.fingerprint(),
                 static_meta=static_meta_for("prefill", **SHAPES))
    assert rec.payload == artifact.payload and rec.trees == artifact.trees
    assert rec.manifest["exec_fingerprint"] == \
        artifact.manifest["exec_fingerprint"]
    assert rec.manifest["record_virtual_s"] == 0.0
    rs = rec.manifest["record_session"]
    assert rs["net"] == "in-process" and rs["passes"] == list(PASS_NAMES)
    assert rs["blocking_round_trips"] == rs["async_round_trips"] == 0
    assert rs["bytes_sent"] == rs["bytes_received"] == 0
    assert rs["jobs"] > 0 and rs["ops_executed"] > 0


def _bench_rows():
    bench = json.loads((ROOT / "BENCH_recording.json").read_text())
    return {r["stack"]: r for r in bench["rows"] if r["net"] == "wifi"}


@pytest.mark.parametrize("net", ["wifi", "cellular"])
def test_ablation_meets_bench_recording(published, net):
    """The four stacks at ``jobs=32``: the round-trip columns of
    ``BENCH_recording.json`` (link-independent counts, so cellular meets
    the wifi rows too), virtual time strictly falling, all passes >= 90%
    below naive, and every session's recording the shared artifact's
    bytes, verifying under the key."""
    rows, times = _bench_rows(), []
    for label, passes in STACKS:
        s = RecordingSession.for_profile(N.PROFILES[net], passes=passes,
                                         cloud=CloudDryrun(jobs=32))
        rec = s.finalize(_copy(published))
        rep = rec.manifest["record_session"]
        spec = rep["per_pass"].get("speculation", {})
        want = rows[label]
        assert (rep["blocking_round_trips"], rep["async_round_trips"],
                int(spec.get("spec_commits", 0)),
                int(spec.get("mispredicts", 0)), rep["jobs"]) == \
            (want["blocking_rts"], want["async_rts"], want["spec_commits"],
             want["mispredicts"], want["jobs"]), label
        assert rec.payload == published.payload
        assert rec.manifest["exec_fingerprint"] == \
            published.manifest["exec_fingerprint"]
        Recording.from_bytes(_copy(rec).sign_with(KEY).to_bytes(), KEY)
        times.append(rep["virtual_time_s"])
        assert format_session_report(rep).startswith(f"session[{net}|")
    assert all(a > b for a, b in zip(times, times[1:])), times
    assert times[-1] <= 0.1 * times[0], times


def test_record_launcher_prints_the_session_report(tmp_path, capsys):
    done = record_cli.main([
        "--arch", "cody-mnist", "--smoke", "--device", "cpu", "--kinds",
        "prefill", "--out", str(tmp_path), "--key", "k", "--cache-len",
        "32", "--block-k", "4", "--seq", "8", "--net", "cellular",
        "--passes", "deferral,metasync", "--jobs", "12"])
    out = capsys.readouterr().out
    assert "session[cellular|deferral+metasync]" in out and "12 jobs" in out
    rec = Recording.load(done["prefill"][0], b"k")
    rs = rec.manifest["record_session"]
    assert rs["jobs"] == 12 and rs["passes"] == ["deferral", "metasync"]
    assert rec.manifest["record_virtual_s"] == rs["virtual_time_s"] > 0
