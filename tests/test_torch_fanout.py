"""The port's record fan-out (``RecordCampaign``) against the JAX package on
the CPU: given the same artifacts (identical ``Recording`` bytes), a
campaign over 1, 2 and 4 device slots gives the reference's ``stats()``,
session reports and annotated manifests, exactly; shared speculation
history warms later sessions; artifacts are compiled once and shared;
variants are claimed FIFO."""
import pytest

torch = pytest.importorskip("torch")

from repro.core import netem as JN  # noqa: E402
from repro.core.recording import Recording as JaxRecording  # noqa: E402
from repro.core.speculation import HistorySpeculator as JaxSpec  # noqa: E402
from repro.obs.metrics import Metrics as JaxMetrics  # noqa: E402
from repro.record import CloudDryrun as JaxCloud  # noqa: E402
from repro.record import DeviceProxy as JaxDevice  # noqa: E402
from repro.record import DeviceSlot as JaxSlot  # noqa: E402
from repro.record import RecordCampaign as JaxCampaign  # noqa: E402
from repro.record import RecordingSession as JaxSession  # noqa: E402
from repro.record import VariantSpec as JaxVariant  # noqa: E402
from repro_torch.api.workload import build_step, static_meta_for  # noqa: E402
from repro_torch.configs import get_config, smoke_shrink  # noqa: E402
from repro_torch.core import netem as N  # noqa: E402
from repro_torch.core.recorder import compile_artifact  # noqa: E402
from repro_torch.core.recording import Recording  # noqa: E402
from repro_torch.core.speculation import HistorySpeculator  # noqa: E402
from repro_torch.obs.metrics import Metrics  # noqa: E402
from repro_torch.record import (CloudDryrun, DeviceProxy,  # noqa: E402
                                DeviceSlot, RecordCampaign, RecordingSession,
                                VariantSpec)

SHAPES = dict(cache_len=32, block_k=4, batch=2)
VARIANTS = [("prefill", 8), ("prefill", 16), ("decode", 8), ("prefill", 24)]


@pytest.fixture(scope="module")
def artifacts():
    """One export per variant, keyed as a campaign keys them."""
    cfg = smoke_shrink(get_config("cody-mnist"))
    arts = {}
    for kind, seq in VARIANTS:
        fn, args, donate = build_step(cfg, kind, seq=seq, device="cpu",
                                      **SHAPES)
        static = static_meta_for(kind, seq=seq, **SHAPES)
        arts[f"{kind}/s{seq}"] = compile_artifact(
            f"{cfg.name}_{kind}", fn, args, donate_argnums=donate,
            config_fingerprint=cfg.fingerprint(), static_meta=static)
    return arts


def _campaigns(artifacts, devices, *, share_history=True, jobs=12,
               nets=("wifi", "cellular")):
    """The same campaign in both packages: ``devices`` slots alternating
    over ``nets``, artifacts pre-seeded (copies of the same bytes)."""
    out = []
    for pkg in ("port", "jax"):
        em, slot, var, camp, rec, metrics = (
            (N, DeviceSlot, VariantSpec, RecordCampaign, Recording, Metrics)
            if pkg == "port" else
            (JN, JaxSlot, JaxVariant, JaxCampaign, JaxRecording, JaxMetrics))
        arts = {k: rec(dict(a.manifest), a.payload, a.trees)
                for k, a in artifacts.items()}
        slots = [slot(f"dev{i}", em.NetworkEmulator(
                     em.PROFILES[nets[i % len(nets)]]),
                     hw_class="edge-gpu" if i < 3 else "other-gpu")
                 for i in range(devices)]
        variants = [var(k, lambda: pytest.fail("recompiled"), label=k)
                    for k in artifacts]
        out.append(camp(variants, slots, share_history=share_history,
                        artifacts=arts, jobs=jobs, name=f"c{devices}",
                        metrics=metrics()))
    return out


@pytest.mark.parametrize("share_history", [True, False],
                         ids=["shared", "cold"])
@pytest.mark.parametrize("devices", [1, 2, 4])
def test_campaign_stats_equal_the_reference(artifacts, devices,
                                            share_history):
    port, ref = _campaigns(artifacts, devices, share_history=share_history)
    recs, jrecs = port.run(), ref.run()
    assert port.stats() == ref.stats()
    assert port.sessions == ref.sessions
    assert list(recs) == list(jrecs)          # completion order
    assert sorted(recs) == sorted(artifacts)
    for key, rec in recs.items():
        assert rec.manifest == jrecs[key].manifest
        assert rec.payload == artifacts[key].payload
    assert port.metrics.snapshot() == ref.metrics.snapshot()
    s = port.stats()
    assert s["recorded"] == len(VARIANTS) and s["compiles"] == 0
    assert s["artifact_reuses"] == len(VARIANTS)


def test_fifo_order_and_makespan_shrink_with_devices(artifacts):
    order, times = None, {}
    for devices in (1, 2, 4):
        port, _ = _campaigns(artifacts, devices, nets=("wifi",))
        port.run()
        keys = [k for k, _rep in port.sessions]
        order = order or keys
        assert keys == order == list(artifacts)
        times[devices] = port.stats()["virtual_time_s"]
    assert times[1] > times[2] > times[4]


def test_shared_history_warms_a_second_session(artifacts):
    """Device B's session starts from device A's validated history: fewer
    blocking round trips than a cold session, in both packages alike."""
    art = artifacts["prefill/s8"]
    reports = []
    for spec_cls, sess, cloud, dev, em, rec in (
            (HistorySpeculator, RecordingSession, CloudDryrun, DeviceProxy,
             N, Recording),
            (JaxSpec, JaxSession, JaxCloud, JaxDevice, JN, JaxRecording)):
        shared = spec_cls(k=3)
        reps = []
        for spec in (None, shared, shared):
            s = sess(device=dev(), cloud=cloud(jobs=6),
                     netem=em.NetworkEmulator(em.WIFI), speculator=spec)
            s.finalize(rec(dict(art.manifest), art.payload, art.trees))
            reps.append(s.report())
        reports.append((reps, dict(shared.stats)))
    assert reports[0] == reports[1]
    cold, _first, warm = reports[0][0]
    assert warm["blocking_round_trips"] < cold["blocking_round_trips"]


def test_compile_once_and_single_run(artifacts):
    calls = []

    def compile_fn():
        calls.append(1)
        a = artifacts["decode/s8"]
        return Recording(dict(a.manifest), a.payload, a.trees)
    c = RecordCampaign([VariantSpec("decode", compile_fn)],
                       [DeviceSlot("dev0", None)], jobs=6)
    recs = c.run()
    assert calls == [1] and c.stats()["compiles"] == 1
    assert recs["decode"].manifest["record_session"]["net"] == "in-process"
    with pytest.raises(RuntimeError, match="already ran"):
        c.run()
    with pytest.raises(ValueError):
        RecordCampaign([], [])
