"""RecordCampaign — multi-device record fan-out on a virtual tick clock.

Counterpart of ``repro/record/fanout.py``.  ``Workspace.campaign``
builds one over a workload's variants; with a ``service``
(``repro_torch.registry.RegistryService``) variants are claimed through
its ``variant_lease`` and published as they finish.  A ``VariantSpec``'s
compile is any zero-argument callable returning a ``Recording``.

The paper's recording environment drives ONE mobile device against the
cloud dry-run per session, so populating the registry with a new key's
shape variants (prefill buckets x decode x kinds) is serial: campaign
time scales linearly with variant count even after CODY's 92% per-record
cut.  A ``RecordCampaign`` makes the *fleet* record: a work-queue of
variants fans out across N ``DeviceSlot``s, each device running its own
``RecordingSession`` over its own ``NetworkEmulator`` span, scheduled on
a deterministic virtual tick clock — no wall clock, no ``random``,
identical results every run.

Three perf levers:

  * **Shared speculation history** (``SpeculationHistoryStore``): one
    ``HistorySpeculator`` per hardware class, injected into every
    session of that class, so device A's validated commits warm device
    B's predictions — later variants skip the history-k warm-up that a
    cold-per-session speculator pays per record.
  * **Artifact sharing**: each variant is compiled ONCE
    (``Workload.compile``) and every session replays that artifact
    (``RecordingSession.finalize``) — devices never recompile, and the
    recordings stay byte-identical to their serial counterparts
    (sharing one export is what makes ``bit_exact_vs_serial`` hold).
  * **Multi-variant lease fan-out** (``RegistryService.variant_lease``):
    concurrent missers of *different* variants become workers instead of
    waiters on one single-flight lease; each finished variant publishes
    incrementally through the service's per-key DeltaSync.

Scheduling invariant: variants are claimed FIFO, so the *execution*
order (which is what warms the shared speculator) equals the queue order
at EVERY device count — per-variant durations are identical across the
1/2/4/8-device ladder and the makespan shrinkage is purely virtual-time
concurrency.  That is what makes the ladder strictly monotone by
construction rather than by luck.
"""
from __future__ import annotations

import collections
import math
from typing import Callable, Dict, List, Optional, Sequence

from repro_torch.core.netem import NetworkEmulator
from repro_torch.core.recording import Recording
from repro_torch.core.speculation import HistorySpeculator
from repro_torch.obs.trace import NULL, traced
from repro_torch.record.cloud import CloudDryrun
from repro_torch.record.device import DeviceProxy
from repro_torch.record.session import RecordingSession

_EPS = 1e-9

# HistorySpeculator.stats key -> the metric/stat name campaigns expose
_SPEC_STAT_KEYS = (("predicts", "predict"), ("predicted", "hit"),
                   ("records", "record"))


class VariantSpec:
    """One unit of campaign work: a registry key plus a zero-arg compile
    producing its artifact (``Workspace.campaign`` builds these from
    ``Workload.compile``; anything with the same shape works)."""

    __slots__ = ("key", "compile_fn", "label")

    def __init__(self, key: str, compile_fn: Callable[[], Recording],
                 label: Optional[str] = None):
        self.key = key
        self.compile_fn = compile_fn
        self.label = label if label else key

    def __repr__(self):
        return f"VariantSpec({self.label!r})"


class DeviceSlot:
    """One recording device in the pool: a netem billing span (its own
    ``checkpoint()/delta()`` spans per session — never aliased with its
    siblings') plus fan-out bookkeeping."""

    def __init__(self, name: str, netem: Optional[NetworkEmulator], *,
                 hw_class: str = "edge-gpu"):
        self.name = name
        self.netem = netem
        self.hw_class = hw_class
        self.busy_until = 0.0
        self.recorded = 0
        self.busy_virtual_s = 0.0
        self.stats = collections.Counter()

    def snapshot(self) -> dict:
        return {
            "name": self.name,
            "hw_class": self.hw_class,
            "net": self.netem.profile.name if self.netem is not None
            else "in-process",
            "recorded": self.recorded,
            "busy_virtual_s": round(self.busy_virtual_s, 6),
            "blocking_round_trips": int(self.stats["blocking_rts"]),
            "spec": {stat: int(self.stats[f"spec_{stat}"])
                     for _raw, stat in _SPEC_STAT_KEYS},
        }


class SpeculationHistoryStore:
    """Per-hardware-class ``HistorySpeculator`` pool.

    Devices of one hardware class expose the same register behavior, so
    their commit histories are interchangeable: ONE speculator per class,
    shared by every session the campaign runs on that class.  Distinct
    classes never mix (a different device generation may legitimately
    return different register values at the same site)."""

    def __init__(self, k: int = 3):
        self.k = k
        self._by_class: Dict[str, HistorySpeculator] = {}

    def speculator(self, hw_class: str) -> HistorySpeculator:
        if hw_class not in self._by_class:
            self._by_class[hw_class] = HistorySpeculator(k=self.k)
        return self._by_class[hw_class]

    def snapshot(self) -> dict:
        return {hw: {"sites": len(s.history),
                     "predicts": int(s.stats["predicts"]),
                     "hits": int(s.stats["predicted"]),
                     "records": int(s.stats["records"]),
                     "hit_rate": round(s.hit_rate(), 6)}
                for hw, s in sorted(self._by_class.items())}


class _CampaignClock:
    """Mutable virtual-time shim for ``Tracer.clock_scope`` — the
    campaign stamps its spans on the tick clock, not any one device's
    emulator."""

    __slots__ = ("virtual_time_s",)

    def __init__(self):
        self.virtual_time_s = 0.0


class RecordCampaign:
    """Fan a variant work-queue out across a device pool.

    ``run()`` executes every claimable variant exactly once and returns
    ``{key: Recording}``.  With a ``service``, variants are claimed
    through a multi-variant lease set (published or foreign-leased keys
    are skipped, not re-recorded) and each finished variant is published
    incrementally.  ``share_history=False`` is the cold baseline: every
    session gets a fresh speculator, exactly today's serial
    ``Workload.record`` behavior."""

    def __init__(self, variants: Sequence[VariantSpec],
                 devices: Sequence[DeviceSlot], *,
                 share_history: bool = True, spec_k: int = 3,
                 artifacts: Optional[Dict[str, Recording]] = None,
                 passes="all", jobs: Optional[int] = None,
                 tick_s: float = 0.02, name: str = "campaign",
                 tracer=NULL, metrics=None, service=None,
                 max_ticks: int = 500_000):
        if not devices:
            raise ValueError("RecordCampaign needs at least one device")
        self.variants = list(variants)
        self.devices = list(devices)
        self.share_history = share_history
        self.history = SpeculationHistoryStore(k=spec_k)
        self.artifacts = artifacts if artifacts is not None else {}
        self.passes = passes
        self.jobs = jobs
        self.tick_s = tick_s
        self.name = name
        self.tracer = tracer if tracer is not None else NULL
        self.metrics = metrics
        self.service = service
        self.max_ticks = max_ticks
        self.ticks = 0
        self.clock = 0.0
        self.counters = collections.Counter()
        self.recordings: Dict[str, Recording] = {}
        self.sessions: List[tuple] = []       # (key, session report)
        self._clk = _CampaignClock()
        self._ran = False

    # ------------------------------------------------------------ artifacts --
    def _artifact(self, v: VariantSpec) -> Recording:
        """Compile-once artifact sharing: the dict may be pre-seeded (a
        bench sharing one compile across ladder rungs) and is filled on
        first use otherwise."""
        if v.key not in self.artifacts:
            with traced(self.tracer, "campaign.compile", "campaign",
                        variant=v.label):
                self.artifacts[v.key] = v.compile_fn()
            self.counters["compiles"] += 1
        else:
            self.counters["artifact_reuses"] += 1
        return self.artifacts[v.key]

    # ------------------------------------------------------------- sessions --
    def _execute(self, slot: DeviceSlot, v: VariantSpec):
        """Run ONE fresh single-use session for (device, variant); returns
        (recording, report, virtual duration).  The session's netem spans
        bill into the device's own emulator via checkpoint()/delta()."""
        art = self._artifact(v)
        spec = self.history.speculator(slot.hw_class) \
            if self.share_history else HistorySpeculator(k=self.history.k)
        before = dict(spec.stats)
        cloud = CloudDryrun(jobs=self.jobs) if self.jobs is not None \
            else CloudDryrun()
        session = RecordingSession(
            device=DeviceProxy(), cloud=cloud, netem=slot.netem,
            passes=self.passes, tracer=self.tracer, speculator=spec)
        rec = session.finalize(
            Recording(dict(art.manifest), art.payload, art.trees))
        rep = session.report()
        self.sessions.append((v.key, rep))
        dur = float(rep["virtual_time_s"])
        self._bill(slot, spec, before, rep, dur)
        return rec, rep, dur

    def _bill(self, slot: DeviceSlot, spec: HistorySpeculator,
              before: dict, rep: dict, dur: float) -> None:
        """Per-(hw_class, device) speculation counters from the
        speculator's OWN stats delta — the shared-history lift is
        measured, not inferred from round trips."""
        slot.recorded += 1
        slot.busy_virtual_s += dur
        slot.stats["blocking_rts"] += rep["blocking_round_trips"]
        deltas = {}
        for raw, stat in _SPEC_STAT_KEYS:
            d = int(spec.stats.get(raw, 0)) - int(before.get(raw, 0))
            deltas[stat] = d
            slot.stats[f"spec_{stat}"] += d
            self.counters[f"spec_{stat}"] += d
        if self.metrics is not None:
            for stat, d in deltas.items():
                if d:
                    self.metrics.counter(
                        f"spec_history_{stat}", hw_class=slot.hw_class,
                        device=slot.name).inc(d)
            self.metrics.histogram("fanout_record_s", campaign=self.name,
                                   device=slot.name).observe(dur)
            self.metrics.counter("fanout_variants_recorded",
                                 campaign=self.name).inc()

    # ----------------------------------------------------------------- run --
    def run(self) -> Dict[str, Recording]:
        if self._ran:
            raise RuntimeError(f"campaign '{self.name}' already ran; "
                               "build a new RecordCampaign per run")
        self._ran = True
        lease_set = None
        queue: List[VariantSpec] = []
        if self.service is not None:
            lease_set = self.service.variant_lease(
                self.name, [v.key for v in self.variants])
            for v in self.variants:
                why = lease_set.claim(v.key)
                if why is None:
                    queue.append(v)
                else:
                    self.counters[f"skipped_{why}"] += 1
        else:
            queue = list(self.variants)
        self.counters["claimed"] = len(queue)

        running: List[tuple] = []   # (finish_t, seq, slot, variant, rec)
        seq = 0
        try:
            with self.tracer.clock_scope(self._clk), \
                    traced(self.tracer, "campaign.run", "campaign",
                           campaign=self.name, devices=len(self.devices),
                           variants=len(queue)):
                while queue or running:
                    for slot in self.devices:
                        if not queue:
                            break
                        if slot.busy_until > self.clock + _EPS:
                            continue
                        v = queue.pop(0)
                        start = self.clock
                        self._clk.virtual_time_s = start
                        if self.tracer:
                            self.tracer.instant("campaign.assign",
                                                "campaign", device=slot.name,
                                                variant=v.label)
                        with traced(self.tracer, "campaign.record",
                                    "campaign", device=slot.name,
                                    variant=v.label):
                            rec, _rep, dur = self._execute(slot, v)
                            self._clk.virtual_time_s = start + dur
                        slot.busy_until = start + dur
                        seq += 1
                        running.append((slot.busy_until, seq, slot, v, rec))
                    if not running:
                        if queue:       # every device idle yet none claimed
                            raise RuntimeError(
                                f"campaign '{self.name}' stuck with "
                                f"{len(queue)} variants unassigned")
                        break
                    target = min(r[0] for r in running)
                    n = max(1, math.ceil(
                        (target - self.clock) / self.tick_s - _EPS))
                    self.ticks += n
                    if self.ticks > self.max_ticks:
                        raise RuntimeError(
                            f"campaign '{self.name}' exceeded max_ticks="
                            f"{self.max_ticks}")
                    self.clock = self.ticks * self.tick_s
                    done = sorted(r for r in running
                                  if r[0] <= self.clock + _EPS)
                    running = [r for r in running
                               if r[0] > self.clock + _EPS]
                    self._clk.virtual_time_s = self.clock
                    for _ft, _seq, slot, v, rec in done:
                        self._complete(lease_set, slot, v, rec)
        except BaseException:
            # release EVERY still-held lease — including the in-flight
            # variant that raised (popped from the queue but never added
            # to ``running``) — or later missers would block forever
            if lease_set is not None:
                for key in list(lease_set.outstanding()):
                    lease_set.fail(key)
            raise
        return self.recordings

    def _complete(self, lease_set, slot: DeviceSlot, v: VariantSpec,
                  rec: Recording) -> None:
        self.recordings[v.key] = rec
        self.counters["recorded"] += 1
        if self.tracer:
            self.tracer.instant("campaign.done", "campaign",
                                device=slot.name, variant=v.label)
        if lease_set is not None:
            # incremental publish: this variant ships (delta-packed by the
            # service's per-key DeltaSync) the moment it finishes — missers
            # waiting on ITS lease unblock without waiting for the campaign
            lease_set.complete(v.key, rec)
            self.counters["publishes"] += 1

    # ------------------------------------------------------------ reporting --
    def hit_rate(self) -> float:
        n = self.counters["spec_predict"]
        return (self.counters["spec_hit"] / n) if n else 0.0

    def stats(self) -> dict:
        """Campaign accounting; shape pinned by
        the reference's ``repro/obs/schema.py`` (``check_campaign_stats``)."""
        serial_s = sum(s.busy_virtual_s for s in self.devices)
        return {
            "name": self.name,
            "devices": len(self.devices),
            "variants": len(self.variants),
            "recorded": int(self.counters["recorded"]),
            "skipped_published": int(self.counters["skipped_published"]),
            "skipped_leased": int(self.counters["skipped_leased"]),
            "share_history": self.share_history,
            "tick_s": self.tick_s,
            "ticks": self.ticks,
            "virtual_time_s": round(self.clock, 9),
            "sum_record_virtual_s": round(serial_s, 6),
            "publishes": int(self.counters["publishes"]),
            "compiles": int(self.counters["compiles"]),
            "artifact_reuses": int(self.counters["artifact_reuses"]),
            "speculation": {
                "predicts": int(self.counters["spec_predict"]),
                "hits": int(self.counters["spec_hit"]),
                "records": int(self.counters["spec_record"]),
                "hit_rate": round(self.hit_rate(), 6),
                "shared": self.history.snapshot(),
            },
            "per_device": [s.snapshot() for s in self.devices],
        }


__all__ = ["RecordCampaign", "DeviceSlot", "SpeculationHistoryStore",
           "VariantSpec"]
