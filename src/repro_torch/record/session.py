"""RecordingSession — the CODY two-party record protocol over an emulated
link, with the paper's three optimizations as stackable interceptor passes.
Counterpart of ``repro/record/session.py``; for the same ``Recording``
bytes its report is the reference's, field by field.

Layering (outer → inner)::

    CloudDryrun ──► [MetasyncPass] ─► [DeferralPass] ─► [SpeculationPass] ─► WireLink ──► DeviceProxy
      (software)      sync deltas       batch commits      async commits      CommitQueue     (hardware)
                         §5                §4.1+4.3            §4.2          + NetworkEmulator

The cloud emits the interaction plan; each enabled pass intercepts the
part of the wire protocol it optimizes; ``WireLink`` is the naive base
transport (one blocking round trip per register access, full memory image
per job sync).  Any subset of passes composes — the session always stacks
them in canonical order — which is exactly what the paper's naive →
+deferral → +speculation → +metasync ablation (Fig. 7 / Table 1) needs.

Per-pass accounting uses ``NetworkEmulator.checkpoint()/delta()`` spans,
so each pass reports the blocking/async round trips and bytes that flowed
through *it* without clobbering the emulator's global totals.

``RecordingSession.local()`` is the in-process degenerate session: device
and cloud co-located, all passes on, no emulator — ``core.recorder.record``
routes through it, producing the same artifact as ``compile_artifact``
plus zeroed session fields in the manifest.
"""
from __future__ import annotations

import collections
import traceback
from typing import Optional, Sequence, Tuple, Union

from repro_torch.core.deferral import CommitQueue
from repro_torch.core.metasync import DeltaSync, full_pack, split
from repro_torch.core.netem import NetProfile, NetworkEmulator
from repro_torch.core.recording import Recording
from repro_torch.core.speculation import (HistorySpeculator, MispredictError,
                                    SpeculativeRunner)
from repro_torch.obs.trace import NULL, traced
from repro_torch.record.cloud import CloudDryrun
from repro_torch.record.device import POLL_TRIPS, DeviceProxy

PASS_NAMES = ("deferral", "speculation", "metasync")


class SessionReusedError(RuntimeError):
    """A ``RecordingSession`` was exercised twice.

    Sessions are single-use — device state, speculation history,
    delta-sync bases and per-pass accounting all belong to ONE recording.
    The message names the call site that consumed the session first, so a
    fan-out scheduler handing sessions around can find the offender."""

    def __init__(self, first_use_site: str):
        super().__init__(
            "RecordingSession is single-use: build a new session per "
            "recording (its device state, speculation history and "
            "accounting belong to one record); this session was first "
            f"used at {first_use_site}")
        self.first_use_site = first_use_site


def _caller_site() -> str:
    """Deepest stack frame outside this module — where exercise() was
    entered from."""
    here = __file__
    for frame in reversed(traceback.extract_stack()):
        if frame.filename != here:
            return f"{frame.filename}:{frame.lineno} (in {frame.name})"
    return "<unknown>"


def resolve_passes(passes: Union[str, Sequence[str], None]) \
        -> Tuple[str, ...]:
    """Normalize a pass spec — "all", "none", comma string, or sequence —
    into the canonical composition order (subset of ``PASS_NAMES``)."""
    if passes is None or passes == "all":
        return PASS_NAMES
    if passes == "none" or passes == "naive":
        return ()
    if isinstance(passes, str):
        passes = [p for p in passes.split(",") if p.strip()]
    names = {p.strip() for p in passes}
    unknown = names - set(PASS_NAMES)
    if unknown:
        raise ValueError(f"unknown session passes {sorted(unknown)}; "
                         f"valid: {PASS_NAMES}")
    return tuple(p for p in PASS_NAMES if p in names)


class LinkLayer:
    """One interceptor in the session's wire-protocol stack.

    Calls enter at the outermost layer; the default implementation
    delegates inward.  Cross-cutting re-entry (e.g. deferral deciding a
    batch must ship NOW) goes through ``self.root`` — the chain head — so
    every layer above the shipping decision still sees it.
    """

    name = "link"

    def __init__(self):
        self.s: "RecordingSession" = None
        self.inner: Optional["LinkLayer"] = None
        self.root: Optional["LinkLayer"] = None
        self.acct = collections.Counter()

    def bind(self, session: "RecordingSession") -> None:
        self.s = session

    # -- the wire protocol surface a pass may intercept --
    def op(self, kind: str, site: str, payload=None, cdep: bool = False):
        return self.inner.op(kind, site, payload, cdep)

    def commit_now(self):
        """Ship the queued batch (how is a pass decision: blocking vs
        speculative-async)."""
        return self.inner.commit_now()

    def barrier(self):
        """Externalization point: drain the queue and validate anything
        outstanding.  Flows inward; each layer drains its own state after
        its inner layers."""
        return self.inner.barrier()

    def sync_state(self, state):
        """Post-job memory sync of the device's GPU state mirror."""
        return self.inner.sync_state(state)

    # -- accounting helpers --
    @property
    def tracer(self):
        return self.s.tracer

    def _span(self):
        return self.s.netem.checkpoint() if self.s.netem else None

    def _absorb(self, mark) -> None:
        if mark is None:
            return
        d = self.s.netem.delta(mark)
        self.acct["time_s"] += d["time_s"]
        self.acct["blocking_rts"] += d["round_trips"]
        self.acct["async_rts"] += d["async_trips"]
        self.acct["bytes"] += d["bytes_sent"] + d["bytes_received"]


class WireLink(LinkLayer):
    """Innermost base transport: the NAIVE protocol.  Every register
    access is its own blocking round trip, polling loops spin over the
    link (``POLL_TRIPS`` round trips each), and each job sync ships the
    full memory image."""

    name = "wire"

    def op(self, kind, site, payload=None, cdep=False):
        q = self.s.q
        mark = self._span()
        if kind == "write":
            q.write(site, payload)
            self.root.commit_now()
            self._absorb(mark)
            return None
        if kind == "poll":
            sym = None
            with traced(self.tracer, "wire.poll_spin", "record",
                        site=site, trips=POLL_TRIPS):
                for _ in range(POLL_TRIPS):   # unoffloaded: spin over RTTs
                    sym = q.read(site)
                    self.root.commit_now()
            self._absorb(mark)
            return sym
        sym = q.read(site)
        self.root.commit_now()
        self._absorb(mark)
        return sym

    def commit_now(self):
        self.s.q.commit()

    def barrier(self):
        if self.s.q.queue:
            self.root.commit_now()

    def sync_state(self, state):
        mark = self._span()
        wire = full_pack(state)               # naive MemSync: everything
        self.acct["sync_bytes"] += len(wire)
        with traced(self.tracer, "wire.sync", "record", bytes=len(wire)):
            self.s.ship_sync(len(wire))
            self.s.device.apply_full_sync(state)
        self._absorb(mark)


class DeferralPass(LinkLayer):
    """Register-access deferral (§4.1) + poll offloading (§4.3): ops queue
    in program order on the session's ``CommitQueue`` and ship as ONE
    round trip at control dependencies and barriers."""

    name = "deferral"

    def op(self, kind, site, payload=None, cdep=False):
        q = self.s.q
        self.acct["ops_deferred"] += 1
        if kind == "write":
            sym = None
            q.write(site, payload)
        elif kind == "poll":
            sym = q.poll(site)                # offloaded device-side loop
        else:
            sym = q.read(site)
        if cdep:                              # driver branches on this read
            self.acct["cdep_commits"] += 1
            mark = self._span()
            with traced(self.tracer, "deferral.cdep_commit", "record",
                        site=site, batch=len(q.queue)):
                self.root.commit_now()
            self._absorb(mark)
        return sym

    def barrier(self):
        if self.s.q.queue:
            self.acct["barrier_commits"] += 1
            with traced(self.tracer, "deferral.barrier_commit", "record",
                        batch=len(self.s.q.queue)):
                self.root.commit_now()
        self.inner.barrier()


class SpeculationPass(LinkLayer):
    """History-k commit speculation (§4.2): predictable commits ship
    asynchronously (wire cost, no stall) and validate at the frontier /
    at barriers; mispredicts roll the device back to the metastate
    snapshot and bill the paper's local replay recovery (§7.3)."""

    name = "speculation"
    FRONTIER = 8          # outstanding speculative commits before validate
    ROLLBACK_BASE_S = 0.5     # local log replay, no network (§7.3)
    ROLLBACK_PER_OP_S = 2.0 / 8000

    def __init__(self, k: int = 3,
                 speculator: Optional[HistorySpeculator] = None):
        super().__init__()
        self.k = k
        self.speculator = speculator
        self.runner: Optional[SpeculativeRunner] = None
        self._validated_log_len = 0

    def bind(self, session):
        super().bind(session)
        # a checkpoint is the device metastate snapshot + the log position
        # it was taken at: rollback restores the snapshot, then REPLAYS the
        # log suffix so no executed write is lost (§7.3 replay recovery).
        # An injected speculator lets a campaign share prediction history
        # across sessions of one hardware class (devices warm each other).
        spec = self.speculator if self.speculator is not None \
            else HistorySpeculator(k=self.k)
        self.runner = SpeculativeRunner(
            session.q, spec,
            lambda: (session.device.snapshot(), len(session.q.log)),
            self._rollback)

    def _rollback(self, snap, log):
        dev_snap, log_len = snap
        self.s.device.restore(dev_snap)
        # fast-forward locally: re-execute every op committed since the
        # snapshot (symbols keep their first — actual — resolutions; the
        # device is deterministic from the restored state, so it converges
        # to the exact state of a mispredict-free run).  No network.
        for op in log[log_len:]:
            self.s.device.channel(op)
        self.acct["ops_replayed"] += len(log) - log_len

    def commit_now(self):
        mark = self._span()
        went_async = self.runner.commit_speculative()
        self.acct["spec_commits" if went_async else "sync_commits"] += 1
        self._absorb(mark)
        if self.tracer:
            self.tracer.instant("spec.ship", "record",
                                mode="async" if went_async else "sync")
        if len(self.runner.outstanding) >= self.FRONTIER:
            self._validate()

    def barrier(self):
        self.inner.barrier()                  # drain queue first
        self._validate()                      # then settle speculation

    def _validate(self):
        with traced(self.tracer, "spec.validate", "record",
                    outstanding=len(self.runner.outstanding)):
            try:
                self.runner.sync()
            except MispredictError:
                # rollback-via-replay: both sides restart from the last
                # validated snapshot and fast-forward the log locally — no
                # network traffic, but real recovery time scaling with the
                # REPLAY DISTANCE (ops since the last validation), not the
                # whole session log (§7.3)
                self.acct["mispredicts"] += 1
                if self.s.netem is not None:
                    replay_ops = len(self.s.q.log) - self._validated_log_len
                    penalty = self.ROLLBACK_BASE_S + \
                        self.ROLLBACK_PER_OP_S * replay_ops
                    self.acct["rollback_s"] += penalty
                    with traced(self.tracer, "spec.rollback", "record",
                                replay_ops=replay_ops,
                                penalty_s=round(penalty, 6)):
                        self.s.netem.virtual_time_s += penalty
        self._validated_log_len = len(self.s.q.log)


class MetasyncPass(LinkLayer):
    """Metastate-only synchronization (§5): job syncs ship only the
    changed small/integer-ish descriptor leaves, delta-compressed —
    program data never crosses the link."""

    name = "metasync"

    def __init__(self):
        super().__init__()
        self.ds = DeltaSync()

    def sync_state(self, state):
        mark = self._span()
        meta, _data = split(state)
        wire = self.ds.pack(meta)
        self.acct["sync_bytes"] += len(wire)
        self.acct["leaves_skipped"] = self.ds.stats["leaves_skipped"]
        with traced(self.tracer, "metasync.sync", "record", bytes=len(wire)):
            self.s.ship_sync(len(wire))
            self.s.device.apply_meta_sync(wire)
        self._absorb(mark)


class RecordingSession:
    """One two-party record: DeviceProxy (hardware) + CloudDryrun
    (software) over a ``NetworkEmulator``, with a composable pass stack.

    ``netem=None`` is the co-located in-process degenerate: the protocol
    still runs (op logs, symbols, state mirrors), nothing is billed, and
    the manifest's session counters are zero — the LOCAL record.
    """

    def __init__(self, device: Optional[DeviceProxy] = None,
                 cloud: Optional[CloudDryrun] = None,
                 netem: Optional[NetworkEmulator] = None,
                 passes: Union[str, Sequence[str], None] = "all",
                 tracer=NULL,
                 speculator: Optional[HistorySpeculator] = None):
        self.device = device if device is not None else DeviceProxy()
        self.cloud = cloud if cloud is not None else CloudDryrun()
        self.netem = netem
        self.tracer = tracer if tracer is not None else NULL
        self.pass_names = resolve_passes(passes)
        self.q = CommitQueue(self.device.channel, netem=self.netem,
                             name="record-session")
        # canonical composition, outer -> inner, base transport last
        self.layers = [MetasyncPass()] if "metasync" in self.pass_names \
            else []
        if "deferral" in self.pass_names:
            self.layers.append(DeferralPass())
        if "speculation" in self.pass_names:
            self.layers.append(SpeculationPass(speculator=speculator))
        self.layers.append(WireLink())
        for outer, inner in zip(self.layers, self.layers[1:]):
            outer.inner = inner
        for layer in self.layers:
            layer.root = self.layers[0]
            layer.bind(self)
        self.root = self.layers[0]
        self._totals = self._zero_totals()
        self.jobs = 0
        self._first_use_site: Optional[str] = None

    # ------------------------------------------------------- constructors --
    @classmethod
    def local(cls, **kw) -> "RecordingSession":
        """In-process degenerate session (all passes, nothing billed)."""
        return cls(netem=None, **kw)

    @classmethod
    def for_profile(cls, profile: NetProfile,
                    passes: Union[str, Sequence[str], None] = "all",
                    **kw) -> "RecordingSession":
        return cls(netem=NetworkEmulator(profile), passes=passes, **kw)

    # ------------------------------------------------------------- record --
    def record(self, name: str, fn, args, **kw) -> Recording:
        """The full two-party record: cloud dryrun (export + serialize),
        then the distributed register-access protocol over the link, then
        manifest annotation.  The artifact bytes are exactly
        what ``compile_artifact`` built — the session adds cost truth,
        never payload changes."""
        rec = self.cloud.dryrun(name, fn, args, **kw)
        return self.finalize(rec)

    def finalize(self, rec: Recording) -> Recording:
        """Exercise the session protocol over an already-compiled artifact
        and annotate it — ``record()`` minus the compile.  Lets callers
        amortize ONE dryrun across a pass-stack ablation (one export per
        artifact, shared by one session per stack, is what makes the
        recordings comparable byte for byte)."""
        self.exercise(rec)
        self._annotate(rec)
        return rec

    def exercise(self, rec: Recording) -> None:
        """Play the artifact's interaction plan through the pass stack.

        Single-use: device state, speculation history, delta-sync bases
        and per-pass accounting all belong to ONE recording — reuse would
        make the manifest's totals and counters disagree.  Build a fresh
        session per recording."""
        if self._first_use_site is not None:
            raise SessionReusedError(self._first_use_site)
        self._first_use_site = _caller_site()
        mark = self.netem.checkpoint() if self.netem else None
        root = self.root
        tr = self.tracer
        with tr.clock_scope(self.netem):
            for seg, ops in self.cloud.interaction_plan(rec):
                with traced(tr, f"record.{seg}", "record",
                            ops=len(ops), passes=",".join(self.pass_names)):
                    for kind, site, payload, cdep in ops:
                        root.op(kind, site, payload, cdep)
                    if seg.startswith("job"):
                        root.barrier()        # job end = externalization
                        root.sync_state(
                            self.cloud.job_state(rec, int(seg[3:])))
                        self.jobs += 1
            with traced(tr, "record.final_barrier", "record"):
                root.barrier()
        if mark is not None:
            self._totals = self.netem.delta(mark)

    # ------------------------------------------------------------ billing --
    def ship_sync(self, nbytes: int) -> None:
        """Cloud -> device state sync transfer (device is the client)."""
        if self.netem is not None:
            self.netem.one_way(nbytes, direction="recv")

    # ---------------------------------------------------------- reporting --
    @staticmethod
    def _zero_totals() -> dict:
        return {"time_s": 0.0, "round_trips": 0, "async_trips": 0,
                "bytes_sent": 0, "bytes_received": 0}

    def report(self) -> dict:
        """Session accounting for the last ``exercise``: link totals plus
        per-pass spans — the rows of the paper's record-time ablation."""
        t = self._totals
        return {
            "net": self.netem.profile.name if self.netem else "in-process",
            "passes": list(self.pass_names),
            "virtual_time_s": round(float(t["time_s"]), 6),
            "blocking_round_trips": int(t["round_trips"]),
            "async_round_trips": int(t["async_trips"]),
            "bytes_sent": int(t["bytes_sent"]),
            "bytes_received": int(t["bytes_received"]),
            "jobs": self.jobs,
            "ops_executed": len(self.device.exec_log),
            "per_pass": {layer.name: {k: round(float(v), 6)
                                      for k, v in layer.acct.items()}
                         for layer in self.layers},
        }

    def _annotate(self, rec: Recording) -> None:
        rep = self.report()
        rec.manifest["record_virtual_s"] = rep["virtual_time_s"]
        rec.manifest["record_session"] = rep


__all__ = ["RecordingSession", "SessionReusedError", "LinkLayer", "WireLink",
           "DeferralPass", "SpeculationPass", "MetasyncPass", "PASS_NAMES",
           "resolve_passes"]
