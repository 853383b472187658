"""Replay-time interaction-plan compaction — the GPUReplay asymmetry.

Counterpart of ``repro/core/replay_passes.py``; its plans, logs and
reports equal the reference's for the same ``Recording`` bytes, and so
do the attestation quotes of executed plans (``PlanExecutor.quote``).

Record needs the whole GPU software stack in the loop; replay does not.
A recorded interaction plan still carries everything the *driver* needed
while it was steering live hardware — boot-time register probing, power/
config readbacks it branched on, polling loops spun over the link — but
at replay time every one of those branches is already resolved: the
recording IS the resolution.  This module compacts the plan down to what
the replayed hardware actually consumes, mirroring the record-side pass
architecture (``repro_torch.record.session``) with stackable, individually
ablatable passes in canonical order::

    naive plan ─► [dead] ─► [poll] ─► [coalesce] ─► PlanExecutor
                 dead-reg    spin       commit        dispatch over
                 access     collapse   coalescing     CommitQueue+netem
                 elim

  * ``dead``      — dead-register-access elimination: drop init probes and
                    pwr/cfg/irq reads whose readback is never consumed
                    downstream in the plan (the completion chain —
                    ``CloudDryrun.consumed_readbacks()`` — survives);
  * ``poll``      — poll-spin collapsing: a ``POLL_TRIPS``-trip spin
                    becomes ONE completion wait; the emulator records the
                    collapsed trips (``NetworkEmulator.collapse_spins``)
                    so compacted-plan billing spans stay auditable;
  * ``coalesce``  — commit coalescing: adjacent per-job doorbell/commit
                    segments fuse into single dispatches (the record
                    side's ``DeferralPass`` batching semantics, §4.1/§4.3
                    — enclosed polls are offloaded device-side).

Unlike a record session, a replay plan has NO post-job memory sync and no
cloud on the other end — the recording already holds the final state
(GPUReplay's ~50-KB footprint argument).  Compaction never touches the
recording's payload/trees/signature: a compacted plan stays bound to its
source recording by ``exec_fingerprint`` and ``verified_plan`` only
builds plans from recordings that verify under the caller's key.

Correctness invariant (tested): the committed WRITE sequence — the ops
that mutate the GPU — and the resolved values of every consumed readback
are identical between the naive and any compacted replay.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

from repro_torch.core.deferral import CommitQueue
from repro_torch.core.recording import Recording

REPLAY_PASS_NAMES = ("dead", "poll", "coalesce")

# ops per fused dispatch stay bounded: a real link MTU / command-ring depth
# would cap the batch, and one-giant-commit would hide the per-job structure
# the ablation reports.  4 jobs/dispatch mirrors the record side's
# speculation frontier granularity.
FUSE_JOBS = 4


def resolve_replay_passes(passes: Union[str, Sequence[str], None]) \
        -> Tuple[str, ...]:
    """Normalize a replay-pass spec — "all", "none"/"naive", comma string,
    or sequence — into canonical composition order."""
    if passes is None or passes == "all":
        return REPLAY_PASS_NAMES
    if passes == "none" or passes == "naive":
        return ()
    if isinstance(passes, str):
        passes = [p for p in passes.split(",") if p.strip()]
    names = {p.strip() for p in passes}
    unknown = names - set(REPLAY_PASS_NAMES)
    if unknown:
        raise ValueError(f"unknown replay passes {sorted(unknown)}; "
                         f"valid: {REPLAY_PASS_NAMES}")
    return tuple(p for p in REPLAY_PASS_NAMES if p in names)


@dataclasses.dataclass
class DispatchGroup:
    """One dispatch unit: the ops that ship to the device in one commit.
    The naive plan has one group per register access (1 blocking RTT
    each); coalescing fuses whole job segments into one group."""
    label: str
    ops: List[tuple]          # PlanOp (+ the compacted "wait" kind)


@dataclasses.dataclass
class ReplayPlan:
    """A recording's interaction plan in dispatchable form.

    ``source_fingerprint`` binds the plan to the recording it was derived
    from (``manifest["exec_fingerprint"]``); passes rewrite ``groups`` and
    append to ``passes``/``acct`` but never touch the binding.
    """
    name: str
    source_fingerprint: str
    jobs: int
    groups: List[DispatchGroup]
    passes: Tuple[str, ...] = ()
    acct: Dict[str, dict] = dataclasses.field(default_factory=dict)

    @property
    def n_ops(self) -> int:
        return sum(len(g.ops) for g in self.groups)

    def op_sites(self, kind: Optional[str] = None) -> List[str]:
        return [op[1] for g in self.groups for op in g.ops
                if kind is None or op[0] == kind]


# ------------------------------------------------------------- the passes --
class DeadRegisterElim:
    """Drop reads whose readback the downstream plan never consumes.

    At record time those reads were control-dependency commit points (the
    live driver branched on them); at replay time the branch outcomes are
    baked into the plan, so only the completion chain's readbacks (poll /
    flush id / job status — ``consumed``) still carry information.  Writes
    and polls always survive: they are what drives the hardware.
    """

    name = "dead"

    def __init__(self, consumed):
        self.consumed = frozenset(consumed)

    def apply(self, plan: ReplayPlan) -> ReplayPlan:
        dropped = 0
        groups = []
        for g in plan.groups:
            kept = [op for op in g.ops
                    if op[0] != "read" or op[1] in self.consumed]
            dropped += len(g.ops) - len(kept)
            if kept:
                groups.append(DispatchGroup(g.label, kept))
        plan.groups = groups
        plan.acct[self.name] = {"reads_dropped": dropped,
                                "ops_remaining": plan.n_ops}
        return plan


class PollCollapse:
    """Fold each ``POLL_TRIPS``-trip spin into ONE completion wait.

    The naive replay spins a poll over the link exactly like the record
    side's ``WireLink`` (one blocking round trip per trip).  The collapsed
    ``wait`` op ships once and blocks once; its payload remembers how many
    spin trips it replaced so the executor can report the collapse to the
    emulator's billing span.
    """

    name = "poll"

    def __init__(self, poll_trips: int):
        self.poll_trips = poll_trips

    def apply(self, plan: ReplayPlan) -> ReplayPlan:
        collapsed = 0
        for g in plan.groups:
            for i, op in enumerate(g.ops):
                if op[0] == "poll":
                    g.ops[i] = ("wait", op[1], self.poll_trips, op[3])
                    collapsed += 1
        plan.acct[self.name] = {
            "polls_collapsed": collapsed,
            "spins_collapsed": collapsed * (self.poll_trips - 1)}
        return plan


class CommitCoalesce:
    """Fuse adjacent per-job dispatch groups into single commits.

    Reuses the record side's ``DeferralPass`` batching semantics: ops queue
    in program order on one ``CommitQueue`` and ship together; polls inside
    a fused batch execute as offloaded device-side loops (§4.3).  With the
    cdep branches pre-resolved by the recording there is nothing left to
    commit *for* mid-job, so the dispatch boundary becomes the fused-job
    boundary: ``fuse_jobs`` adjacent job segments per commit.
    """

    name = "coalesce"

    def __init__(self, fuse_jobs: int = FUSE_JOBS):
        self.fuse_jobs = max(1, fuse_jobs)

    def apply(self, plan: ReplayPlan) -> ReplayPlan:
        before = len(plan.groups)
        # merge groups back into their originating segments, in order
        segs: List[DispatchGroup] = []
        for g in plan.groups:
            if segs and segs[-1].label == g.label:
                segs[-1].ops.extend(g.ops)
            else:
                segs.append(DispatchGroup(g.label, list(g.ops)))
        fused: List[DispatchGroup] = []
        run: List[DispatchGroup] = []

        def flush_run():
            if run:
                fused.append(DispatchGroup(
                    run[0].label if len(run) == 1 else
                    f"{run[0].label}..{run[-1].label}",
                    [op for s in run for op in s.ops]))
                run.clear()

        for seg in segs:
            if seg.label.startswith("job"):
                run.append(seg)
                if len(run) == self.fuse_jobs:
                    flush_run()
            else:
                flush_run()
                fused.append(seg)
        flush_run()
        plan.groups = fused
        plan.acct[self.name] = {"dispatches_before": before,
                                "dispatches_after": len(fused),
                                "fuse_jobs": self.fuse_jobs}
        return plan


# -------------------------------------------------------- plan construction --
def plan_for(rec: Recording, passes: Union[str, Sequence[str], None] = "all",
             *, jobs: Optional[int] = None, cloud=None,
             fuse_jobs: int = FUSE_JOBS) -> ReplayPlan:
    """Materialize ``rec``'s interaction plan and compact it with the
    requested passes (canonical order).  ``jobs`` pins the GPU job count
    exactly as on the record side, so replay and record ablations are
    comparable for one artifact."""
    from repro_torch.record.cloud import CloudDryrun
    from repro_torch.record.device import POLL_TRIPS
    if cloud is None:
        cloud = CloudDryrun(jobs=jobs)
    groups = [DispatchGroup(seg, [op])
              for seg, ops in cloud.interaction_plan(rec) for op in ops]
    plan = ReplayPlan(name=rec.manifest.get("name", ""),
                      source_fingerprint=rec.manifest.get(
                          "exec_fingerprint", ""),
                      jobs=cloud.plan_jobs(rec), groups=groups)
    stack = resolve_replay_passes(passes)
    built = {"dead": lambda: DeadRegisterElim(cloud.consumed_readbacks()),
             "poll": lambda: PollCollapse(POLL_TRIPS),
             "coalesce": lambda: CommitCoalesce(fuse_jobs)}
    for name in stack:
        plan = built[name]().apply(plan)
    plan.passes = stack
    return plan


def verified_plan(blob: bytes, key: bytes,
                  passes: Union[str, Sequence[str], None] = "all", *,
                  jobs: Optional[int] = None,
                  fuse_jobs: int = FUSE_JOBS) -> Tuple[ReplayPlan, Recording]:
    """Verify signed recording bytes under ``key`` (HMAC before anything
    else — tampered bytes never reach plan construction), then compact.
    Returns ``(plan, recording)``; the plan's ``source_fingerprint`` is the
    verified recording's payload fingerprint."""
    from repro_torch.core.attest import TamperedRecordingError, fingerprint
    rec = Recording.from_bytes(blob, key)
    if rec.manifest.get("exec_fingerprint") != fingerprint(rec.payload):
        raise TamperedRecordingError("payload fingerprint mismatch")
    return plan_for(rec, passes, jobs=jobs, fuse_jobs=fuse_jobs), rec


# ------------------------------------------------------------ the executor --
class PlanExecutor:
    """Plays a (compacted) replay plan through a ``CommitQueue`` ->
    ``DeviceProxy`` over an emulated link — the replay-side analogue of the
    record session's wire protocol.

    Dispatch semantics (what the ablation measures):

      * a single-op group ships as its own blocking round trip — the naive
        base, one RTT per register access, exactly ``WireLink``;
      * an UNCOLLAPSED standalone poll spins ``POLL_TRIPS`` blocking round
        trips (read + commit per trip), again mirroring ``WireLink``;
      * a collapsed ``wait`` ships once, blocks once, and reports the spin
        trips it replaced to ``NetworkEmulator.collapse_spins``;
      * a fused multi-op group queues everything and commits ONCE; polls
        and waits inside it run as offloaded device-side loops.

    Single-use, like ``RecordingSession``: device state and the commit log
    belong to one replay.
    """

    def __init__(self, netem=None, device=None, tracer=None):
        from repro_torch.obs.trace import NULL
        from repro_torch.record.device import POLL_TRIPS, DeviceProxy
        self.device = device if device is not None else DeviceProxy()
        self.netem = netem
        self.tracer = tracer if tracer is not None else NULL
        self.poll_trips = POLL_TRIPS
        self.q = CommitQueue(self.device.channel, netem=netem,
                             name="replay-plan")
        self._ran = False
        self._plan: Optional[ReplayPlan] = None

    def run(self, plan: ReplayPlan) -> dict:
        from repro_torch.obs.trace import traced
        if self._ran:
            raise RuntimeError("PlanExecutor is single-use: build a new "
                               "executor per replayed plan")
        self._ran = True
        self._plan = plan
        mark = self.netem.checkpoint() if self.netem else None
        q = self.q
        tr = self.tracer
        with tr.clock_scope(self.netem):
            for i, g in enumerate(plan.groups):
                if len(g.ops) == 1 and g.ops[0][0] == "poll":
                    # naive spin, one blocking round trip per trip: warm-up
                    # trips re-read the poll site (not-ready), the final trip
                    # is the dispatch that resolves the completion value
                    with traced(tr, "replay.poll_spin", "replay",
                                group=i, site=g.ops[0][1],
                                trips=self.poll_trips):
                        for _ in range(self.poll_trips - 1):
                            q.read(g.ops[0][1])
                            q.commit()
                        q.poll(g.ops[0][1])
                        q.commit()
                    continue
                with traced(tr, "replay.dispatch", "replay",
                            group=i, ops=len(g.ops)):
                    for kind, site, payload, _cdep in g.ops:
                        if kind == "write":
                            q.write(site, payload)
                        elif kind == "read":
                            q.read(site)
                        elif kind in ("poll", "wait"):
                            q.poll(site)  # offloaded device-side loop
                            if kind == "wait" and self.netem is not None:
                                self.netem.collapse_spins(payload - 1)
                                if tr:
                                    tr.instant("replay.collapsed_poll",
                                               "replay", group=i, site=site,
                                               spins=payload - 1)
                        else:
                            raise ValueError(
                                f"unknown replay op kind {kind!r}")
                    q.commit()
        totals = self.netem.delta(mark) if mark is not None else {}
        return self._report(plan, totals)

    # ---------------------------------------------------------- attestation --
    def quote(self, keys, *, recording_key: str, head: dict) -> dict:
        """Emit a replay attestation quote for the plan this executor
        ran: binds the recording key, the source program fingerprint,
        the compacted plan's identity, the committed write frontier, and
        the signed tree head the recording was fetched under.  Offline-
        verifiable via ``repro_torch.attest.verifier.verify_quote``."""
        from repro_torch.attest.quote import (build_quote, frontier_digest_of,
                                              plan_fingerprint_of)
        if not self._ran or self._plan is None:
            raise RuntimeError("quote() before run(): a quote attests an "
                               "executed replay, not an intention")
        return build_quote(
            keys, recording_key=recording_key,
            exec_fingerprint=self._plan.source_fingerprint,
            plan_fingerprint=plan_fingerprint_of(self._plan),
            frontier_digest=frontier_digest_of(self.write_log()),
            head=head,
            annotations={"passes": list(self._plan.passes),
                         "dispatches": len(self._plan.groups),
                         "writes": len(self.write_log())})

    # ----------------------------------------------------------- inspection --
    def write_log(self) -> List[tuple]:
        """Committed ``(site, payload)`` write sequence — the plan-level
        bit-exactness witness: compaction must never change it."""
        return [(op.site, op.payload) for op in self.q.log
                if op.kind == "write"]

    def readback_log(self, sites=None) -> List[tuple]:
        """Resolved ``(site, value)`` readbacks, optionally filtered to the
        consumed set — the raw committed order, spins included."""
        return [(op.site, op.symbol.value) for op in self.q.log
                if op.symbol is not None and op.symbol.resolved
                and (sites is None or op.site in sites)]

    def consumed_log(self, sites) -> List[tuple]:
        """The OTHER bit-exactness witness: the consumed completion values.
        A naive spin's warm-up trips re-read the poll site (each readback
        is "not ready yet"); only the final trip's value is what the plan
        consumes — so runs of consecutive same-site entries collapse to
        their last value.  Identical across pass stacks by construction,
        and the tests pin it."""
        raw = self.readback_log(sites)
        out: List[tuple] = []
        for site, value in raw:
            if out and out[-1][0] == site:
                out[-1] = (site, value)
            else:
                out.append((site, value))
        return out

    def _report(self, plan: ReplayPlan, totals: dict) -> dict:
        return {
            "net": self.netem.profile.name if self.netem else "in-process",
            "passes": list(plan.passes),
            "virtual_time_s": round(float(totals.get("time_s", 0.0)), 6),
            "blocking_round_trips": int(totals.get("round_trips", 0)),
            "async_round_trips": int(totals.get("async_trips", 0)),
            "bytes_sent": int(totals.get("bytes_sent", 0)),
            "bytes_received": int(totals.get("bytes_received", 0)),
            "collapsed_spins": int(totals.get("collapsed_spins", 0)),
            "dispatches": len(plan.groups),
            "plan_ops": plan.n_ops,
            "ops_executed": len(self.device.exec_log),
            "writes": len(self.write_log()),
            "jobs": plan.jobs,
            "per_pass": dict(plan.acct),
        }


def replay_plan_report(rec: Recording, passes="all", *, netem=None,
                       jobs: Optional[int] = None,
                       fuse_jobs: int = FUSE_JOBS) -> dict:
    """One-call convenience: compact ``rec``'s plan and execute it over
    ``netem`` (None = unbilled in-process), returning the executor report."""
    plan = plan_for(rec, passes, jobs=jobs, fuse_jobs=fuse_jobs)
    return PlanExecutor(netem=netem).run(plan)


__all__ = ["REPLAY_PASS_NAMES", "FUSE_JOBS", "resolve_replay_passes",
           "ReplayPlan", "DispatchGroup", "DeadRegisterElim", "PollCollapse",
           "CommitCoalesce", "plan_for", "verified_plan", "PlanExecutor",
           "replay_plan_report"]
