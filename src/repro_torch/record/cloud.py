"""CloudDryrun — the "software" half of the CODY recording session.

Counterpart of ``repro/record/cloud.py``.  The cloud owns the GPU
software stack: it dry-runs the workload through the ``torch.export``
path (``repro_torch.core.recorder.compile_artifact`` — example tensors,
never the caller's data) and, from the exported artifact, derives
the *interaction plan*: the program-ordered stream of register accesses
the distributed driver must execute on the device's hardware, structured
into the driver-routine segments of the paper's Fig. 8 (init probes,
per-job power/config/doorbell/IRQ handling, offloadable polling loops)
plus a per-job memory sync.

The plan is deterministic in the artifact (job count derives from the
serialized program's size), so two sessions over the same dryrun replay
identical op logs — the invariant the record-time ablation measures
against.  A ``torch.export`` payload is not the size of an XLA
executable, so the default job count differs from the reference's for
the same step; ``jobs=`` pins it, and at a pinned count (or on identical
``Recording`` bytes) both packages play the same plan.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from repro_torch.core.recorder import compile_artifact
from repro_torch.core.recording import Recording

# An op is (kind, site, payload, cdep): cdep marks a control dependency —
# the real driver branches on this read, so deferral must commit here
# (§4.1); without deferral every op is its own blocking round trip.
PlanOp = Tuple[str, str, Optional[int], bool]

INIT_PROBES = 64          # boot-time register probing (paper fig. 8 "init")
PROBE_CDEP_EVERY = 16
IRQ_FILL = 8              # per-job auxiliary IRQ-handler reads
CDEP_EVERY = 5            # paper: deferral encloses ~3.8-5 accesses/commit
JOB_MIN, JOB_MAX = 12, 48
DATA_FLOOR_BYTES = 256 << 10    # modeled GPU memory image floor per job
DATA_CAP_BYTES = 1 << 20

# Readbacks the downstream plan CONSUMES at replay time: the job completion
# chain — the offloaded flush poll, the flush id it resolves to (job
# chaining orders on it: ``job_state['job']['chain_prev_id']``), and the
# final job status the replayer checks before retiring the job.  Every
# other read (init probes, pwr/cfg status, irq fills) only steered the
# live driver's record-time control flow; the recording has those branch
# outcomes baked in, so their readbacks are dead weight during replay —
# the liveness set the replay-side dead-access-elimination pass prunes to.
REPLAY_CONSUMED_SITES = frozenset(
    {"flush_poll", "latest_flush_id", "job_status"})


class CloudDryrun:
    """Drives the compile stack and emits the register-access plan.

    ``jobs`` pins the GPU job count (benchmarks use this so the ablation
    is invariant to program size); default derives it from the
    artifact.
    """

    def __init__(self, jobs: Optional[int] = None):
        self._jobs_override = jobs
        self._heap_base: Dict[int, np.ndarray] = {}

    # ------------------------------------------------------------ dryrun --
    def dryrun(self, name: str, fn, args, **kw) -> Recording:
        """Export + serialize — the software half of the record."""
        return compile_artifact(name, fn, args, **kw)

    # -------------------------------------------------------------- plan --
    def plan_jobs(self, rec: Recording) -> int:
        if self._jobs_override is not None:
            return self._jobs_override
        return max(JOB_MIN, min(JOB_MAX, len(rec.payload) // 8192))

    def interaction_plan(self, rec: Recording) \
            -> Iterator[Tuple[str, List[PlanOp]]]:
        """Segments of ``(name, ops)``: one init segment, then one per GPU
        job.  Session plays these through the pass stack in order."""
        yield "init", [("read", f"probe_{i:03d}", None,
                        (i % PROBE_CDEP_EVERY) == PROBE_CDEP_EVERY - 1)
                       for i in range(INIT_PROBES)]
        for j in range(self.plan_jobs(rec)):
            ops: List[PlanOp] = [
                ("write", "pwr_on", 1, False),
                ("read", "pwr_status", None, True),
            ]
            ops += [("write", f"job_cfg{i}", j, False) for i in range(4)]
            ops += [("write", "job_doorbell", j, False),
                    ("poll", "flush_poll", None, True),
                    ("read", "latest_flush_id", None, True)]
            ops += [("read", f"irq_aux{i}", None,
                     (i % CDEP_EVERY) == CDEP_EVERY - 1)
                    for i in range(IRQ_FILL)]
            ops += [("read", "job_irq_status", None, True),
                    ("write", "job_irq_clear", 1, False),
                    ("read", "job_status", None, True)]
            yield f"job{j}", ops

    def consumed_readbacks(self) -> frozenset:
        """Sites whose readback the plan consumes downstream at REPLAY
        time (see ``REPLAY_CONSUMED_SITES``) — the liveness contract the
        replay-side dead-register-access-elimination pass prunes against.
        Every site in this set appears in the per-job segments of
        ``interaction_plan``; dropping any of them would change the
        consumed-readback log the compaction invariant pins."""
        return REPLAY_CONSUMED_SITES

    # --------------------------------------------------------- job state --
    def data_bytes(self, rec: Recording) -> int:
        """Per-job GPU memory image size, from the artifact's memory
        analysis (floored/capped: smoke compiles are tiny, real GPU images
        are not)."""
        mem = rec.manifest.get("memory", {})
        total = sum(int(mem.get(k, 0) or 0)
                    for k in ("arg_bytes", "temp_bytes", "out_bytes"))
        return max(DATA_FLOOR_BYTES, min(DATA_CAP_BYTES, total))

    def job_state(self, rec: Recording, j: int) -> dict:
        """GPU state after job ``j``: small integer job/ring descriptors
        (metastate — ``metasync.split`` classifies them by hint tokens and
        size) plus the big float memory image (program data).  The naive
        sync ships all of it; the metasync pass ships only the changed
        descriptor leaves."""
        elems = self.data_bytes(rec) // 4
        base = self._heap_base.get(elems)
        if base is None:
            # incompressible content — zlib must not deflate the naive
            # sync cost away; generated once, stamped per job
            base = np.random.default_rng(0).standard_normal(elems) \
                .astype(np.float32)
            self._heap_base[elems] = base
        heap = base.copy()
        heap[: min(64, elems)] = np.float32(j)
        return {
            "job": {"job_id": np.int32(j),
                    "chain_prev_id": np.int32(j - 1),
                    "slot_mask": np.full(8, j % 2, np.int32),
                    "irq_mask": np.int32(0x7)},
            "ring": {"doorbell_pos": np.int32(j % 16),
                     "submit_count": np.int32(j + 1)},
            "heap": heap,
        }


__all__ = ["CloudDryrun", "PlanOp", "INIT_PROBES", "IRQ_FILL", "CDEP_EVERY",
           "JOB_MIN", "JOB_MAX", "REPLAY_CONSUMED_SITES"]
