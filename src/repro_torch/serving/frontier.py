"""CommitFrontier — the ONE host<->device synchronization point (§4.2+§5).

Every readback in the serving stack funnels through this object: a
frontier drain materializes the metastate (tokens / done mask / pos) of
every in-flight block of ONE stream in program order — one stall no
matter how many blocks it validates — and a synchronous fallback commit
is a one-block drain.  Nothing else in the stack reads device values
back (``to_host``) apart from the prefill's next-token read, which is
what keeps the pipeline's "only transfer is the frontier" invariant
checkable (the benchmarks count ``host_syncs``).

Rollback is BY NOT APPLYING: a mispredicted block (a sequence finished
mid-pipeline) is applied with EOS honored and the speculative tail behind
it is dropped — pure metastate, no device work is redone (KV rows beyond
the committed position are inert, repro.serving.cache invariant).
"""
from __future__ import annotations

import collections

import numpy as np
import torch

from repro_torch.obs.trace import NULL, traced

ALL_RUNNING = ("all_running",)
SOME_DONE = ("some_done",)


def to_host(x) -> np.ndarray:
    """Device -> host copy of one value (a stall on a CUDA tensor)."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class CommitFrontier:
    """Validates in-flight blocks; owns all host-sync accounting."""

    def __init__(self):
        self.stats = collections.Counter()
        self.tracer = NULL      # set by the Scheduler when tracing is on

    # ---------------------------------------------------------- readback --
    @staticmethod
    def materialize(out):
        """Host←device transfer of one block's metastate.  Callers never
        count this directly — ``drain``/``read_now`` account the stall."""
        return (to_host(out["tokens"]), to_host(out["done"]),
                to_host(out["pos"]))

    def read_now(self, stream, out):
        """Synchronous-commit readback: ONE stall for one block (the
        non-speculative fallback path)."""
        stream.stats["host_syncs"] += 1
        self.stats["host_syncs"] += 1
        if self.tracer:
            self.tracer.instant("host_sync", f"serve.{stream.name}",
                                kind="read_now")
        return self.materialize(out)

    # ------------------------------------------------------------- drain --
    def drain(self, stream) -> bool:
        """Validate every in-flight block of ``stream`` in order with ONE
        metastate readback, then commit the generated tails.  Returns
        False when a mispredict dropped the tail of the pipeline."""
        ok = True
        if stream.inflight:
            pipeline, stream.inflight = stream.inflight, []
            stream.stats["host_syncs"] += 1    # one stall for the drain
            self.stats["host_syncs"] += 1
            self.stats["drains"] += 1
            track = f"serve.{stream.name}"
            if self.tracer:
                self.tracer.instant("host_sync", track, kind="drain",
                                    blocks=len(pipeline))
            with traced(self.tracer, "frontier.drain", track,
                        blocks=len(pipeline)):
                if stream.netem is not None:
                    # the paper's metastate-only sync: done masks + token
                    # tails
                    n, k = stream.slots.n_slots, stream.block_k
                    stream.netem.round_trip(
                        send_bytes=64,
                        recv_bytes=len(pipeline) * n * (4 * k + 5))
                for b_idx, blk in enumerate(pipeline):
                    actual = self.materialize(blk["out"])
                    outcome = SOME_DONE if actual[1].any() else ALL_RUNNING
                    stream.spec.record(blk["ops"], outcome,
                                       stream=stream.name)
                    if blk["pred"] != outcome:
                        stream.stats["mispredicts"] += 1
                        self.stats["mispredicts"] += 1
                        if self.tracer:
                            self.tracer.instant(
                                "frontier.mispredict", track,
                                dropped=len(pipeline) - b_idx - 1)
                        stream.apply_block(actual, speculative=False)
                        stream.retire(actual)
                        stream.reset_device_chain()  # chain built on a lie
                        dropped = len(pipeline) - b_idx - 1
                        stream.stats["dropped_blocks"] += dropped
                        ok = False
                        break
                    stream.apply_block(
                        actual, speculative=outcome == ALL_RUNNING)
                    stream.retire(actual)
                    stream.stats["validated_blocks"] += 1
                    self.stats["validated_blocks"] += 1
        # frontier clean: commit generated tails
        for req in stream.requests.values():
            req.committed = len(req.generated)
        stream.slots.committed_pos[:] = stream.slots.pos
        return ok

    def drain_all(self, streams) -> bool:
        ok = True
        for s in streams:
            ok = self.drain(s) and ok
        return ok
