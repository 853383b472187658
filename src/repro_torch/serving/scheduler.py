"""Scheduler — multi-tenant serving over per-stream executors.

One scheduler serves N streams (model families / workloads) round-robin,
each through its own ``StreamExecutor`` and ``ExecutionChannel``, all
sharing ONE ``CommitFrontier`` (the only host<->device sync point) and
ONE ``HistorySpeculator`` (keyed by ``(stream, site)`` so per-stream
prediction dynamics are identical to serving that stream alone — the
bit-exactness guarantee the multi-tenant tests pin down).

Scheduler responsibilities, per layer:
  * admission — per-stream; a global ``max_live_slots`` budget applies
    back-pressure across tenants (slot pressure): a stream whose
    admission would push the fleet over budget defers until slots free;
  * shape-bucketing — the per-stream prefill bucket ladders are policy
    owned here and handed to the executors;
  * preemption/eviction — a stream that holds slots but commits no new
    tokens for ``stall_limit`` consecutive frontier drains is preempted:
    its unfinished requests are requeued (committed tails survive;
    deterministic decode resumes them bit-exactly) and its slots return
    to the pool.  ``preempt(name)`` does the same on demand.

Per-stream isolation: an executor touches only its own slots, caches,
and commit queue; the shared speculator never mixes histories across
streams; a replay-channel stream reaches decode without importing model
code (the channel trust boundary).
"""
from __future__ import annotations

import collections
from typing import Dict, List, Optional, Sequence

from repro_torch.core.channel import ExecutionChannel
from repro_torch.core.speculation import HistorySpeculator
from repro_torch.obs.metrics import Metrics
from repro_torch.obs.trace import NULL
from repro_torch.serving.executor import (PreemptionUnsupportedError,
                                          StreamExecutor)
from repro_torch.serving.frontier import CommitFrontier


class UnknownStreamError(KeyError):
    pass


class Scheduler:
    def __init__(self, *, netem=None, spec_k: int = 3,
                 max_live_slots: Optional[int] = None,
                 stall_limit: Optional[int] = None,
                 tracer=None, metrics: Optional[Metrics] = None):
        self.netem = netem
        self.tracer = tracer if tracer is not None else NULL
        self.metrics = metrics if metrics is not None else Metrics()
        self.frontier = CommitFrontier()
        self.frontier.tracer = self.tracer
        self.spec = HistorySpeculator(k=spec_k)
        self.streams: Dict[str, StreamExecutor] = {}
        self.max_live_slots = max_live_slots
        self.stall_limit = stall_limit
        self.counters = collections.Counter()
        self._progress: Dict[str, tuple] = {}  # slot marker at last drain
        self._stalled: Dict[str, int] = {}     # consecutive no-progress drains
        self._stall_hwm: Dict[str, int] = {}   # worst stall streak per stream
        self._blocks_since_drain: Dict[str, int] = {}
        self._unevictable: set = set()         # auto-eviction failed once

    # ------------------------------------------------------------ streams --
    def add_stream(self, name: str, channel: ExecutionChannel, params, *,
                   n_slots: int, cache_len: int, block_k: int,
                   eos_id: int = 2, init_caches_fn=None,
                   cache_batch_axes=None, speculate: bool = True,
                   pipeline_depth: int = 4,
                   prefill_buckets: Sequence[int] = (8, 16, 32, 64, 128),
                   ) -> StreamExecutor:
        if name in self.streams:
            raise ValueError(f"stream '{name}' already registered")
        ex = StreamExecutor(
            name, channel, params, n_slots=n_slots, cache_len=cache_len,
            block_k=block_k, frontier=self.frontier, speculator=self.spec,
            eos_id=eos_id, init_caches_fn=init_caches_fn,
            cache_batch_axes=cache_batch_axes, netem=self.netem,
            speculate=speculate, pipeline_depth=pipeline_depth,
            prefill_buckets=prefill_buckets,
            admission_gate=self._may_admit,
            tracer=self.tracer, metrics=self.metrics)
        self.streams[name] = ex
        self._progress[name] = ex.progress_marker()
        self._stalled[name] = 0
        self._stall_hwm[name] = 0
        self._blocks_since_drain[name] = 0
        return ex

    def stream(self, name: str) -> StreamExecutor:
        try:
            return self.streams[name]
        except KeyError:
            raise UnknownStreamError(name) from None

    # ---------------------------------------------------------- admission --
    def live_slots(self) -> int:
        return sum(int(ex.slots.active_mask().sum())
                   for ex in self.streams.values())

    def _may_admit(self, ex: StreamExecutor) -> int:
        """Slot-pressure gate: how many slots the stream may take without
        pushing the fleet past the global budget (a large number when no
        budget is set).  Per-stream slot tables still bound each tenant."""
        if self.max_live_slots is None:
            return ex.slots.n_slots
        return max(0, self.max_live_slots - self.live_slots())

    def submit(self, name: str, prompt: List[int], max_new: int) -> int:
        return self.stream(name).submit(prompt, max_new)

    # ----------------------------------------------------------- stepping --
    def has_work(self) -> bool:
        return any(ex.has_work() for ex in self.streams.values())

    def step(self, validate_every: Optional[int] = None) -> int:
        """One round-robin pass: each stream with work dispatches one fused
        block; a stream visits the frontier every ``validate_every`` of ITS
        OWN blocks (default: its pipeline depth), exactly as it would when
        served alone.  Returns the number of blocks stepped."""
        stepped = 0
        for name, ex in self.streams.items():
            if not ex.has_work():
                continue
            ex.step_block()
            stepped += 1
            self._blocks_since_drain[name] += 1
            if self._blocks_since_drain[name] >= \
                    (validate_every or ex.pipeline_depth):
                self.frontier.drain(ex)
                self._blocks_since_drain[name] = 0
                self._note_progress(name, ex)
        return stepped

    # --------------------------------------------------------- preemption --
    def _note_progress(self, name: str, ex: StreamExecutor):
        """Stall detection: a stream whose active slots show the same
        device positions across consecutive frontier drains is making no
        forward progress (hung/frozen channel) — evict it so its slots
        relieve the global pressure and healthy tenants keep serving."""
        marker = ex.progress_marker()
        if marker != self._progress[name] or not ex.slots.active_mask().any():
            self._stalled[name] = 0
        else:
            self._stalled[name] += 1
            if self._stalled[name] > self._stall_hwm[name]:
                self._stall_hwm[name] = self._stalled[name]
        self._progress[name] = marker
        if self.stall_limit is not None and \
                self._stalled[name] >= self.stall_limit and \
                ex.slots.active_mask().any() and \
                name not in self._unevictable:
            try:
                self.preempt(name)
            except PreemptionUnsupportedError:
                # a pinned-prefill-shape (replay) stream cannot resume
                # evicted prefixes — leave it in place rather than abort
                # serving for every healthy tenant; never retry
                self._unevictable.add(name)
                self.counters["eviction_unsupported"] += 1
                if self.tracer:
                    self.tracer.instant("sched.eviction_unsupported", "sched",
                                        stream=name)

    def preempt(self, name: str) -> List[int]:
        """Evict a stream's active requests back to its pending queue; the
        slots return to the pool (global slot pressure relief) and the
        stream re-admits when the scheduler next reaches it."""
        ex = self.stream(name)
        evicted = ex.preempt()
        if evicted:
            self.counters["preemptions"] += 1
            self._stalled[name] = 0
            if self.tracer:
                self.tracer.instant("sched.preempt", "sched", stream=name,
                                    evicted=len(evicted))
        return evicted

    # ---------------------------------------------------------------- run --
    def run(self, max_blocks: int = 10_000,
            validate_every: Optional[int] = None
            ) -> Dict[str, Dict[int, List[int]]]:
        """Serve every stream until drained; final frontier drain included.
        Returns ``{stream: {rid: tokens}}``."""
        b = 0
        while self.has_work() and b < max_blocks:
            b += self.step(validate_every)
        for name, ex in self.streams.items():
            self.frontier.drain(ex)
            self._blocks_since_drain[name] = 0
        return {name: ex.outputs() for name, ex in self.streams.items()}

    # ---------------------------------------------------------- reporting --
    def stats(self) -> dict:
        """Public scheduler stats: preempt/evict counts plus the per-stream
        stall state the preemption policy runs on — the stall high-water
        mark answers "how close did this tenant come to eviction".  Shape
        is pinned by ``repro.obs.schema.check_scheduler_stats``."""
        return {
            "preemptions": int(self.counters["preemptions"]),
            "eviction_unsupported": int(self.counters["eviction_unsupported"]),
            "live_slots": self.live_slots(),
            "max_live_slots": self.max_live_slots,
            "stall_limit": self.stall_limit,
            "streams": {
                name: {
                    "stalled": int(self._stalled[name]),
                    "stall_hwm": int(self._stall_hwm[name]),
                    "unevictable": name in self._unevictable,
                    "evicted_requests": int(ex.stats["evicted_requests"]),
                    "admissions_deferred":
                        int(ex.stats["admissions_deferred"]),
                } for name, ex in self.streams.items()
            },
        }

    def aggregate_stats(self) -> collections.Counter:
        total = collections.Counter(self.counters)
        for name, ex in self.streams.items():
            for k, v in ex.stats.items():
                total[f"{name}.{k}"] = v
        total.update({f"frontier.{k}": v
                      for k, v in self.frontier.stats.items()})
        return total
