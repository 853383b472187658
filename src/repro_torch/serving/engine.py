"""Engine — thin single-stream facade over the layered serving stack.

Counterpart of ``repro/serving/engine.py``.

Serving is three layers (see ``repro_torch.serving.scheduler``):

  * ``Scheduler``      — admission across streams, slot pressure,
                         preemption/eviction of stalled streams;
  * ``StreamExecutor`` — one tenant's CommitQueue + pipeline of in-flight
                         fused blocks over its ``ExecutionChannel``;
  * ``CommitFrontier`` — the ONLY host<->device sync point: metastate
                         readback, rollback-by-not-applying on mispredict.

``Engine`` keeps the reference's single-workload API — ``submit`` /
``step_block`` / ``validate`` / ``run``, ``stats`` / ``requests`` /
``slots`` / ``spec`` — by wiring ONE stream through that stack.  Its
transport is an ``ExecutionChannel`` (``repro_torch.core.channel``);
``repro_torch.launch.serve.build_engine`` builds the live one.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

from repro_torch.core.channel import ExecutionChannel
from repro_torch.serving.cache import cache_leaves
from repro_torch.serving.executor import Request, StreamExecutor  # noqa: F401
from repro_torch.serving.scheduler import Scheduler

__all__ = ["Engine", "Request", "StreamExecutor", "Scheduler",
           "cache_batch_axes_for"]


class Engine:
    """One stream over ``channel``, whose steps are
    prefill(params, batch) -> ({"next_tokens", ...}, caches_for_slot),
    the optional batched_prefill(params, tokens[B,S], lengths[B]) (grouped
    admission) and decode_block(params, tokens, pos, caches) ->
    ({"tokens":[B,k], "pos", "done"}, caches).  ``pipeline_depth`` bounds
    how many decode blocks may be in flight before the frontier must
    drain.  ``netem`` (a ``NetworkEmulator``) bills the stream's commits,
    synchronous prefills and frontier drains to the emulated link.
    """

    def __init__(self, params, *, channel: ExecutionChannel, n_slots: int,
                 cache_len: int, block_k: int, eos_id: int = 2,
                 init_caches_fn=None, cache_batch_axes=None, netem=None,
                 spec_k: int = 3, speculate: bool = True,
                 pipeline_depth: int = 4,
                 prefill_buckets: Sequence[int] = (8, 16, 32, 64, 128),
                 stream_name: str = "stream0", tracer=None, metrics=None):
        self.scheduler = Scheduler(netem=netem, spec_k=spec_k,
                                   tracer=tracer, metrics=metrics)
        self.stream = self.scheduler.add_stream(
            stream_name, channel, params, n_slots=n_slots,
            cache_len=cache_len, block_k=block_k, eos_id=eos_id,
            init_caches_fn=init_caches_fn,
            cache_batch_axes=cache_batch_axes, speculate=speculate,
            pipeline_depth=pipeline_depth, prefill_buckets=prefill_buckets)
        self.channel = channel
        self.frontier = self.scheduler.frontier
        self.fixed_prompt_len = channel.fixed_prompt_len

    # ------------------------------------------------- stream pass-through --
    @property
    def params(self):
        return self.stream.params

    @property
    def stats(self):
        return self.stream.stats

    @property
    def metrics(self):
        return self.scheduler.metrics

    @property
    def spec(self):
        return self.scheduler.spec

    @property
    def slots(self):
        return self.stream.slots

    @property
    def caches(self):
        return self.stream.caches

    @property
    def requests(self):
        return self.stream.requests

    @property
    def pending(self):
        return self.stream.pending

    @property
    def queue(self):
        return self.stream.queue

    @property
    def inflight(self):
        return self.stream.inflight

    @property
    def pipeline_depth(self):
        return self.stream.pipeline_depth

    @property
    def speculate(self):
        return self.stream.speculate

    # ------------------------------------------------------------- public --
    def submit(self, prompt: List[int], max_new: int) -> int:
        return self.stream.submit(prompt, max_new)

    def step_block(self) -> int:
        return self.stream.step_block()

    def validate(self) -> bool:
        """Drain the commit frontier for this engine's stream."""
        return self.frontier.drain(self.stream)

    def run(self, max_blocks: int = 10_000,
            validate_every: Optional[int] = None):
        """Serve until drained.  The frontier is visited every
        ``validate_every`` blocks (default: the pipeline depth)."""
        validate_every = validate_every or self.stream.pipeline_depth
        b = 0
        while self.stream.has_work() and b < max_blocks:
            self.step_block()
            b += 1
            if b % validate_every == 0:
                self.validate()
        self.validate()
        return self.stream.outputs()


def cache_batch_axes_for(cfg) -> List[int]:
    """Per-leaf batch-axis positions, derived from the model's cache axes
    metadata (leaves align with ``cache_leaves`` of the cache tree).
    The model is imported here, not at module level, so the serving stack
    itself loads no model code (the channel trust boundary)."""
    from repro_torch.models import model as M
    return [ax.index("batch") for ax in cache_leaves(M.cache_axes(cfg))]
