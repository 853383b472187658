"""StreamExecutor — one tenant's decode pipeline over one ExecutionChannel.

Counterpart of ``repro/serving/executor.py``; the KV caches live on the
channel's device and are updated in place.

A stream owns everything whose corruption could leak across tenants: its
``SlotTable``, its KV caches, its ``CommitQueue`` (program order is a
per-stream property), and its pipeline of in-flight fused blocks.  What
it does NOT own is shared serving infrastructure: the
``HistorySpeculator`` (keyed by ``(stream, site)`` so histories never
mix) and the ``CommitFrontier`` (the single host<->device sync point)
are handed in by the scheduler.

The hot path is unchanged from the single-tenant engine: decode runs in
fused k-step blocks, a dispatched block's outputs stay on device and the
next block's inputs chain off them, up to ``pipeline_depth`` blocks in
flight with zero host syncs; speculation decides whether a block ships
via ``commit_async`` or falls back to a synchronous commit.  Token tails
apply only at the frontier, so rollback is by not applying.

Preemption support: ``preempt()`` drains the frontier, releases every
active slot, and requeues the unfinished requests at the front of the
pending queue.  Because decoding is deterministic, a resumed request
re-prefills ``prompt + generated[:-1]`` and continues bit-exactly where
it was evicted (the re-predicted next token IS ``generated[-1]``); KV
rows left behind are inert.  Recorded-prefill channels pin the prompt
shape, so preemption requires ``channel.fixed_prompt_len is None``.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Dict, List, Sequence

import numpy as np
import torch

from repro_torch.core.channel import ExecutionChannel
from repro_torch.core.deferral import CommitQueue, Op
from repro_torch.obs.trace import NULL, traced
from repro_torch.serving.cache import SlotTable, cache_leaves
from repro_torch.serving.frontier import (ALL_RUNNING, SOME_DONE,
                                          CommitFrontier, to_host)


class PreemptionUnsupportedError(RuntimeError):
    """The stream's channel pins the prefill shape; an evicted request
    could not be resumed (``prompt + generated[:-1]`` has a new length)."""


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new: int
    generated: List[int] = dataclasses.field(default_factory=list)
    committed: int = 0            # validated prefix of `generated`
    done: bool = False
    failed: bool = False          # dropped (e.g. prefix outgrew the cache)
    submit_t: float = 0.0
    finish_t: float = 0.0

    def prefix(self) -> List[int]:
        """The tokens a (re-)admission must prefill: the prompt, plus — for
        a request resumed after preemption — all but the last committed
        token (decode re-consumes ``generated[-1]`` as its next input)."""
        if self.generated:
            return self.prompt + self.generated[:-1]
        return self.prompt


class StreamExecutor:
    """One stream's admission + pipelined fused-block decode."""

    def __init__(self, name: str, channel: ExecutionChannel, params, *,
                 n_slots: int, cache_len: int, block_k: int,
                 frontier: CommitFrontier, speculator, eos_id: int = 2,
                 init_caches_fn=None, cache_batch_axes=None, netem=None,
                 speculate: bool = True, pipeline_depth: int = 4,
                 prefill_buckets: Sequence[int] = (8, 16, 32, 64, 128),
                 admission_gate=None, tracer=None, metrics=None):
        self.name = name
        self.channel = channel
        self.params = params
        self.netem = netem
        self.tracer = tracer if tracer is not None else NULL
        self.metrics = metrics
        self.track = f"serve.{name}"
        self.block_k = block_k
        self.cache_len = cache_len
        self.eos_id = eos_id
        self.frontier = frontier
        self.slots = SlotTable(n_slots)
        self.caches = init_caches_fn() if init_caches_fn else None
        self._init_caches_fn = init_caches_fn
        # per-leaf position of the batch axis (leading dims may be stage
        # stacks); provided by the launcher from model.cache_axes
        self._batch_axes = cache_batch_axes
        self.requests: Dict[int, Request] = {}
        self.pending: collections.deque = collections.deque()
        self._rid = 0              # monotonic: rids survive request removal
        self.queue = CommitQueue(self._exec_op, netem=netem, name=name)
        self.spec = speculator
        self.speculate = speculate
        self.pipeline_depth = max(1, pipeline_depth)
        self.prefill_buckets = tuple(sorted(prefill_buckets))
        # scheduler slot-pressure hook: admission asks before taking a slot
        self._admission_gate = admission_gate
        self.inflight: List[dict] = []     # unvalidated blocks (device futures)
        self.stats = collections.Counter()
        self._slot_tokens = np.zeros(n_slots, np.int32)
        # device-chained decode inputs; None => host metastate authoritative
        self._dev_tokens = None
        self._dev_pos = None
        self._last_block_out = None

    # ------------------------------------------------------------ channel --
    def _exec_op(self, op: Op):
        """CommitQueue channel: device-side execution of one interaction."""
        if op.kind == "write":      # dispatch a fused decode block
            self._dispatch_block()
            return None
        if op.kind == "read":       # done mask + tokens: an in-flight future
            return self._last_block_out
        return None

    def _dispatch_block(self):
        if self._dev_tokens is None:   # re-seed the chain from host metastate
            self._dev_tokens = self._slot_tokens.copy()   # the channel
            self._dev_pos = self.slots.pos.copy()         # places them
        out, self.caches = self.channel.decode_block(
            self.params, self._dev_tokens, self._dev_pos, self.caches)
        # chain the NEXT block's inputs off this block's device outputs:
        # nothing is read back (the fused kernel freezes finished rows, so
        # tokens[:, -1]/pos are exactly what a host round trip would feed)
        self._dev_tokens = out["tokens"][:, -1]
        self._dev_pos = out["pos"]
        self._last_block_out = out
        self.stats["blocks_dispatched"] += 1

    def reset_device_chain(self):
        """Host metastate becomes authoritative: the next dispatch re-seeds
        its inputs instead of chaining off stale device futures."""
        self._dev_tokens = None
        self._dev_pos = None

    # ------------------------------------------------------------- public --
    def submit(self, prompt: List[int], max_new: int) -> int:
        rid = self._rid
        self._rid += 1
        self.requests[rid] = Request(rid, list(prompt), max_new,
                                     submit_t=time.time())
        self.pending.append(rid)
        return rid

    def has_work(self) -> bool:
        return bool(self.pending) or not all(self.slots.done)

    def committed_tokens(self) -> int:
        return sum(r.committed for r in self.requests.values())

    def progress_marker(self) -> tuple:
        """Device-progress fingerprint for the scheduler's stall detector:
        the active slot set and its positions.  A channel that stops
        advancing ``pos`` (a hung/frozen device) yields an identical
        marker across frontier drains even though speculative token tails
        may still be growing host-side."""
        live = self.slots.active_mask()
        return (tuple(self.slots.request_id[live].tolist()),
                tuple(self.slots.pos[live].tolist()))

    # ---------------------------------------------------------- admission --
    def _admit(self):
        if not self.pending or not self.slots.done.any():
            return
        budget = None          # scheduler slot pressure: None = unlimited
        if self._admission_gate is not None:
            budget = self._admission_gate(self)
            if budget <= 0:
                self.stats["admissions_deferred"] += 1
                return
        if self.inflight:
            # admission changes the decode batch and re-seeds the device
            # chain from host metastate — which is STALE while blocks are
            # in flight (tails apply at the frontier).  Drain first.
            self.frontier.drain(self)
        group = []
        while self.pending and (budget is None or len(group) < budget):
            rid = self.pending[0]
            req = self.requests[rid]
            if len(req.prefix()) + 1 > self.cache_len:
                # the prefix no longer fits the cache (a resumed request
                # that outgrew capacity): drop it rather than crash decode
                self.pending.popleft()
                req.done = True
                req.failed = True
                req.finish_t = time.time()
                self.stats["capacity_dropped"] += 1
                continue
            slot = self.slots.alloc(rid, len(req.prefix()))
            if slot is None:
                break
            self.pending.popleft()
            group.append((req, slot))
        if not group:
            return
        self.reset_device_chain()          # host metastate changes below
        if not self.channel.supports_batched_prefill:
            for req, slot in group:
                self._prefill_into_slot(req, slot)
        else:
            for plen, members in sorted(self._bucketize(group).items()):
                self._prefill_group(members, plen)
        self.stats["admitted"] += len(group)

    def _bucketize(self, group):
        """Group (request, slot) pairs by padded prompt length so each
        bucket is ONE prefill dispatch (and one jit shape)."""
        buckets: Dict[int, list] = {}
        for req, slot in group:
            plen = len(req.prefix())
            padded = next((b for b in self.prefill_buckets if b >= plen),
                          plen)
            padded = max(min(padded, self.cache_len), plen)
            buckets.setdefault(padded, []).append((req, slot))
        return buckets

    def _seed_slot(self, req: Request, slot: int, predicted_first: int):
        """Install a freshly prefilled request's next decode input.  For a
        resumed request the model re-predicts ``generated[-1]`` (greedy
        decode is deterministic), so the committed tail stays authoritative
        and nothing is appended twice."""
        if req.generated:
            self._slot_tokens[slot] = req.generated[-1]
        else:
            self._slot_tokens[slot] = predicted_first
            req.generated.append(predicted_first)

    def _prefill_group(self, members, padded_len: int):
        """One dispatch for a whole bucket.  Right padding is sound: each
        row's next token is read at its true last position and decode masks
        cache rows >= pos, so pad garbage in the caches is inert."""
        toks = np.zeros((len(members), padded_len), np.int32)
        lens = np.empty(len(members), np.int32)
        for row, (req, _slot) in enumerate(members):
            prefix = req.prefix()
            toks[row, :len(prefix)] = prefix
            lens[row] = len(prefix)
        with traced(self.tracer, "prefill.dispatch", self.track,
                    padded_len=padded_len, requests=len(members)):
            out, caches = self.channel.batched_prefill(
                self.params, toks, lens)
            firsts = to_host(out["next_tokens"])
            for row, (req, slot) in enumerate(members):
                self._seed_slot(req, slot, int(firsts[row]))
            self._scatter_caches(caches, np.array([s for _, s in members]))
            if self.netem is not None:
                self.netem.round_trip()  # ONE synchronous commit per bucket
        self.stats["prefill_dispatches"] += 1

    def _scatter_caches(self, new_caches, slots_arr: np.ndarray):
        """Vectorized scatter of a prefilled group into the slot caches:
        one indexed write per cache leaf (not per request per leaf).  The
        slot caches are written IN PLACE (the reference rebuilds them with
        ``.at[].set``): only the group's own slots change."""
        flat_c = cache_leaves(self.caches)
        flat_n = cache_leaves(new_caches)
        axes = self._batch_axes or [0] * len(flat_c)
        for c, n, ax in zip(flat_c, flat_n, axes):
            idx = torch.as_tensor(slots_arr, device=c.device)
            c[(slice(None),) * ax + (idx,)] = n.to(c.dtype)

    def _prefill_into_slot(self, req: Request, slot: int):
        """Per-request path: exact shapes (required for recorded prefill
        executables and for recurrent-state families)."""
        with traced(self.tracer, "prefill.dispatch", self.track,
                    rid=req.rid, prefix_len=len(req.prefix())):
            batch = {"tokens": np.asarray([req.prefix()], np.int32)}
            out, caches = self.channel.prefill(self.params, batch)
            self._seed_slot(req, slot, int(to_host(out["next_tokens"])[0]))
            self._scatter_caches(caches, np.array([slot]))
            if self.netem is not None:
                self.netem.round_trip()  # prefill is a synchronous commit
        self.stats["prefill_dispatches"] += 1

    # ------------------------------------------------------------- decode --
    def step_block(self):
        """One fused block for all active slots; returns #active.

        With speculation, up to ``pipeline_depth`` blocks stay in flight as
        device futures (shipped via ``commit_async``); without it — or when
        history is not k-confident — the block commits synchronously."""
        if len(self.inflight) >= self.pipeline_depth:
            self.frontier.drain(self)  # frontier full: drain before refill
        self._admit()
        active = int(self.slots.active_mask().sum())
        if not active:
            return 0
        self.queue.write("decode.block")
        self.queue.read("decode.done_mask")
        ops = list(self.queue.queue)
        pred = self.spec.predict(ops, stream=self.name) \
            if self.speculate else None
        if pred is not None:
            # speculative continuation: ship without blocking; token tails
            # are applied (and validated) only at the commit frontier
            with traced(self.tracer, "decode.block", self.track,
                        mode="spec", active=active):
                self.queue.commit_async()
            self.inflight.append({"ops": ops, "out": self._last_block_out,
                                  "pred": pred})
            self.stats["spec_blocks"] += 1
        else:
            if self.inflight:
                self.frontier.drain(self)  # program order: drain, then block
            with traced(self.tracer, "decode.block", self.track,
                        mode="sync", active=active):
                self.queue.commit()
                actual = self.frontier.read_now(self, self._last_block_out)
            self.apply_block(actual, speculative=False)
            self.spec.record(
                ops, SOME_DONE if actual[1].any() else ALL_RUNNING,
                stream=self.name)
            self.retire(actual)
            self.stats["sync_blocks"] += 1
        return active

    # --------------------------------------------------------- preemption --
    def preempt(self) -> List[int]:
        """Evict every active request: drain the frontier (their committed
        tails survive), free the slots, and requeue the unfinished requests
        at the FRONT of the pending queue in slot order.  Returns the
        requeued request ids."""
        if self.channel.fixed_prompt_len is not None:
            raise PreemptionUnsupportedError(
                f"stream '{self.name}': channel '{self.channel.kind}' pins "
                f"the prefill shape to {self.channel.fixed_prompt_len}; "
                "resumed prefixes would not match")
        self.frontier.drain(self)
        evicted = []
        for i in np.flatnonzero(self.slots.active_mask()):
            evicted.append(int(self.slots.request_id[i]))
            self.slots.release(int(i))
        for rid in reversed(evicted):
            self.pending.appendleft(rid)
        if evicted:
            self.reset_device_chain()      # slot table changed
            self.stats["preemptions"] += 1
            self.stats["evicted_requests"] += len(evicted)
        return evicted

    # ------------------------------------------------------------ helpers --
    def apply_block(self, actual, speculative: bool):
        """Extend per-request tails from one block's metastate.  Mask math
        is vectorized; only the list extends touch Python objects."""
        tokens, done, newpos = actual
        n = self.slots.n_slots
        live = self.slots.active_mask()
        if not live.any():
            return
        k = tokens.shape[1]
        cut = np.full(n, k, np.int64)
        if not speculative:
            iseos = tokens[:n] == self.eos_id
            hit = iseos.any(axis=1) & np.asarray(done[:n], bool)
            if hit.any():
                cut[hit] = iseos[hit].argmax(axis=1) + 1
        last = tokens[np.arange(n), cut - 1]
        for i in np.flatnonzero(live):
            req = self.requests[int(self.slots.request_id[i])]
            req.generated.extend(int(t) for t in tokens[i, :cut[i]])
        self._slot_tokens[live] = last[live]
        self.slots.pos[live] = np.asarray(newpos)[:n][live]

    def retire(self, actual):
        _tokens, done, _ = actual
        done = np.asarray(done[: self.slots.n_slots], bool)
        for i in np.flatnonzero(self.slots.active_mask()):
            req = self.requests[int(self.slots.request_id[i])]
            if not (done[i] or len(req.generated) >= req.max_new):
                continue
            if done[i]:
                g = np.asarray(req.generated)
                eos = np.flatnonzero(g == self.eos_id)
                if eos.size:                   # truncate at first EOS
                    req.generated = req.generated[:int(eos[0]) + 1]
            req.generated = req.generated[:req.max_new]
            req.done = True
            req.finish_t = time.time()
            self.slots.release(i)
            self.reset_device_chain()          # slot table changed
            self.stats["retired"] += 1
            if self.metrics is not None:
                self.metrics.histogram(
                    "request_latency_s", stream=self.name).observe(
                        req.finish_t - req.submit_t)
                self.metrics.counter(
                    "requests_retired", stream=self.name).inc()
                self.metrics.counter(
                    "tokens_generated", stream=self.name).inc(
                        len(req.generated))
            if self.tracer:
                self.tracer.instant("request.done", self.track, rid=req.rid,
                                    tokens=len(req.generated))

    def outputs(self) -> Dict[int, List[int]]:
        return {rid: r.generated for rid, r in self.requests.items()}
