"""Register-access deferral (paper §4.1) on the host<->accelerator channel.

The paper's DriverShim queues GPU register accesses in program order,
represents unread values as *symbols* so the driver keeps executing, and
commits the queue in one network round trip when a value is actually needed
(control dependency), at externalization points, or at explicit barriers.

Here the "registers" are host<->device interactions of a serving/training
runtime: dispatches (writes) and readbacks (reads: done-flags, token values,
metrics).  ``CommitQueue`` preserves program order per stream, coalesces
round trips, and supports symbolic reads exactly like the paper.

This module is runtime-agnostic: the channel is anything callable that
executes one ``Op`` at a time in program order — a real device loop, the
NetworkEmulator-backed ``DeviceProxy`` of a recording session
(``repro_torch.record``), or a serving stream's executor (which turns ops
into ``ExecutionChannel`` step dispatches, see
``repro_torch.core.channel``).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Callable, List, Optional

_ids = itertools.count()


class Symbol:
    """A deferred read value (paper: symbolic register value).

    ``sid`` identifies the symbol within its queue/session.  Symbols made
    through a ``CommitQueue`` get ids from that queue's own counter, so op
    logs are deterministic per session; a bare ``Symbol(site)`` falls back
    to a module-global counter (standalone use only — ids from that
    counter leak across sessions and are NOT reproducible)."""
    __slots__ = ("sid", "site", "_value", "resolved")

    def __init__(self, site: str, sid: Optional[int] = None):
        self.sid = next(_ids) if sid is None else sid
        self.site = site
        self._value = None
        self.resolved = False

    @property
    def value(self):
        if not self.resolved:
            raise UnresolvedSymbolError(f"symbol {self.sid} @ {self.site}")
        return self._value

    def resolve(self, v):
        if self.resolved:
            # a second resolution would silently rewrite history the
            # speculation/validation machinery already acted on
            raise SymbolReResolutionError(
                f"symbol {self.sid} @ {self.site} already resolved")
        self._value = v
        self.resolved = True

    def __repr__(self):
        return f"S{self.sid}({self._value if self.resolved else '?'})"


class UnresolvedSymbolError(Exception):
    pass


class SymbolReResolutionError(RuntimeError):
    """A deferred read was resolved twice (program-order violation)."""


@dataclasses.dataclass
class Op:
    kind: str                  # "read" | "write" | "poll"
    site: str                  # program location (paper: driver source loc)
    payload: Any = None        # may contain Symbols (data dependencies)
    symbol: Optional[Symbol] = None   # for reads


def _resolve_payload(p):
    if isinstance(p, Symbol):
        return p.value
    if isinstance(p, (list, tuple)):
        return type(p)(_resolve_payload(x) for x in p)
    if isinstance(p, dict):
        return {k: _resolve_payload(v) for k, v in p.items()}
    return p


class CommitQueue:
    """Per-stream deferred interaction queue (program order preserved).

    ``channel(op) -> result_or_None`` executes ONE interaction on the
    device side; a commit ships the whole queue in a single round trip and
    the client executes ops in order, resolving intra-batch symbolic
    references as it goes (the paper ships symbols to the client the same
    way).  ``netem`` (optional) accounts the virtual network cost; the log
    of committed interactions *is* the recording trace.
    """

    def __init__(self, channel: Callable[[Op], Any],
                 netem=None, name: str = "stream0"):
        self.channel = channel
        self.netem = netem
        self.name = name
        # symbol ids are scoped to THIS queue: two freshly built sessions
        # replaying the same program produce identical op logs (a module-
        # global counter leaked ids across sessions/tests)
        self._sids = itertools.count()
        self.queue: List[Op] = []
        self.log: List[Op] = []            # committed interaction log
        self.commits = 0                   # blocking commits (1 RTT each)
        self.async_commits = 0             # shipped without stalling
        self.deferred_total = 0

    # -- deferral API (paper fig. 5b) --
    def write(self, site: str, payload=None):
        self.queue.append(Op("write", site, payload))
        self.deferred_total += 1

    def read(self, site: str) -> Symbol:
        s = Symbol(site, sid=next(self._sids))
        self.queue.append(Op("read", site, symbol=s))
        self.deferred_total += 1
        return s

    def poll(self, site: str, predicate_site: str = "") -> Symbol:
        """Offloaded polling loop (§4.3): executes device-side in the same
        commit; the read value is the loop's final state / trip count."""
        s = Symbol(site, sid=next(self._sids))
        self.queue.append(Op("poll", site, payload=predicate_site, symbol=s))
        self.deferred_total += 1
        return s

    def need(self, symbol: Symbol):
        """Control dependency on a deferred read -> synchronous commit."""
        if not symbol.resolved:
            self.commit()
        return symbol.value

    # -- commit --
    def execute_ops(self, ops: List[Op]) -> List[Any]:
        """Client-side in-order execution; resolves symbols as it goes so
        later ops in the same batch may reference earlier reads."""
        results = []
        for op in ops:
            op.payload = _resolve_payload(op.payload)
            res = self.channel(op)
            if op.symbol is not None:
                op.symbol.resolve(res)
                results.append(res)
        return results

    def commit(self, approx_bytes: int = 256) -> List[Any]:
        if not self.queue:
            return []
        ops = self.queue
        self.queue = []
        results = self.execute_ops(ops)
        self.log.extend(ops)
        self.commits += 1
        if self.netem is not None:
            send, recv = _wire_bytes(ops, results)
            self.netem.round_trip(send_bytes=max(send, approx_bytes),
                                  recv_bytes=recv)
        return results

    def commit_async(self, approx_bytes: int = 256) -> List[Any]:
        """Ship the queue WITHOUT a blocking round trip (paper fig. 5c).

        The client executes the batch now; read symbols resolve to whatever
        the channel returns — for the serving engine that is an in-flight
        device future, so the host keeps running and only materializes the
        value at the commit frontier.  Wire bytes are accounted with the
        same op/byte math as ``commit`` but as a non-blocking trip, so
        speculative and synchronous shipping can never drift apart in
        netem accounting."""
        if not self.queue:
            return []
        ops = self.queue
        self.queue = []
        results = self.execute_ops(ops)
        self.log.extend(ops)
        self.async_commits += 1
        if self.netem is not None:
            send, recv = _wire_bytes(ops, results)
            self.netem.async_trip(send_bytes=max(send, approx_bytes),
                                  recv_bytes=recv)
        return results

    def flush(self):
        return self.commit()


def _wire_bytes(ops: List[Op], results: List[Any]):
    """(send, recv) bytes for one shipped batch — the single source of
    truth for commit/commit_async netem accounting."""
    send = sum(64 + _payload_bytes(o.payload) for o in ops)
    recv = 64 + 8 * len(results)
    return send, recv


def _payload_bytes(p) -> int:
    if p is None:
        return 0
    if isinstance(p, (bytes, bytearray)):
        return len(p)
    if isinstance(p, (list, tuple)):
        return sum(_payload_bytes(x) for x in p)
    if isinstance(p, dict):
        return sum(_payload_bytes(v) for v in p.values())
    if hasattr(p, "nbytes"):
        return int(p.nbytes)
    return 8
