"""Commit speculation with history-based prediction (paper §4.2).

DriverShim predicts the read values of a commit when the last ``k``
commits at the same site returned identical values; execution continues on
the prediction and is validated when the real values arrive.  Misprediction
triggers rollback-via-replay: both sides restart from the last validated
point and fast-forward the interaction log (no network needed).

``HistorySpeculator`` is the predictor; ``SpeculativeRunner`` drives a
CommitQueue with speculation + validation + rollback, and collects the
paper's Fig. 8 statistics (commit categories, speculation hit rates).
"""
from __future__ import annotations

import collections
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.core.deferral import CommitQueue, Op


class MispredictError(Exception):
    def __init__(self, site, predicted, actual):
        super().__init__(f"mispredict @ {site}: {predicted} != {actual}")
        self.site = site
        self.predicted = predicted
        self.actual = actual


class HistorySpeculator:
    """Predict commit outcomes from k identical historical outcomes.

    One speculator may be SHARED across serving streams: histories are
    keyed by ``(stream, site-sequence)``, so a multi-tenant scheduler
    gets per-stream prediction dynamics identical to serving each stream
    alone (tenant isolation — histories never mix)."""

    def __init__(self, k: int = 3):
        self.k = k
        self.history: Dict[str, collections.deque] = {}
        self.stats = collections.Counter()

    def _key(self, ops: List[Op], stream: str = "") -> str:
        sites = "|".join(f"{o.kind}:{o.site}" for o in ops)
        return f"{stream}::{sites}" if stream else sites

    def predict(self, ops: List[Op], stream: str = "") -> Optional[Tuple]:
        self.stats["predicts"] += 1
        key = self._key(ops, stream)
        h = self.history.get(key)
        if h is None or len(h) < self.k:
            self.stats["no_history"] += 1
            return None
        vals = list(h)[-self.k:]
        if all(v == vals[0] for v in vals):
            self.stats["predicted"] += 1
            return vals[0]
        self.stats["low_confidence"] += 1
        return None

    def record(self, ops: List[Op], outcome: Tuple, stream: str = ""):
        self.stats["records"] += 1
        key = self._key(ops, stream)
        self.history.setdefault(key, collections.deque(maxlen=16)).append(
            tuple(outcome))

    def hit_rate(self) -> float:
        """Fraction of ``predict()`` calls that produced a usable
        prediction — the shared-history lift metric the record fan-out
        campaign reports per (hw_class, device)."""
        n = self.stats["predicts"]
        return (self.stats["predicted"] / n) if n else 0.0


class SpeculativeRunner:
    """Speculative commits over a CommitQueue.

    ``checkpoint_fn()`` captures a restartable snapshot (metastate only —
    cheap); ``rollback_fn(snapshot, log)`` restores and fast-forwards, the
    paper's replay-based recovery.  Validation of outstanding commits
    happens at ``sync()`` (the paper's externalization points) or when a
    dependent commit must not spill speculative state (§4.2 optimization).
    """

    def __init__(self, queue: CommitQueue, speculator: HistorySpeculator,
                 checkpoint_fn: Callable[[], Any],
                 rollback_fn: Callable[[Any, List[Op]], None]):
        self.q = queue
        self.spec = speculator
        self.checkpoint_fn = checkpoint_fn
        self.rollback_fn = rollback_fn
        self.outstanding: List[Tuple[List[Op], Tuple, Any]] = []
        self.stats = collections.Counter()

    def commit_speculative(self) -> bool:
        """Try to commit the queued ops with predicted read values.

        On success the commit is shipped ASYNCHRONOUSLY via
        ``CommitQueue.commit_async`` (device executes it; no blocking round
        trip — paper fig. 5c) and execution continues on the prediction;
        validation happens at ``sync()``.  Shipping goes through the ONE
        queue path, so in-batch symbol resolution is identical to a
        synchronous commit."""
        ops = list(self.q.queue)
        reads = [o for o in ops if o.symbol is not None]
        pred = self.spec.predict(ops) if reads else None
        if pred is None or len(pred) != len(reads):
            res = self.q.commit()           # synchronous fallback (1 RTT)
            self.spec.record(ops, tuple(res))
            self.stats["sync_commits"] += 1
            return False
        snapshot = self.checkpoint_fn()
        actual = self.q.commit_async()      # ships now; host does not stall
        self.outstanding.append((ops, tuple(pred), tuple(actual), snapshot))
        self.stats["spec_commits"] += 1
        return True

    def sync(self):
        """Validate all outstanding speculative commits (in order) — the
        paper's externalization barrier.  The ops were already logged and
        counted by ``commit_async``; this only compares prediction against
        the arrived values and rolls back on divergence."""
        while self.outstanding:
            ops, pred, actual, snapshot = self.outstanding.pop(0)
            self.spec.record(ops, actual)
            if pred != actual:
                self.stats["mispredicts"] += 1
                self.rollback_fn(snapshot, list(self.q.log))
                self.outstanding.clear()
                raise MispredictError(ops[0].site if ops else "?",
                                      pred, actual)
            self.stats["validated"] += 1
