"""Straggler mitigation for the dispatch pipeline.

Counterpart of ``repro/runtime/straggler.py`` (pure Python; the same
flags for the same latency stream).

The deferral CommitQueue gives a natural interposition point: every commit
has a measurable latency.  ``DispatchMonitor`` keeps an EWMA of commit
latencies per stream; a commit exceeding ``factor x EWMA`` flags the
stream as straggling, which triggers (a) re-dispatch of the speculative
segment on a backup stream (serving), or (b) work-stealing in the data
loader (training).
"""
from __future__ import annotations

import collections
import time
from typing import Callable, Dict, Optional


class DispatchMonitor:
    def __init__(self, factor: float = 3.0, alpha: float = 0.2,
                 min_samples: int = 5):
        self.factor = factor
        self.alpha = alpha
        self.min_samples = min_samples
        self.ewma: Dict[str, float] = {}
        self.count: Dict[str, int] = collections.Counter()
        self.flagged: collections.Counter = collections.Counter()

    def observe(self, stream: str, latency_s: float) -> bool:
        """Record a commit latency; True if this commit straggles."""
        n = self.count[stream]
        self.count[stream] += 1
        if n == 0:
            self.ewma[stream] = latency_s
            return False
        mean = self.ewma[stream]
        straggle = (n >= self.min_samples and
                    latency_s > self.factor * max(mean, 1e-9))
        self.ewma[stream] = (1 - self.alpha) * mean + self.alpha * latency_s
        if straggle:
            self.flagged[stream] += 1
        return straggle

    def timed(self, stream: str, fn: Callable, *args,
              backup: Optional[Callable] = None):
        """Run fn; on straggle, re-dispatch on `backup` (first result wins —
        here sequential emulation: backup result replaces)."""
        t0 = time.time()
        out = fn(*args)
        if self.observe(stream, time.time() - t0) and backup is not None:
            out = backup(*args)
        return out


__all__ = ["DispatchMonitor"]
