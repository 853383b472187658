"""Counter/histogram metrics registry — tail latencies, not just totals.

The serving stack's `collections.Counter` stats answer "how many"; the
fleet-serving story (ROADMAP: per-tenant p50/p99/p99.9 SLOs) needs "how
slow at the tail".  ``Metrics`` is the one registry both live on:
named counters and histograms with label sets (``stream=...``), exact
nearest-rank quantiles, and a stable ``snapshot()`` schema that
``Workspace.report()`` and the benchmark artifacts are checked against
(``repro.obs.schema``) so report fields can't silently vanish.

Observations are stored exactly (these are bench/serving-scale series,
thousands of points, not production firehoses); quantiles are
nearest-rank on a sorted copy, so p50/p99/p99.9 are actual observed
values — no interpolation surprises in the artifacts.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

QUANTILE_KEYS = ("p50", "p99", "p999")
_QUANTILES = {"p50": 0.50, "p99": 0.99, "p999": 0.999}


def metric_key(name: str, labels: dict) -> str:
    """Canonical flattened series name: ``name{k=v,...}`` with labels
    sorted — the snapshot/schema key format."""
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


class Counter:
    """A monotonically increasing named count."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Histogram:
    """Exact-observation histogram with nearest-rank quantiles."""

    __slots__ = ("_vals",)

    def __init__(self):
        self._vals: List[float] = []

    def observe(self, x: float) -> None:
        self._vals.append(float(x))

    @property
    def count(self) -> int:
        return len(self._vals)

    @property
    def sum(self) -> float:
        return float(math.fsum(self._vals))

    def quantile(self, q: float) -> float:
        """Nearest-rank quantile (an actual observed value); 0.0 when no
        observations have been made."""
        if not self._vals:
            return 0.0
        if not 0.0 < q <= 1.0:
            raise ValueError(f"quantile must be in (0, 1], got {q}")
        v = sorted(self._vals)
        return v[min(len(v) - 1, max(0, math.ceil(q * len(v)) - 1))]

    def summary(self) -> dict:
        """Stable-shape summary: every key always present (zeros when
        empty) so downstream schemas never see missing fields."""
        out = {"count": self.count,
               "sum": round(self.sum, 6),
               "min": round(min(self._vals), 6) if self._vals else 0.0,
               "max": round(max(self._vals), 6) if self._vals else 0.0}
        for k, q in _QUANTILES.items():
            out[k] = round(self.quantile(q), 6)
        return out


class Metrics:
    """The registry: ``counter()``/``histogram()`` create-or-return named
    series; ``snapshot()`` renders the whole registry in the one shape
    the schema checker pins."""

    def __init__(self):
        self._counters: Dict[str, Counter] = {}
        self._histograms: Dict[str, Histogram] = {}

    # ------------------------------------------------------------- series --
    def counter(self, name: str, **labels) -> Counter:
        return self._counters.setdefault(metric_key(name, labels), Counter())

    def histogram(self, name: str, **labels) -> Histogram:
        return self._histograms.setdefault(metric_key(name, labels),
                                           Histogram())

    def get_histogram(self, name: str, **labels) -> Optional[Histogram]:
        """Lookup without creating (reporting paths must not mint empty
        series)."""
        return self._histograms.get(metric_key(name, labels))

    def quantiles(self, name: str, **labels) -> Optional[dict]:
        """p50/p99/p999 for one series, or None if it was never observed
        — the per-stream latency block the multitenant bench reports."""
        h = self.get_histogram(name, **labels)
        if h is None or h.count == 0:
            return None
        return {k: round(h.quantile(q), 6) for k, q in _QUANTILES.items()}

    # ----------------------------------------------------------- snapshot --
    def snapshot(self) -> dict:
        return {
            "counters": {k: c.value
                         for k, c in sorted(self._counters.items())},
            "histograms": {k: h.summary()
                           for k, h in sorted(self._histograms.items())},
        }


__all__ = ["Metrics", "Counter", "Histogram", "metric_key", "QUANTILE_KEYS"]
