"""Deterministic open-loop traffic — Poisson arrivals + bursts on the
virtual clock.

The fleet bench's latency claim is only worth something under OPEN-LOOP
load: arrivals come from the outside world at their own rate, they do
not wait for the system to finish the previous request (closed-loop
generators hide queueing delay exactly when it matters).  This module
generates that arrival process deterministically:

  * NO wall clock, NO ``random`` module — every draw comes from a
    ``numpy`` generator seeded from ``(seed, tenant index)``, and every
    timestamp is a virtual-clock second.  Two generators built with the
    same mixes and seed produce byte-identical arrival lists (the
    determinism test diffs the resulting ``BENCH_fleet.json``).
  * Per-tenant Poisson processes: exponential inter-arrivals at
    ``rate_rps``, one independent substream per tenant so adding a
    tenant never perturbs another tenant's arrivals.
  * Bursts by thinning: arrivals are drawn at the burst-peak rate and
    kept with probability ``rate(t)/peak`` — an exact inhomogeneous
    Poisson process whose rate is ``burst_x`` times the base inside
    periodic burst windows (flash-crowd traffic, the p99.9 stressor).

Counterpart of ``repro/fleet/traffic.py`` (pure Python and numpy): the
same mixes and seed give the reference's arrival list element for
element.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

_IntOrRange = Union[int, Tuple[int, int]]


@dataclasses.dataclass(frozen=True)
class TenantMix:
    """One tenant's share of the open-loop mix.

    ``prompt_len`` / ``max_new`` are an exact int or an inclusive
    ``(lo, hi)`` range; replay-mode fleets pin ``prompt_len`` to the
    recorded prefill ``seq`` (a recorded executable has exactly one
    prompt shape)."""
    tenant: str
    rate_rps: float
    prompt_len: _IntOrRange = 8
    max_new: _IntOrRange = 12
    vocab: int = 256


@dataclasses.dataclass(frozen=True)
class Arrival:
    """One request: global id, virtual arrival time, tenant, payload."""
    gid: int
    t: float
    tenant: str
    prompt: Tuple[int, ...]
    max_new: int


def _draw(rng: np.random.Generator, v: _IntOrRange) -> int:
    if isinstance(v, tuple):
        lo, hi = v
        return int(rng.integers(lo, hi + 1))
    return int(v)


class OpenLoopTraffic:
    """Seeded open-loop arrival generator over a set of tenant mixes.

    ``burst_every_s``/``burst_len_s``/``burst_x`` define periodic burst
    windows (rate multiplied by ``burst_x`` while
    ``t mod burst_every_s < burst_len_s``); ``burst_x=1`` or
    ``burst_every_s=None`` is plain Poisson."""

    def __init__(self, mixes: Sequence[TenantMix], *, seed: int = 0,
                 burst_every_s: Optional[float] = None,
                 burst_len_s: float = 0.0, burst_x: float = 1.0):
        if not mixes:
            raise ValueError("OpenLoopTraffic needs at least one TenantMix")
        names = [m.tenant for m in mixes]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate tenant names in mix: {names}")
        if burst_x < 1.0:
            raise ValueError(f"burst_x must be >= 1, got {burst_x}")
        self.mixes = tuple(mixes)
        self.seed = seed
        self.burst_every_s = burst_every_s
        self.burst_len_s = burst_len_s
        self.burst_x = burst_x

    # ------------------------------------------------------------- rates --
    def rate_at(self, mix: TenantMix, t: float) -> float:
        """Instantaneous arrival rate for ``mix`` at virtual time ``t``."""
        if self.burst_every_s and self.burst_x > 1.0 and \
                (t % self.burst_every_s) < self.burst_len_s:
            return mix.rate_rps * self.burst_x
        return mix.rate_rps

    def in_burst(self, t: float) -> bool:
        return bool(self.burst_every_s and self.burst_x > 1.0 and
                    (t % self.burst_every_s) < self.burst_len_s)

    # ---------------------------------------------------------- generate --
    def _tenant_arrivals(self, idx: int, mix: TenantMix,
                         horizon_s: float) -> List[tuple]:
        """Thinned inhomogeneous Poisson stream for one tenant: draw at
        the peak rate, keep each point with prob rate(t)/peak."""
        rng = np.random.default_rng([self.seed, idx])
        peak = mix.rate_rps * (self.burst_x if self.burst_every_s else 1.0)
        out, t = [], 0.0
        if peak <= 0.0:
            return out
        while True:
            t += float(rng.exponential(1.0 / peak))
            # the keep/payload draws happen for every candidate point, so
            # the substream consumed per candidate is fixed and thinning
            # never shifts later draws between runs
            keep = float(rng.random()) < self.rate_at(mix, t) / peak
            prompt = tuple(int(x) for x in rng.integers(
                3, mix.vocab, _draw(rng, mix.prompt_len)))
            max_new = _draw(rng, mix.max_new)
            if t >= horizon_s:
                break
            if keep:
                out.append((t, mix.tenant, prompt, max_new))
        return out

    def generate(self, horizon_s: float) -> List[Arrival]:
        """All arrivals in ``[0, horizon_s)``, merged across tenants and
        sorted by virtual time; ``gid`` is the global arrival order."""
        rows: List[tuple] = []
        for idx, mix in enumerate(self.mixes):
            rows.extend(self._tenant_arrivals(idx, mix, horizon_s))
        rows.sort(key=lambda r: (r[0], r[1]))
        return [Arrival(gid, t, tenant, prompt, max_new)
                for gid, (t, tenant, prompt, max_new) in enumerate(rows)]


__all__ = ["TenantMix", "Arrival", "OpenLoopTraffic"]
