"""The one traffic generator: a mix's data file (``traffic/<mix>.json``)
and a seed give every request of a run, and when it arrives.

The loop is open: request i arrives at a time fixed by the schedule,
whether or not earlier ones have finished.  Gaps between arrivals follow an
exponential distribution of the mix's ``rate`` (Poisson arrivals), and
``max_new`` a log-normal of the mix's ``median`` and ``sigma``.  Each
distribution is cut into ``strata`` equal-probability strata, each stood
for by its quantile at the stratum's midpoint, and each run of ``strata``
consecutive requests takes every quantile once, in an order drawn from the
seed.  So every seed asks for the same work at the same mean rate, in
another order, however many requests a window takes.
A prompt is ``prompt_len`` tokens drawn uniformly from the vocabulary."""
from __future__ import annotations

import math
from statistics import NormalDist

import numpy as np

_MASK = (1 << 64) - 1


def _midpoints(n: int) -> list:
    return [(2 * i + 1) / (2 * n) for i in range(n)]


def gap_levels(mix: dict) -> list:
    """The exponential gaps' quantiles, seconds."""
    a = mix["arrivals"]
    return [-math.log1p(-u) / a["rate"] for u in _midpoints(a["strata"])]


def max_new_levels(mix: dict) -> list:
    """The log-normal output lengths' quantiles, tokens."""
    m = mix["max_new"]
    z = NormalDist()
    return [max(1, round(m["median"] * math.exp(m["sigma"] * z.inv_cdf(u))))
            for u in _midpoints(m["strata"])]


class Traffic:
    def __init__(self, mix: dict, vocab: int, seed: int):
        self.mix = mix
        self.vocab = vocab
        self.seed = seed & _MASK          # any whole number, negative too
        self.gaps = gap_levels(mix)
        self.lengths = max_new_levels(mix)
        self._orders = {}
        self._arrivals = [0.0]

    def _stratum(self, levels: list, stream: int, i: int):
        n = len(levels)
        key = (stream, i // n)
        if key not in self._orders:
            self._orders[key] = np.random.default_rng(
                [self.seed, i // n, stream]).permutation(n)
        return levels[int(self._orders[key][i % n])]

    def max_new(self, i: int) -> int:
        return self._stratum(self.lengths, 1, i)

    def arrival(self, i: int) -> float:
        """Seconds from the schedule's start to request i's arrival."""
        while len(self._arrivals) <= i:
            j = len(self._arrivals)
            self._arrivals.append(self._arrivals[-1]
                                  + self._stratum(self.gaps, 2, j - 1))
        return self._arrivals[i]

    def prompt(self, i: int) -> list:
        rng = np.random.default_rng([self.seed, i, 0])
        return rng.integers(0, self.vocab, self.mix["prompt_len"]).tolist()

    def request(self, i: int):
        """(prompt tokens, max_new) of request i."""
        return self.prompt(i), self.max_new(i)
