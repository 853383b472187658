"""The traffic generator: the same seed draws the same requests at the same
times, and every seed the same work at the same rate in another order."""
from __future__ import annotations

import collections
import json
import math
from pathlib import Path

import pytest

from portbench import tiny
from portbench.traffic import Traffic, gap_levels, max_new_levels

BENCH = Path(__file__).resolve().parent
MIXES = sorted(p.stem for p in (BENCH / "traffic").glob("*.json"))


def _mix(name):
    return json.loads((BENCH / "traffic" / f"{name}.json").read_text())


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_requests(name):
    mix = _mix(name)
    a, b = Traffic(mix, 1000, 2**31 + 17), Traffic(mix, 1000, 2**31 + 17)
    for i in (0, 1, 63, 64, 500):
        assert a.request(i) == b.request(i)
        assert a.arrival(i) == b.arrival(i)
    c = Traffic(mix, 1000, 2**31 + 18)
    assert [c.prompt(i) for i in range(4)] != [a.prompt(i) for i in range(4)]
    assert [c.arrival(i) for i in range(8)] != [a.arrival(i) for i in range(8)]


@pytest.mark.parametrize("name", MIXES + ["tiny"])
def test_every_seed_draws_the_same_work(name):
    mix = tiny.MIX if name == "tiny" else _mix(name)
    lengths, gaps = max_new_levels(mix), gap_levels(mix)
    n, g = len(lengths), len(gaps)
    for seed in (0, 7, -3, 2**33 + 1):
        t = Traffic(mix, 50, seed)
        for block in range(3):
            drawn = [t.max_new(block * n + j) for j in range(n)]
            assert collections.Counter(drawn) == collections.Counter(lengths)
            # every run of `strata` arrivals spans the same time
            span = t.arrival((block + 1) * g) - t.arrival(block * g)
            assert math.isclose(span, sum(gaps), rel_tol=1e-9)


def test_the_levels_follow_their_distributions():
    mix = {"arrivals": {"rate": 4.0, "strata": 1000},
           "max_new": {"median": 129, "sigma": 1.0, "strata": 1001}}
    gaps = gap_levels(mix)
    # the exponential's quantiles: mean 1 / rate, median ln 2 / rate
    assert math.isclose(sum(gaps) / len(gaps), 0.25, rel_tol=0.01)
    assert math.isclose(sorted(gaps)[500], math.log(2) / 4, rel_tol=0.01)
    lengths = sorted(max_new_levels(mix))
    # the log-normal's: median 129, mean 129 * e^(1/2)
    assert lengths[500] == 129
    assert math.isclose(sum(lengths) / len(lengths), 129 * math.exp(0.5),
                        rel_tol=0.02)


@pytest.mark.parametrize("name", MIXES)
def test_prompts_fit_the_vocabulary_and_the_recorded_shape(name):
    mix = _mix(name)
    t = Traffic(mix, 151936, 5)
    p, max_new = t.request(3)
    assert len(p) == mix["prompt_len"] and 0 <= min(p) and max(p) < 151936
    # the longest request, and the blocks in flight behind it, fit the cache
    assert (mix["prompt_len"] + max(max_new_levels(mix))
            + (mix["pipeline_depth"] + 1) * mix["block_k"]) <= mix["cache_len"]
    assert "source" in mix and mix["arrivals"]["rate"] > 0
