"""The control of ``correct`` at a size a CPU test holds: the port's own
int8 path (int8 weights; ``control.py``), put in the program's place, has
to fail the limit that the program's bf16 runs pass, read by the same
comparison that decides a run's ``correct``, and through a whole run.

At the sizes of ``tiny.py`` int8 rounding barely moves a logit, so this
cell is wider (hidden 512, vocabulary 4,096); its limit lies between the
program's readings and the control's at this size, as the cells' limits
do on the card (``limits/``, PERF.md).  A control's mean gap comes from a
few flipped tokens, so a reading holds 800 served tokens or more: on ten
seeds (9 s windows) the program read 0.00013-0.00031 and the control
0.00092-0.0021."""
from __future__ import annotations

import json

import pytest

from portbench import control, harness, tiny

CELL = "small-qwen2.tinylong"
LIMIT = 0.0006
SEEDS = [2**31 + 21, 2**31 + 22, 2**31 + 23]
TOKENS = 800
WINDOWS = (9.0, 27.0, 81.0)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("controlroot")
    spec = tiny.make(root)
    bench = root / "portbench"
    conf = dict(tiny.QWEN2, name="small-qwen2", hidden_size=512,
                intermediate_size=1024, vocab_size=4096)
    (bench / "configs" / "small-qwen2.json").write_text(json.dumps(conf))
    mix = dict(tiny.MIX, name="tinylong", cache_len=128,
               arrivals={"rate": 5.0, "strata": 4},
               max_new={"median": 40, "sigma": 0.3, "strata": 4})
    (bench / "traffic" / "tinylong.json").write_text(json.dumps(mix))
    (bench / "limits" / f"{CELL}.json").write_text(
        json.dumps({"mean_gap": LIMIT, "check_tokens": 900}))
    spec["configs"].append({"name": "small-qwen2", "source": "tiny",
                            "file": "portbench/configs/small-qwen2.json",
                            "reduced": [], "why": "tiny"})
    spec["workloads"].append({"name": CELL, "config": "small-qwen2",
                              "traffic": "tinylong", "chips": 1,
                              "why": "tiny"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    with tiny.one_thread():
        yield root


@pytest.fixture(scope="module")
def session(root):
    return harness.Session(root, CELL, "cpu")


def readings(session, seed: int) -> dict:
    """A seed's readings over at least ``TOKENS`` served tokens: on a
    loaded machine the window is lengthened until enough requests finish."""
    for seconds in WINDOWS:
        row = next(control.readings(session, [seed], {seed}, seconds))
        if row["tokens"] >= TOKENS:
            return row
    raise AssertionError(f"only {row['tokens']} tokens finished in {seconds} s")


@pytest.mark.parametrize("seed", SEEDS)
def test_the_int8_control_fails_the_limit_that_the_program_passes(session, seed):
    row = readings(session, seed)
    assert row["mean_gap"] <= LIMIT, row
    assert row["control"]["mean_gap"] > LIMIT, row


def test_the_control_in_a_run_is_not_correct(root):
    for seconds in WINDOWS:
        r = harness.run_cell(root, CELL, seed=SEEDS[0], seconds=seconds,
                             trace=False, device="cpu", control="int8")
        if r["info"]["compare"]["tokens"] >= TOKENS:
            break
    assert r["info"]["compare"]["program"]["mean_gap"] <= LIMIT, r["checks"]
    assert r["checks"]["mean_gap"]["value"] > LIMIT
    assert r["correct"] is False
