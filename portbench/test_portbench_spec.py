"""BENCHMARK.json against the benchmark's contract, and every piece it
names found as a file of its own."""
from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
BENCH = Path(__file__).resolve().parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")
LINE = re.compile(r"[^\t\n]{1,200}")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_command_and_paths_stay_inside():
    assert 1 <= len(SPEC["paths"]) <= 16
    for p in SPEC["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p)
        assert (ROOT / p).is_dir() and not p.startswith("/") and ".." not in p
    assert len(SPEC["command"]) <= 32
    for word in SPEC["command"]:
        assert LINE.fullmatch(word) and not word.startswith("/") and ".." not in word
        if "/" in word:
            assert any(word.startswith(p + "/") for p in SPEC["paths"])


@pytest.mark.parametrize("entry", SPEC["configs"] + SPEC["workloads"] + METRICS,
                         ids=lambda e: e["name"])
def test_names_and_lines(entry):
    assert NAME.fullmatch(entry["name"])
    for key in ("why", "layer", "source"):
        if key in entry:
            assert LINE.fullmatch(entry[key])
    if "unit" in entry:
        assert UNIT.fullmatch(entry["unit"])
        assert entry["better"] in ("lower", "higher")


def test_names_are_unique():
    for group in (SPEC["configs"], SPEC["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))


@pytest.mark.parametrize("conf", SPEC["configs"], ids=lambda c: c["name"])
def test_config_file(conf):
    assert set(conf) == {"name", "source", "file", "reduced", "why"}
    assert any(conf["file"].startswith(p + "/") for p in SPEC["paths"])
    body = json.loads((ROOT / conf["file"]).read_text())
    assert body["name"] == conf["name"] and body["source"] == conf["source"]
    # every key changed from the source is in `reduced`, with its reason
    assert sorted(conf["reduced"]) == sorted(body["reduced"])
    for key in conf["reduced"]:
        assert NAME.fullmatch(key)
    assert any(c["config"] == conf["name"] for c in SPEC["workloads"])


CONFIG_FILES = sorted((BENCH / "configs").glob("*.json"))


@pytest.mark.parametrize("path", CONFIG_FILES, ids=lambda p: p.stem)
def test_config_files_state_their_cuts_and_departures(path):
    """A file holds the published values; `reduced` cuts only depth, never a
    width; what the port forces (`departures`) is kept apart, each with the
    place in the port that forces it."""
    body = json.loads(path.read_text())
    assert body["name"] == path.stem
    assert sorted(body["published"]) == sorted(body["reduced"])
    for key in body["reduced"]:
        assert body[key] != body["published"][key]
        assert not key.endswith(("_dim", "_rank", "_size")), key
    for key, dep in body.get("departures", {}).items():
        assert key not in body["reduced"] and set(dep) == {"value", "why"}
        assert dep["value"] != body[key] and "src/repro_torch/" in dep["why"]


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda c: c["name"])
def test_cell_finds_its_files(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] == 1
    assert NAME.fullmatch(cell["traffic"])
    conf = next(c for c in SPEC["configs"] if c["name"] == cell["config"])
    model_type = json.loads((ROOT / conf["file"]).read_text())["model_type"]
    for f in (f"traffic/{cell['traffic']}.json", f"limits/{cell['name']}.json",
              f"reference/{model_type}.py", f"adapters/{model_type}.py"):
        assert (BENCH / f).is_file(), f
    limits = json.loads((BENCH / "limits" / f"{cell['name']}.json").read_text())
    assert limits["mean_gap"] > 0 and limits["check_tokens"] > 0


def test_pairs_appear_once():
    pairs = [(c["config"], c["traffic"]) for c in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))


def _reports(cell: str, metric: dict) -> bool:
    return cell in metric.get("workloads", [cell])


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_entry(metric):
    allowed = {"name", "unit", "better", "source", "workloads"}
    if metric in SPEC["end_to_end"]:
        assert set(metric) <= allowed | {"bound"}
        assert metric["source"] in ("host_clock", "device_trace")
        cap = 0.25
        assert 0.01 <= metric["bound"] <= cap
    else:
        assert set(metric) <= allowed | {"layer", "moves"}
        assert metric["source"] in SOURCES
        assert (BENCH / "metrics" / f"{metric['name']}.py").is_file()
    cells = {c["name"] for c in SPEC["workloads"]}
    assert set(metric.get("workloads", [])) <= cells


@pytest.mark.parametrize("metric", SPEC["per_layer"], ids=lambda m: m["name"])
def test_moves_an_end_to_end_metric_its_cells_report(metric):
    moved = next(m for m in SPEC["end_to_end"] if m["name"] == metric["moves"])
    for cell in SPEC["workloads"]:
        if _reports(cell["name"], metric):
            assert _reports(cell["name"], moved), cell["name"]


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda c: c["name"])
def test_every_cell_reports_enough(cell):
    e2e = [m["name"] for m in SPEC["end_to_end"] if _reports(cell["name"], m)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(_reports(cell["name"], m) for m in SPEC["per_layer"])


def test_rooflines_and_mfu_are_shares():
    for m in SPEC["per_layer"]:
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%" and m["better"] == "higher"


def test_a_layer_has_one_spelling():
    layers = {m["layer"] for m in SPEC["per_layer"]}
    assert len({x.lower() for x in layers}) == len(layers)
