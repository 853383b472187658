"""The harness driven end to end on the CPU at a tiny size (``tiny.py``):
the result line, an addition made by files alone, the faults that must
make ``correct`` false, and what the run leaves loaded.  The look for a
card is skipped: ``harness.run_cell`` is called on the CPU directly, where
the kernels take their plain versions and the replayer runs the recorded
programs eagerly."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from portbench import harness, tiny

ROOT = Path(__file__).resolve().parents[1]
QWEN = f"{tiny.QWEN2['name']}.{tiny.MIX['name']}"
DEEPSEEK = f"{tiny.DEEPSEEK_V2['name']}.{tiny.MIX['name']}"
SEED = 2**31 + 11


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    r = tmp_path_factory.mktemp("tinyroot")
    tiny.make(r)
    with tiny.one_thread():
        yield r


def run(root, cell, trace=False, seed=SEED):
    """One run whose window saw requests finish: on a loaded machine the
    window is lengthened until some do, so no verdict rests on none."""
    for seconds in (1.5, 6.0, 24.0):
        r = harness.run_cell(root, cell, seed=seed, seconds=seconds,
                             trace=trace, device="cpu")
        if r["attempted"] > 0:
            return r
    raise AssertionError(f"no request of {cell} finished in {seconds} s")


@pytest.mark.parametrize("cell", [QWEN, DEEPSEEK])
def test_a_run_is_correct_and_well_formed(root, cell):
    r = run(root, cell)
    assert r["correct"] is True, r["checks"]
    assert list(r)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(r)
    assert set(r["metrics"]) == {"tokens_per_s", "ttft_p95_ms", "tpot_p95_ms",
                                 "setup_s"}
    assert r["device"]["platform"] == "cpu" and r["attempted"] > 0
    assert r["checks"]["compared_tokens"]["value"] > 0
    lines = harness.check_lines(r)
    assert lines[-1] == "correct True" and lines[0].startswith("check mean_gap")


def test_a_traced_run_reports_per_layer_metrics_and_no_device_numbers(root):
    r = run(root, QWEN, trace=True)
    assert r["correct"] is True
    # on the CPU only the host's and the program's numbers are reported
    assert set(r["metrics"]) == {"record_s", "boot_s",
                                 "serve.host_syncs_per_block"}
    assert r["device"]["busy_s"] == 0 and r["breakdown"]["device_ops"] == []
    assert len(r["breakdown"]["idle_gaps"]) <= 10


def test_an_addition_by_files_alone(root, tmp_path):
    """A new configuration, traffic mix, cell and per-layer metric, made
    by adding files and entries only: the harness finds each by name."""
    r2 = tmp_path / "grown"
    shutil.copytree(root, r2, ignore=shutil.ignore_patterns(".cache"))
    bench = r2 / "portbench"
    spec = json.loads((r2 / "BENCHMARK.json").read_text())
    conf = dict(tiny.QWEN2, name="tiny-qwen2-wide", intermediate_size=192)
    (bench / "configs" / "tiny-qwen2-wide.json").write_text(json.dumps(conf))
    mix = dict(tiny.MIX, name="tinypair", slots=2,
               max_new={"median": 3, "sigma": 0.3, "strata": 4})
    (bench / "traffic" / "tinypair.json").write_text(json.dumps(mix))
    cell = "tiny-qwen2-wide.tinypair"
    (bench / "limits" / f"{cell}.json").write_text(
        json.dumps({"mean_gap": tiny.MEAN_GAP, "check_tokens": 12}))
    (bench / "metrics" / "serve.admitted.py").write_text(
        "def read(ctx):\n    return ctx.stats.get('admitted')\n")
    spec["configs"].append({"name": conf["name"], "source": "tiny",
                            "file": "portbench/configs/tiny-qwen2-wide.json",
                            "reduced": [], "why": "tiny"})
    spec["workloads"].append({"name": cell, "config": conf["name"],
                              "traffic": "tinypair", "chips": 1, "why": "tiny"})
    spec["per_layer"].append({"name": "serve.admitted", "unit": "requests",
                              "better": "higher", "source": "program_counter",
                              "layer": "serving", "moves": "tokens_per_s",
                              "workloads": [cell]})
    (r2 / "BENCHMARK.json").write_text(json.dumps(spec))
    r = run(r2, cell, trace=True)
    assert r["correct"] is True
    assert r["metrics"]["serve.admitted"]["value"] > 0


def _break(monkeypatch, fault):
    """Break the replayed decode block underneath the harness."""
    from repro_torch.core.channel import ReplayChannel
    from repro_torch.serving.cache import cache_leaves
    real = ReplayChannel.decode_block

    def broken(self, params, tokens, pos, caches):
        before = [c.clone() for c in cache_leaves(caches)]
        out, caches = real(self, params, tokens, pos, caches)
        t = out["tokens"].clone()
        if fault == "state_unchanged":
            for c, b in zip(cache_leaves(caches), before):
                c.copy_(b)
        elif fault == "half_batch_left_out":
            half = t.shape[0] // 2
            t[half:] = torch.as_tensor(tokens, device=t.device)[half:, None]
        elif fault == "token_altered":
            t[:, 0] = (t[:, 0] + 1) % tiny.QWEN2["vocab_size"]
        return dict(out, tokens=t), caches

    monkeypatch.setattr(ReplayChannel, "decode_block", broken)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch_left_out",
                                   "token_altered"])
def test_a_broken_path_is_not_correct(root, monkeypatch, fault):
    """Each fault a serving cell can have (one card: no exchange between
    cards to leave out) makes ``correct`` false."""
    _break(monkeypatch, fault)
    r = run(root, QWEN)
    assert r["checks"]["compared_tokens"]["value"] > 0
    assert r["correct"] is False, (fault, r["checks"])


def test_a_broken_prefill_is_not_correct(root, monkeypatch):
    from repro_torch.core.channel import ReplayChannel
    real = ReplayChannel.prefill

    def altered(self, params, batch):
        out, caches = real(self, params, batch)
        nxt = (out["next_tokens"] + 1) % tiny.QWEN2["vocab_size"]
        return dict(out, next_tokens=nxt), caches

    monkeypatch.setattr(ReplayChannel, "prefill", altered)
    r = run(root, QWEN)
    assert r["checks"]["compared_tokens"]["value"] > 0
    assert r["correct"] is False


def test_the_rehearsal_loads_no_jax(root):
    """In a process of its own (this one may hold the JAX package of other
    tests): a whole CPU run, then no module whose top-level name, compared
    whole, is jax, jaxlib, flax or repro."""
    code = (
        "import sys, json\n"
        f"sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "from portbench import harness\n"
        f"r = harness.run_cell({str(root)!r}, {QWEN!r}, seed=3, seconds=6.0,"
        " trace=False, device='cpu')\n"
        "print(json.dumps([r['correct'], harness.forbidden_modules(),"
        " sorted(m for m in sys.modules if m.split('.')[0] == 'repro_torch')[:3]]))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=root,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-3000:]
    correct, forbidden, port = json.loads(out.stdout.strip().splitlines()[-1])
    assert correct is True and forbidden == [] and port


def test_the_command_refuses_without_a_card_or_without_the_port(tmp_path):
    cmd = [sys.executable, str(ROOT / "portbench" / "run.py"), "--workload",
           "qwen2.5-3b-12l.chat", "--seed", "1", "--seconds", "1", "--trace", "0"]
    if not torch.cuda.is_available():
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                             cwd=ROOT)
        assert out.returncode != 0 and out.stdout == ""
    # a folder with BENCHMARK.json and the benchmark's files alone
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    cmd[1] = str(tmp_path / "portbench" / "run.py")
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                         cwd=tmp_path, env={"PATH": os.environ.get("PATH", "")})
    assert out.returncode != 0 and out.stdout == ""
