"""The port's fleet-side launchers on the CPU (``--device cpu --smoke``)
against the reference's: ``launch.fleet`` live and from a registry gives
the reference's pool accounting and latency quantiles (virtual clock);
``launch.fanout`` at a pinned ``--jobs`` gives the reference's campaign
stats; ``launch.record --devices 2`` records, signs and publishes both
kinds through one campaign; ``launch.trace`` writes a Chrome trace whose
record attribution equals the reference's; ``launch.serve --streams``
serves each stream with the tokens it gets alone and with the
reference's multi-stream tokens on the same (carried) weights."""
import contextlib
import io
import json
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("msgpack")

import jax  # noqa: E402

import repro.api.workspace as JW  # noqa: E402
from repro.configs import smoke_shrink as jax_smoke_shrink  # noqa: E402
from repro.launch import fanout as jax_fanout  # noqa: E402
from repro.launch import fleet as jax_fleet  # noqa: E402
from repro.launch import record as jax_record  # noqa: E402
from repro.launch import serve as jax_serve  # noqa: E402
from repro.launch import trace as jax_trace  # noqa: E402
import repro_torch.api.workspace as W  # noqa: E402
from repro_torch.api import Workload, Workspace  # noqa: E402
from repro_torch.configs import get_config, smoke_shrink  # noqa: E402
from repro_torch.core.recording import Recording  # noqa: E402
from repro_torch.launch import fanout, fleet, record, serve, trace  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.obs import schema as S  # noqa: E402

KEY = "launch-fleet-key"


def _quiet(fn, argv):
    """``fn(argv)`` with its printing captured: (result, text)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(argv)
    return out, buf.getvalue()


def _strip(obj):
    """Every dict field whose key mentions ``wall`` or ``boot`` dropped:
    a registry replica's boot bills the fetched bytes, and a
    ``torch.export`` payload is not an XLA executable's size."""
    if isinstance(obj, dict):
        return {k: _strip(v) for k, v in obj.items()
                if "wall" not in k and "boot" not in k}
    if isinstance(obj, list):
        return [_strip(v) for v in obj]
    return obj


def _latencies(text):
    return re.findall(r"\] latency[^:]*: (\{.*\})", text)


FLEET = ["--tenants", "cody-mnist", "--replicas", "2", "--horizon", "0.6",
         "--rate", "12", "--cache-len", "32", "--block-k", "4", "--slots",
         "2"]


@pytest.mark.parametrize("policy", ["least_loaded", "cache_affinity"])
def test_fleet_launcher_live_equals_the_reference(policy):
    argv = FLEET + ["--policy", policy]
    (outs, pool), text = _quiet(fleet.main, argv + ["--smoke", "--device",
                                                    "cpu"])
    (jouts, jpool), jtext = _quiet(jax_fleet.main, argv)
    assert sorted(outs) == sorted(jouts) and not pool.failed
    assert pool.stats() == jpool.stats()
    assert _latencies(text) == _latencies(jtext) != []
    assert "link model output" in text and "virtual clock" in text
    S.check_fleet_stats(pool.stats())


def test_fleet_launcher_from_registry_equals_the_reference(tmp_path):
    """Both packages record cody-mnist into their own registry (the
    record launchers), then boot a two-region registry fleet from it:
    the pool's accounting is the reference's but for the boot's billed
    bytes, every replica boots on its own span, prompts are pinned to the
    recorded prefill length."""
    shape = ["--cache-len", "32", "--block-k", "4", "--batch", "2",
             "--seq", str(fleet.REC_SEQ), "--key", KEY, "--net", "wifi"]
    _quiet(record.main, ["--arch", "cody-mnist", "--smoke", "--device",
                         "cpu", "--out", str(tmp_path / "mine")] + shape)
    _quiet(jax_record.main, ["--arch", "cody-mnist", "--out",
                             str(tmp_path / "ref")] + shape)
    argv = FLEET + ["--policy", "round_robin", "--regions", "2", "--key",
                    KEY]
    (outs, pool), text = _quiet(fleet.main, argv + [
        "--smoke", "--device", "cpu", "--from-registry",
        str(tmp_path / "mine" / "registry")])
    (jouts, jpool), jtext = _quiet(jax_fleet.main, argv + [
        "--from-registry", str(tmp_path / "ref" / "registry")])
    assert sorted(outs) == sorted(jouts) and not pool.failed
    assert _strip(pool.stats()) == _strip(jpool.stats())
    assert _latencies(text) == _latencies(jtext) != []
    assert [r.region for r in pool.replicas] == [0, 1]
    assert all(r.boot_virtual_s > 0 for r in pool.replicas)
    assert len({id(r.netem) for r in pool.replicas}) == 2
    for r in pool.replicas:
        ex = r.scheduler.streams["cody-mnist-smoke"]
        assert ex.channel.fixed_prompt_len == fleet.REC_SEQ
        assert ex.channel.kind == "signed-replay"


def test_fanout_launcher_equals_the_reference_at_pinned_jobs():
    argv = ["--arch", "cody-mnist", "--devices", "2", "--seqs", "8,16",
            "--cache-len", "32", "--block-k", "4", "--batch", "2", "--jobs",
            "12", "--net", "wifi,cellular"]
    c, text = _quiet(fanout.main, argv + ["--smoke", "--device", "cpu"])
    jc, _ = _quiet(jax_fanout.main, argv)
    s = S.check_campaign_stats(c.stats())
    assert s == jc.stats()
    assert s["recorded"] == s["publishes"] == 3 and s["compiles"] == 3
    assert "makespan" in text and "emulated" in text


def test_record_launcher_fans_the_kinds_out_over_devices(tmp_path):
    out = tmp_path / "rec"
    done, text = _quiet(record.main, [
        "--arch", "cody-mnist", "--smoke", "--device", "cpu", "--out",
        str(out), "--key", KEY, "--cache-len", "32", "--block-k", "4",
        "--batch", "2", "--seq", "8", "--net", "wifi", "--devices", "2",
        "--jobs", "12"])
    assert sorted(done) == ["decode", "prefill"]
    assert "campaign[2 devices]" in text and "2 published" in text
    ws = Workspace(registry=str(out / "registry"), key=KEY.encode(),
                   device="cpu")
    wl = ws.workload("cody-mnist", cache_len=32, block_k=4, batch=2, seq=8)
    for kind, (path, rec) in done.items():
        assert os.path.exists(path)
        saved = Recording.load(path, KEY.encode())
        assert saved.payload == rec.payload
        assert saved.manifest["record_session"]["net"] == "wifi"
        assert saved.manifest["record_session"]["jobs"] == 12
        assert rec.manifest["name"] == wl.key(kind)
        assert ws.service.has(wl.key(kind))
    # the campaign's recordings serve from the registry
    eng = wl.engine()
    eng.submit([5, 6, 7, 8, 9, 10, 11, 12], 4)
    assert len(eng.run()[0]) == 4


def test_trace_launcher_attribution_equals_the_reference(tmp_path):
    argv = ["--arch", "cody-mnist", "--net", "wifi", "--jobs", "12",
            "--cache-len", "32", "--block-k", "4", "--seq", "8",
            "--strip-wall"]
    path = tmp_path / "trace.json"
    rc, text = _quiet(trace.main, argv + ["--smoke", "--device", "cpu",
                                          "--out", str(path)])
    _, jtext = _quiet(jax_trace.main,
                      argv + ["--out", str(tmp_path / "jax.json")])
    assert rc == 0
    doc = json.loads(path.read_text())
    names = {ev.get("name", "") for ev in doc["traceEvents"]}
    assert any(n.startswith("record.") for n in names), sorted(names)[:10]

    def attribution(t):
        return re.search(r"record attribution: .*", t).group(0)
    assert attribution(text) == attribution(jtext)
    assert "(100.0%)" in attribution(text)
    rec_line = [ln for ln in text.splitlines() if "blocking RTs" in ln]
    assert rec_line == [ln for ln in jtext.splitlines()
                        if "blocking RTs" in ln]


def test_serve_streams_equals_solo_and_the_reference(monkeypatch):
    """Both packages' ``serve --streams`` on fp32 smoke configs, the
    port's streams on the reference's weights: the reference's tokens
    per stream, and each stream's tokens served alone."""
    monkeypatch.setattr(JW, "smoke_shrink",
                        lambda c: jax_smoke_shrink(c, dtype="float32"))
    monkeypatch.setattr(W, "smoke_shrink",
                        lambda c: smoke_shrink(c, dtype="float32"))
    argv = ["--streams", "qwen2.5-3b,xlstm-350m", "--requests", "3",
            "--max-new", "8", "--slots", "2", "--cache-len", "64",
            "--block-k", "4"]
    (jouts, jsched), _ = _quiet(jax_serve.main, argv)
    jparams = {name: jax.tree.map(np.asarray, ex.params)
               for name, ex in jsched.streams.items()}

    def params(self, seed=0):
        if seed not in self._params:
            self._params[seed] = params_from_jax(
                self.cfg, jparams[self.cfg.name], device="cpu")
        return self._params[seed]
    monkeypatch.setattr(Workload, "params", params)
    (outs, sched), text = _quiet(serve.main, argv + ["--smoke", "--device",
                                                     "cpu"])
    assert outs == jouts and sorted(outs) == sorted(jparams)
    assert "served 2 streams x 3 requests" in text
    for arch in ("qwen2.5-3b", "xlstm-350m"):
        cfg = smoke_shrink(get_config(arch), dtype="float32")
        ex = sched.streams[cfg.name]
        assert dict(ex.stats) == dict(jsched.streams[cfg.name].stats)
        eng = serve.build_engine(cfg, n_slots=2, cache_len=64, block_k=4,
                                 device="cpu")
        rids = {rid: eng.submit(req.prompt, req.max_new)
                for rid, req in ex.requests.items()}
        solo = eng.run()
        assert {rid: solo[r] for rid, r in rids.items()} == outs[cfg.name]
    with pytest.raises(ValueError, match="one stream"):
        serve.main(argv + ["--smoke", "--device", "cpu", "--from-registry",
                           "somewhere"])
