"""One run of one cell: set-up, warm-up, the measured window, the
comparison with the reference, and the result line.

Everything a cell needs is found by name from ``BENCHMARK.json``: its
configuration file, ``traffic/<mix>.json``, ``limits/<cell>.json``, the
reference and the adapter of its ``model_type`` (``reference/<type>.py``,
``adapters/<type>.py``) and each metric's reader (``metrics/<metric>.py``).

The path a run drives is the port's serving of a signed recording: weights
made on the device from the seed (``weights.py``), the two recordings from
the cache or recorded once (``recordings.py``), ``Workload.channel``
verifying, loading and warming them (a ``ReplayChannel``), and
``Workload.engine`` over it with the mix's speculation and pipeline depth.
The window drives ``Engine.step_block`` and ``Engine.validate`` every
``pipeline_depth`` blocks, as ``Engine.run`` does, under the open loop of
the mix's arrivals (``Loop``)."""
from __future__ import annotations

import gc
import importlib.util
import json
import sys
import time
import types
from pathlib import Path

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.core.channel import ExecutionChannel

from portbench import check, recordings, tracing
from portbench.traffic import Traffic
from portbench.weights import Weights

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# a traced run measures at most this long: the profile of a window holds
# ~150,000 device operations a second, and reading them takes longer than
# running them
TRACE_SECONDS = 8.0


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def _plugin(path: Path):
    """A module of the benchmark's folder found by name, loaded from its
    file (metric names hold dots, so they are not import paths)."""
    if not path.exists():
        raise FileNotFoundError(f"the benchmark has no {path}")
    label = "portbench_plugin_" + "_".join(path.with_suffix("").parts[-2:])
    spec = importlib.util.spec_from_file_location(label.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def as_run(conf: dict) -> dict:
    """A configuration file as the port runs it: the published values, with
    each of the file's ``departures`` (a value the port forces) in place."""
    out = dict(conf)
    for key, dep in conf.get("departures", {}).items():
        out[key] = dep["value"]
    return out


class Bench:
    """``BENCHMARK.json`` at ``root`` and the folder of the benchmark's
    files (``root/<name of this package>``)."""

    def __init__(self, root: Path):
        self.root = Path(root)
        self.dir = self.root / Path(__file__).resolve().parent.name
        self.spec = load_json(self.root / "BENCHMARK.json")

    def _one(self, key: str, name: str) -> dict:
        found = [e for e in self.spec[key] if e["name"] == name]
        if len(found) != 1:
            raise KeyError(f"BENCHMARK.json has no {key} entry {name!r}")
        return found[0]

    def cell(self, name: str) -> dict:
        return self._one("workloads", name)

    def config(self, cell: dict) -> dict:
        return as_run(load_json(
            self.root / self._one("configs", cell["config"])["file"]))

    def traffic(self, cell: dict) -> dict:
        return load_json(self.dir / "traffic" / f"{cell['traffic']}.json")

    def limits(self, cell: dict) -> dict:
        return load_json(self.dir / "limits" / f"{cell['name']}.json")

    def reference(self, conf: dict):
        return _plugin(self.dir / "reference" / f"{conf['model_type']}.py")

    def adapter(self, conf: dict):
        return _plugin(self.dir / "adapters" / f"{conf['model_type']}.py")

    def metrics(self, cell: dict, per_layer: bool) -> list:
        key = "per_layer" if per_layer else "end_to_end"
        return [m for m in self.spec[key]
                if cell["name"] in m.get("workloads", [cell["name"]])]

    def reader(self, metric: dict):
        return _plugin(self.dir / "metrics" / f"{metric['name']}.py").read


def forbidden_modules() -> list:
    """Modules loaded in this process whose top-level name is JAX's, its
    libraries' or the JAX package's."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


class Channel(ExecutionChannel):
    """The replay channel as the engine sees it, with each call labelled
    for the profiler and what the cell drove noted: every prefill's prompt
    length, and every decode block's row positions at its first step (a
    block whose positions come from the host re-seeds them; a chained one
    is k steps on from the last, since no row ends on EOS)."""

    def __init__(self, inner, block_k: int):
        self.inner = inner
        self.kind = inner.kind
        self.k = block_k
        self.prefill_lens: list = []
        self.block_pos: list = []
        self._pos = None

    @property
    def fixed_prompt_len(self):
        return self.inner.fixed_prompt_len

    @property
    def supports_batched_prefill(self):
        return self.inner.supports_batched_prefill

    def prefill(self, params, batch):
        with record_function("portbench.prefill"):
            out = self.inner.prefill(params, batch)
        self.prefill_lens.append(int(np.shape(batch["tokens"])[1]))
        return out

    def decode_block(self, params, tokens, pos, caches):
        if isinstance(pos, np.ndarray):
            self._pos = pos.astype(np.int64)
        else:
            self._pos = self._pos + self.k
        self.block_pos.append(self._pos)
        with record_function("portbench.decode_block"):
            return self.inner.decode_block(params, tokens, pos, caches)


class Loop:
    """An open loop: request i of the traffic arrives ``traffic.arrival(i)``
    seconds after ``start``, whether or not earlier ones have finished, and
    is submitted at the first engine call after that; its first-token time
    counts from its arrival.  After each engine call, ``observe`` notes the
    slot that serves each request, stamps first tokens (the host has them
    once ``step_block`` returns) and retirements (``Request.finish_t``), and
    counts the tokens committed while ``counting``."""

    def __init__(self, eng, traffic: Traffic):
        self.eng = eng
        self.traffic = traffic
        self.origin = None
        self.next = 0
        self.live: dict = {}
        self.done: list = []
        self.counting = False
        self.tokens = 0
        self.decode_ctx: list = []

    def start(self, now: float) -> None:
        self.origin = now

    def next_arrival(self) -> float:
        return self.origin + self.traffic.arrival(self.next)

    def arrive(self, now: float) -> None:
        """Submit every request whose arrival has come."""
        while self.next_arrival() <= now:
            prompt, max_new = self.traffic.request(self.next)
            arrive = self.next_arrival()
            rid = self.eng.submit(prompt, max_new)
            self.live[rid] = {"prompt": prompt, "max_new": max_new,
                              "arrive": arrive, "slot": None, "first": None,
                              "finish": None, "seen": 0}
            self.next += 1

    def observe(self) -> float:
        now = time.time()
        reqs, slots = self.eng.requests, self.eng.slots
        for s in np.flatnonzero(~slots.done).tolist():
            r = self.live.get(int(slots.request_id[s]))
            if r is not None and r["slot"] is None:
                r["slot"] = s
        for rid in list(self.live):
            r, req = self.live[rid], reqs[rid]
            if r["first"] is None and req.generated:
                r["first"] = now
            n = len(req.generated) if req.done else req.committed
            if n > r["seen"]:
                if self.counting:
                    self.tokens += n - r["seen"]
                    P = len(r["prompt"])
                    # token j >= 1 came from a decode step over P + j keys
                    self.decode_ctx.extend(range(P + max(r["seen"], 1), P + n))
                r["seen"] = n
            if req.done:
                r.update(finish=req.finish_t, failed=req.failed,
                         served=list(req.generated))
                del self.live[rid]
                self.done.append(r)
        return now


class Driver:
    """Steps the engine as ``Engine.run`` does, the loop submitting what
    has arrived before and observing after every call, each call labelled
    for the profiler.  With nothing to serve it waits for the next
    arrival."""

    def __init__(self, eng, loop: Loop, depth: int):
        self.eng, self.loop, self.depth, self.blocks = eng, loop, depth, 0

    def step(self, deadline: float) -> float:
        self.loop.arrive(time.time())
        if not self.eng.stream.has_work():
            with record_function("portbench.wait"):
                time.sleep(max(0.0, min(self.loop.next_arrival(), deadline)
                               - time.time()))
            return time.time()
        with record_function("portbench.step_block"):
            self.eng.step_block()
        self.blocks += 1
        if self.blocks % self.depth == 0:
            with record_function("portbench.validate"):
                self.eng.validate()
        with record_function("portbench.client"):
            return self.loop.observe()

    def run_for(self, seconds: float):
        """Steps until ``seconds`` have passed -> (start, end) host times."""
        t0 = now = time.time()
        while now - t0 < seconds:
            now = self.step(t0 + seconds)
        return t0, now

    def window(self, seconds: float):
        """The measured window: ``run_for`` with the loop counting."""
        self.loop.counting = True
        with record_function("portbench.window"):
            t0, t1 = self.run_for(seconds)
        self.loop.counting = False
        return t0, t1


def p95(values) -> float:
    return float(np.percentile(np.asarray(values, dtype=np.float64), 95))


def p50(values) -> float:
    return float(np.percentile(np.asarray(values, dtype=np.float64), 50))


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Session:
    """A cell's set-up on one device: its files, the port's configuration,
    the weight buffers, the recordings (recorded once per cache key) and
    the booted replay channel.  ``serve`` draws the weights from a seed in
    place (the captured graph keeps reading them where they are) and
    serves the cell's traffic on a fresh engine over that channel."""

    def __init__(self, root, name: str, device="cuda"):
        from repro_torch.api import Workspace
        from repro_torch.core.recorder import topology_fingerprint
        from repro_torch.models import model as M

        self.bench = bench = Bench(root)
        self.cell = bench.cell(name)
        self.conf = bench.config(self.cell)
        self.mix = mix = bench.traffic(self.cell)
        self.limits = bench.limits(self.cell)
        self.ref = bench.reference(self.conf)
        self.dev = dev = torch.device(device)
        self.cfg = cfg = bench.adapter(self.conf).port_config(self.conf)
        self.weights = Weights(M.model_schema(cfg), cfg.dtype, dev)
        import repro_torch
        rec_dir = recordings.cache_dir(
            bench.dir, Path(repro_torch.__file__).resolve().parent, cfg, mix,
            topology_fingerprint(dev), torch.__version__)
        self.rec = recordings.ensure(rec_dir, bench.root, name, dev)
        self.ws = Workspace(key=recordings.SIGNING_KEY, device=dev)
        self.wl = self.ws.workload(
            cfg, cache_len=mix["cache_len"], block_k=mix["block_k"],
            batch=mix["slots"], prefill_batch=1, seq=mix["prompt_len"],
            eos_id=mix["eos_id"])
        tb = time.time()
        self.channel = Channel(self.wl.channel(recordings_dir=str(rec_dir)),
                               mix["block_k"])
        self.boot_s = time.time() - tb

    def serve(self, seed: int, seconds: float, trace: bool = False,
              t_start: float | None = None) -> types.SimpleNamespace:
        """Warm up on the seed's traffic, then measure ``seconds``; the
        engine is dropped before this returns."""
        mix, dev, ch = self.mix, self.dev, self.channel
        self.weights.fill(seed)
        eng = self.wl.engine(params=self.weights.tree, channel=ch,
                             speculate=mix["speculate"],
                             pipeline_depth=mix["pipeline_depth"])
        loop = Loop(eng, Traffic(mix, self.conf["vocab_size"], seed))
        drv = Driver(eng, loop, mix["pipeline_depth"])
        loop.start(time.time())
        drv.run_for(mix["warmup_s"])
        _sync(dev)
        ch.prefill_lens, ch.block_pos = [], []
        stats0 = dict(eng.stats)
        # what set-up left on the heap (loaded programs, a recording's
        # export) is not scanned again by the collector inside the window
        gc.collect()
        gc.freeze()
        setup_s = None if t_start is None else time.time() - t_start
        prof = None
        if trace:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if dev.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.__enter__()
        try:
            t0, t1 = drv.window(seconds)
        finally:
            if prof is not None:
                _sync(dev)
                prof.__exit__(None, None, None)
        t_sum = time.time()
        summary = tracing.summarize(prof) if prof is not None else None
        timing = {"profile_exit_s": t_sum - t1, "summarize_s": time.time() - t_sum}
        prof = None
        stats = {k: v - stats0.get(k, 0) for k, v in eng.stats.items()}
        mem_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        loop.eng = None
        del eng, drv
        gc.unfreeze()
        gc.collect()
        return types.SimpleNamespace(
            seed=seed, loop=loop, t0=t0, t1=t1, setup_s=setup_s,
            summary=summary, stats=stats, mem_peak=mem_peak, timing=timing,
            prefill_lens=list(ch.prefill_lens), block_pos=list(ch.block_pos))

    def finished(self, served) -> list:
        """The requests that finished in the window."""
        return [r for r in served.loop.done
                if served.t0 <= r["finish"] <= served.t1]

    def sample(self, served) -> list:
        """The requests the comparison reads: [(prompt, served tokens)]."""
        return check.sample([(r["prompt"], r["served"], r["slot"])
                             for r in self.finished(served) if not r["failed"]],
                            served.seed, self.limits["check_tokens"])

    def judge(self, picked: list, control: str | None = None) -> dict:
        """The comparison of ``picked`` with the reference: the served
        tokens' gaps, or with ``control`` those of the tokens that the
        control (``control.py``) puts first at the same positions."""
        choose = None
        if control is not None:
            from portbench import control as C
            choose = C.chooser(self, control)
        return check.compare(self.ref, self.weights.flat, self.conf, picked,
                             choose)

    def close_program(self) -> None:
        """Free the program's state (engine, replayer, graphs, caches)."""
        self.channel = self.wl = self.ws = None
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()


def latencies(sv, finished: list):
    """(first-token times, from arrival, of the requests whose first token
    came in the window; per-token times of the requests that retired in it
    with two tokens or more), seconds."""
    recs = sv.loop.done + list(sv.loop.live.values())
    ttft = [r["first"] - r["arrive"] for r in recs
            if r["first"] is not None and sv.t0 <= r["first"] <= sv.t1]
    tpot = [(r["finish"] - r["first"]) / (len(r["served"]) - 1)
            for r in finished if not r["failed"] and len(r["served"]) >= 2]
    return ttft, tpot


def run_cell(root, name: str, *, seed: int, seconds: float, trace: bool,
             device="cuda", t_start: float | None = None,
             control: str | None = None) -> dict:
    """One run of cell ``name``; returns the result line (a dict whose last
    key, ``checks``, holds every number compared with its limit).  With
    ``control`` (``"int8"``) the comparison judges the control in the
    program's place, at the cell's own size and limit: it has to come out
    not correct."""
    t_start = time.time() if t_start is None else t_start
    sess = Session(root, name, device)
    readers = {m["name"]: (m, sess.bench.reader(m))
               for m in sess.bench.metrics(sess.cell, per_layer=True)} if trace else {}
    sv = sess.serve(seed, min(seconds, TRACE_SECONDS) if trace else seconds,
                    trace, t_start)
    conf, mix, dev, loop, summary = sess.conf, sess.mix, sess.dev, sv.loop, sv.summary
    finished = sess.finished(sv)
    ttft, tpot = latencies(sv, finished)
    failed = sum(r["failed"] for r in finished)
    short = sum(len(r["served"]) != r["max_new"] for r in finished
                if not r["failed"])
    window_s = sv.t1 - sv.t0
    ctx = types.SimpleNamespace(
        conf=conf, shapes=sess.ref.shapes(conf), mix=mix, cell=sess.cell,
        window_s=window_s, tokens=loop.tokens, decode_ctx=loop.decode_ctx,
        prefill_lens=sv.prefill_lens, block_pos=sv.block_pos,
        stats=sv.stats, trace=summary, record_s=sum(sess.rec["record_s"]),
        boot_s=sess.boot_s, on_card=dev.type == "cuda")

    # the program's state goes before the reference runs
    sess.close_program()
    picked = sess.sample(sv)
    cmp = sess.judge(picked)
    if control is not None:
        cmp = dict(sess.judge(picked, control), program=cmp, control=control)
    checks = {
        "mean_gap": {"value": cmp["mean_gap"], "limit": sess.limits["mean_gap"]},
        "short_requests": {"value": short, "limit": 0},
        "failed_requests": {"value": failed, "limit": 0},
        "compared_tokens": {"value": cmp["tokens"], "limit": 1,
                            "at_least": True},
    }
    correct = all((c["value"] >= c["limit"]) if c.get("at_least")
                  else (c["value"] <= c["limit"]) for c in checks.values())

    if trace:
        metrics = {}
        for mname, (m, read) in readers.items():
            # a device's numbers come only from a run on the card
            if m["source"] == "device_trace" and not summary["kernels"]:
                continue
            v = read(ctx)
            if v is not None:
                metrics[mname] = {"value": float(v), "unit": m["unit"]}
    else:
        e2e = {"tokens_per_s": loop.tokens / window_s,
               "ttft_p95_ms": p95(ttft) * 1e3 if ttft else None,
               "tpot_p95_ms": p95(tpot) * 1e3 if tpot else None,
               "setup_s": sv.setup_s}
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in sess.bench.metrics(sess.cell, per_layer=False)
                   if e2e.get(m["name"]) is not None}
    device_info = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type,
        "count": 1, "memory_peak_bytes": int(sv.mem_peak)}
    result = {"correct": bool(correct), "attempted": len(finished),
              "failed": failed + short, "metrics": metrics,
              "device": device_info}
    if summary is not None:
        device_info.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
        result["breakdown"] = tracing.breakdown(summary)
    result["info"] = {
        "recorded": sess.rec["recorded"], "record_s": sess.rec["record_s"],
        "boot_s": sess.boot_s, "window_s": window_s,
        "requests_sent": loop.next, "unserved": len(loop.live),
        "ttft_n": len(ttft), "tpot_n": len(tpot),
        "ttft_median_ms": p50(ttft) * 1e3 if ttft else None,
        "stats": sv.stats, "compare": cmp, **sv.timing,
        "trace": None if summary is None else {
            k: summary[k] for k in ("by_span", "calls", "kernels",
                                    "launches_seen")}}
    result["checks"] = checks
    return result


def check_lines(result: dict) -> list:
    """Each number compared beside its limit, one per line."""
    out = []
    for name, c in result["checks"].items():
        rel = ">=" if c.get("at_least") else "<="
        out.append(f"check {name} {c['value']!r} {rel} {c['limit']!r}")
    out.append(f"correct {result['correct']}")
    return out
