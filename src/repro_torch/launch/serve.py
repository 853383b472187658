"""Serving launcher: one stream behind the ``Engine`` facade, or several
through one ``Scheduler``, a thin shim over ``repro_torch.api``.

Counterpart of ``repro/launch/serve.py``: live steps; with
``--from-recordings``, the signed recordings of
``repro_torch.launch.record`` in a flat directory; with
``--from-registry``, recordings fetched from the content-addressed
registry (chunked, resumable, billed to the ``--net`` emulated link,
HMAC and transparency-log proof verified before ``torch.export.load``),
with collaborative record-on-miss under ``--record-on-miss``.  Replayed
recordings run through a ``ReplayChannel`` (the paper's in-TEE mode; on
the card the warmed programs replay as CUDA graphs).  ``--net`` also
bills the stream's commits, prefills and frontier drains, and
``build_engine(..., bill_dispatches=True)`` each step dispatch.  It runs
on the CUDA device unless asked for the CPU:

    python -m repro_torch.launch.serve --arch qwen2.5-3b
    python -m repro_torch.launch.serve --arch cody-mnist --smoke --device cpu
    python -m repro_torch.launch.serve --arch cody-mnist --smoke \\
        --device cpu --cache-len 32 --from-recordings recs --key secret
    python -m repro_torch.launch.serve --arch cody-mnist --smoke \\
        --device cpu --cache-len 32 --from-registry recs/registry \\
        --net wifi --key secret
    python -m repro_torch.launch.serve --streams qwen2.5-3b,xlstm-350m \\
        --smoke --device cpu --requests 4

``--streams`` serves the listed archs CONCURRENTLY through one
``Scheduler`` (multi-tenant: one live channel, params, slots and caches
per stream, stream ``i`` on seed ``i``'s weights).  Passing both
``--from-recordings`` and ``--from-registry`` is refused: recordings
come from exactly one source.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch import resolve_device
from repro_torch.api import Workspace, stream_kwargs
from repro_torch.configs import get_config, smoke_shrink
from repro_torch.core.channel import ReplayChannel
from repro_torch.core.netem import PROFILES, NetworkEmulator
from repro_torch.serving.engine import Engine

__all__ = ["REC_SEQ", "stream_kwargs", "build_engine", "build_scheduler",
           "serve_multi", "main"]

# registry prefill recordings are fetched at this prompt length; a
# published prefill of another length substitutes for it (the engine
# adapts admission via channel.fixed_prompt_len)
REC_SEQ = 16


def build_engine(cfg, *, n_slots: int, cache_len: int, block_k: int,
                 eos_id: int = 2, params=None, speculate: bool = True,
                 pipeline_depth: int = 4, device="cuda",
                 recordings_dir: str = "", registry_dir: str = "",
                 record_on_miss: bool = False, key: bytes = b"", netem=None,
                 bill_dispatches: bool = False) -> Engine:
    """One stream on ``device`` through ``Workload.engine``: live steps,
    the flat recordings of ``recordings_dir``, or the verified registry
    at ``registry_dir`` (both at once raise ``ValueError``).  ``netem``
    bills the engine's round trips and a registry's fetches;
    ``bill_dispatches`` wraps the channel in a ``NetemBilledChannel`` on
    the same emulator.  Without ``params`` the weights are drawn at
    random from seed 0 on the device."""
    ws = Workspace(registry=registry_dir or None, key=key, net=netem,
                   device=resolve_device(device))
    wl = ws.workload(cfg, cache_len=cache_len, block_k=block_k,
                     batch=n_slots, prefill_batch=1, seq=REC_SEQ,
                     eos_id=eos_id)
    return wl.engine(params=params, recordings_dir=recordings_dir,
                     record_on_miss=record_on_miss,
                     bill_dispatches=bill_dispatches, speculate=speculate,
                     pipeline_depth=pipeline_depth)


def build_scheduler(archs, *, n_slots: int, cache_len: int, block_k: int,
                    eos_id: int = 2, netem=None, speculate: bool = True,
                    pipeline_depth: int = 4, smoke: bool = False,
                    max_live_slots=None, stall_limit=None, seed: int = 0,
                    device="cuda"):
    """Multi-workload path: one Scheduler on ``device``, one stream per
    arch, each with its own live channel, params (seeded ``seed + i``),
    slots and caches.  Returns ``(scheduler, {name: workload})``: a
    workload's ``engine(seed=seed + i)`` serves its stream alone on the
    same weights."""
    ws = Workspace(net=netem, device=resolve_device(device))
    return ws.scheduler(archs, n_slots=n_slots, cache_len=cache_len,
                        block_k=block_k, eos_id=eos_id, smoke=smoke,
                        speculate=speculate, pipeline_depth=pipeline_depth,
                        max_live_slots=max_live_slots,
                        stall_limit=stall_limit, seed=seed)


def serve_multi(archs, *, requests: int, max_new: int,
                prompt_lens=(4, 16), **kw):
    """Submit ``requests`` prompts a stream (lengths drawn from
    ``[lo, hi)`` of ``prompt_lens``, tokens from seed 0 as the reference
    draws them) to ``build_scheduler(archs, **kw)`` and serve them all.
    Returns ``(outputs by stream, scheduler, workloads, wall seconds)``."""
    sched, wls = build_scheduler(archs, **kw)
    rng = np.random.default_rng(0)
    for name, wl in wls.items():
        for _ in range(requests):
            plen = int(rng.integers(*prompt_lens))
            sched.submit(name, [int(t) for t in rng.integers(
                3, wl.cfg.vocab_size, plen)], max_new)
    t0 = time.time()
    outs = sched.run()
    return outs, sched, wls, time.time() - t0


def _serve_multi(args, netem):
    archs = [a.strip() for a in args.streams.split(",") if a.strip()]
    outs, sched, wls, dt = serve_multi(
        archs, requests=args.requests, max_new=args.max_new,
        n_slots=args.slots, cache_len=args.cache_len, block_k=args.block_k,
        netem=netem, speculate=not args.no_speculate,
        pipeline_depth=args.pipeline_depth, smoke=args.smoke,
        device=args.device)
    toks = sum(len(v) for per in outs.values() for v in per.values())
    print(f"served {len(wls)} streams x {args.requests} requests, "
          f"{toks} tokens in {dt:.2f}s ({toks/dt:.0f} tok/s) on "
          f"{resolve_device(args.device)}")
    for name, ex in sched.streams.items():
        print(f"  [{name}] stats: {dict(ex.stats)}")
    print("frontier:", dict(sched.frontier.stats))
    print("speculator:", dict(sched.spec.stats))
    return outs, sched


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--streams", default="",
                    help="comma-separated archs to serve CONCURRENTLY "
                         "through one Scheduler (multi-tenant mode)")
    ap.add_argument("--smoke", action="store_true",
                    help="serve the reduced same-family config")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--block-k", type=int, default=8)
    ap.add_argument("--no-speculate", action="store_true")
    ap.add_argument("--pipeline-depth", type=int, default=4)
    ap.add_argument("--from-recordings", default="",
                    help="serve from the signed recordings in this "
                         "directory (repro_torch.launch.record)")
    ap.add_argument("--from-registry", default="",
                    help="registry root to fetch recordings from")
    ap.add_argument("--record-on-miss", action="store_true",
                    help="on registry miss, record through the service's "
                         "single-flight lease")
    ap.add_argument("--key", default="cody-demo-key")
    ap.add_argument("--net", default="none",
                    choices=["none"] + sorted(PROFILES),
                    help="emulated network profile the registry fetches "
                         "and the engine's round trips are billed to")
    args = ap.parse_args(argv)
    netem = None
    if args.net != "none":
        netem = NetworkEmulator(PROFILES[args.net])

    if args.streams:
        if args.from_recordings or args.from_registry:
            raise ValueError("--streams serves live steps; recordings "
                             "serve one stream (--arch)")
        return _serve_multi(args, netem)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_shrink(cfg)
    eng = build_engine(cfg, n_slots=args.slots, cache_len=args.cache_len,
                       block_k=args.block_k, device=args.device,
                       speculate=not args.no_speculate,
                       pipeline_depth=args.pipeline_depth,
                       recordings_dir=args.from_recordings,
                       registry_dir=args.from_registry,
                       record_on_miss=args.record_on_miss,
                       key=args.key.encode(), netem=netem)
    # registry boot traffic, snapshotted BEFORE the engine starts billing
    # its own commit round trips into the same emulated link
    registry_net = dict(netem.snapshot()) if netem is not None else None
    rng = np.random.default_rng(0)
    for _ in range(args.requests):
        plen = eng.fixed_prompt_len or int(rng.integers(4, 16))
        eng.submit(list(rng.integers(3, cfg.vocab_size, plen)), args.max_new)
    t0 = time.time()
    outs = eng.run()
    dt = time.time() - t0
    toks = sum(len(v) for v in outs.values())
    print(f"served {len(outs)} requests, {toks} tokens in {dt:.2f}s "
          f"({toks/dt:.0f} tok/s) on {resolve_device(args.device)} through "
          f"the {eng.channel.kind} channel")
    print("engine stats:", dict(eng.stats))
    print("speculator:", dict(eng.spec.stats))
    if isinstance(eng.channel, ReplayChannel):
        print("replayer:", dict(eng.channel.replayer.stats))
    if eng.registry_client is not None:
        print("registry client:", dict(eng.registry_client.stats))
        if registry_net is not None:
            print(f"registry net (boot, {netem.profile.name}, emulated):",
                  registry_net)
    if netem is not None:
        print(f"net ({netem.profile.name}, emulated):", netem.snapshot())
    return outs, eng


if __name__ == "__main__":
    main()
