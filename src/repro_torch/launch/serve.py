"""Serving launcher: one stream behind the ``Engine`` facade, a thin shim
over ``repro_torch.api``.

Counterpart of the single-stream paths of ``repro/launch/serve.py``:
live steps; with ``--from-recordings``, the signed recordings of
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

Passing both ``--from-recordings`` and ``--from-registry`` is refused:
recordings come from exactly one source.  Multi-stream serving comes
with a later slice of the port.
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

__all__ = ["REC_SEQ", "stream_kwargs", "build_engine", "main"]

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


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
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
