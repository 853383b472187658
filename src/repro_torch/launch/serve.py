"""Serving launcher: one stream behind the ``Engine`` facade.

Counterpart of the single-stream paths of ``repro/launch/serve.py``
(``Workload.channel`` + ``Workload.engine``): live steps, or, with
``--from-recordings``, the signed recordings of ``repro_torch.launch.
record`` verified and replayed through a ``ReplayChannel`` (the paper's
in-TEE mode; on the card the decode block replays as a CUDA graph).
``--net`` bills the stream's commits, prefills and frontier drains to an
emulated link (``NetworkEmulator``), and ``build_engine(...,
bill_dispatches=True)`` also bills each step dispatch through a
``NetemBilledChannel``.  It runs on the CUDA device unless asked for the
CPU:

    python -m repro_torch.launch.serve --arch qwen2.5-3b
    python -m repro_torch.launch.serve --arch cody-mnist --smoke --device cpu
    python -m repro_torch.launch.serve --arch cody-mnist --smoke \
        --device cpu --cache-len 32 --from-recordings recs --key secret

Registries and multi-stream serving come with later slices of the port.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.api.workload import recording_name
from repro_torch.configs import get_config, smoke_shrink
from repro_torch.core.channel import (LiveChannel, NetemBilledChannel,
                                      ReplayChannel)
from repro_torch.core.netem import PROFILES, NetworkEmulator
from repro_torch.core.replay import Replayer
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.serving.engine import Engine, cache_batch_axes_for
from repro_torch.training import steps as ST

__all__ = ["stream_kwargs", "build_engine", "main"]


def stream_kwargs(cfg, *, n_slots: int, cache_len: int, block_k: int,
                  eos_id: int, speculate: bool = True,
                  pipeline_depth: int = 4, device="cuda") -> dict:
    """Per-stream policy for ``Scheduler.add_stream`` derived from the
    model family: recurrent state is not position-indexed, so dropped
    pipeline tails cannot be re-executed against an already-advanced
    state — metastate-only rollback is unsound there and speculation is
    forced off."""
    if cfg.family in ("ssm", "hybrid"):
        speculate = False
    return dict(n_slots=n_slots, cache_len=cache_len, block_k=block_k,
                eos_id=eos_id,
                init_caches_fn=lambda: M.init_cache(cfg, n_slots, cache_len,
                                                    device=device),
                cache_batch_axes=cache_batch_axes_for(cfg),
                speculate=speculate, pipeline_depth=pipeline_depth)


def build_engine(cfg, *, n_slots: int, cache_len: int, block_k: int,
                 eos_id: int = 2, params=None, speculate: bool = True,
                 pipeline_depth: int = 4, device="cuda",
                 recordings_dir: str = "", key: bytes = b"", netem=None,
                 bill_dispatches: bool = False) -> Engine:
    """One stream on ``device``.  Live: the prefill, batched-prefill and
    fused-decode steps behind a ``LiveChannel``.  With ``recordings_dir``:
    its prefill and decode recordings, verified and loaded through one
    ``Replayer``, behind a ``ReplayChannel``, fed the params as the tree
    the recorded steps take; the decode variant is warmed (on the card:
    captured as a CUDA graph at its first block).  ``netem`` bills the
    engine's round trips; ``bill_dispatches`` wraps the channel in a
    ``NetemBilledChannel`` on the same emulator.  Without ``params`` the
    weights are drawn at random from seed 0 on the device."""
    device = resolve_device(device)
    if params is None:
        params = M.init_params(cfg, seed=0, device=device)
    kwargs = stream_kwargs(cfg, n_slots=n_slots, cache_len=cache_len,
                           block_k=block_k, eos_id=eos_id,
                           speculate=speculate,
                           pipeline_depth=pipeline_depth, device=device)
    kwargs["netem"] = netem

    def billed(channel):
        return NetemBilledChannel(channel, netem) if bill_dispatches \
            else channel

    if recordings_dir:
        rp = Replayer(key=key, device=device)
        pre, dec = (rp.load(os.path.join(recordings_dir,
                                         recording_name(cfg.name, kind)))
                    for kind in ("prefill", "decode"))
        rp.warm(dec)    # decode joins the pipeline with no cold start
        channel = ReplayChannel(rp, pre, dec)
        tree = L.to_tree(params) if isinstance(params, torch.nn.Module) \
            else params
        return Engine(tree, channel=billed(channel), **kwargs)
    prefill = ST.make_prefill_step(cfg, cache_len)
    decode = ST.make_fused_decode_step(cfg, k=block_k, eos_id=eos_id)
    # grouped right-padded admission: attention families only (decode
    # masks rows >= pos), and the SWA ring layout needs true lengths
    batched = None
    if cfg.family in ("dense", "moe") and not cfg.sliding_window:
        batched = ST.make_batched_prefill_step(cfg, cache_len)
    channel = LiveChannel(prefill, decode, batched)
    return Engine(params, channel=billed(channel), **kwargs)


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
    ap.add_argument("--key", default="cody-demo-key")
    ap.add_argument("--net", default="none",
                    choices=["none"] + sorted(PROFILES),
                    help="emulated network profile the engine's round "
                         "trips are billed to")
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
                       key=args.key.encode(), netem=netem)
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
    if netem is not None:
        print(f"net ({netem.profile.name}, emulated):", netem.snapshot())
    return outs, eng


if __name__ == "__main__":
    main()
