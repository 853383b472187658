"""Serving launcher: one live stream behind the ``Engine`` facade.

Counterpart of the live single-stream path of ``repro/launch/serve.py``
(``Workload._live_channel`` + ``Workload.engine``).  It runs on the CUDA
device unless asked for the CPU:

    python -m repro_torch.launch.serve --arch qwen2.5-3b
    python -m repro_torch.launch.serve --arch cody-mnist --smoke --device cpu

Recorded (signed-replay) channels, registries and multi-stream serving
come with later slices of the port.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch import resolve_device
from repro_torch.configs import get_config, smoke_shrink
from repro_torch.core.channel import LiveChannel
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
                 pipeline_depth: int = 4, device="cuda") -> Engine:
    """One live stream on ``device``: the prefill, batched-prefill and
    fused-decode steps behind a ``LiveChannel``.  Without ``params`` the
    weights are drawn at random from seed 0 on the device."""
    device = resolve_device(device)
    if params is None:
        params = M.init_params(cfg, seed=0, device=device)
    prefill = ST.make_prefill_step(cfg, cache_len)
    decode = ST.make_fused_decode_step(cfg, k=block_k, eos_id=eos_id)
    # grouped right-padded admission: attention families only (decode
    # masks rows >= pos), and the SWA ring layout needs true lengths
    batched = None
    if cfg.family in ("dense", "moe") and not cfg.sliding_window:
        batched = ST.make_batched_prefill_step(cfg, cache_len)
    channel = LiveChannel(prefill, decode, batched)
    return Engine(params, channel=channel,
                  **stream_kwargs(cfg, n_slots=n_slots, cache_len=cache_len,
                                  block_k=block_k, eos_id=eos_id,
                                  speculate=speculate,
                                  pipeline_depth=pipeline_depth,
                                  device=device))


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
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_shrink(cfg)
    eng = build_engine(cfg, n_slots=args.slots, cache_len=args.cache_len,
                       block_k=args.block_k, device=args.device,
                       speculate=not args.no_speculate,
                       pipeline_depth=args.pipeline_depth)
    rng = np.random.default_rng(0)
    for _ in range(args.requests):
        plen = int(rng.integers(4, 16))
        eng.submit(list(rng.integers(3, cfg.vocab_size, plen)), args.max_new)
    t0 = time.time()
    outs = eng.run()
    dt = time.time() - t0
    toks = sum(len(v) for v in outs.values())
    print(f"served {len(outs)} requests, {toks} tokens in {dt:.2f}s "
          f"({toks/dt:.0f} tok/s) on {resolve_device(args.device)}")
    print("engine stats:", dict(eng.stats))
    print("speculator:", dict(eng.spec.stats))
    return outs, eng


if __name__ == "__main__":
    main()
