"""Record launcher: CODY's "cloud dryrun service" on the flat-file path.

Counterpart of the flat-file path of ``repro/launch/record.py``.  Each
kind's step is exported through ``compile_artifact`` (the params as
inputs: a recording carries no weights), signed with ``--key`` and
written to ``--out`` as ``recording_name(arch, kind)``.  It records on
the CUDA device unless asked for the CPU, and a recording replays only
on the device type it was made on:

    python -m repro_torch.launch.record --arch qwen2.5-3b --out recs \\
        --key secret --cache-len 1024 --batch 4 --seq 128
    python -m repro_torch.launch.record --arch cody-mnist --smoke \\
        --device cpu --out recs --key secret --cache-len 32 --seq 8

``--batch`` is the decode batch, the serving slots of ``serve --slots``;
prefill is recorded at batch 1, as the engine admits one request per
prefill.  The registry, the recording session and device fan-out come
with later slices of the port.
"""
from __future__ import annotations

import argparse
import os

from repro_torch import resolve_device
from repro_torch.api.workload import (KINDS, build_step, recording_name,
                                      static_meta_for)
from repro_torch.configs import get_config, smoke_shrink
from repro_torch.core.recorder import compile_artifact

__all__ = ["record_kinds", "main"]


def record_kinds(cfg, kinds=KINDS, *, out: str, key: bytes, cache_len: int,
                 block_k: int, batch: int, seq: int, eos_id: int = 2,
                 params=None, device="cuda") -> dict:
    """Record, sign and save each kind into ``out``; returns {kind: (path,
    Recording)}.  ``params`` (a ParamTree or its tree) serve as the
    example inputs of the export where given, else zeros do: only their
    shapes and dtypes enter the recording."""
    device = resolve_device(device)
    os.makedirs(out, exist_ok=True)
    done = {}
    for kind in kinds:
        b = 1 if kind == "prefill" else batch
        static = static_meta_for(kind, cache_len=cache_len, block_k=block_k,
                                 batch=b, seq=seq, eos_id=eos_id)
        fn, args, donate = build_step(cfg, kind, cache_len=cache_len,
                                      block_k=block_k, batch=b, seq=seq,
                                      eos_id=eos_id, params=params,
                                      device=device)
        fname = recording_name(cfg.name, kind)
        rec = compile_artifact(fname.removesuffix(".codyrec"), fn, args,
                               donate_argnums=donate,
                               config_fingerprint=cfg.fingerprint(),
                               static_meta=static)
        path = os.path.join(out, fname)
        rec.save(path, key)
        done[kind] = (path, rec)
    return done


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--smoke", action="store_true",
                    help="record the reduced same-family config")
    ap.add_argument("--kinds", default="prefill,decode")
    ap.add_argument("--out", required=True)
    ap.add_argument("--key", default="cody-demo-key")
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--block-k", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4,
                    help="decode batch = number of serving slots (match "
                         "serve --slots)")
    ap.add_argument("--seq", type=int, default=32,
                    help="the prefill prompt length served from the "
                         "recording")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_shrink(cfg)
    kinds = [k.strip() for k in args.kinds.split(",") if k.strip()]
    done = record_kinds(cfg, kinds, out=args.out, key=args.key.encode(),
                        cache_len=args.cache_len, block_k=args.block_k,
                        batch=args.batch, seq=args.seq, device=args.device)
    for kind, (path, rec) in done.items():
        print(f"recorded {kind}: {path} ({len(rec.payload)/1e6:.2f} MB "
              f"program, {rec.manifest['record_wall_s']:.1f}s record time)")
    return done


if __name__ == "__main__":
    main()
