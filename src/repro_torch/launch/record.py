"""Record launcher: CODY's "cloud dryrun service" on the flat-file path.

Counterpart of the flat-file path of ``repro/launch/record.py``.  Each
kind is recorded as a distributed ``RecordingSession`` (device proxy +
cloud dryrun over the ``--net`` emulated link, the record optimizations
selected by ``--passes``; one fresh session per recording) whose dryrun
exports the step through ``compile_artifact`` (the params as inputs: a
recording carries no weights); the recording is signed with ``--key``
and written to ``--out`` as ``recording_name(arch, kind)``, and the
session report printed: virtual record time, blocking/async round trips,
wire bytes.  It records on the CUDA device unless asked for the CPU, and
a recording replays only on the device type it was made on:

    python -m repro_torch.launch.record --arch qwen2.5-3b --out recs \\
        --key secret --cache-len 1024 --batch 4 --seq 128 \\
        --net wifi --passes all
    python -m repro_torch.launch.record --arch cody-mnist --smoke \\
        --device cpu --out recs --key secret --cache-len 32 --seq 8

``--batch`` is the decode batch, the serving slots of ``serve --slots``;
prefill is recorded at batch 1, as the engine admits one request per
prefill.  The registry and the ``--devices`` fan-out come with later
slices of the port.
"""
from __future__ import annotations

import argparse
import os

from repro_torch import resolve_device
from repro_torch.api.workload import (KINDS, build_step,
                                      format_session_report, recording_name,
                                      static_meta_for)
from repro_torch.configs import get_config, smoke_shrink
from repro_torch.core.netem import PROFILES
from repro_torch.core.recorder import record
from repro_torch.record import CloudDryrun, RecordingSession

__all__ = ["record_kinds", "main"]


def record_kinds(cfg, kinds=KINDS, *, out: str, key: bytes, cache_len: int,
                 block_k: int, batch: int, seq: int, eos_id: int = 2,
                 params=None, device="cuda", net: str = "local",
                 passes="all", jobs=None) -> dict:
    """Record, sign and save each kind into ``out``; returns {kind: (path,
    Recording)}.  Each kind runs through its own ``RecordingSession`` over
    ``PROFILES[net]`` with ``passes`` (``jobs`` pins the GPU job count),
    whose report lands in the manifest (``record_session``).  ``params``
    (a ParamTree or its tree) serve as the example inputs of the export
    where given, else zeros do: only their shapes and dtypes enter the
    recording."""
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
        # one two-party session per recording: fresh device proxy, fresh
        # speculation history, per-recording report
        session = RecordingSession.for_profile(
            PROFILES[net], passes=passes,
            cloud=CloudDryrun(jobs=jobs) if jobs is not None else None)
        rec = record(fname.removesuffix(".codyrec"), fn, args,
                     donate_argnums=donate,
                     config_fingerprint=cfg.fingerprint(),
                     static_meta=static, session=session)
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
    ap.add_argument("--net", default="local", choices=sorted(PROFILES),
                    help="emulated device<->cloud link the recording "
                         "session runs over")
    ap.add_argument("--passes", default="all",
                    help="comma list of record-session optimization passes "
                         "(deferral,speculation,metasync) | all | none")
    ap.add_argument("--jobs", type=int, default=None,
                    help="pin the session's GPU job count (default: from "
                         "the program's size)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_shrink(cfg)
    kinds = [k.strip() for k in args.kinds.split(",") if k.strip()]
    done = record_kinds(cfg, kinds, out=args.out, key=args.key.encode(),
                        cache_len=args.cache_len, block_k=args.block_k,
                        batch=args.batch, seq=args.seq, device=args.device,
                        net=args.net, passes=args.passes, jobs=args.jobs)
    for kind, (path, rec) in done.items():
        print(f"recorded {kind}: {path} ({len(rec.payload)/1e6:.2f} MB "
              f"program, {rec.manifest['record_wall_s']:.1f}s record time)")
        print("  " + format_session_report(rec.manifest["record_session"]))
    return done


if __name__ == "__main__":
    main()
