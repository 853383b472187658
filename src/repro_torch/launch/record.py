"""Record launcher: CODY's "cloud dryrun service", a thin shim over
``repro_torch.api``.

Counterpart of ``repro/launch/record.py``.  Each kind is recorded by
``Workload.record``: a distributed ``RecordingSession`` (device proxy +
cloud dryrun over the ``--net`` emulated link, the record optimizations
selected by ``--passes``; one fresh session per recording) whose dryrun
exports the step through ``compile_artifact`` (the params as inputs: a
recording carries no weights).  The recording is named by its registry
key (``registry.key_for``, the key ``serve --from-registry`` fetches
by), signed with ``--key``, written to ``--out`` as
``recording_name(arch, kind)``, and published (delta-published, logged
in the transparency log) into the content-addressed registry at
``--registry`` (default ``<out>/registry``; ``--no-registry`` writes the
flat files only); the session report is printed: virtual record time,
blocking/async round trips, wire bytes.  It records on the CUDA device
unless asked for the CPU, and a recording replays only on the device
type it was made on:

    python -m repro_torch.launch.record --arch qwen2.5-3b --out recs \\
        --key secret --cache-len 1024 --batch 4 --seq 128 \\
        --net wifi --passes all
    python -m repro_torch.launch.record --arch cody-mnist --smoke \\
        --device cpu --out recs --key secret --cache-len 32 --seq 8

``--batch`` is the decode batch, the serving slots of ``serve --slots``;
prefill is recorded at batch 1, as the engine admits one request per
prefill.  The ``--devices`` fan-out comes with the port's ``fanout``
launcher.
"""
from __future__ import annotations

import argparse
import os

from repro_torch.api import (KINDS, Workspace, format_session_report,
                             recording_name)
from repro_torch.configs import get_config, smoke_shrink
from repro_torch.core.netem import PROFILES

__all__ = ["record_kinds", "main"]


def record_kinds(cfg, kinds=KINDS, *, out: str, key: bytes, cache_len: int,
                 block_k: int, batch: int, seq: int, eos_id: int = 2,
                 params=None, device="cuda", net: str = "local",
                 passes="all", jobs=None) -> dict:
    """Record, sign and save each kind into ``out``; returns {kind: (path,
    Recording)}.  Each kind runs through ``Workload.record``: its own
    ``RecordingSession`` over ``PROFILES[net]`` with ``passes`` (``jobs``
    pins the GPU job count), whose report lands in the manifest
    (``record_session``).  ``params`` (a ParamTree or its tree) serve as
    the example inputs of the export where given, else zeros do: only
    their shapes and dtypes enter the recording."""
    ws = Workspace(key=key, net=net, record_passes=passes, device=device)
    wl = ws.workload(cfg, cache_len=cache_len, block_k=block_k, batch=batch,
                     prefill_batch=1, seq=seq, eos_id=eos_id)
    os.makedirs(out, exist_ok=True)
    done = {}
    for kind in kinds:
        rec = wl.record(kind, jobs=jobs, params=params)
        path = os.path.join(out, recording_name(cfg.name, kind))
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
    ap.add_argument("--registry", default=None,
                    help="registry root (default: <out>/registry)")
    ap.add_argument("--no-registry", action="store_true",
                    help="skip registry publishing (flat files only)")
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
    wl = None
    if not args.no_registry:
        ws = Workspace(registry=args.registry or
                       os.path.join(args.out, "registry"),
                       key=args.key.encode(), device=args.device)
        wl = ws.workload(cfg, cache_len=args.cache_len,
                         block_k=args.block_k, batch=args.batch,
                         prefill_batch=1, seq=args.seq)
    for kind, (path, rec) in done.items():
        line = (f"recorded {kind}: {path} ({len(rec.payload)/1e6:.2f} MB "
                f"program, {rec.manifest['record_wall_s']:.1f}s record time)")
        if wl is not None:
            pub = wl.publish(rec)
            line += (f"; published {pub['key']} v{pub['version']} "
                     f"({pub['wire_bytes']/1e3:.1f} kB wire, "
                     f"{pub['chunks_new']} new / "
                     f"{pub['chunks_reused']} reused chunks)")
        print(line)
        print("  " + format_session_report(rec.manifest["record_session"]))
    return done


if __name__ == "__main__":
    main()
