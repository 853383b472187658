"""Trace a record -> publish -> fetch -> replay lifecycle and dump the
virtual-time timeline.

Counterpart of ``repro/launch/trace.py``:

    python -m repro_torch.launch.trace --arch cody-mnist --smoke \\
        --device cpu --net wifi --out trace.json

Runs one workload through the lifecycle under ``Workspace(trace=True)``
(record through a ``RecordingSession`` over the ``--net`` emulated link,
publish, a verified fetch, the priced replay-plan execution) and writes
a Chrome trace-event / Perfetto-loadable JSON file, then prints the top
spans by virtual time and the attribution check: how much of the record
session's billed virtual time is covered by named spans.  Every span
time is the link model's virtual clock, not a measured time.  The
export runs on the CUDA device unless asked for the CPU.
"""
from __future__ import annotations

import argparse

from repro_torch import resolve_device
from repro_torch.api import Workspace
from repro_torch.core.netem import PROFILES

__all__ = ["main"]


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="trace one record/publish/fetch/replay lifecycle on "
                    "the deterministic virtual clock")
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--smoke", action="store_true",
                    help="trace the reduced same-family config")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--net", default="wifi", choices=sorted(PROFILES))
    ap.add_argument("--passes", default="all",
                    help="record-session pass stack "
                         "(deferral,speculation,metasync | all | none)")
    ap.add_argument("--jobs", type=int, default=16,
                    help="interaction-plan jobs in the record session")
    ap.add_argument("--cache-len", type=int, default=64)
    ap.add_argument("--block-k", type=int, default=8)
    ap.add_argument("--seq", type=int, default=16)
    ap.add_argument("--key", default="cody-demo-key")
    ap.add_argument("--out", default="trace.json",
                    help="Chrome trace-event JSON output path")
    ap.add_argument("--top", type=int, default=15,
                    help="rows in the printed span summary")
    ap.add_argument("--strip-wall", action="store_true",
                    help="drop wall timestamps from the export (the "
                         "deterministic, byte-reproducible form)")
    args = ap.parse_args(argv)

    ws = Workspace(registry=":memory:", key=args.key.encode(),
                   net=args.net, record_passes=args.passes, trace=True,
                   device=resolve_device(args.device))
    wl = ws.workload(args.arch, smoke=args.smoke, cache_len=args.cache_len,
                     block_k=args.block_k, batch=2, seq=args.seq)

    print(f"== record ({args.net}, passes={args.passes}, "
          f"jobs={args.jobs}) ==")
    rec = wl.record("prefill", jobs=args.jobs)
    srep = wl.sessions[-1][1]
    print(f"   virtual {srep['virtual_time_s']:.3f}s, "
          f"{srep['blocking_round_trips']} blocking RTs")

    print("== publish + fetch ==")
    wl.publish(rec)
    wl.fetch("prefill")

    print("== replay ==")
    rrep = wl.replay(artifact=rec, jobs=args.jobs)
    print(f"   virtual {rrep['virtual_time_s']:.3f}s, "
          f"{rrep['dispatches']} dispatches")

    tr = ws.tracer
    path = tr.dump(args.out, strip_wall=args.strip_wall)
    print(f"\ntrace: {path}  ({len(tr.events)} events; open in Perfetto)")

    att = tr.attributed_s("record")
    vt = srep["virtual_time_s"]
    frac = att / vt if vt else 1.0
    print(f"record attribution: {att:.3f}s of {vt:.3f}s virtual "
          f"({frac:.1%}) covered by named spans")

    print(f"\ntop {args.top} spans by virtual time:")
    print(tr.format_summary(top=args.top))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
