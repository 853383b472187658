"""Recording-campaign launcher — a thin shim over ``Workspace.campaign``.

Counterpart of ``repro/launch/fanout.py``.  Fans a key's shape variants
(a prefill per ``--seqs`` bucket, decode once) out across a pool of
emulated device slots and publishes each finished variant into the
registry through the multi-variant lease.  The exports run on the CUDA
device unless asked for the CPU:

    python -m repro_torch.launch.fanout --arch cody-mnist --smoke \\
        --device cpu --devices 4 --seqs 8,16,32,64 --net wifi
    python -m repro_torch.launch.fanout --arch cody-mnist --smoke \\
        --device cpu --devices 4 --net wifi,cellular --no-share-history

Prints the per-device assignment table and the campaign accounting:
makespan against the sum of per-record times (emulated seconds, the link
model's output), speculation hit rates per device (shared history warms
later devices), skips for already-published variants.  ``--jobs`` pins
the session's job count: a ``torch.export`` payload is not an XLA
executable's size, so only a pinned count gives the reference's round
trips and virtual seconds.
"""
from __future__ import annotations

import argparse
import json
import os

from repro_torch import resolve_device
from repro_torch.api import Workspace
from repro_torch.core.netem import PROFILES

__all__ = ["run_campaign", "main"]


def run_campaign(arch: str, *, devices: int, nets=("wifi",), seqs=(8,),
                 kinds=("prefill", "decode"), registry=None,
                 key: bytes = b"cody-demo-key", cache_len: int = 128,
                 block_k: int = 8, batch: int = 4, prefill_batch: int = 1,
                 jobs=None, passes="all", hw_class: str = "edge-gpu",
                 share_history: bool = True, smoke: bool = False,
                 device="cuda", artifacts=None, name=None):
    """Build and run one campaign: ``arch``'s variants (a prefill per seq
    of ``seqs``, the other kinds once) over ``devices`` slots, round-robin
    over the link profiles ``nets``, publishing into ``registry`` (a root,
    or in memory when None).  ``artifacts`` is the campaign's shared
    ``{key: Recording}`` dict (each variant is exported once and reused
    by later campaigns handed the same dict).  Returns the campaign."""
    ws = Workspace(registry=registry or ":memory:", key=key, net=nets[0],
                   record_passes=passes, device=resolve_device(device))
    wl = ws.workload(arch, smoke=smoke, cache_len=cache_len,
                     block_k=block_k, batch=batch,
                     prefill_batch=prefill_batch, seq=seqs[0])
    campaign = ws.campaign(wl.variants(seqs=list(seqs), kinds=tuple(kinds)),
                           devices=devices, nets=list(nets),
                           hw_class=hw_class, share_history=share_history,
                           jobs=jobs, artifacts=artifacts,
                           name=name or f"fanout-{arch}")
    campaign.run()
    return campaign


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--smoke", action="store_true",
                    help="record the reduced same-family config")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--devices", type=int, default=4)
    ap.add_argument("--net", default="wifi",
                    help="comma list of link profiles, round-robin over "
                         f"devices ({'|'.join(sorted(PROFILES))})")
    ap.add_argument("--seqs", default="8,16,32,64",
                    help="prefill seq buckets to record (decode rides "
                         "along once)")
    ap.add_argument("--kinds", default="prefill,decode")
    ap.add_argument("--registry", default=None,
                    help="registry root (default: in-memory, print-only)")
    ap.add_argument("--key", default="cody-demo-key")
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--block-k", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prefill-batch", type=int, default=1)
    ap.add_argument("--jobs", type=int, default=None,
                    help="pin per-session job count (determinism across "
                         "exports)")
    ap.add_argument("--passes", default="all")
    ap.add_argument("--hw-class", default="edge-gpu")
    ap.add_argument("--no-share-history", action="store_true",
                    help="cold speculator per session (the serial "
                         "baseline's behavior)")
    args = ap.parse_args(argv)

    if args.registry:
        os.makedirs(args.registry, exist_ok=True)
    nets = [n.strip() for n in args.net.split(",") if n.strip()]
    seqs = [int(s) for s in args.seqs.split(",") if s.strip()]
    kinds = tuple(k.strip() for k in args.kinds.split(",") if k.strip())
    n_items = len(seqs) * ("prefill" in kinds) + \
        sum(k != "prefill" for k in kinds)
    print(f"campaign: {n_items} variants over {args.devices} devices "
          f"({'+'.join(nets)}), shared history="
          f"{not args.no_share_history}")
    campaign = run_campaign(
        args.arch, devices=args.devices, nets=nets, seqs=seqs, kinds=kinds,
        registry=args.registry, key=args.key.encode(),
        cache_len=args.cache_len, block_k=args.block_k, batch=args.batch,
        prefill_batch=args.prefill_batch, jobs=args.jobs,
        passes=args.passes, hw_class=args.hw_class,
        share_history=not args.no_share_history, smoke=args.smoke,
        device=args.device)
    s = campaign.stats()
    for d in s["per_device"]:
        spec = d["spec"]
        hr = (spec["hit"] / spec["predict"]) if spec["predict"] else 0.0
        print(f"  {d['name']}[{d['net']}]: {d['recorded']} variants, "
              f"{d['busy_virtual_s']:.2f}s busy, "
              f"{d['blocking_round_trips']} blocking RTs, "
              f"spec hit {hr:.0%}")
    print(f"makespan {s['virtual_time_s']:.2f}s virtual vs "
          f"{s['sum_record_virtual_s']:.2f}s summed record time "
          f"(emulated; {s['recorded']} recorded, "
          f"{s['skipped_published']} already published, "
          f"{s['publishes']} published)")
    print("campaign:", json.dumps(s, indent=2))
    return campaign


if __name__ == "__main__":
    main()
