"""Fleet serving launcher — a thin shim over ``Workspace.fleet``.

Counterpart of ``repro/launch/fleet.py``.  Boots a pool of replicas
(live steps when no registry is given; with ``--from-registry`` each
replica boots warm from the registry through its own client and link
span: fetch, verify, load, warm), generates deterministic open-loop
traffic, serves it on the pool's virtual tick clock, and prints the
per-tenant latency quantiles (virtual-clock seconds, not a measured
time) and the pool and balancer accounting.  It runs on the CUDA device
unless asked for the CPU:

    python -m repro_torch.launch.fleet --tenants qwen2.5-3b,xlstm-350m \\
        --smoke --device cpu --replicas 3 --policy least_loaded --rate 12
    python -m repro_torch.launch.fleet --from-registry recs/registry \\
        --smoke --device cpu --key secret --net wifi --record-on-miss \\
        --regions 2 --policy cache_affinity

A registry fleet draws every prompt at the length its replayed prefill
was recorded at (a recorded program has one prompt shape): the
workloads ask for ``REC_SEQ`` (16), and the registry may substitute a
published prefill of another length.
"""
from __future__ import annotations

import argparse
import json
import time

from repro_torch import resolve_device
from repro_torch.api import Workspace
from repro_torch.configs import get_config, smoke_shrink
from repro_torch.core.netem import PROFILES
from repro_torch.fleet import POLICIES, OpenLoopTraffic, TenantMix

__all__ = ["REC_SEQ", "main"]

# registry prefill recordings pin the prompt shape; live fleets may vary
REC_SEQ = 16


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tenants", default="qwen2.5-3b",
                    help="comma-separated archs, one stream per tenant")
    ap.add_argument("--smoke", action="store_true",
                    help="serve the reduced same-family configs")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--policy", default="round_robin", choices=POLICIES)
    ap.add_argument("--rate", type=float, default=10.0,
                    help="per-tenant Poisson arrival rate (requests/s)")
    ap.add_argument("--horizon", type=float, default=2.0,
                    help="virtual seconds of open-loop traffic")
    ap.add_argument("--burst-x", type=float, default=4.0)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--cache-len", type=int, default=64)
    ap.add_argument("--block-k", type=int, default=4)
    ap.add_argument("--tick", type=float, default=0.02)
    ap.add_argument("--regions", type=int, default=1)
    ap.add_argument("--queue-limit", type=int, default=None)
    ap.add_argument("--autoscale", action="store_true")
    ap.add_argument("--from-registry", default="",
                    help="registry root; replicas boot warm from it")
    ap.add_argument("--record-on-miss", action="store_true")
    ap.add_argument("--net", default="wifi",
                    choices=["none"] + sorted(PROFILES))
    ap.add_argument("--key", default="cody-demo-key")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    registry = args.from_registry or None
    ws = Workspace(registry=registry,
                   key=args.key.encode() if registry else b"",
                   net=None if args.net == "none" else args.net,
                   device=resolve_device(args.device))
    archs = [a.strip() for a in args.tenants.split(",") if a.strip()]
    cfgs = [smoke_shrink(get_config(a)) if args.smoke else get_config(a)
            for a in archs]
    wls = [ws.workload(c, cache_len=args.cache_len, block_k=args.block_k,
                       batch=args.slots, seq=REC_SEQ) for c in cfgs]
    pool, _ = ws.fleet(wls, replicas=args.replicas, policy=args.policy,
                       tick_s=args.tick, regions=args.regions,
                       record_on_miss=args.record_on_miss,
                       queue_limit=args.queue_limit,
                       autoscale=args.autoscale, seed=args.seed)
    for r in pool.replicas:
        print(f"replica {r.name}: region r{r.region}, boot "
              f"{r.boot_virtual_s:.3f}s virtual (link model output)")

    streams = pool.replicas[0].scheduler.streams
    mixes = [TenantMix(wl.cfg.name, args.rate,
                       prompt_len=streams[wl.cfg.name].channel
                       .fixed_prompt_len or (4, 12),
                       max_new=(4, args.max_new),
                       vocab=min(wl.cfg.vocab_size, 256)) for wl in wls]
    traffic = OpenLoopTraffic(mixes, seed=args.seed, burst_every_s=1.0,
                              burst_len_s=0.25, burst_x=args.burst_x)
    arrivals = traffic.generate(args.horizon)
    print(f"open-loop traffic: {len(arrivals)} arrivals over "
          f"{args.horizon}s virtual ({args.policy})")
    t0 = time.time()
    outputs = pool.run(arrivals)
    dt = time.time() - t0
    toks = sum(len(v) for v in outputs.values())
    print(f"served {len(outputs)}/{len(arrivals)} requests, {toks} tokens "
          f"in {dt:.2f}s wall on {ws.device} / {pool.clock:.2f}s virtual")
    for wl in wls:
        q = ws.metrics.quantiles("fleet_request_latency_s",
                                 pool=pool.name, tenant=wl.cfg.name)
        print(f"  [{wl.cfg.name}] latency (virtual clock): {q}")
    print("pool:", json.dumps(pool.stats(), indent=2))
    return outputs, pool


if __name__ == "__main__":
    main()
