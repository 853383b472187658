"""The knee of a cell: the highest arrival rate it sustains, swept once on
the card when the cell's rate is chosen (never by the benchmark's runs):

    python3 portbench/sweep.py --workload <cell> --rates 8,12,16,20 \\
        --seconds 15 --seed <n>

One process serves the cell's traffic at each rate in turn (the mix's
``arrivals.rate`` replaced, all else as a run does), and prints one JSON
line a rate: the rate offered and the requests completed a second, the
tokens a second, the first-token and per-token tails, the first-token tail
of each half of the window, and the requests still unserved at its close.
Past the knee the queue grows through the window: the completed rate falls
behind the offered one and the second half's tail outgrows the first's."""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=15)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "portbench" / ".cache" / "triton")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from portbench import harness

    sess = harness.Session(ROOT, args.workload, "cuda")
    mix = sess.mix
    for rate in (float(r) for r in args.rates.split(",")):
        sess.mix = dict(mix, arrivals=dict(mix["arrivals"], rate=rate))
        sv = sess.serve(args.seed, args.seconds)
        finished = sess.finished(sv)
        ttft, tpot = harness.latencies(sv, finished)
        mid = (sv.t0 + sv.t1) / 2
        halves = [[r["first"] - r["arrive"] for r in sv.loop.done
                   if r["first"] is not None and a <= r["first"] < b]
                  for a, b in ((sv.t0, mid), (mid, sv.t1))]
        w = sv.t1 - sv.t0
        print(json.dumps({
            "rate": rate, "completed_per_s": len(finished) / w,
            "tokens_per_s": sv.loop.tokens / w,
            "ttft_p50_ms": 1e3 * harness.p50(ttft) if ttft else None,
            "ttft_p95_ms": 1e3 * harness.p95(ttft) if ttft else None,
            "tpot_p95_ms": 1e3 * harness.p95(tpot) if tpot else None,
            "ttft_p95_halves_ms": [1e3 * harness.p95(h) if h else None
                                   for h in halves],
            "unserved": len(sv.loop.live), "stats": sv.stats}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
