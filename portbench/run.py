"""Run one cell of ``BENCHMARK.json`` once on the card:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout (``--control int8`` judges the control in the
program's place instead, which has to come out not correct).  It exits non-zero and prints no result where
the card is missing or the cell asks for more cards than there are, where
the port's sources are not in the checkout, and where JAX or the JAX package
was loaded.  Otherwise the last line of its standard output is the result
(``harness.run_cell``) and the last lines of its standard error are each
number compared beside its limit."""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

T_IMPORT = time.time()
ROOT = Path(__file__).resolve().parents[1]
BENCH = Path(__file__).resolve().parent


def process_start() -> float:
    """Wall time at which this process started (from its start tick since
    boot), or the time this module was loaded where that cannot be read."""
    try:
        fields = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
        ticks = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        up = time.clock_gettime(time.CLOCK_BOOTTIME)
        return min(time.time() - (up - ticks), T_IMPORT)
    except (OSError, ValueError, IndexError, AttributeError):
        return T_IMPORT


def main(argv=None) -> int:
    start = process_start()
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # the control in the program's place (control.py): never in a check
    ap.add_argument("--control", choices=("int8",), default=None)
    args = ap.parse_args(argv)

    # every cache of the program and of its compilers stays in the checkout
    cache = BENCH / ".cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(cache / "inductor")
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"no src/repro_torch under {ROOT}: nothing to measure",
              file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    # the host paces the cell (the eager prefill's dispatch): one host
    # thread for the CPU's kernels, so no idle pool spins on shared cores
    os.environ["OMP_NUM_THREADS"] = os.environ["MKL_NUM_THREADS"] = "1"

    import torch
    torch.set_num_threads(1)
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {c["name"]: c for c in spec["workloads"]}
    if args.workload not in cells:
        print(f"no cell {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    chips = cells[args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"cell {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3

    from portbench import harness
    result = harness.run_cell(ROOT, args.workload, seed=args.seed,
                              seconds=args.seconds, trace=bool(args.trace),
                              device="cuda", t_start=start,
                              control=args.control)
    found = harness.forbidden_modules()
    if found:
        print(f"modules of JAX or of the JAX package were loaded: {found}",
              file=sys.stderr)
        return 4
    sys.stderr.write("\n".join(harness.check_lines(result)) + "\n")
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
