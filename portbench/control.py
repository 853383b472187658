"""The control of ``correct``, and the readings a cell's limit is set from.

The control is the port's own int8 serving path (``serving/quant.py``:
int8 weights with a scale per output channel, dequantized block by block),
the nearest precision below the configuration's bf16, put in the program's
place.  It is teacher-forced on the tokens the program served: one
forward pass of the int8 model over each sampled prompt and its served
tokens, and at every position that chose a served token, the token the
int8 path puts first.  ``run.py --control int8`` judges it by the cell's
own comparison and limit (``harness.run_cell``): it has to come out not
correct.

For the limit, one process serves a dozen seeds or more as a run does (the
same ``Session``: the recordings replayed, the same warm-up, a window of
``--seconds``), and reads ``mean_gap`` and ``max_gap`` of the program and,
on the control seeds, of the control, over the same sample:

    python3 portbench/control.py --workload <cell> --seeds 1,2,...,12 \\
        --control-seeds 1,2,3 --seconds 10

One JSON line a seed; the benchmark's own runs never run this."""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
KINDS = ("int8",)


def chooser(sess, kind: str):
    """choose(prompt, served) -> the control's first choice at every
    position that chose a served token (``sess`` a ``harness.Session``)."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.serving import quant as Q
    if kind not in KINDS:
        raise ValueError(f"no control {kind!r}; there are {KINDS}")
    params = Q.quantize_params(sess.weights.tree)

    def choose(prompt, served):
        tokens = list(prompt) + list(served[:-1])
        with torch.no_grad():
            tok = torch.tensor([tokens], dtype=torch.int32, device=sess.dev)
            logits = M.forward(params, sess.cfg, {"tokens": tok})[0]
            first = len(prompt) - 1
            return logits[0, first:first + len(served)].argmax(-1).tolist()

    return choose


def readings(sess, seeds, controls, seconds):
    """One dict of readings per seed (``sess`` a ``harness.Session``)."""
    import torch
    for seed in seeds:
        sv = sess.serve(seed, seconds)
        picked = sess.sample(sv)
        row = {"cell": sess.cell["name"], "seed": seed, **sess.judge(picked),
               "finished": len(sess.finished(sv))}
        if seed in controls:
            row["control"] = sess.judge(picked, "int8")
        if sess.dev.type == "cuda":
            torch.cuda.empty_cache()
        yield row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=10)
    args = ap.parse_args(argv)
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "portbench" / ".cache" / "triton")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from portbench import harness

    sess = harness.Session(ROOT, args.workload, "cuda")
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    for row in readings(sess, [int(s) for s in args.seeds.split(",")],
                        controls, args.seconds):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
