"""Signed recordings of a cell's two steps, kept like a compile cache.

A recording holds the step's program and the shapes and dtypes of its
inputs, never the weights (``launch/record.py:record_kinds`` exports with
zeros).  So a recording depends only on the port's code, the model's
configuration, the cell's shapes, the precision and the card: those are
hashed into the name of a fixed directory under ``.cache/recordings`` in
the benchmark's folder.  The first run of a cell in a checkout records, in a
process of its own (``python3 -m portbench.recordings``), so that what an
export leaves behind never reaches the run's window; it writes into
``<name>.partial``, renamed when both kinds are signed and saved.  Later
runs find the directory and only verify and load."""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

SIGNING_KEY = b"portbench-recordings"


def _code_hash(src: Path) -> str:
    h = hashlib.sha256()
    for p in sorted(src.rglob("*")):
        if p.is_file() and "__pycache__" not in p.parts:
            h.update(str(p.relative_to(src)).encode())
            h.update(p.read_bytes())
    return h.hexdigest()


def cache_dir(bench: Path, src: Path, cfg, mix: dict, topology: str,
              torch_version: str) -> Path:
    key = {"code": _code_hash(src), "config": cfg.fingerprint(),
           "slots": mix["slots"], "prompt_len": mix["prompt_len"],
           "cache_len": mix["cache_len"], "block_k": mix["block_k"],
           "eos_id": mix["eos_id"], "dtype": cfg.dtype,
           "topology": topology, "torch": torch_version}
    digest = hashlib.sha256(json.dumps(key, sort_keys=True).encode())
    return bench / ".cache" / "recordings" / f"{cfg.name}-{digest.hexdigest()[:20]}"


def ensure(out: Path, root: Path, cell: str, device) -> dict:
    """Record both kinds of ``cell`` into ``out`` unless it holds them, in
    a child process; returns {"record_s": [each kind's record_wall_s],
    "recorded": bool}."""
    info = out / "record.json"
    if not info.exists():
        import repro_torch
        here = Path(__file__).resolve().parent
        src = Path(repro_torch.__file__).resolve().parents[1]
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [str(here.parent), str(src)]
            + [p for p in [os.environ.get("PYTHONPATH")] if p]))
        subprocess.run([sys.executable, "-m", f"{here.name}.recordings",
                        "--root", str(root), "--cell", cell, "--out", str(out),
                        "--device", str(device)], check=True, env=env)
        return dict(json.loads(info.read_text()), recorded=True)
    return dict(json.loads(info.read_text()), recorded=False)


def record(out: Path, cfg, mix: dict, device) -> None:
    """Record, sign and save both kinds into ``out``."""
    from repro_torch.launch.record import record_kinds
    part = out.with_name(out.name + ".partial")
    shutil.rmtree(part, ignore_errors=True)
    t = time.time()
    done = record_kinds(cfg, out=str(part), key=SIGNING_KEY,
                        cache_len=mix["cache_len"], block_k=mix["block_k"],
                        batch=mix["slots"], seq=mix["prompt_len"],
                        eos_id=mix["eos_id"], device=device)
    meta = {"record_s": [rec.manifest["record_wall_s"]
                         for _, rec in done.values()],
            "wall_s": time.time() - t}
    (part / "record.json").write_text(json.dumps(meta))
    shutil.rmtree(out, ignore_errors=True)
    part.rename(out)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    for a in ("--root", "--cell", "--out", "--device"):
        ap.add_argument(a, required=True)
    args = ap.parse_args(argv)
    from portbench.harness import Bench
    import torch
    bench = Bench(args.root)
    cell = bench.cell(args.cell)
    conf = bench.config(cell)
    record(Path(args.out), bench.adapter(conf).port_config(conf),
           bench.traffic(cell), torch.device(args.device))


if __name__ == "__main__":
    main()
