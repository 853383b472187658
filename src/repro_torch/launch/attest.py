"""Attested-replay lifecycle demo + offline quote verification.

Counterpart of ``repro/launch/attest.py``.  Demo (records on
``--device``, publishes through the transparency log, replays with proof
verification, emits a signed quote bundle)::

    python -m repro_torch.launch.attest --arch qwen2.5-3b --net wifi \
        --out attest_quote.json

Offline verification of a previously emitted bundle — this path imports
ONLY ``repro_torch.attest`` (no model, registry, or serving code), i.e.
what a remote verifier would run::

    python -m repro_torch.launch.attest --verify attest_quote.json \
        --key cody-demo-key

``--rotate`` advances the key-schedule epoch after publishing, showing
that heads/quotes signed in older epochs stay verifiable.

This module is CLI-only: the attestation layer itself is
``repro_torch.attest``.
"""
from __future__ import annotations

import argparse
import json


def _verify(path: str, key: bytes) -> int:
    # the offline half: repro_torch.attest only — nothing a replica
    # controls
    from repro_torch.attest import KeySchedule, verify_quote
    with open(path) as f:
        bundle = json.load(f)
    keys = KeySchedule(key)
    for _ in range(int(bundle.get("epoch", 0))):
        keys.rotate()
    report = verify_quote(bundle["quote"], head=bundle["head"], keys=keys,
                          leaf=bundle.get("leaf"),
                          proof=bundle.get("path"),
                          leaf_index=bundle.get("index"))
    print(f"quote VERIFIED: key={report['recording_key']} "
          f"epoch={report['epoch']} log_size={report['log_size']} "
          f"root={report['root'][:16]}... "
          f"inclusion={'checked' if report['inclusion_checked'] else 'skipped'}")
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="attested replay: transparency-log publish, "
                    "proof-verified fetch, signed replay quote")
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--net", default="wifi")
    ap.add_argument("--jobs", type=int, default=16)
    ap.add_argument("--cache-len", type=int, default=64)
    ap.add_argument("--block-k", type=int, default=8)
    ap.add_argument("--seq", type=int, default=16)
    ap.add_argument("--key", default="cody-demo-key")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rotate", action="store_true",
                    help="rotate the signing epoch after publish (older-"
                         "epoch signatures must still verify)")
    ap.add_argument("--out", default="attest_quote.json",
                    help="quote-bundle JSON output path")
    ap.add_argument("--verify", default="",
                    help="offline-verify a quote bundle instead of "
                         "running the demo")
    args = ap.parse_args(argv)
    key = args.key.encode()

    if args.verify:
        return _verify(args.verify, key)

    from repro_torch.api import Workspace
    ws = Workspace(registry=":memory:", key=key, net=args.net,
                   device=args.device)
    wl = ws.workload(args.arch, cache_len=args.cache_len,
                     block_k=args.block_k, batch=2, seq=args.seq)

    print(f"== record + publish (epoch {ws.keys.epoch}) ==")
    rec = wl.record("prefill", jobs=args.jobs)
    pub = wl.publish(rec)
    print(f"   log_index={pub['log_index']} log_size={pub['log_size']} "
          f"root={pub['root'][:16]}...")

    if args.rotate:
        print(f"== rotate epoch -> {ws.rotate_epoch()} ==")

    print("== attested replay (proof-verified fetch) ==")
    rep, quote, bundle = wl.attested_replay("prefill", jobs=args.jobs)
    att = ws.report()["attest"]
    print(f"   virtual {rep['virtual_time_s']:.3f}s, "
          f"{rep['dispatches']} dispatches; proofs_verified="
          f"{att['proofs_verified']} proof_bytes={att['proof_bytes']}")

    out = {"quote": quote, "head": bundle["head"], "leaf": bundle["leaf"],
           "index": bundle["index"], "path": bundle["path"],
           "epoch": ws.keys.epoch}
    with open(args.out, "w") as f:
        json.dump(out, f, indent=2, sort_keys=True)
    print(f"quote bundle: {args.out}")

    print("== offline verification ==")
    return _verify(args.out, key)


if __name__ == "__main__":
    raise SystemExit(main())
