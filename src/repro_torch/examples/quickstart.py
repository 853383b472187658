"""Quickstart: the paper's whole lifecycle through ``repro_torch.api`` —
record once in the trusted cloud role (distributed recording session
over emulated wifi), publish into the content-addressed registry, then
boot a TEE replica that serves from verified recordings only.

Counterpart of the reference's ``examples/quickstart.py``:

    python -m repro_torch.examples.quickstart              # on the card
    python -m repro_torch.examples.quickstart --device cpu
"""
import argparse
import tempfile

from repro_torch.api import Workspace


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory() as root:
        ws = Workspace(registry=root, key=b"quickstart-key", net="wifi",
                       device=args.device)
        wl = ws.workload("cody-mnist", cache_len=64, block_k=4, batch=2,
                         seq=16)
        for kind in ("prefill", "decode"):      # cloud role: record + publish
            pub = wl.publish(wl.record(kind))
            print(f"published {pub['key']} v{pub['version']} "
                  f"({pub['wire_bytes']/1e3:.1f} kB wire)")
        eng = wl.engine()     # TEE role: fetch-verified, warmed ReplayChannel
        for prompt in ([7] * 16, [11] * 16):
            eng.submit(prompt, max_new=6)
        print("served from verified recordings:", eng.run())
        print("link accounting (emulated):", ws.report()["net"])


if __name__ == "__main__":
    main()
