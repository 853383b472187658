"""The paper's end-to-end story (CODY) through ``repro_torch.api`` only:

  1. CLOUD — record the workload once (no weights or user data needed:
     zeros stand in for the params) and publish the SIGNED recordings.
  2. TEE   — the engine boots from the registry: chunked fetch, HMAC
     verified BEFORE ``torch.export.load``, no model code / exporter in
     the replay path — and serves a private prompt BIT-EXACTLY vs live
     execution.
  3. An adversary tampers with the fetched recording -> rejected.
  4. The TEE checks the registry's TRANSPARENCY LOG: the fetched bytes
     are committed under a signed Merkle root (inclusion proof), so even
     a validly-signed swap by a compromised registry is caught.

Counterpart of the reference's ``examples/secure_inference.py``:

    python -m repro_torch.examples.secure_inference        # on the card
    python -m repro_torch.examples.secure_inference --device cpu
"""
import argparse
import tempfile

from repro_torch.api import Workspace
from repro_torch.attest import leaf_data, verify_inclusion
from repro_torch.attest.verifier import head_signable
from repro_torch.core import Recording, TamperedRecordingError

KEY = b"cloud-hsm-key"
SHAPES = dict(cache_len=64, block_k=4, batch=1, seq=16)
SECRET_PROMPT = [11, 22, 33, 44, 55, 66, 77, 88,
                 99, 111, 122, 133, 144, 155, 166, 177]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory() as root:
        ws = Workspace(registry=root, key=KEY, net="wifi",
                       device=args.device)
        wl = ws.workload("qwen2.5-3b", **SHAPES)
        print("=== 1. cloud: record + publish (session over wifi) ===")
        for kind in ("prefill", "decode"):
            wl.publish(wl.record(kind))
        print("=== 2. TEE: fetch-verified replay on private data ===")
        tee = wl.engine(seed=42)        # weights stay private in the TEE
        tee.submit(SECRET_PROMPT, max_new=8)
        private = tee.run()
        live = Workspace(device=args.device).workload(
            "qwen2.5-3b", **SHAPES).engine(seed=42)
        live.submit(SECRET_PROMPT, max_new=8)
        assert live.run() == private, "replay diverged from live execution"
        print(f"generated (privately, bit-exact vs live): {private[0]}")
        print("=== 3. adversary tampers with the recording ===")
        blob = bytearray(wl.fetch("decode"))
        blob[len(blob) // 2] ^= 0xFF
        try:
            Recording.from_bytes(bytes(blob), KEY)
        except TamperedRecordingError as e:
            print(f"tampering rejected by the TEE: {e}")
        else:
            raise AssertionError("tampering NOT detected")
        print("=== 4. transparency: fetched bytes are in the signed log ===")
        bundle = ws.service.proof_for(wl.key("decode"))
        head, leaf = bundle["head"], bundle["leaf"]
        assert ws.keys.verify(head_signable(head), head["signature"])
        assert verify_inclusion(
            leaf_data(leaf["key"], leaf["manifest_fp"],
                      leaf["payload_digest"], leaf["epoch"]),
            bundle["index"], head["size"], bundle["path"], head["root"])
        print(f"inclusion proof ok: leaf {bundle['index']} of "
              f"{head['size']} under signed root {head['root'][:16]}...")


if __name__ == "__main__":
    main()
