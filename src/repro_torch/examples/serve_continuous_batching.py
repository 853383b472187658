"""Continuous-batching serving with the paper's I/O optimizations:

  * fused k-step decode blocks  (register-access deferral + §4.3 offload:
    one host dispatch per k tokens, EOS polled device-side)
  * speculative continuation    (§4.2: dispatch block N+1 before block N's
    done-mask readback, k=3 history confidence, metastate rollback)

Counterpart of the reference's ``examples/serve_continuous_batching.py``:
serves the same 8 requests with the speculative engine (pipeline depth 4)
and the synchronous one, and asserts identical outputs with fewer host
syncs.  It serves the smoke config, the reference launcher's default:

    python -m repro_torch.examples.serve_continuous_batching   # on the card
    python -m repro_torch.examples.serve_continuous_batching --device cpu
"""
import argparse

from repro_torch.launch.serve import main as serve


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    flags = ["--arch", "qwen2.5-3b", "--smoke", "--device", args.device,
             "--requests", "8", "--max-new", "24", "--slots", "4",
             "--block-k", "8"]
    print("=== speculative continuation ON (pipeline depth 4) ===")
    outs_spec, eng_spec = serve(flags + ["--pipeline-depth", "4"])
    print("\n=== speculative continuation OFF (synchronous) ===")
    outs_sync, eng_sync = serve(flags + ["--no-speculate"])
    same = outs_spec == outs_sync
    print(f"\noutputs identical under speculation: {same}")
    print(f"speculative blocks: {eng_spec.stats.get('spec_blocks', 0)} "
          f"(sync fallbacks {eng_spec.stats.get('sync_blocks', 0)}, "
          f"mispredicts {eng_spec.stats.get('mispredicts', 0)})")
    print(f"host syncs: {eng_spec.stats.get('host_syncs', 0)} pipelined vs "
          f"{eng_sync.stats.get('host_syncs', 0)} synchronous")
    assert same
    return outs_spec


if __name__ == "__main__":
    main()
