"""The recorder: CODY's "cloud dryrun service" on the ``torch.export`` path.

Counterpart of ``compile_artifact`` and ``topology_fingerprint`` of
``repro/core/recorder.py``.  ``compile_artifact()`` runs the model code
once per (workload × shape): it exports the step with ``torch.export``
against example tensors on the recording device, serializes the program
(``torch.export.save``) and builds the signable ``Recording``.  Replay
needs none of this machinery.

The params are inputs of the exported program, never constants: the
payload carries no weight, as the reference's executable carries none,
and a program that closed over a tensor is refused.  The example inputs
are real tensors (zeros, or the caller's own): a program exported against
``FakeTensorMode`` inputs serializes fake tensors that
``torch.export.load`` can open only by full unpickling.  Factory ops bake
the recording device into the graph, so a recording replays only on the
device type it was made on; the topology fingerprint says which.

``record()``, the two-party recording session, comes with the port of
``repro/record`` (ROADMAP Queue 1, item 8).
"""
from __future__ import annotations

import io
import json
import time
from typing import Any, Optional, Sequence

import torch
from torch.export.graph_signature import OutputKind
from torch.utils import _pytree as pytree

from repro_torch.core.attest import fingerprint
from repro_torch.core.recording import Recording


def topology_fingerprint(device="cuda") -> str:
    """The hardware a recording made on ``device`` replays on: the sorted
    names of the cards and their count, or the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        n = torch.cuda.device_count()
        names = [torch.cuda.get_device_name(i) for i in range(n)]
    else:
        n, names = 1, [device.type]
    return fingerprint(sorted(names), n)


def dtype_name(x) -> str:
    """``float32``, ``bfloat16``, ``int32``...: the name of a tensor's (or
    numpy array's) dtype without its module, as the reference's
    manifests spell numpy's."""
    return str(getattr(x, "dtype", "")).removeprefix("torch.")


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) else 0


class _Step(torch.nn.Module):
    """The step as the module ``torch.export`` takes; it holds nothing."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def _out_bytes(ep) -> int:
    """Bytes of the program's user outputs, from the exported specs."""
    out = next(n for n in ep.graph.nodes if n.op == "output").args[0]
    return sum(_nbytes(getattr(node, "meta", {}).get("val"))
               for node, spec in zip(out, ep.graph_signature.output_specs)
               if spec.kind == OutputKind.USER_OUTPUT)


def compile_artifact(name: str, fn, args: Sequence[Any], *,
                     donate_argnums=(), config_fingerprint: str = "",
                     static_meta: Optional[dict] = None) -> Recording:
    """Export and serialize ``fn`` into a signable Recording.  ``args``
    are real tensors (a pytree) on the recording device; every tensor
    ``fn`` reads must come through them."""
    t0 = time.time()
    flat = pytree.tree_leaves(tuple(args))
    devices = {x.device for x in flat if isinstance(x, torch.Tensor)}
    if len(devices) != 1:
        raise ValueError(f"compile_artifact: inputs on {sorted(map(str, devices))}"
                         "; record on one device")
    device = devices.pop()
    ep = torch.export.export(_Step(fn), tuple(args), strict=False)
    closed = sorted(ep.state_dict) + sorted(ep.constants)
    if closed:
        raise ValueError(f"compile_artifact: '{name}' closes over tensors "
                         f"{closed[:4]}; pass them as inputs")
    ep.example_inputs = None    # save would write them: the weights
    for node in ep.graph.nodes:
        # the recorder's source paths: a payload's bytes must not depend
        # on where the recording checkout lives
        node.meta.pop("stack_trace", None)
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    payload = buf.getvalue()
    trees = json.dumps([pytree.treespec_dumps(ep.call_spec.in_spec),
                        pytree.treespec_dumps(ep.call_spec.out_spec)]
                       ).encode()
    manifest = {
        "name": name,
        "created_s": time.time(),
        "record_wall_s": time.time() - t0,
        "torch_version": torch.__version__,
        "topology": topology_fingerprint(device),
        "mesh": None,
        "config_fingerprint": config_fingerprint,
        "donate": list(donate_argnums),
        "inputs": [{"shape": list(getattr(a, "shape", ())),
                    "dtype": dtype_name(a)} for a in flat],
        "cost": {},
        # temp_bytes stays null: PyTorch runs the program eagerly, so no
        # compiler plans its intermediates the way XLA's memory analysis
        # reports them; what a replay holds at its peak shows only on the
        # device (torch.cuda.max_memory_allocated)
        "memory": {"arg_bytes": sum(map(_nbytes, flat)),
                   "temp_bytes": None,
                   "out_bytes": _out_bytes(ep)},
        "static": dict(static_meta or {}, backend="torch"),
    }
    manifest["exec_fingerprint"] = fingerprint(payload)
    return Recording(manifest=manifest, payload=payload, trees=trees)


__all__ = ["compile_artifact", "topology_fingerprint", "dtype_name"]
