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

``record()`` is the paper's full record phase: it runs the export through
an in-process degenerate ``repro_torch.record.RecordingSession`` (device
proxy and cloud dryrun co-located, all three optimization passes on,
nothing billed) — the same Recording ``compile_artifact`` builds, plus
the session fields (``record_virtual_s`` and per-pass counters, zero for
local records).  A session built over a real ``NetProfile`` runs the
distributed record phase over an emulated link and bills it.
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


def mesh_descriptor(mesh=None) -> dict:
    """The mesh a recording was made for, as the reference's manifests
    describe one: a ``DeviceMesh``'s shape and axis names.  Without a
    mesh it is the reference's host mesh on one device (``shape`` [1, 1]
    over ``data`` and ``model``), which is what a 1 x 1 mesh gives too, so
    a recording made under one keys as one made without.  Every manifest
    records it and every registry key fingerprints it
    (``repro_torch.api.workload.Workload``)."""
    if mesh is None:
        return {"shape": [1, 1], "axes": ["data", "model"]}
    return {"shape": [int(n) for n in mesh.mesh.shape],
            "axes": list(mesh.mesh_dim_names)}


def recorded_static(static_meta: Optional[dict]) -> dict:
    """The static meta a manifest records: the caller's shapes, and the
    backend that exported the program (registry keys fingerprint it, so
    a ``torch.export`` recording never shares a key with an XLA one)."""
    return dict(static_meta or {}, backend="torch")


def dtype_name(x) -> str:
    """``float32``, ``bfloat16``, ``int32``...: the name of a tensor's (or
    numpy array's) dtype without its module, as the reference's
    manifests spell numpy's."""
    return str(getattr(x, "dtype", "")).removeprefix("torch.")


def jax_arg_order(args) -> tuple:
    """``args`` with every flat dict argument after the first (a batch of
    tensors; the first is the params) in sorted key order.  JAX flattens
    a dict by sorted keys, so a batch's leaves come in the reference's
    order (``frames`` and ``image_embeds`` before ``tokens``) whatever
    order the caller built it in."""
    args = tuple(args)
    return args[:1] + tuple(
        dict(sorted(a.items())) if isinstance(a, dict) and all(
            isinstance(v, torch.Tensor) for v in a.values()) else a
        for a in args[1:])


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


def _program_cost(ep) -> dict:
    """{"flops", "bytes accessed", "flops_by_dtype"} of an exported step
    (``analysis.cost.analyze_exported``, eager byte count)."""
    from repro_torch.analysis.cost import analyze_exported
    c = analyze_exported(ep)
    return {"flops": c["flops"], "bytes accessed": c["hbm_bytes"],
            "flops_by_dtype": c["flops_by_dtype"]}


def compile_artifact(name: str, fn, args: Sequence[Any], *,
                     donate_argnums=(), config_fingerprint: str = "",
                     static_meta: Optional[dict] = None,
                     mesh=None) -> Recording:
    """Export and serialize ``fn`` into a signable Recording.  ``args``
    are real tensors (a pytree) on the recording device; every tensor
    ``fn`` reads must come through them.  A batch's leaves are recorded
    in JAX's order (``jax_arg_order``).  ``mesh`` (a ``DeviceMesh``) is
    the one the manifest names (``mesh_descriptor``)."""
    t0 = time.time()
    args = jax_arg_order(args)
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
        "mesh": mesh_descriptor(mesh),
        "config_fingerprint": config_fingerprint,
        "donate": list(donate_argnums),
        "inputs": [{"shape": list(getattr(a, "shape", ())),
                    "dtype": dtype_name(a)} for a in flat],
        # the program's own cost, counted from the exported graph (the
        # reference writes XLA's cost analysis here): the keys
        # roofline.from_recording_manifest reads
        "cost": _program_cost(ep),
        # temp_bytes stays null: PyTorch runs the program eagerly, so no
        # compiler plans its intermediates the way XLA's memory analysis
        # reports them; what a replay holds at its peak shows only on the
        # device (torch.cuda.max_memory_allocated)
        "memory": {"arg_bytes": sum(map(_nbytes, flat)),
                   "temp_bytes": None,
                   "out_bytes": _out_bytes(ep)},
        "static": recorded_static(static_meta),
    }
    manifest["exec_fingerprint"] = fingerprint(payload)
    return Recording(manifest=manifest, payload=payload, trees=trees)


def record(name: str, fn, args: Sequence[Any], *, donate_argnums=(),
           config_fingerprint: str = "", static_meta: Optional[dict] = None,
           session=None, mesh=None) -> Recording:
    """Record ``fn`` through a ``RecordingSession`` (the CODY two-party
    record phase).  Without ``session`` this is the in-process degenerate
    session — LOCAL co-located device+cloud, all passes on, nothing billed
    — whose Recording is the same artifact ``compile_artifact`` builds.
    Pass a session built over a real ``NetProfile`` (see
    ``repro_torch.record.RecordingSession.for_profile``) to bill the
    distributed record protocol into its emulator and into the
    manifest."""
    # lazy import: repro_torch.record composes over this module's export
    from repro_torch.record import RecordingSession
    sess = session if session is not None else RecordingSession.local()
    return sess.record(name, fn, args, donate_argnums=donate_argnums,
                       config_fingerprint=config_fingerprint,
                       static_meta=static_meta, mesh=mesh)


__all__ = ["compile_artifact", "record", "topology_fingerprint",
           "mesh_descriptor", "recorded_static", "dtype_name",
           "jax_arg_order"]
