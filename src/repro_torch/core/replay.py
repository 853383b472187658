"""The replayer: CODY's in-TEE component.

Counterpart of ``repro/core/replay.py``.  Deliberately minimal: it
imports no model code, no configs, no training or serving machinery
(tests assert this).  It loads a signed recording, verifies it
(signature, payload fingerprint, topology) and only then hands the
payload to ``torch.export.load``; it executes the loaded program on new
inputs.  There is no tracing and no Python model in the TCB: the
exported program *is* the recorded interaction script.  It does import
``repro_torch.kernels``, so that the custom ops a program names are
registered before it loads: the kernels are the port's counterpart of
the XLA runtime that executes the reference's recordings, not model
code.

Programs are cached by ``(name, input signature)``: several recordings
of one workload at different shapes can share a logical name, and
``execute`` dispatches on the arguments' shapes and dtypes.  The
signature is computed from the manifest once, at ``load``; a mismatch
raises ``ReplayArgumentError`` naming the first differing leaf.  Once a
sole-variant name has validated one call, the resolved program is pinned
and later calls skip the signature build (``stats['fast_hits']`` /
``stats['slow_validations']``); the pin is dropped the moment a second
variant loads under the name.

``warm`` runs every variant once on zeros, which builds its kernels.  On
a CUDA device the next ``execute`` of a warmed variant captures it as a
``torch.cuda.CUDAGraph``, the counterpart of the reference's precompiled
executable.  The graph reads the params (the step's first argument, as
``api.workload.build_step`` gives it) where the caller keeps them, so
they are never copied: a later call whose params lie elsewhere captures
anew.  Every other input (tokens, positions, caches) is copied into the
graph's own static inputs before each replay; each output is copied out
after it (an output in flight in the serving pipeline must survive the
next replay), and an input updated in place, such as the caches of a
decode block, is copied back into the caller's tensor, which is
returned.  A replay runs no Python wrapper, so the kernels' ``.launches``
do not advance: ``stats['graph_replays']`` counts replays,
``stats['captures']`` captures, and ``captured_launches(name)`` the
launches one replay makes.  A failed capture raises.  A variant never
warmed runs the loaded program eagerly, which is how the CPU replays.
"""
from __future__ import annotations

import io
import json
from typing import Any, Optional

import torch
from torch.utils import _pytree as pytree

import repro_torch.kernels as _kernels  # registers the custom ops
from repro_torch import resolve_device
from repro_torch.core.attest import (TamperedRecordingError,
                                     TopologyMismatchError,
                                     UnverifiedRecordingError, fingerprint)
from repro_torch.core.recorder import (dtype_name, jax_arg_order,
                                       topology_fingerprint)
from repro_torch.core.recording import Recording


class ReplayArgumentError(TypeError):
    """Replay arguments do not match any recorded program."""


def _aval_signature(leaves) -> tuple:
    return tuple((tuple(getattr(a, "shape", ())), dtype_name(a))
                 for a in leaves)


def _same(a, b) -> bool:
    """``a`` is ``b``'s memory, as a captured graph reads it."""
    return a is b or (isinstance(a, torch.Tensor)
                      and a.data_ptr() == b.data_ptr()
                      and a.stride() == b.stride() and a.device == b.device)


def _structure_diff(args, spec) -> str:
    """Where ``args`` first part from the tree ``spec`` records: an
    argument's structure, or a dict's keys (in order)."""
    (want, _) = pytree.tree_unflatten([None] * spec.num_leaves, spec)
    if len(args) != len(want):
        return f"{len(args)} arguments, recorded {len(want)}"

    def walk(got, rec, path):
        if type(got) is not type(rec):
            return f"{path}: got {type(got).__name__}, recorded " \
                   f"{type(rec).__name__}"
        if isinstance(rec, dict):
            if list(got) != list(rec):
                return f"{path}: keys {list(got)}, recorded {list(rec)}"
            items = [(got[k], rec[k], f"{path}[{k!r}]") for k in rec]
        elif isinstance(rec, (list, tuple)):
            if len(got) != len(rec):
                return f"{path}: {len(got)} items, recorded {len(rec)}"
            items = [(g, r, f"{path}[{i}]")
                     for i, (g, r) in enumerate(zip(got, rec))]
        else:
            return None
        for g, r, p in items:
            found = walk(g, r, p)
            if found:
                return found
        return None

    return walk(tuple(args), tuple(want), "args") or "another tree type"


class _Variant:
    """One loaded program, and its CUDA graph once captured."""

    def __init__(self, program, manifest: dict, in_spec, out_spec):
        self.program = program
        self.manifest = manifest
        self.in_spec = in_spec
        self.out_spec = out_spec
        self.armed = False         # warmed on a card: capture at next run
        self.graph = None
        self.borrowed = 0          # leading input leaves read in place
        self.static_in: list = []
        self.static_out: list = []
        self.alias: list = []      # per output leaf: the input leaf it is
        self.launches: dict = {}   # kernel launches one replay makes

    def run(self, args, stats):
        leaves, spec = pytree.tree_flatten((args, {}))
        if spec != self.in_spec:
            raise ReplayArgumentError(
                f"replay args for '{self.manifest['name']}' are not laid "
                f"out as the recorded program's: "
                f"{_structure_diff(args, self.in_spec)}")
        if not self.armed:
            return self.program(*args)
        n = self.borrowed
        if self.graph is None or not all(
                map(_same, leaves[:n], self.static_in[:n])):
            self._capture(args, leaves, stats)
            n = self.borrowed
        for src, dst in zip(leaves[n:], self.static_in[n:]):
            dst.copy_(src)
        self.graph.replay()
        stats["graph_replays"] += 1
        outs = []
        for o, a in zip(self.static_out, self.alias):
            if a is None:
                outs.append(o.clone())
            else:                   # an input updated in place
                outs.append(leaves[a].copy_(o))
        return pytree.tree_unflatten(outs, self.out_spec)

    def _capture(self, args, leaves, stats):
        """Capture the program reading the caller's params in place and
        its own zeroed copies of every other input; an error raises."""
        self.graph, self.static_in, self.static_out = None, [], []
        n = len(pytree.tree_leaves(args[0])) if args else 0
        static = leaves[:n] + [torch.zeros_like(t) for t in leaves[n:]]
        s_args, s_kwargs = pytree.tree_unflatten(static, self.in_spec)
        counted = _kernels.KERNELS + _kernels.INT8_KERNELS
        before = _kernels.launch_counts(counted)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            outs = self.program(*s_args, **s_kwargs)
        after = _kernels.launch_counts(counted)
        ids = {id(t): i for i, t in enumerate(static)}
        self.static_out = pytree.tree_leaves(outs)
        self.alias = [ids.get(id(o)) for o in self.static_out]
        self.static_in, self.borrowed = static, n
        self.launches = {k: after[k] - before[k] for k in after
                         if after[k] != before[k]}
        self.graph = graph
        stats["captures"] += 1


class Replayer:
    def __init__(self, key: Optional[bytes] = None,
                 enforce_topology: bool = True,
                 allow_unsigned: bool = False, device="cuda"):
        if key is None and not allow_unsigned:
            raise UnverifiedRecordingError(
                "Replayer without a signing key would hand unverified "
                "recordings to torch.export.load; pass key=... or opt in "
                "with allow_unsigned=True")
        self._key = key
        self._allow_unsigned = allow_unsigned
        self._enforce_topology = enforce_topology
        self.device = resolve_device(device)
        self._loaded = {}   # name -> {signature: _Variant}
        self._fast = {}     # name -> _Variant, sole-variant names only,
        #                     pinned after the first validated execute()
        self.stats = {"loads": 0, "executions": 0, "rejected": 0,
                      "fast_hits": 0, "slow_validations": 0,
                      "graph_replays": 0, "captures": 0}

    def load(self, path_or_bytes, name: Optional[str] = None):
        try:
            if isinstance(path_or_bytes, (bytes, bytearray)):
                rec = Recording.from_bytes(
                    bytes(path_or_bytes), self._key,
                    allow_unsigned=self._allow_unsigned)
            else:
                rec = Recording.load(path_or_bytes, self._key,
                                     allow_unsigned=self._allow_unsigned)
        except TamperedRecordingError:
            self.stats["rejected"] += 1
            raise
        if rec.manifest.get("exec_fingerprint") != fingerprint(rec.payload):
            self.stats["rejected"] += 1
            raise TamperedRecordingError("payload fingerprint mismatch")
        here = topology_fingerprint(self.device)
        if self._enforce_topology and rec.manifest["topology"] != here:
            self.stats["rejected"] += 1
            raise TopologyMismatchError(
                "recording was made for different hardware "
                f"({rec.manifest['topology'][:12]}... vs {here[:12]}...)")
        try:
            in_spec, out_spec = (pytree.treespec_loads(s)
                                 for s in json.loads(rec.trees))
        except Exception as e:
            self.stats["rejected"] += 1
            raise TamperedRecordingError(f"unparseable trees: {e}")
        program = torch.export.load(io.BytesIO(rec.payload)).module()
        nm = name or rec.manifest["name"]
        # the signature is the cache key, so every execute() validates by
        # construction
        sig = tuple((tuple(i["shape"]), i["dtype"])
                    for i in rec.manifest["inputs"])
        self._loaded.setdefault(nm, {})[sig] = _Variant(
            program, rec.manifest, in_spec, out_spec)
        # the name may now be multi-variant, which must dispatch by
        # signature: drop its fast-path pin
        self._fast.pop(nm, None)
        self.stats["loads"] += 1
        return nm

    def preload(self, items) -> list:
        """Load many recordings up front (paths, or (path, name) pairs) so
        the serving pipeline never loads mid-decode."""
        names = []
        for it in items:
            path, name = it if isinstance(it, tuple) else (it, None)
            names.append(self.load(path, name))
        return names

    def manifest(self, name: str, signature: Optional[tuple] = None) -> dict:
        """Manifest of a loaded recording; with several variants loaded
        under ``name`` the caller must pass the ``signature`` of one."""
        variants = self._loaded[name]
        if signature is not None:
            try:
                return variants[signature].manifest
            except KeyError:
                raise ReplayArgumentError(
                    f"no variant of '{name}' with signature "
                    f"{self._describe(signature)}") from None
        if len(variants) != 1:
            raise ReplayArgumentError(
                f"'{name}' has {len(variants)} loaded variants; pass "
                "signature=... to pick one (or use manifests())")
        return next(iter(variants.values())).manifest

    def manifests(self, name: str) -> list:
        """Manifests of every loaded variant of ``name`` (load order)."""
        return [v.manifest for v in self._loaded[name].values()]

    def execute(self, name: str, *args) -> Any:
        """Run the recorded program on new inputs.  The signature lookup
        doubles as the shape/dtype validation; once a sole-variant name
        has validated one call, later calls take the pinned fast path.
        A batch dict is taken in any key order (``jax_arg_order``)."""
        args = jax_arg_order(args)
        v = self._fast.get(name)
        if v is not None:
            self.stats["fast_hits"] += 1
            self.stats["executions"] += 1
            return v.run(args, self.stats)
        variants = self._loaded[name]
        sig = _aval_signature(pytree.tree_leaves(args))
        v = variants.get(sig)
        if v is None:
            known = "\n  ".join(self._diff(sig, s) for s in variants)
            raise ReplayArgumentError(
                f"replay args for '{name}' match no recorded program.\n"
                f"got:      {self._describe(sig)}\n"
                f"recorded: {known}")
        self.stats["slow_validations"] += 1
        self.stats["executions"] += 1
        if len(variants) == 1:
            self._fast[name] = v
        return v.run(args, self.stats)

    def warm(self, name: str):
        """Execute every variant of ``name`` once on zero-filled inputs
        (outputs discarded), which builds its kernels; on a CUDA device
        the run goes on a side stream, as ``torch.cuda.graphs`` asks
        before a capture, and the variant is captured as a CUDA graph at
        its next ``execute``."""
        cuda = self.device.type == "cuda"
        for sig, v in self._loaded[name].items():
            leaves = [torch.zeros(shape, dtype=getattr(torch, dt),
                                  device=self.device) for shape, dt in sig]
            args, kwargs = pytree.tree_unflatten(leaves, v.in_spec)
            if cuda:
                here = torch.cuda.current_stream(self.device)
                side = torch.cuda.Stream(device=self.device)
                side.wait_stream(here)
                with torch.cuda.stream(side):
                    v.program(*args, **kwargs)
                here.wait_stream(side)
                v.armed = True
            else:
                v.program(*args, **kwargs)
            self.stats["executions"] += 1
        return name

    def quote(self, keys, name: str, *, head: dict,
              recording_key: Optional[str] = None) -> dict:
        """Replay attestation quote for a loaded recording: binds the
        registry key, the verified program fingerprint (the manifest's
        ``exec_fingerprint``, the log leaf's ``payload_digest``) and how
        many executions this replayer has served, against the signed
        tree head the recording was fetched under.  (Plan-level replays
        quote through ``PlanExecutor.quote``, which also binds the
        compacted plan and the committed write frontier.)"""
        from repro_torch.attest.quote import build_quote
        manifests = self.manifests(name)
        return build_quote(
            keys, recording_key=recording_key or name,
            exec_fingerprint=manifests[0].get("exec_fingerprint", ""),
            plan_fingerprint="",
            frontier_digest=fingerprint({
                "executions": self.stats["executions"],
                "loads": self.stats["loads"]}),
            head=head, annotations={"variants": len(self._loaded[name])})

    def captured_launches(self, name: str) -> dict:
        """{kernel: launches} one graph replay of ``name`` makes ({} for
        a variant not captured); with several variants, their sum."""
        total: dict = {}
        for v in self._loaded[name].values():
            for k, n in v.launches.items():
                total[k] = total.get(k, 0) + n
        return total

    @staticmethod
    def _describe(sig) -> str:
        short = [f"{dt}{list(shape)}" for shape, dt in sig[:6]]
        more = f" ... +{len(sig) - 6} leaves" if len(sig) > 6 else ""
        return ", ".join(short) + more

    @staticmethod
    def _diff(got, want) -> str:
        """Describe a recorded signature, pointing at the first leaf that
        disagrees with ``got``."""
        if len(got) != len(want):
            return (f"{Replayer._describe(want)}  "
                    f"[{len(want)} leaves, got {len(got)}]")
        for i, (g, w) in enumerate(zip(got, want)):
            if g != w:
                return (f"{Replayer._describe(want)}  [first mismatch at "
                        f"leaf {i}: got {g[1]}{list(g[0])}, recorded "
                        f"{w[1]}{list(w[0])}]")
        return Replayer._describe(want)

    def __contains__(self, name: str) -> bool:
        return name in self._loaded


__all__ = ["Replayer", "ReplayArgumentError"]
