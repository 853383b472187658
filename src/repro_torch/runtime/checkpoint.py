"""Fault-tolerant checkpointing: content-addressed chunks + metastate
manifest (the paper's metastate/program-data split applied to persistence).

Counterpart of ``repro/runtime/checkpoint.py``, on the port's own
``core/metasync.py``:

* Program data (weights, moments) -> write-once chunks keyed by content
  hash: unchanged tensors across steps cost nothing (dedup), partial writes
  are harmless (manifest commits atomically last).
* Metastate (step, data cursor) -> inline in the manifest.
* ``async_save`` runs serialization off-thread; ``save`` is atomic via
  tempfile + rename.

A chunk is the ``np.save`` bytes of a leaf (a bf16 tensor as the
reference's bf16 array saves, ``metasync._pack_leaf``), and leaves come in
JAX's order with JAX's path strings, so the same state gives the
reference's chunk hashes and manifest byte for byte.  The reference
stacks each stage's blocks on a leading axis where the port keeps one
tensor per block: ``to_reference_layout`` stacks a port tree into the
reference's layout before a save and ``from_reference_layout`` splits it
again after a restore, so a checkpoint that either package writes
restores in the other.  A state of DTensors is saved whole (every rank
gathers each leaf; the caller lets one rank write), and
``restore_on_mesh`` places a restored state on any mesh through
``runtime.elastic.reshard_state``: chunks hold whole logical arrays, so
a checkpoint restores onto a mesh of another shape than it was saved
from.
"""
from __future__ import annotations

import hashlib
import io
import json
import os
import tempfile
import threading
from typing import Dict, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch import resolve_device
from repro_torch.core import metasync
from repro_torch.core.recorder import dtype_name
from repro_torch.models import layers as L
from repro_torch.models import model as M


# a leaf's np.save bytes, bf16 as the reference's bf16 arrays save
_chunk_bytes = metasync._pack_leaf


def _host(x):
    """A leaf as a host copy that later device work cannot change (a
    DTensor gathered whole first: a collective every rank must join)."""
    if isinstance(x, torch.Tensor):
        if hasattr(x, "full_tensor"):
            x = x.full_tensor()
        return x.detach().to("cpu", copy=True)
    return np.array(x, copy=True)


class CheckpointStore:
    def __init__(self, root: str):
        self.root = root
        os.makedirs(os.path.join(root, "chunks"), exist_ok=True)
        self._pending: Optional[threading.Thread] = None
        self.stats = {"chunks_written": 0, "chunks_deduped": 0,
                      "bytes_written": 0}

    # ----------------------------------------------------------- writing --
    def _write_chunk(self, arr) -> str:
        blob = _chunk_bytes(arr)
        h = hashlib.sha256(blob).hexdigest()[:32]
        path = os.path.join(self.root, "chunks", h + ".npy")
        if not os.path.exists(path):
            with tempfile.NamedTemporaryFile(
                    dir=os.path.dirname(path), delete=False) as f:
                f.write(blob)
            os.replace(f.name, path)
            self.stats["chunks_written"] += 1
            self.stats["bytes_written"] += len(blob)
        else:
            self.stats["chunks_deduped"] += 1
        return h

    def save(self, state, step: int, extra_meta: Optional[Dict] = None):
        """Blocking atomic save of a tree of tensors or numpy arrays."""
        meta, data = metasync.split(state)
        manifest = {
            "step": step,
            "meta": {p: {"data": _chunk_bytes(v).hex()}
                     for p, v in meta.items()},
            "data": {},
            "extra": extra_meta or {},
        }
        for path, arr in data.items():
            h = self._write_chunk(arr)
            manifest["data"][path] = {
                "hash": h, "shape": list(arr.shape),
                "dtype": dtype_name(arr)}
        mpath = os.path.join(self.root, f"manifest_{step:08d}.json")
        with tempfile.NamedTemporaryFile("w", dir=self.root,
                                         delete=False) as f:
            json.dump(manifest, f)
        os.replace(f.name, mpath)   # atomic commit point
        return mpath

    def async_save(self, state, step: int, extra_meta=None):
        """Snapshot on the caller thread (a host copy), serialize on a
        background thread — training continues immediately."""
        host_state = pytree.tree_map(_host, state)
        self.wait()
        t = threading.Thread(target=self.save,
                             args=(host_state, step, extra_meta))
        t.start()
        self._pending = t
        return t

    def wait(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    # ----------------------------------------------------------- reading --
    def latest_step(self) -> Optional[int]:
        steps = [int(f[len("manifest_"):-5]) for f in os.listdir(self.root)
                 if f.startswith("manifest_")]
        return max(steps) if steps else None

    def restore(self, state_like, step: Optional[int] = None):
        """Rebuild the state tree (numpy leaves) from a manifest;
        ``state_like`` (meta tensors will do) gives its structure."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError("no checkpoint manifests in " + self.root)
        with open(os.path.join(self.root, f"manifest_{step:08d}.json")) as f:
            manifest = json.load(f)
        meta = {p: np.load(io.BytesIO(bytes.fromhex(d["data"])),
                           allow_pickle=False)
                for p, d in manifest["meta"].items()}
        data = {}
        for path, d in manifest["data"].items():
            with open(os.path.join(self.root, "chunks",
                                   d["hash"] + ".npy"), "rb") as f:
                data[path] = np.load(f, allow_pickle=False)
        return metasync.merge(state_like, meta, data), manifest

    def gc(self, keep_last: int = 2):
        steps = sorted([int(f[len("manifest_"):-5])
                        for f in os.listdir(self.root)
                        if f.startswith("manifest_")])
        keep = set(steps[-keep_last:])
        live = set()
        for s in keep:
            with open(os.path.join(self.root, f"manifest_{s:08d}.json")) as f:
                live |= {d["hash"] for d in json.load(f)["data"].values()}
        for s in steps:
            if s not in keep:
                os.remove(os.path.join(self.root, f"manifest_{s:08d}.json"))
        for c in os.listdir(os.path.join(self.root, "chunks")):
            if c[:-4] not in live:
                os.remove(os.path.join(self.root, "chunks", c))


# ----------------------------------------------------------- layouts ----
def to_reference_layout(tree, host: bool = True):
    """A tree holding the port's parameter trees (a train state, or params)
    in the reference's layout: under ``"stages"`` each stage's list of
    blocks is stacked leaf by leaf on a new axis 0 (unless it holds one
    block), and so is every list inside a block (zamba2's ``mambas``,
    xLSTM's ``m``).  ``host``: leaves become host copies (for a save);
    otherwise they stay where they are (meta tensors stay meta, which
    gives ``restore`` a structure for free)."""
    leaf = _host if host else (lambda t: t)

    def stack(xs):
        return torch.stack(xs) if isinstance(xs[0], torch.Tensor) \
            else np.stack(xs)

    def stacked(items):
        items = [conv(x) for x in items]
        if len(items) == 1:
            return items[0]
        return pytree.tree_map(lambda *xs: stack(xs), items[0], *items[1:])

    def conv(node):
        if isinstance(node, dict):
            return {k: [stacked(s) for s in v] if k == "stages" else conv(v)
                    for k, v in node.items()}
        if isinstance(node, list):
            return stacked(node)
        return leaf(node)
    return conv(tree)


def from_reference_layout(cfg, tree, device="cuda"):
    """``to_reference_layout``'s inverse for a train state (or any dict
    whose dict values are parameter trees of ``cfg``'s schema): tensors on
    ``device`` in the stored dtypes."""
    device = resolve_device(device)
    schema = M.model_schema(cfg)

    def tensor(arr):
        return torch.from_numpy(np.array(arr)).to(device)

    def walk(s, sub, idx=()):
        if isinstance(s, L.ParamSpec):
            return tensor(np.asarray(sub)[idx] if idx else sub)
        if isinstance(s, list):
            return [walk(c, sub, idx + ((i,) if len(s) > 1 else ()))
                    for i, c in enumerate(s)]
        return {k: walk(c, sub[k], idx) for k, c in s.items()}

    def params(t):
        return {name: [walk(b, js) for b, js in zip(sch, t["stages"])]
                if name == "stages" else walk(sch, t[name])
                for name, sch in schema.items()}
    return {k: params(v) if isinstance(v, dict) else tensor(v)
            for k, v in tree.items()}


def restore_on_mesh(store: CheckpointStore, cfg, mesh, mode: str = "train",
                    step: Optional[int] = None):
    """-> (train state of DTensors on ``mesh``, manifest): the store's
    checkpoint (written by either package, in the reference's layout)
    placed by ``runtime.elastic.reshard_state`` under
    ``rules_for(mode)``."""
    from repro_torch.runtime.elastic import reshard_state
    from repro_torch.training.steps import (abstract_train_state,
                                            train_state_axes)
    state_np, manifest = store.restore(
        to_reference_layout(abstract_train_state(cfg), host=False), step)
    return reshard_state(state_np, train_state_axes(cfg), mesh, mode,
                         cfg=cfg), manifest


__all__ = ["CheckpointStore", "to_reference_layout", "from_reference_layout",
           "restore_on_mesh"]
