"""Metastate-only synchronization (paper §5).

Counterpart of ``repro/core/metasync.py``: the same split, the same path
strings and the same wire bytes, on ``torch.utils._pytree``.

The paper synchronizes only GPU *metastate* (commands, shaders, job
descriptors) between the distributed driver and GPU — never program data —
and ships compressed deltas between consecutive sync points.

Here the same split governs every cross-host/persistence path:
  * metastate    — step counters, positions, RNG keys, page tables, done
                   masks, sampler state, schedules: small, integer-ish,
                   latency-critical;
  * program data — weights, optimizer moments, KV pages, activations: big,
                   bandwidth-bound, moved by collectives / chunk store only.

``split``/``merge`` partition a pytree; ``DeltaSync`` ships only changed
leaves, zlib-compressed (the paper's range-coder + delta, §5).

Two things differ from JAX and are evened out here, because the wire
bytes depend on them: JAX flattens a dict in sorted key order and treats
``None`` as an empty subtree, where torch's pytree keeps insertion order
and makes ``None`` a leaf; and numpy has no bfloat16, so a bf16 tensor
leaf is saved as the reference's bf16 JAX array is, raw 2-byte elements
under the ``'<V2'`` descr (it loads back as a ``V2`` array in both).
"""
from __future__ import annotations

import hashlib
import io
import re
import zlib
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.core import _msgpack

META_MAX_ELEMS = 4096     # leaves larger than this are program data
_META_HINTS = ("pos", "step", "rng", "page", "done", "length", "count",
               "slot", "id", "mask")
_TOKEN_SPLIT = re.compile(r"[^a-z0-9]+")


def _path_tokens(path: str) -> Tuple[str, ...]:
    """Split a keystr path into name tokens: ``['hidden_mask'][0]`` ->
    ('hidden', 'mask', '0').  Hints match whole tokens (plural allowed),
    never substrings — ``"id" in "hidden"`` must not classify a weight
    leaf as metastate."""
    return tuple(t for t in _TOKEN_SPLIT.split(path.lower()) if t)


def _size_and_intlike(leaf) -> Tuple[int, bool]:
    """(elements, integer or bool dtype) without moving a tensor to the
    host."""
    if isinstance(leaf, torch.Tensor):
        dt = leaf.dtype
        return leaf.numel(), not (dt.is_floating_point or dt.is_complex)
    arr = np.asarray(leaf)
    return arr.size, (np.issubdtype(arr.dtype, np.integer)
                      or arr.dtype == np.bool_)


def is_metastate(path: str, leaf) -> bool:
    if any(t in _META_HINTS or t.rstrip("s") in _META_HINTS
           for t in _path_tokens(path)):
        return True
    size, intlike = _size_and_intlike(leaf)
    if intlike:
        return size <= META_MAX_ELEMS * 64
    return size <= META_MAX_ELEMS


def _jax_order(flat: List[tuple], depth: int = 0) -> List[tuple]:
    """Reorder torch's ``tree_flatten_with_path`` leaves into JAX's order:
    the children of every dict level sorted by key, every other node's in
    its own order."""
    if len(flat) == 1 and len(flat[0][0]) == depth:
        return flat
    groups: Dict[Any, List[tuple]] = {}
    for kp, leaf in flat:
        groups.setdefault(kp[depth], []).append((kp, leaf))
    keys = list(groups)
    if all(isinstance(k, pytree.MappingKey) for k in keys):
        keys.sort(key=lambda k: k.key)
    return [item for k in keys for item in _jax_order(groups[k], depth + 1)]


def _paths(tree) -> Dict[str, Any]:
    flat = [(kp, v) for kp, v in pytree.tree_flatten_with_path(tree)[0]
            if v is not None]
    return {pytree.keystr(kp): v for kp, v in _jax_order(flat)}


def split(tree) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """tree -> (metastate dict, program-data dict), both path-keyed."""
    meta, data = {}, {}
    for path, leaf in _paths(tree).items():
        (meta if is_metastate(path, leaf) else data)[path] = leaf
    return meta, data


def merge(tree_like, meta: Dict[str, Any], data: Dict[str, Any]):
    """Rebuild a pytree with the same structure from the two halves."""
    flat, treedef = pytree.tree_flatten_with_path(tree_like)
    out = []
    for kp, old in flat:
        path = pytree.keystr(kp)
        out.append(meta.get(path, data.get(path, old)))
    return pytree.tree_unflatten(out, treedef)


def _pack_leaf(v) -> bytes:
    buf = io.BytesIO()
    if isinstance(v, torch.Tensor):
        t = v.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            np.lib.format.write_array_header_1_0(buf, {
                "descr": "<V2", "fortran_order": False,
                "shape": tuple(t.shape)})
            buf.write(t.view(torch.int16).numpy().tobytes())
            return buf.getvalue()
        v = t.numpy()
    np.save(buf, np.asarray(v), allow_pickle=False)
    return buf.getvalue()


def _unpack_leaf(b: bytes):
    return np.load(io.BytesIO(b), allow_pickle=False)


def _digest(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()[:16]


class DeltaSync:
    """Delta + compression sync of a path-keyed metastate dict."""

    def __init__(self):
        self._last: Dict[str, str] = {}
        self.stats = {"syncs": 0, "bytes_raw": 0, "bytes_wire": 0,
                      "leaves_sent": 0, "leaves_skipped": 0}

    def pack(self, meta: Dict[str, Any]) -> bytes:
        changed = {}
        for path, leaf in meta.items():
            blob = _pack_leaf(leaf)
            d = _digest(blob)
            self.stats["bytes_raw"] += len(blob)
            if self._last.get(path) != d:
                changed[path] = blob
                self._last[path] = d
                self.stats["leaves_sent"] += 1
            else:
                self.stats["leaves_skipped"] += 1
        wire = zlib.compress(_msgpack.packb(changed), 6)
        self.stats["syncs"] += 1
        self.stats["bytes_wire"] += len(wire)
        return wire

    @staticmethod
    def unpack(wire: bytes, base: Dict[str, Any]) -> Dict[str, Any]:
        changed = _msgpack.unpackb(zlib.decompress(wire))
        out = dict(base)
        for path, blob in changed.items():
            out[path] = _unpack_leaf(blob)
        return out


def full_pack(tree) -> bytes:
    """Naive baseline: ship EVERYTHING (paper's 'Naive' MemSync column)."""
    blobs = {p: _pack_leaf(v) for p, v in _paths(tree).items()}
    return zlib.compress(_msgpack.packb(blobs), 1)


__all__ = ["META_MAX_ELEMS", "is_metastate", "split", "merge", "DeltaSync",
           "full_pack"]
