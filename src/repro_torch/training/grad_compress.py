"""Int8 error-feedback gradient compression.

Counterpart of ``repro/training/grad_compress.py``:

1. ``make_ef_int8_transform``: a ``grad_transform`` hook for
   ``make_train_step`` that quantizes every grad leaf to int8 (per-leaf
   max scaling) with the residual carried in an error-feedback buffer
   (Karimireddy et al. style), so the update math matches what a
   compressed-collective deployment computes.  On a DTensor grad the
   scale is the max over every shard, as under the reference's jit.

2. ``compressed_psum``: the data-parallel all-reduce with int8 on the
   wire: quantize -> ``all_to_all_single`` of the int8 chunks over the
   mesh's ``axis`` group (and an all-gather of the fp32 scales) -> the
   local fp32 sum -> requantize -> all-gather of the int8.  Wire bytes per
   rank: 2 x S x (n-1)/n x 1 B against 4 B for an fp32 ring all-reduce.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils import _pytree as pytree


def _quant(x: torch.Tensor):
    scale = x.abs().max()
    if hasattr(scale, "full_tensor"):   # a DTensor: the max of every shard
        scale = scale.full_tensor()
    scale = torch.clamp_min(scale, 1e-8) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequant(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def make_ef_int8_transform():
    """grad_transform(grads, state) -> (decompressed grads, state') with
    an error-feedback buffer stored in state['ef']."""

    @torch.no_grad()
    def transform(grads, state):
        ef = state.get("ef")
        if ef is None:
            ef = pytree.tree_map(
                lambda g: torch.zeros_like(g, dtype=torch.float32), grads)

        def one(g, e):
            v = g.float() + e
            d = _dequant(*_quant(v))
            return d.to(g.dtype), v - d

        flat_g, spec = pytree.tree_flatten(grads)
        out = [one(g, e) for g, e in zip(flat_g, pytree.tree_leaves(ef))]
        state = dict(state)
        state["ef"] = pytree.tree_unflatten([o[1] for o in out], spec)
        return pytree.tree_unflatten([o[0] for o in out], spec), state

    return transform


def _all_gather(t: torch.Tensor, n: int, group) -> torch.Tensor:
    out = t.new_empty(n * t.numel())
    dist.all_gather_into_tensor(out, t.reshape(-1).contiguous(), group=group)
    return out.reshape((n,) + tuple(t.shape))


def compressed_psum(x: torch.Tensor, mesh, axis: str = "data"):
    """int8-on-the-wire all-reduce of ``x`` over the mesh axis ``axis``
    (reduce-scatter then all-gather, both in int8, with fp32 local
    accumulation).  ``x`` is this rank's whole local tensor, as the
    reference's shard_map with a replicated spec hands each device its
    copy; every rank of the axis gets the same result, in fp32.  A flat
    length that the axis size does not divide is zero-padded as the
    reference pads it."""
    group = mesh.get_group(axis)
    n = mesh.size(list(mesh.mesh_dim_names).index(axis))
    flat = x.reshape(-1).float()
    pad = (-flat.numel()) % n
    chunks = F.pad(flat, (0, pad)).reshape(n, -1)
    q, s = _quant(chunks)
    qt = torch.empty_like(q)               # chunk i goes to rank i
    dist.all_to_all_single(qt, q, group=group)
    st = _all_gather(s, n, group)          # the senders' scales
    partial_sum = _dequant(qt, st[:, None]).sum(0)
    q2, s2 = _quant(partial_sum)
    gathered = _all_gather(q2, n, group)   # [n, chunk] int8
    s2g = _all_gather(s2, n, group)
    full = _dequant(gathered, s2g[:, None]).reshape(-1)
    return full[:x.numel()].reshape(x.shape)


__all__ = ["make_ef_int8_transform", "compressed_psum"]
