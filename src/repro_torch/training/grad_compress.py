"""Int8 error-feedback gradient compression.

Counterpart of ``make_ef_int8_transform`` in
``repro/training/grad_compress.py``: a ``grad_transform`` hook for
``make_train_step`` that quantizes every grad leaf to int8 (per-leaf max
scaling) with the residual carried in an error-feedback buffer
(Karimireddy et al. style), so the update math matches what a
compressed-collective deployment computes.  The reference's
``compressed_psum`` moves int8 over a mesh of several devices; it waits
for the sharding slice (ROADMAP Queue 1, item 15).
"""
from __future__ import annotations

import torch
from torch.utils import _pytree as pytree


def _quant(x: torch.Tensor):
    scale = torch.clamp_min(x.abs().max(), 1e-8) / 127.0
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


__all__ = ["make_ef_int8_transform"]
