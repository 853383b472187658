"""Int8 weight quantization for serving.

Counterpart of ``repro/serving/quant.py``.  Decode reads every weight for
every token, so storing the big matrix weights as int8 with one fp32
scale per output channel (the last axis) halves their bytes against bf16
and halves resident weight memory.  The model dequantizes them one block
at a time (``models/model.py:_maybe_dequant``), so only one layer's
weights are bf16 at once; the products then run in plain PyTorch on the
dequantized block (the reference leaves the same dequantize to XLA).

A quantized leaf becomes ``{"q": int8, "s": fp32 [..., 1]}``, with
``s = max(|w|) / 127`` over the last axis and ``q = round(w / s)`` (both
libraries round half to even), so the values and the scales equal the
reference's bit for bit.  Norm scales, small tensors and fp32 leaves stay
as they are.

The reference decides quantizability on its stacked layout: a stage's
blocks share one leaf with a leading layer axis (and a group's blocks a
second one).  The port keeps one tensor per block, so each function here
tracks the stacks a leaf sits in (every list of more than one block is
one) and decides on the stacked shape: a port leaf is quantized exactly
where the reference's stacked leaf is, with the same per-row scales.

Each function takes a ``ParamTree`` (``models/layers.py``) or the nested
dicts/lists of tensors ``layers.to_tree`` gives, and returns the same
kind; ``dequantize`` returns nested dicts/lists.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.models.layers import ParamTree, to_module

QUANT_MIN_SIZE = 1 << 14   # only quantize big matmul weights


def _is_quantizable(leaf, stack: tuple = ()) -> bool:
    """A bf16 leaf whose stacked form (``stack``: the sizes of the stacks
    it sits in) has two axes or more and ``QUANT_MIN_SIZE`` elements."""
    return (isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16
            and leaf.dim() + len(stack) >= 2
            and leaf.numel() * math.prod(stack) >= QUANT_MIN_SIZE)


def _is_q(x) -> bool:
    """A quantized leaf: a dict (or ParamTree) of exactly ``q`` and ``s``."""
    if isinstance(x, dict):
        return set(x) == {"q", "s"}
    return isinstance(x, ParamTree) and set(x.keys()) == {"q", "s"}


def _map(fn, tree, stack=(), *others):
    """``fn(leaf, stack, *other leaves)`` over a tree of dicts, lists,
    ParamTrees and ModuleLists (and ``others`` of the same structure),
    rebuilt as nested dicts/lists; a quantized leaf is one leaf.  The
    list of stages is not a stack (each stage's list of blocks is)."""
    if _is_q(tree):
        return fn(tree, stack, *others)
    if isinstance(tree, (dict, ParamTree)):
        out = {}
        for k in tree.keys():
            sub = [o[k] for o in others]
            if k == "stages":
                out[k] = [_map(fn, st, stack, *(o[i] for o in sub))
                          for i, st in enumerate(tree[k])]
            else:
                out[k] = _map(fn, tree[k], stack, *sub)
        return out
    if isinstance(tree, (list, nn.ModuleList)):
        inner = stack + ((len(tree),) if len(tree) > 1 else ())
        return [_map(fn, t, inner, *(o[i] for o in others))
                for i, t in enumerate(tree)]
    return fn(tree, stack, *others)


def _like(params, tree):
    """``tree`` as a ParamTree where ``params`` is a module."""
    return to_module(tree) if isinstance(params, nn.Module) else tree


def _quantize(w: torch.Tensor) -> dict:
    """One leaf -> {"q": int8, "s": fp32 per-output-channel scale}."""
    f = w.float()
    s = f.abs().amax(-1, keepdim=True).clamp_min(1e-8) / 127.0
    q = torch.round(f / s).clamp(-127, 127).to(torch.int8)
    return {"q": q, "s": s}


def quantize_params(params):
    """Params -> the same tree where big bf16 leaves become
    {"q": int8, "s": fp32 per-output-channel scale} (last dim channels)."""
    def one(leaf, stack):
        return _quantize(leaf) if _is_quantizable(leaf, stack) else leaf
    return _like(params, _map(one, params))


def abstract_quantized(params_abstract):
    """Abstract params (meta tensors, ``model.abstract_params``) -> the
    quantized tree's shapes and dtypes, as meta tensors."""
    def one(leaf, stack):
        if not _is_quantizable(leaf, stack):
            return leaf
        return {"q": torch.empty(leaf.shape, dtype=torch.int8,
                                 device="meta"),
                "s": torch.empty(leaf.shape[:-1] + (1,),
                                 dtype=torch.float32, device="meta")}
    return _map(one, params_abstract)


def quantized_axes(params_axes, params_abstract):
    """The logical axes of the quantized tree: a quantized leaf's ``q``
    keeps its axes, its ``s`` drops the last one."""
    def one(ab, stack, ax):
        if _is_quantizable(ab, stack):
            return {"q": ax, "s": ax[:-1] + (None,)}
        return ax
    return _map(one, params_abstract, (), params_axes)


def has_quantized(tree) -> bool:
    """Whether any leaf of ``tree`` is quantized."""
    if _is_q(tree):
        return True
    if isinstance(tree, (dict, ParamTree)):
        return any(has_quantized(tree[k]) for k in tree.keys())
    if isinstance(tree, (list, nn.ModuleList)):
        return any(map(has_quantized, tree))
    return False


def dequantize(params_q, dtype=torch.bfloat16):
    """The inverse transform, ``q * s`` in fp32 cast to ``dtype``, as
    nested dicts/lists (the model runs it inside its loop over blocks)."""
    def one(x, stack):
        if _is_q(x):
            return (x["q"].float() * x["s"]).to(dtype)
        return x
    return _map(one, params_q)


__all__ = ["QUANT_MIN_SIZE", "quantize_params",
           "abstract_quantized", "quantized_axes", "has_quantized",
           "dequantize"]
