"""DTensor sharding strategies of the custom ops: the helpers.

Each kernel module lists its ops' strategies in ``SHARDING`` as (op name,
function) pairs.  A function takes the op's arguments (a ``DTensorSpec``
for each tensor) and returns the rows of
``torch.distributed.tensor.experimental.register_sharding``: for one mesh
dim, (output placements, input placements) under which calling the kernel
on every rank's local shards gives each rank its shard of the global
result.  DTensor expands the rows over every mesh dim, drops a combination
that splits a dim into more parts than it has, redistributes any other
input layout to the cheapest row, and calls the kernel (its CUDA launch
on the card) on the local shards.  The last row is all ``Replicate``.

``register`` registers every strategy once, on the first mesh or
placement the port makes (``launch/mesh.py``, ``sharding.py``), so that
importing the kernels does not import ``torch.distributed.tensor``.
"""
from __future__ import annotations

import importlib
import itertools

# the kernel modules, in registration order
MODULES = ("rmsnorm", "flash_attention", "decode_attention", "moe_gmm",
           "mamba_scan", "mlstm")
# elementwise aten ops the model differentiates that DTensor has no
# strategy for (xLSTM's forget gate, F.logsigmoid): every input and the
# output split alike
ATEN_ELEMENTWISE = ("log_sigmoid_backward",)
_done = False


def placement_types():
    """(Shard, Replicate(), Partial()) of ``torch.distributed.tensor``."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    return Shard, Replicate(), Partial()


def replicated(n_out: int, args) -> tuple:
    """The all-``Replicate`` row: ``n_out`` outputs, one entry per
    argument (None for an argument that is not a tensor)."""
    _, R, _ = placement_types()
    return ([R] * n_out, [R if is_spec(a) else None for a in args])


def is_spec(a) -> bool:
    return hasattr(a, "placements")


def splits_evenly(mesh, *counts: int) -> bool:
    """Whether every split DTensor could make of dims of these sizes over
    a product of ``mesh``'s dims is even.  A split into more parts than
    the smallest count is dropped by DTensor (a dim of n splits into at
    most n parts), so only the products up to it are checked.  A head
    split of attention needs this: local q head i reads kv head i // G of
    the local K/V only when q's H and k's Hkv are split into the same
    number of equal parts."""
    prods = {1}
    for size in mesh.mesh.shape:
        prods |= {p * int(size) for p in prods}
    lim = min(counts)
    return all(n % p == 0 for n, p in itertools.product(counts, prods)
               if p <= lim)


def register() -> None:
    """Register every custom op's strategy with DTensor (idempotent)."""
    global _done
    if _done:
        return
    import torch
    from torch.distributed.tensor.experimental import register_sharding

    for name, fn in strategies():
        register_sharding(getattr(torch.ops.repro_torch, name).default)(fn)
    for name in ATEN_ELEMENTWISE:
        register_sharding(getattr(torch.ops.aten, name).default)(_elementwise)
    # torch 2.11 has no strategy for these (cumsum's backward flips; a
    # sliding window's prefill rolls its ring cache)
    for op, fn in ((torch.ops.aten.flip.default, _flip),
                   (torch.ops.aten.roll.default, _roll)):
        if not _has_strategy(op):
            register_sharding(op)(fn)
    _done = True


def _has_strategy(op) -> bool:
    from torch.distributed.tensor import DTensor
    prop = DTensor._op_dispatcher.sharding_propagator
    return any(op in getattr(prop, table, {}) for table in (
        "op_strategy_funcs", "op_to_rules",
        "op_single_dim_strategy_funcs"))


def _kept_dims(x, moved, *args):
    """Rows splitting ``x`` and the output alike on any dim not in
    ``moved`` (the flipped or rolled dims), then the replicate row."""
    S, _, _ = placement_types()
    moved = {d % x.ndim for d in moved}
    return [([S(d)], [S(d)] + [None] * len(args)) for d in range(x.ndim)
            if d not in moved] + [replicated(1, (x,) + args)]


def _flip(x, dims):
    return _kept_dims(x, dims, dims)


def _roll(x, shifts, *dims):
    """``dims`` as the op was called (absent: the default ``[]``, a roll
    of the flattened tensor, which no split keeps)."""
    return _kept_dims(x, (dims and dims[0]) or range(x.ndim), shifts, *dims)


def _elementwise(*args):
    """Every tensor argument and the output split on the same dim."""
    S, _, _ = placement_types()
    ndim = next(a.ndim for a in args if is_spec(a))
    return [([S(d)], [S(d) if is_spec(a) else None for a in args])
            for d in range(ndim)] + [replicated(1, args)]


def strategies() -> tuple:
    """(op name, strategy) of every custom op, in registration order."""
    return tuple(pair for mod in MODULES for pair in importlib.import_module(
        f"repro_torch.kernels.{mod}").SHARDING)


__all__ = ["placement_types", "replicated", "is_spec", "splits_evenly",
           "register", "strategies", "MODULES"]
