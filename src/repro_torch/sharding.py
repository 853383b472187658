"""Logical-axis sharding rules (DP / FSDP / TP / EP / SP) on DTensor.

Counterpart of ``repro/sharding.py``.  Params and activations carry
*logical* axis names; the rules resolve them to the physical axes of a
``torch.distributed.device_mesh.DeviceMesh`` per execution mode:

train:  batch/fsdp -> ('pod','data');  heads/ffn/vocab/experts -> 'model'
        (2D weight sharding: FSDP over the data axes + TP over model; the
        optimizer state is sharded the same way.)
train_zero: every mesh axis is batch DP; weights and optimizer state are
        sharded over all axes and gathered per op.
serve:  TP-dominant: weights sharded over 'model' only; the KV cache is
        sequence-sharded over 'model'; MoE expert weights also sharded over
        the data axes on d_model.

``rules_for`` and ``spec`` are the reference's, with a plain tuple (one
entry per tensor dim: None, a mesh axis name, or a tuple of names) in
place of a ``PartitionSpec``.  ``placements`` turns a spec into DTensor
placements, one per mesh dim: a tensor dim split over several mesh dims is
``Shard(d)`` on each, outer mesh dims first, which is JAX's major-to-minor
order of a tuple mapping.  ``constrain`` is the counterpart of
``with_sharding_constraint``: a DTensor is redistributed to the resolved
placements, anything else is returned as it is (the reference's no-op
outside jit or a mesh).
"""
from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch
from torch.utils import _pytree as pytree

DATA_AXES = ("pod", "data")  # flattened DP axes (pod may be absent)


def _dp(mesh_axes: Tuple[str, ...]):
    present = tuple(a for a in DATA_AXES if a in mesh_axes)
    return present if len(present) > 1 else (present[0] if present else None)


def rules_for(mode: str, mesh_axes: Tuple[str, ...], fsdp: bool = True) -> dict:
    dp = _dp(mesh_axes)
    tp = "model" if "model" in mesh_axes else None
    common = {
        "batch": dp, "seq": None, "embed": None, "heads": tp, "kv_heads": tp,
        "head_dim": None, "ffn": tp, "vocab": tp, "experts": tp,
        "expert_ffn": tp, "kv_lora": None, "ssm_inner": tp, "ssm_heads": tp,
        "ssm_state": None, "layers": None, "conv": None, "norm": None,
        "stack": None,
    }
    if mode == "train":
        common["fsdp"] = dp if fsdp else None      # 2nd weight dim
        common["seq"] = tp                         # Megatron-style SP
        common["kv_seq"] = None                    # KV == activations in train
        common["expert_embed"] = dp                # MoE 2D weight sharding
    elif mode == "train_zero":
        # ZeRO-3 pure data parallelism over every mesh axis
        allaxes = tuple(a for a in ("pod", "data", "model") if a in mesh_axes)
        common.update({
            "batch": allaxes, "seq": None, "heads": None, "kv_heads": None,
            "head_dim": None, "ffn": None, "expert_ffn": None,
            "ssm_inner": None, "ssm_heads": None,
            "fsdp": allaxes, "expert_embed": allaxes, "kv_seq": None,
        })
    elif mode == "serve":
        common["fsdp"] = None                      # no weight gathers at decode
        common["kv_seq"] = tp                      # SP: cache seq over model
        common["expert_embed"] = dp                # MoE 2D weight-stationary
    else:
        raise ValueError(f"unknown mode {mode}")
    return common


def spec(axes: Tuple[Optional[str], ...], rules: dict,
         shape: Optional[Tuple[int, ...]] = None,
         mesh_shape: Optional[dict] = None) -> tuple:
    """Resolve logical axes -> a spec tuple (the reference's PartitionSpec).

    With ``shape``/``mesh_shape``, any dim whose size is not divisible by
    the mapped mesh-axis product falls back to replication (e.g. kv_heads=2
    cannot shard over model=16), after dropping the trailing axes of a
    tuple mapping until the dim divides (batch 256 on ("pod","data",
    "model")=512 -> ("pod","data")=32)."""
    parts, used = [], set()
    for i, a in enumerate(axes):
        if a is None:
            parts.append(None)
            continue
        phys = rules.get(a)
        # one physical axis may appear only once in a spec
        key = tuple(phys) if isinstance(phys, tuple) else (phys,)
        if phys is None or any(k in used for k in key):
            parts.append(None)
            continue
        if shape is not None and mesh_shape is not None:
            nshard = 1
            for k in key:
                nshard *= mesh_shape.get(k, 1)
            while key and shape[i] % nshard:
                nshard //= mesh_shape.get(key[-1], 1)
                key = key[:-1]
            if not key or shape[i] % nshard:
                parts.append(None)
                continue
            phys = key if len(key) > 1 else key[0]
        used.update(key)
        parts.append(phys)
    return tuple(parts)


def mesh_shape_of(mesh) -> dict:
    """{axis name: size} of a DeviceMesh."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def placements(sp: tuple, mesh) -> tuple:
    """DTensor placements (one per mesh dim) of the spec tuple ``sp``.  A
    mesh axis the spec does not name is ``Replicate``; a tensor dim mapped
    to a tuple of axes is ``Shard`` on each of them, which splits it outer
    mesh dim first, so the tuple must list the axes in the mesh's order
    (JAX's major-to-minor order of the same tuple)."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(sp):
        if entry is None:
            continue
        key = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(k) for k in key if k in names]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} is not in the mesh's axis "
                             f"order {names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def is_axes(x) -> bool:
    """A logical-axes tuple (the leaves of an axes tree)."""
    return isinstance(x, tuple) and all(
        isinstance(e, (str, type(None))) for e in x)


def shardings_for(axes_tree, abstract_tree, mesh, rules: dict):
    """Divisibility-checked placements for every leaf of ``abstract_tree``
    (tensors or anything with a ``.shape``), in its structure."""
    from repro_torch.kernels import _sharding
    _sharding.register()
    ms = mesh_shape_of(mesh)
    flat_ax = pytree.tree_flatten(axes_tree, is_leaf=is_axes)[0]
    flat_ab, tdef = pytree.tree_flatten(abstract_tree)
    assert len(flat_ax) == len(flat_ab), (len(flat_ax), len(flat_ab))
    out = [placements(spec(a, rules, tuple(v.shape), ms), mesh)
           for a, v in zip(flat_ax, flat_ab)]
    return pytree.tree_unflatten(out, tdef)


def tree_specs(axes_tree, rules: dict):
    """The spec of every leaf of an axes tree, with no shapes (no
    divisibility fallback)."""
    return pytree.tree_map(lambda ax: spec(ax, rules), axes_tree,
                           is_leaf=is_axes)


def tree_shardings(axes_tree, mesh, rules: dict):
    """``tree_specs`` as placements on ``mesh``."""
    return pytree.tree_map(lambda ax: placements(spec(ax, rules), mesh),
                           axes_tree, is_leaf=is_axes)


_meshes: list = []


@contextlib.contextmanager
def set_mesh(mesh):
    """Activate ``mesh`` (the reference's ``jax.set_mesh``): ``constrain``
    places on it, and a plain tensor that meets a DTensor in an op counts
    as replicated over it (``implicit_replication``), as a constant does
    under the reference's jit."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.kernels import _sharding
    _sharding.register()
    _meshes.append(mesh)
    try:
        with implicit_replication():
            yield mesh
    finally:
        _meshes.pop()


def current_mesh():
    """The innermost ``set_mesh``'s mesh, or None."""
    return _meshes[-1] if _meshes else None


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def mesh_of(tree):
    """The mesh of the first DTensor leaf of ``tree`` (params, a state or
    caches), or None when it holds none."""
    for leaf in pytree.tree_leaves(tree):
        if isinstance(leaf, torch.Tensor) and is_dtensor(leaf):
            return leaf.device_mesh
    return None


def to_mesh(x, mesh, rules: dict):
    """A plain tensor that every rank holds whole (a batch, tokens,
    positions) as a DTensor on ``mesh``, its leading dim on ``batch``;
    a DTensor or a non-tensor is returned as it is."""
    if not isinstance(x, torch.Tensor) or is_dtensor(x):
        return x
    from torch.distributed.tensor import DTensor, Replicate
    d = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                           run_check=False)
    return constrain(d, ("batch",) + (None,) * (x.ndim - 1), rules) \
        if x.ndim else d


def to_plain(tree):
    """Every DTensor leaf of ``tree`` as the whole tensor on this rank."""
    return pytree.tree_map(
        lambda t: t.full_tensor() if isinstance(t, torch.Tensor)
        and is_dtensor(t) else t, tree)


def replicate(x):
    """A DTensor whole on every rank (``Replicate`` on every mesh dim);
    anything else as it is."""
    if not (isinstance(x, torch.Tensor) and is_dtensor(x)):
        return x
    from torch.distributed.tensor import Replicate
    want = (Replicate(),) * x.device_mesh.ndim
    return x if tuple(x.placements) == want else \
        x.redistribute(x.device_mesh, want)


def pad(x, widths):
    """``F.pad(x, widths)`` with zeros; a DTensor is padded shard by
    shard, its padded dims gathered first where they are split.  (In
    torch 2.11 DTensor's own pad returns a tensor whose placements do not
    match its mesh.)"""
    import torch.nn.functional as F
    if not (isinstance(x, torch.Tensor) and is_dtensor(x)):
        return F.pad(x, widths)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    padded = {x.ndim - 1 - i // 2 for i, w in enumerate(widths) if w}
    whole = [Replicate() if isinstance(p, Shard) and p.dim in padded else p
             for p in x.placements]
    if whole != list(x.placements):
        x = x.redistribute(x.device_mesh, whole)
    shape = list(x.shape)
    for i, w in enumerate(widths):
        shape[x.ndim - 1 - i // 2] += w
    stride = [1] * len(shape)
    for d in range(len(shape) - 2, -1, -1):
        stride[d] = stride[d + 1] * shape[d + 1]
    return DTensor.from_local(F.pad(x.to_local(), widths), x.device_mesh,
                              x.placements, run_check=False,
                              shape=torch.Size(shape), stride=tuple(stride))


def rows_local(x, row_dims=(0, 1)):
    """(``x``'s local shard, its placements) with ``x``'s splits of
    ``row_dims`` kept and any other split, or partial sum, resolved
    first; the shard's gradient comes back at those placements.  With
    ``whole_local`` and ``from_rows``: a computation run on each rank's
    rows, outside DTensor's dispatch."""
    from torch.distributed.tensor import Replicate
    pl = tuple(p if any(p.is_shard(d) for d in row_dims) else Replicate()
               for p in x.placements)
    return x.redistribute(x.device_mesh, pl).to_local(grad_placements=pl), pl


def whole_local(w, pl):
    """``w`` whole on every rank, as a local tensor: its gradient is a
    partial sum over the mesh dims that split the rows (``pl``, from
    ``rows_local``) and whole over the others."""
    from torch.distributed.tensor import Partial, Replicate
    mesh = w.device_mesh
    return w.redistribute(mesh, [Replicate()] * mesh.ndim).to_local(
        grad_placements=[Replicate() if p.is_replicate() else Partial()
                         for p in pl])


def from_rows(y, mesh, pl, shape):
    """The DTensor of global ``shape`` whose rank-local rows are ``y``."""
    from torch.distributed.tensor import DTensor
    shape = torch.Size(shape)
    return DTensor.from_local(y, mesh, pl, run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta")
                              .stride())


def whole_dims(x, dims):
    """A DTensor gathered on every mesh dim that splits one of ``dims``
    (its other splits kept); anything else as it is."""
    if not (isinstance(x, torch.Tensor) and is_dtensor(x)):
        return x
    from torch.distributed.tensor import Replicate
    dims = {d % x.ndim for d in dims}
    want = tuple(Replicate() if p.is_shard() and p.dim in dims else p
                 for p in x.placements)
    return x if want == tuple(x.placements) else \
        x.redistribute(x.device_mesh, want)


def grad_like(x):
    """``x`` unchanged, but its gradient redistributed to ``x``'s own
    placements on the way back (a DTensor; anything else is returned as
    it is).  A product's backward views its output's gradient: one that
    arrives split on the sequence would flatten into strided shards."""
    if not (isinstance(x, torch.Tensor) and is_dtensor(x)):
        return x
    return _GradLike.apply(x)


class _GradLike(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.placements = tuple(x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if is_dtensor(g) and tuple(g.placements) != ctx.placements:
            g = g.redistribute(g.device_mesh, ctx.placements)
        return g


def constrain(x, axes: Tuple[Optional[str], ...], rules: Optional[dict]):
    """``with_sharding_constraint`` by logical axes: a DTensor is
    redistributed to the divisibility-checked placements of ``axes`` on its
    mesh, which must be the active one if a mesh is set (a ``Partial`` one
    is reduced on the way); a plain tensor, or ``rules=None``, returns
    ``x`` as it is."""
    if rules is None or not isinstance(x, torch.Tensor) or not is_dtensor(x):
        return x
    mesh = x.device_mesh
    if current_mesh() is not None and current_mesh() != mesh:
        raise ValueError("constrain: a DTensor on another mesh than the "
                         "active one")
    want = placements(spec(axes, rules, tuple(x.shape), mesh_shape_of(mesh)),
                      mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


__all__ = ["DATA_AXES", "rules_for", "spec", "mesh_shape_of", "placements",
           "is_axes", "shardings_for", "tree_specs", "tree_shardings",
           "set_mesh", "current_mesh", "is_dtensor", "mesh_of", "to_mesh",
           "to_plain", "replicate", "pad", "rows_local", "whole_local", "from_rows", "whole_dims",
           "grad_like", "constrain"]
