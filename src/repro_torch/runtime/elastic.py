"""Elastic scaling: restart on a different device count or mesh.

Counterpart of ``repro/runtime/elastic.py``.  Shardings are logical rules
resolved on the mesh at hand, and recordings embed the mesh's descriptor.
On a topology change (a node lost, a scale-up):

  1. pick the new mesh from the surviving device count
     (``choose_mesh_shape``, ``make_elastic_mesh``),
  2. restore the checkpoint (whole logical arrays) and place each leaf on
     the new mesh with ``shardings_for``'s placements (``reshard_state``),
  3. re-record the step for the new mesh (a recording's key carries the
     mesh's fingerprint, ``api/workload.py``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from repro_torch.launch.mesh import init_world, make_mesh
from repro_torch.sharding import rules_for, shardings_for


def choose_mesh_shape(n_devices: int, prefer_model: int = 16) -> Tuple[int, int]:
    """Largest (data, model) grid for the surviving devices; model axis
    capped at prefer_model and must divide n_devices."""
    model = min(prefer_model, n_devices)
    while n_devices % model:
        model -= 1
    return (n_devices // model, model)


def make_elastic_mesh(n_devices: Optional[int] = None, prefer_model: int = 16,
                      device="cuda"):
    """A ("data", "model") mesh of ``choose_mesh_shape`` over the world
    (started if there is none), whose size must be ``n_devices`` when it
    is given: a process group does not shrink, a restart starts a world of
    the surviving size."""
    init_world(device)
    n = dist.get_world_size()
    if n_devices is not None and n_devices != n:
        raise ValueError(f"make_elastic_mesh: {n_devices} devices asked for "
                         f"in a world of {n}")
    return make_mesh(choose_mesh_shape(n, prefer_model), ("data", "model"),
                     device)


def reshard_state(state_np, axes_tree, mesh, mode: str = "train", cfg=None):
    """Place a restored state (numpy or host tensor leaves) on ``mesh``:
    every leaf a DTensor on the mesh's device with ``shardings_for``'s
    placements under ``rules_for(mode)``.  With ``cfg`` the state is in
    the reference's stacked layout (what ``CheckpointStore.restore`` of a
    ``to_reference_layout`` tree returns) and is split into the port's
    per-block trees first (``from_reference_layout``); ``axes_tree`` is
    the port's (``training.steps.train_state_axes``)."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.runtime.checkpoint import from_reference_layout
    if cfg is not None:
        state_np = from_reference_layout(cfg, state_np, "cpu")
    state = pytree.tree_map(
        lambda x: x if isinstance(x, torch.Tensor)
        else torch.from_numpy(np.array(x)), state_np)
    rules = rules_for(mode, tuple(mesh.mesh_dim_names))
    sh = shardings_for(axes_tree, state, mesh, rules)
    device = mesh.device_type
    return pytree.tree_map(
        lambda x, p: distribute_tensor(x.to(device), mesh, list(p)),
        state, sh, is_leaf=lambda x: isinstance(x, torch.Tensor))


__all__ = ["choose_mesh_shape", "make_elastic_mesh", "reshard_state"]
