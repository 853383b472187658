"""Device meshes on ``torch.distributed``'s ``DeviceMesh``.

Counterpart of ``repro/launch/mesh.py``.  ``make_production_mesh`` is a
function, never a module constant, and importing this module starts no
process group: a mesh is built over the world that exists when it is
asked for.  ``make_host_mesh`` starts a world when there is none: the one
``torchrun`` describes in the environment (``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT``), or else a world of one through a
``FileStore`` in a temporary directory (no TCP port), over NCCL on
``cuda`` (and gloo for CPU tensors in it) and gloo on ``cpu``.

    mesh = make_host_mesh(model=1, device="cpu")   # ("data", "model")
    with set_mesh(mesh):
        ...
"""
from __future__ import annotations

import atexit
import os
import shutil
import tempfile
from datetime import timedelta

import torch
import torch.distributed as dist

from repro_torch.sharding import set_mesh  # re-export for launchers

__all__ = ["make_mesh", "set_mesh", "make_production_mesh", "make_host_mesh",
           "init_world", "BACKENDS"]

# the card's world also takes CPU tensors (gloo), as a CPU mesh of it does
BACKENDS = {"cuda": "cpu:gloo,cuda:nccl", "cpu": "gloo"}
TIMEOUT = timedelta(seconds=120)    # a hung collective fails, not stalls


def init_world(device="cuda") -> int:
    """The process group, started if there is none (module docstring) ->
    this process's rank."""
    if not dist.is_initialized():
        device = torch.device(device)
        backend = BACKENDS[device.type]
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            if device.type == "cuda":
                torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
            dist.init_process_group(backend, timeout=TIMEOUT)
        else:
            root = tempfile.mkdtemp(prefix="repro_torch_world_")
            atexit.register(shutil.rmtree, root, True)
            store = dist.FileStore(os.path.join(root, "store"), 1)
            dist.init_process_group(backend, store=store, rank=0,
                                    world_size=1, timeout=TIMEOUT)
            # ended before its store is removed (exit handlers run last
            # first): an NCCL world left open keeps its process alive
            atexit.register(_end_world)
    return dist.get_rank()


def _end_world() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def make_mesh(shape, axes, device="cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the existing
    world (whose size must be the product of ``shape``)."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.kernels import _sharding
    _sharding.register()
    return init_device_mesh(torch.device(device).type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """16 x 16 ("data", "model"), or 2 x 16 x 16 ("pod", "data", "model")."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def make_host_mesh(model: int = 1, device="cuda"):
    """A ("data", "model") mesh over every rank of the world (started if
    there is none): world / model x model."""
    init_world(device)
    n = dist.get_world_size()
    if n % model:
        raise ValueError(f"make_host_mesh: model={model} does not divide "
                         f"the world of {n}")
    return make_mesh((n // model, model), ("data", "model"), device)
