"""Carry the reference's parameters over into the port.

``params_from_jax(cfg, tree)`` takes the JAX package's parameter pytree as
numpy arrays (e.g. ``jax.tree.map(np.asarray, init_params(cfg, key))``)
and returns the port's ``ParamTree`` on ``device``.  The reference stacks a stage's
blocks on a leading axis (its ``stack_schema``, scanned by ``lax.scan``),
and stacks again the blocks inside a group (zamba2's ``mambas``, xLSTM's
``m``); the port keeps one module per block, so both axes are un-stacked
here.  Nothing in this module imports JAX: the arrays arrive as numpy.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models.layers import ParamSpec


def params_from_jax(cfg, tree, device="cuda"):
    device = resolve_device(device)

    def tensor(spec: ParamSpec, arr):
        arr = np.array(arr, np.float32)     # a writable copy; bf16 -> f32 is exact
        if tuple(arr.shape) != tuple(spec.shape):
            raise ValueError(f"shape {arr.shape} != schema {spec.shape}")
        dt = L.torch_dtype(spec.dtype or cfg.dtype)
        return torch.from_numpy(arr).to(device=device, dtype=dt)

    def walk(schema, sub, idx=()):
        """A list in the port's schema is a stack in the reference's
        (unless it holds one block): its index joins ``idx``."""
        if isinstance(schema, ParamSpec):
            return tensor(schema, np.asarray(sub)[idx] if idx else sub)
        if isinstance(schema, list):
            return [walk(s, sub, idx + ((i,) if len(schema) > 1 else ()))
                    for i, s in enumerate(schema)]
        return {k: walk(s, sub[k], idx) for k, s in schema.items()}

    schema = M.model_schema(cfg)
    entries = {}
    for name, s in schema.items():
        if name == "stages":    # a list of stages in both packages
            entries[name] = [walk(blocks, jstage) for blocks, jstage
                             in zip(s, tree["stages"])]
        else:
            entries[name] = walk(s, tree[name])
    return L.to_module(entries)
