"""Carry the reference's parameters over into the port.

``params_from_jax(cfg, tree)`` takes the JAX package's parameter pytree as
numpy arrays (e.g. ``jax.tree.map(np.asarray, init_params(cfg, key))``)
and returns the port's ``ParamTree`` on ``device``.  The reference stacks a stage's
blocks on a leading axis (its ``stack_schema``, scanned by ``lax.scan``);
the port keeps one module per block, so that axis is un-stacked here.
Nothing in this module imports JAX: the arrays arrive as numpy.
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

    def walk(schema, sub, i=None):
        if isinstance(schema, ParamSpec):
            return tensor(schema, sub if i is None else np.asarray(sub)[i])
        return {k: walk(s, sub[k], i) for k, s in schema.items()}

    schema = M.model_schema(cfg)
    entries = {}
    for name, s in schema.items():
        if name != "stages":
            entries[name] = walk(s, tree[name])
            continue
        entries[name] = [
            [walk(b, jstage, None if st.n == 1 else i)
             for i, b in enumerate(blocks)]
            for st, blocks, jstage in zip(M.build_stages(cfg), s,
                                          tree["stages"])]
    return L.to_module(entries)
