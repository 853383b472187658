"""Carry the reference's parameters over into the port.

``params_from_jax(cfg, tree)`` takes the JAX package's parameter pytree as
numpy arrays (e.g. ``jax.tree.map(np.asarray, init_params(cfg, key))``)
and returns the port's ``ParamTree`` on ``device``.  The reference stacks a stage's
blocks on a leading axis (its ``stack_schema``, scanned by ``lax.scan``),
and stacks again the blocks inside a group (zamba2's ``mambas``, xLSTM's
``m``); the port keeps one module per block, so both axes are un-stacked
here.  A tree quantized by the reference's ``quantize_params`` carries
over too: where it has ``{"q", "s"}`` the port gets int8 ``q`` and fp32
``s``, un-stacked the same way (``repro_torch.serving.quant``).  Nothing
in this module imports JAX: the arrays arrive as numpy.
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

    def tensor(shape, arr, dt):
        # a writable copy; bf16 -> f32 is exact, int8 stays int8
        arr = np.array(arr, np.int8 if dt == torch.int8 else np.float32)
        if tuple(arr.shape) != tuple(shape):
            raise ValueError(f"shape {arr.shape} != schema {shape}")
        return torch.from_numpy(arr).to(device=device, dtype=dt)

    def leaf(spec: ParamSpec, sub, idx):
        if isinstance(sub, dict):   # quantized: {"q": int8, "s": f32}
            q, s = (np.asarray(sub[k])[idx] for k in ("q", "s"))
            return {"q": tensor(spec.shape, q, torch.int8),
                    "s": tensor(spec.shape[:-1] + (1,), s, torch.float32)}
        return tensor(spec.shape, np.asarray(sub)[idx],
                      L.torch_dtype(spec.dtype or cfg.dtype))

    def walk(schema, sub, idx=()):
        """A list in the port's schema is a stack in the reference's
        (unless it holds one block): its index joins ``idx``."""
        if isinstance(schema, ParamSpec):
            return leaf(schema, sub, idx)
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
