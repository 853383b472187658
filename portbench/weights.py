"""The model's weights, made on the device from the seed.

The port's parameter schema (``models.model.model_schema``) gives every
leaf's shape, dtype and init scale.  All leaves of one dtype are views of
one buffer, filled by a few large ``normal_`` calls from one
``torch.Generator`` on the device, then scaled in place: matrices by their
init scale, norm scales to 1 + 0.1 n, biases to 0.1 n.  The program gets
the nested dicts/lists of these tensors; the reference gets the same
tensors by dotted path."""
from __future__ import annotations

import math

import torch

_CHUNK = 1 << 28
_MASK = (1 << 63) - 1


def _leaves(schema, path=()):
    if isinstance(schema, dict):
        for k, v in schema.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(schema, list):
        for i, v in enumerate(schema):
            yield from _leaves(v, path + (str(i),))
    else:
        yield ".".join(path), schema


def _nest(flat: dict, schema, path=()):
    if isinstance(schema, dict):
        return {k: _nest(flat, v, path + (k,)) for k, v in schema.items()}
    if isinstance(schema, list):
        return [_nest(flat, v, path + (str(i),)) for i, v in enumerate(schema)]
    return flat[".".join(path)]


class Weights:
    """Buffers for one schema; ``fill(seed)`` draws them anew in place, so
    the tensors keep their addresses from seed to seed."""

    def __init__(self, schema, default_dtype: str, device):
        self.schema = schema
        self.specs = list(_leaves(schema))
        sizes = {}
        for _, sp in self.specs:
            dt = getattr(torch, sp.dtype or default_dtype)
            sizes[dt] = sizes.get(dt, 0) + math.prod(sp.shape)
        self.buffers = {dt: torch.empty(n, dtype=dt, device=device)
                        for dt, n in sizes.items()}
        offset = dict.fromkeys(sizes, 0)
        self.flat = {}
        for name, sp in self.specs:
            dt = getattr(torch, sp.dtype or default_dtype)
            n = math.prod(sp.shape)
            self.flat[name] = self.buffers[dt][offset[dt]:offset[dt] + n].view(
                sp.shape)
            offset[dt] += n
        self.tree = _nest(self.flat, schema)

    def fill(self, seed: int) -> None:
        dev = next(iter(self.buffers.values())).device
        gen = torch.Generator(device=dev).manual_seed(seed & _MASK)
        with torch.no_grad():
            for buf in self.buffers.values():
                for s in range(0, buf.numel(), _CHUNK):
                    buf[s:s + _CHUNK].normal_(generator=gen)
            for name, sp in self.specs:
                t = self.flat[name]
                if sp.scale == -1.0:
                    t.mul_(0.1).add_(1.0)
                elif sp.scale == 0.0:
                    t.mul_(0.1)
                else:
                    t.mul_(sp.scale)
