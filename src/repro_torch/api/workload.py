"""Step building, static meta and recording names for one workload.

Counterpart of the module functions of ``repro/api/workload.py``
(``static_meta_for``, ``build_step``, ``recording_name``), shared by the
record and serve launchers so that both derive the same shapes and names
from the same arguments.  The ``Workload`` class comes with ROADMAP
Queue 1, item 7.
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.training import steps as ST

KINDS = ("prefill", "decode")


def key_arch(arch: str) -> str:
    """Canonical architecture id: smoke-shrunk configs record and replay
    under the base arch name (``repro/registry`` keeps the reference's)."""
    return arch[:-len("-smoke")] if arch.endswith("-smoke") else arch


def static_meta_for(kind: str, *, cache_len: int, block_k: int, batch: int,
                    seq: int, eos_id: int = 2) -> dict:
    """The shape/static description that parameterizes ``build_step``.
    ``seq`` shapes prefill only; a non-default ``eos_id`` is baked into
    the fused decode program and so enters decode's description."""
    static = {"kind": kind, "cache_len": cache_len, "block_k": block_k,
              "batch": batch}
    if kind == "prefill":
        static["seq"] = seq
    elif eos_id != 2:
        static["eos_id"] = eos_id
    return static


def build_step(cfg, kind: str, *, cache_len: int, block_k: int = 8,
               batch: int = 1, seq: int = 32, eos_id: int = 2, params=None,
               device="cuda"):
    """(step, example inputs, donated argnums) for one kind.  The step
    takes the params as its first input, as the nested dicts/lists of
    tensors ``layers.to_tree`` gives; the example inputs are real tensors
    on ``device``: the caller's params (a ParamTree or such a tree), or
    zeros of the schema's shapes, and zeros for the rest.  Decode donates
    the caches (argument 3): it updates them in place and returns them."""
    device = resolve_device(device)
    if params is None:
        tree = L.zeros_like_schema(M.model_schema(cfg), cfg.dtype, device)
    elif isinstance(params, torch.nn.Module):
        tree = L.to_tree(params)
    else:
        tree = params
    if kind == "prefill":
        fn = ST.make_prefill_step(cfg, cache_len)
        tokens = torch.zeros((batch, seq), dtype=torch.int32, device=device)
        return fn, (tree, {"tokens": tokens}), ()
    if kind == "decode":
        fn = ST.make_fused_decode_step(cfg, k=block_k, eos_id=eos_id)
        caches = M.init_cache(cfg, batch, cache_len, device=device)
        zeros = torch.zeros((batch,), dtype=torch.int32, device=device)
        return fn, (tree, zeros, zeros.clone(), caches), (3,)
    raise ValueError(kind)


def recording_name(arch: str, kind: str, extra: str = "") -> str:
    """Flat on-disk filename for a recording."""
    return f"{key_arch(arch)}_{kind}{('_' + extra) if extra else ''}.codyrec"


__all__ = ["KINDS", "key_arch", "static_meta_for", "build_step",
           "recording_name"]
